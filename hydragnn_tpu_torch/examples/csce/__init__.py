"""The port's copy of ``examples/csce/``."""
