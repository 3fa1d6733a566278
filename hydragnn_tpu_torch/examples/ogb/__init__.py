"""The port's copy of ``examples/ogb/``."""
