"""The port's copy of ``examples/qm9/``."""
