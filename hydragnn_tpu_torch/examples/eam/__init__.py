"""The port's copy of ``examples/eam/``."""
