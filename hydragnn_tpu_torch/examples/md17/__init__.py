"""The port's copy of ``examples/md17/``."""
