"""The port's copy of ``examples/lsms/``."""
