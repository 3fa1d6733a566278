"""The port's copy of ``examples/ising_model/``."""
