"""The port's copy of ``examples/giant_graph/``."""
