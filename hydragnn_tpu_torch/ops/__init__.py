"""Hand-written Hopper kernels, each beside its plain PyTorch version.

``pna_aggregate.py`` (source ``csrc/pna_aggregate.cu``) replaces
``hydragnn_tpu/ops/segment_pallas.py:_family_kernel`` and the XLA
segment max it was paired with. Kernels are built at first use
(``_build.py``), never at import.
"""
