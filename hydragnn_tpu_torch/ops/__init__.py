"""Hand-written Hopper kernels, each beside its plain PyTorch version.

Each module's wrapper launches its CUDA kernel (``csrc/<name>.cu``) on a
CUDA tensor and runs the plain version on a CPU tensor, counts its
launches (``launches``) and names the TPU kernel it replaces
(``REPLACES``):

  pna_aggregate.py      B5 ``_family_kernel`` (+ the XLA max over [v, -v]);
                        autograd op ``pna_aggregate``, its backward on B6/B7
  pna_aggregate_bwd.py  B6 ``_pna_bwd_count_kernel``, B7 ``_pna_bwd_grad_kernel``
  gather_stats.py       B1 ``_gather_stats_kernel``; autograd op
                        ``gather_presum_stats``, its backward on a kernel
                        of its own (``_gather_presum_bwd``'s regather and
                        elementwise block, XLA on the TPU) and B4
  segment_sum.py        B2 ``_sum_kernel``
  gather_rows.py        B3 ``_bcast_kernel``
  segment_sum_local.py  B4 ``_sum_local_kernel``
  fused_conv.py         B8 ``_make_fused_kernel`` (autograd op
                        ``fused_aggregate``, its backward on B2-B4)
  fused_conv_stack.py   B9 ``_make_stack_kernel`` (autograd op
                        ``fused_conv_stack``, exported here; its backward
                        the per-layer composition on B8, B3 and B4)

``row_pointers.py`` is the one source of the sorted receivers' CSR row
pointers (``csrc/row_pointers.cu`` on the card) that B5, B6, B8 and B9
walk (B7 is edge-parallel); the chassis builds them once per forward.

``dynamic_radius.py`` (SchNet's in-forward radius graph) has no kernel:
it is plain PyTorch, as the JAX package's is XLA. Kernels are built at
first use (``_build.py``), never at import.
"""

from hydragnn_tpu_torch.ops.fused_conv_stack import fused_conv_stack  # noqa: E402

__all__ = ["fused_conv_stack"]
