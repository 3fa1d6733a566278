"""PNA aggregation statistics over sorted receivers: the CUDA kernel
``pna_aggregate_fwd`` and its plain PyTorch version, and the trainable
``pna_aggregate`` built on it.

Port of ``hydragnn_tpu/ops/segment_pallas.py:pna_aggregate`` (forward):
the Pallas ``_family_kernel`` (masked Σv, Σv² per receiver, f32
accumulation) together with the XLA segment max over ``[v, -v]`` that
``_pna_aggregate`` pairs with it. One kernel (``csrc/pna_aggregate.cu``)
reads ``v`` once and emits all four outputs:

  sum   [N, H] f32      Σ_e m_e v_e
  sumsq [N, H] f32      Σ_e m_e v_e²
  cnt   [N]    f32      Σ_e m_e
  both  [N, 2H] v.dtype [max v | max -v] over unmasked edges, empty
                        (and at-or-below-lowest) rows cleaned to 0

``receivers`` must be sorted ascending (``graph/batch.py`` emits them
so); this is not checked on the card, where a check would cost a host
sync. ``pna_aggregate`` is differentiable in ``v``, as the reference's
custom VJP: the backward is B6 (walking the same CSR row pointers as
this forward) then B7 (``pna_aggregate_bwd.py``) on a CUDA tensor, and
their plain version on a CPU tensor; ``cnt`` takes no gradient.

``row_ptr`` is the receivers' CSR row pointers
(``row_pointers.py``), which the chassis builds once per forward; given
them, a call is one launch. Without them the wrapper builds them first
(``row_pointers``). They are checked for shape, type and device, not
for their contents. The plain versions do not read them.

``real_edges`` (an int32 scalar tensor on the data's device, or None)
bounds the walk, forward and backward: the caller's promise that every
edge at or past it is masked (``models/convs.py`` passes the batch's
edge occupancy), so the outputs and the gradient are the same bits with
it and without it, and no kernel walks the batch's masked tail. The
kernels read it on the device (no host synchronisation; a CUDA graph's
replay picks up a new value); the plain versions read it on the host
and treat the edges past it as masked.

The wrapper dispatches on the tensor's device: a CPU tensor takes the
plain versions, a CUDA tensor launches the kernels or raises — there is
no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import torch

from hydragnn_tpu_torch.ops._build import (
    FLOAT_CODE,
    LaunchCount,
    bind,
    check_launch,
    cuda_args,
    stream_of,
)
from hydragnn_tpu_torch.ops.pna_aggregate_bwd import pna_aggregate_bwd
from hydragnn_tpu_torch.ops.row_pointers import check_row_ptr, row_pointers
from hydragnn_tpu_torch.ops.segment_sum import bounded_rows, check_bound

SOURCE = "hydragnn_tpu_torch/ops/csrc/pna_aggregate.cu"
REPLACES = "hydragnn_tpu/ops/segment_pallas.py:219"


# launches of the CUDA kernel through pna_aggregate (never the plain path)
launches = LaunchCount()


def pna_aggregate_plain(
    v: torch.Tensor,
    receivers: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
    real_edges: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reference arithmetic in plain PyTorch: masked products summed
    with ``index_add_`` in f32, the maxima with ``scatter_reduce(amax)``
    over ``where(mask, [v, -v], lowest)``, cleaned to 0 at or below the
    type's lowest value (``segment_pallas.py:segment_sum_family_xla`` and
    ``_pna_aggregate``), over the edges below ``real_edges`` (read on
    the host)."""
    r = bounded_rows(real_edges, v.shape[0])
    if r < v.shape[0]:
        v, receivers = v[:r], receivers[:r]
        mask = None if mask is None else mask[:r]
    e, h = v.shape
    n = int(num_segments)
    idx = receivers.long()
    vf = v.float()
    if mask is None:
        mask = torch.ones(e, dtype=torch.bool, device=v.device)
    mf = mask.to(torch.float32)
    vm = vf * mf[:, None]
    s = torch.zeros(n, h, dtype=torch.float32, device=v.device).index_add_(0, idx, vm)
    sq = torch.zeros(n, h, dtype=torch.float32, device=v.device).index_add_(0, idx, vm * vm)
    cnt = torch.zeros(n, dtype=torch.float32, device=v.device).index_add_(0, idx, mf)
    lowest = torch.finfo(v.dtype).min
    vv = torch.cat([v, -v], dim=1)
    vv = torch.where(mask[:, None], vv, torch.full((), lowest, dtype=v.dtype, device=v.device))
    raw = torch.full((n, 2 * h), float("-inf"), dtype=v.dtype, device=v.device).scatter_reduce(
        0, idx[:, None].expand(e, 2 * h), vv, "amax", include_self=True
    )
    both = torch.where(raw <= lowest, torch.zeros((), dtype=v.dtype, device=v.device), raw)
    return s, sq, cnt, both


_lib_lock = threading.Lock()
_fn = None  # the bound C entry point; guarded by _lib_lock


def _kernel():
    global _fn
    with _lib_lock:
        if _fn is None:
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            _fn = bind("pna_aggregate.cu", "hg_pna_aggregate_fwd", [p, i, p, p, ll, ll, i, p, p, p, p, p, p])
        return _fn


def _check(v, receivers, num_segments, mask, row_ptr, real_edges) -> None:
    if v.dim() != 2:
        raise ValueError(f"pna_aggregate: v must be [E, H], got shape {tuple(v.shape)}")
    if v.dtype not in FLOAT_CODE:
        raise TypeError(f"pna_aggregate: v must be float32 or bfloat16, got {v.dtype}")
    if receivers.dim() != 1 or receivers.shape[0] != v.shape[0]:
        raise ValueError("pna_aggregate: receivers must be [E] matching v")
    if mask is not None and (mask.dim() != 1 or mask.shape[0] != v.shape[0]):
        raise ValueError("pna_aggregate: mask must be [E] matching v")
    if mask is not None and mask.dtype != torch.bool:
        raise TypeError(f"pna_aggregate: mask must be bool, got {mask.dtype}")
    if int(num_segments) < 1:
        raise ValueError("pna_aggregate: num_segments must be >= 1")
    if row_ptr is not None:
        check_row_ptr("pna_aggregate", row_ptr, num_segments, v.device)
    check_bound("pna_aggregate", real_edges, v.device)


def _forward(v, receivers, num_segments, mask, row_ptr, real_edges):
    """The four statistics and, on the card, the receivers' CSR row
    pointers the kernel walked (None on the CPU)."""
    if v.device.type == "cpu":
        return pna_aggregate_plain(v, receivers, num_segments, mask, real_edges) + (None,)
    if v.device.type != "cuda":
        raise ValueError(f"pna_aggregate: unsupported device {v.device}")
    dev = cuda_args("pna_aggregate", v, receivers, mask, real_edges)
    if receivers.dtype != torch.int32:
        raise TypeError(f"pna_aggregate: receivers must be int32 on CUDA, got {receivers.dtype}")
    e, h = v.shape
    if e >= 2**31:
        raise ValueError("pna_aggregate: more than 2^31 - 1 edges")
    n = int(num_segments)
    if row_ptr is None:
        row_ptr = row_pointers(receivers, n)
    fn = _kernel()
    with torch.cuda.device(dev):
        s = torch.empty(n, h, dtype=torch.float32, device=dev)
        sq = torch.empty(n, h, dtype=torch.float32, device=dev)
        cnt = torch.empty(n, dtype=torch.float32, device=dev)
        both = torch.empty(n, 2 * h, dtype=v.dtype, device=dev)
        rc = fn(
            v.data_ptr(), FLOAT_CODE[v.dtype], None if mask is None else mask.data_ptr(),
            None if real_edges is None else real_edges.data_ptr(), e, n, h, row_ptr.data_ptr(), s.data_ptr(),
            sq.data_ptr(), cnt.data_ptr(), both.data_ptr(), stream_of(dev),
        )
    check_launch("pna_aggregate_fwd", rc)
    launches.add()
    return s, sq, cnt, both, row_ptr


class _PnaAggregate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v, receivers, num_segments, mask, row_ptr, real_edges):
        s, sq, cnt, both, row_ptr = _forward(v, receivers, num_segments, mask, row_ptr, real_edges)
        ctx.save_for_backward(v, receivers, mask, both, row_ptr, real_edges)
        ctx.num_segments = num_segments
        ctx.mark_non_differentiable(cnt)
        return s, sq, cnt, both

    @staticmethod
    def backward(ctx, g_sum, g_sumsq, g_cnt, g_both):
        v, receivers, mask, both, row_ptr, real_edges = ctx.saved_tensors
        grad = pna_aggregate_bwd(
            v, receivers, mask, both, g_sum.float().contiguous(), g_sumsq.float().contiguous(),
            g_both.to(v.dtype).contiguous(), ctx.num_segments, row_ptr, real_edges,
        )
        return grad, None, None, None, None, None


def pna_aggregate(
    v: torch.Tensor,
    receivers: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
    row_ptr: Optional[torch.Tensor] = None,
    real_edges: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(sum, sumsq, cnt, both)`` of ``v`` grouped by sorted
    ``receivers`` (module docstring), differentiable in ``v``. CPU
    tensors take the plain versions; CUDA tensors launch
    ``pna_aggregate_fwd`` and, in the backward, B6 and B7 (B5 and B6
    walk ``row_ptr``, built here when not given), all three bounded by
    ``real_edges``."""
    _check(v, receivers, num_segments, mask, row_ptr, real_edges)
    if torch.is_grad_enabled() and v.requires_grad:
        return _PnaAggregate.apply(v, receivers, int(num_segments), mask, row_ptr, real_edges)
    return _forward(v, receivers, int(num_segments), mask, row_ptr, real_edges)[:4]
