"""The backward of the PNA aggregation: the CUDA kernels B6
(``pna_bwd_count``) and B7 (``pna_bwd_grad``) and their plain PyTorch
versions.

Port of the custom VJP of ``hydragnn_tpu/ops/segment_pallas.py:
pna_aggregate``: its kernel pair ``_pna_bwd_count_kernel`` (K1) and
``_pna_bwd_grad_kernel`` (K2), and the unfused composition
``_pna_bwd_unfused`` of the same math. With ``both = [max v | max -v]``
per receiver (the forward's output, empty rows cleaned to 0) and the
cotangents ``g_sum``, ``g_sumsq`` (f32) and ``g_both`` (v's type) — the
count's cotangent is ignored, the count does not depend on ``v``:

  cnt  [N, 2H] f32   ties per receiver and column: unmasked edges with
                     v == max v, and with -v == max -v         (B6)
  grad [E, H]        g_sum + 2·v·g_sumsq + [v == max]·share_max
                     − [−v == −min]·share_min on unmasked edges, 0 on
                     masked ones, share = g_both / max(cnt, 1) cast to
                     v's type                                   (B7)

Types, as in the JAX package: the kernel (its K2) forms the sum in f32
on values cast to v's type and casts once at the end; the plain version
(``_pna_bwd_unfused``) combines in v's type. So the two are bit-equal
in f32 and differ by bfloat16 rounding in bf16. The plain version adds
the two tie terms one after the other, as K2 does.

``receivers`` must be sorted ascending. An edge takes part when it is
unmasked, lies below the bound and has a receiver in [0, N): the others
never tie (they are skipped, not tested by value) and get a zero
gradient. ``real_edges`` (an int32 scalar tensor on the data's device,
or None) is that bound: the caller's promise that every edge at or past
it is masked (``pna_aggregate`` hands on the batch's edge occupancy), so
the results are the same bits with it and without it, and the kernels
never walk the tail. They read it on the device: no call synchronises
with the host, and a CUDA graph's replay picks up a new value.

A CPU tensor takes the plain version; a CUDA tensor launches the kernels
(``csrc/pna_aggregate_bwd.cu``) or raises. On the card B6 walks the
receivers' CSR row pointers ``row_ptr`` (``row_pointers.py``):
``pna_aggregate``'s backward hands it the ones its forward walked, so it
builds none. B7 is edge-parallel and takes no row pointers.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from hydragnn_tpu_torch.ops._build import (
    FLOAT_CODE,
    LaunchCount,
    bind,
    check_launch,
    cuda_args,
    stream_of,
)
from hydragnn_tpu_torch.ops.row_pointers import check_row_ptr
from hydragnn_tpu_torch.ops.segment_sum import bounded_rows, check_bound

SOURCE = "hydragnn_tpu_torch/ops/csrc/pna_aggregate_bwd.cu"
COUNT_REPLACES = "hydragnn_tpu/ops/segment_pallas.py:1477"
GRAD_REPLACES = "hydragnn_tpu/ops/segment_pallas.py:1573"

# launches of B6 and of B7 (never the plain path)
count_launches = LaunchCount()
grad_launches = LaunchCount()

_lock = threading.Lock()
_fns = {}  # symbol -> bound C entry point; guarded by _lock

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {
    "hg_pna_bwd_count": [_P, _I, _P, _P, _P, _L, _L, _I, _P, _P, _P, _P],
    "hg_pna_bwd_grad": [_P, _I, _P, _P, _P, _L, _L, _I, _P, _P, _P, _P, _P, _P, _P],
}


def _kernel(symbol: str):
    with _lock:
        if symbol not in _fns:
            _fns[symbol] = bind("pna_aggregate_bwd.cu", symbol, _ARGTYPES[symbol])
        return _fns[symbol]


def _taking_part(receivers, mask, num_segments, real_edges):
    """The edges that take part (unmasked, below the bound, receiver in
    [0, N)) as a bool [E], and the receivers as row indices (0 where an
    edge takes no part)."""
    live = (receivers >= 0) & (receivers < int(num_segments))
    if mask is not None:
        live = live & mask
    r = bounded_rows(real_edges, receivers.shape[0])
    if r < receivers.shape[0]:
        live[r:] = False
    return live, torch.where(live, receivers, 0).long()


def pna_bwd_count_plain(
    v: torch.Tensor,
    receivers: torch.Tensor,
    mask: Optional[torch.Tensor],
    both: torch.Tensor,
    num_segments: int,
    real_edges: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """B6's function: the [N, 2H] f32 tie counts (``_pna_bwd_unfused``'s
    ``cnt_both``) over the edges that take part (``real_edges`` read on
    the host)."""
    live, idx = _taking_part(receivers, mask, num_segments, real_edges)
    sel = (torch.cat([v, -v], dim=1) == both.to(v.dtype).index_select(0, idx)) & live[:, None]
    out = torch.zeros(int(num_segments), 2 * v.shape[1], dtype=torch.float32, device=v.device)
    return out.index_add_(0, idx, sel.to(torch.float32))


def pna_bwd_grad_plain(
    v: torch.Tensor,
    receivers: torch.Tensor,
    mask: Optional[torch.Tensor],
    both: torch.Tensor,
    g_sum: torch.Tensor,
    g_sumsq: torch.Tensor,
    g_both: torch.Tensor,
    cnt: torch.Tensor,
    real_edges: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """B7's function, combined in v's type (``_pna_bwd_unfused``); 0 on
    the edges that take no part (``real_edges`` read on the host)."""
    vd, h = v.dtype, v.shape[1]
    live, idx = _taking_part(receivers, mask, both.shape[0], real_edges)
    share = (g_both.float() / torch.clamp(cnt, min=1.0)).to(vd)
    table = torch.cat([g_sum.to(vd), g_sumsq.to(vd), both.to(vd), share], dim=1)
    t = table.index_select(0, idx)
    gs, gss, bx, bn, shx, shn = (t[:, i * h : (i + 1) * h] for i in range(6))
    zero = torch.zeros((), dtype=vd, device=v.device)
    grad = gs + 2.0 * v * gss
    grad = grad + torch.where(v == bx, shx, zero)
    grad = grad - torch.where(-v == bn, shn, zero)
    return torch.where(live[:, None], grad, zero)


def pna_aggregate_bwd_plain(
    v: torch.Tensor,
    receivers: torch.Tensor,
    mask: Optional[torch.Tensor],
    both: torch.Tensor,
    g_sum: torch.Tensor,
    g_sumsq: torch.Tensor,
    g_both: torch.Tensor,
    num_segments: int,
    real_edges: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The whole backward in plain PyTorch (``_pna_bwd_unfused`` for a
    bool mask or none): ``grad_v`` [E, H] in v's type."""
    cnt = pna_bwd_count_plain(v, receivers, mask, both, num_segments, real_edges)
    return pna_bwd_grad_plain(v, receivers, mask, both, g_sum, g_sumsq, g_both, cnt, real_edges)


def _check(v, receivers, mask, both, num_segments, real_edges) -> None:
    if v.dim() != 2 or v.dtype not in FLOAT_CODE:
        raise ValueError(f"pna_aggregate_bwd: v must be [E, H] float32 or bfloat16, got {tuple(v.shape)} {v.dtype}")
    e, h = v.shape
    if receivers.shape != (e,):
        raise ValueError("pna_aggregate_bwd: receivers must be [E] matching v")
    if mask is not None and (mask.shape != (e,) or mask.dtype != torch.bool):
        raise ValueError("pna_aggregate_bwd: mask must be a bool [E] matching v")
    if both.shape != (int(num_segments), 2 * h) or both.dtype != v.dtype:
        raise ValueError(f"pna_aggregate_bwd: both must be [N, 2H] in v's type, got {tuple(both.shape)} {both.dtype}")
    check_bound("pna_aggregate_bwd", real_edges, v.device)


def _cuda_common(name, v, receivers, mask, *tensors):
    dev = cuda_args(name, v, receivers, mask, *tensors)
    if receivers.dtype != torch.int32:
        raise TypeError(f"{name}: receivers must be int32 on CUDA, got {receivers.dtype}")
    if v.shape[0] >= 2**31:
        raise ValueError(f"{name}: more than 2^31 - 1 edges")
    return dev


def pna_bwd_count(
    v: torch.Tensor,
    receivers: torch.Tensor,
    mask: Optional[torch.Tensor],
    both: torch.Tensor,
    num_segments: int,
    row_ptr: Optional[torch.Tensor] = None,
    real_edges: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """B6: the [N, 2H] f32 tie counts. CPU tensors take the plain
    version (which does not read ``row_ptr``); CUDA tensors launch the
    kernel, which walks ``row_ptr`` up to ``real_edges``."""
    _check(v, receivers, mask, both, num_segments, real_edges)
    n = int(num_segments)
    if row_ptr is not None:
        check_row_ptr("pna_bwd_count", row_ptr, n, v.device)
    if v.device.type == "cpu":
        return pna_bwd_count_plain(v, receivers, mask, both, num_segments, real_edges)
    if row_ptr is None:
        raise ValueError("pna_bwd_count: the receivers' row pointers are needed on CUDA (row_pointers)")
    dev = _cuda_common("pna_bwd_count", v, receivers, mask, both, real_edges)
    e, h = v.shape
    fn = _kernel("hg_pna_bwd_count")
    with torch.cuda.device(dev):
        cnt = torch.empty(n, 2 * h, dtype=torch.float32, device=dev)
        rc = fn(
            v.data_ptr(), FLOAT_CODE[v.dtype], None if mask is None else mask.data_ptr(), receivers.data_ptr(),
            None if real_edges is None else real_edges.data_ptr(), e, n, h, both.data_ptr(), row_ptr.data_ptr(),
            cnt.data_ptr(), stream_of(dev),
        )
    check_launch("pna_bwd_count", rc)
    count_launches.add()
    return cnt


def pna_bwd_grad(
    v: torch.Tensor,
    receivers: torch.Tensor,
    mask: Optional[torch.Tensor],
    both: torch.Tensor,
    g_sum: torch.Tensor,
    g_sumsq: torch.Tensor,
    g_both: torch.Tensor,
    cnt: torch.Tensor,
    real_edges: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """B7: ``grad_v`` [E, H] in v's type from B6's counts. CPU tensors
    take the plain version; CUDA tensors launch the kernel, which writes
    zeros past ``real_edges`` without reading them."""
    n = both.shape[0]
    _check(v, receivers, mask, both, n, real_edges)
    h = v.shape[1]
    for name, t, shape, dtype in (("g_sum", g_sum, (n, h), torch.float32),
                                  ("g_sumsq", g_sumsq, (n, h), torch.float32),
                                  ("g_both", g_both, (n, 2 * h), v.dtype),
                                  ("cnt", cnt, (n, 2 * h), torch.float32)):
        if t.shape != shape or t.dtype != dtype:
            raise ValueError(f"pna_bwd_grad: {name} must be {shape} {dtype}, got {tuple(t.shape)} {t.dtype}")
    if v.device.type == "cpu":
        return pna_bwd_grad_plain(v, receivers, mask, both, g_sum, g_sumsq, g_both, cnt, real_edges)
    dev = _cuda_common("pna_bwd_grad", v, receivers, mask, both, g_sum, g_sumsq, g_both, cnt, real_edges)
    e = v.shape[0]
    fn = _kernel("hg_pna_bwd_grad")
    with torch.cuda.device(dev):
        grad = torch.empty_like(v)
        rc = fn(
            v.data_ptr(), FLOAT_CODE[v.dtype], None if mask is None else mask.data_ptr(), receivers.data_ptr(),
            None if real_edges is None else real_edges.data_ptr(), e, n, h, g_sum.data_ptr(), g_sumsq.data_ptr(),
            both.data_ptr(), g_both.data_ptr(), cnt.data_ptr(), grad.data_ptr(), stream_of(dev),
        )
    check_launch("pna_bwd_grad", rc)
    grad_launches.add()
    return grad


def pna_aggregate_bwd(
    v: torch.Tensor,
    receivers: torch.Tensor,
    mask: Optional[torch.Tensor],
    both: torch.Tensor,
    g_sum: torch.Tensor,
    g_sumsq: torch.Tensor,
    g_both: torch.Tensor,
    num_segments: int,
    row_ptr: Optional[torch.Tensor] = None,
    real_edges: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``grad_v``: B6 (walking ``row_ptr``) then B7 on CUDA tensors, both
    bounded by ``real_edges``, the plain backward on CPU tensors (no
    fallback from one to the other)."""
    cnt = pna_bwd_count(v, receivers, mask, both, num_segments, row_ptr, real_edges)
    return pna_bwd_grad(v, receivers, mask, both, g_sum, g_sumsq, g_both, cnt, real_edges)
