"""Fused gather and K-group statistics (B1): the CUDA kernel
``gather_stats``, its backward kernel ``gather_presum_bwd``, their plain
PyTorch versions, and the differentiable ``gather_presum_stats`` built on
them.

Port of the Pallas ``_gather_stats_kernel`` in
``hydragnn_tpu/ops/segment_pallas.py`` (``gather_presum_stats``). With
``v = table[ids]`` masked by ``mask`` and the E edge slots cut into
E/K groups of K consecutive slots:

  stats [E/K, 2H] f32          [Σ m·v | Σ m·v²] per group
  both  [E/K, 2H] table.dtype  [max where(m, v, lowest) |
                                max where(m, -v, lowest)] per group

``lowest`` is ``finfo(table.dtype).min``. All-masked groups keep it: the
clean to 0 comes only after the E/K segment max (``models/convs.py``).
This is the reference's ``_presum_stats_ref`` composition, which the
run-aligned layout (``graph/batch.py`` ``run_align=K``) makes valid: each
K-group of slots lies within one receiver's run or the batch tail.

The sums add each group's K slots in slot order, in the kernel and in
the plain version alike, so the two are bit-equal in float32.

Layout contract: ``len(ids) % K == 0``. A CPU tensor takes the plain
version; a CUDA tensor launches the kernel (``csrc/gather_stats.cu``) or
raises.

``gather_presum_stats`` is the autograd op. Its backward is the closed
form of the reference's ``_gather_presum_bwd``: form ``grad_v`` [E, H] —
the sum terms are linear plus ``2·v·g`` for the squares, and each
group's max gradient is split evenly among its tied slots, ties taken on
the filled values — then scatter it into the table through the sender
windows (B4), bounded by the optional ``real_edges`` (the batch's edge
occupancy: ``grad_v`` is +0 on every masked slot, and every slot past it
is masked). ``gather_presum_bwd`` forms ``grad_v`` in one kernel that
regathers ``v`` itself; ``gather_presum_bwd_plain`` is the reference's
chain (the regather, then the elementwise block that XLA fuses on the
TPU, one PyTorch op at a time), which the kernel equals bit for bit.
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
from hydragnn_tpu_torch.ops.gather_rows import gather_rows_plain
from hydragnn_tpu_torch.ops.segment_sum_local import segment_sum_local

SOURCE = "hydragnn_tpu_torch/ops/csrc/gather_stats.cu"
REPLACES = "hydragnn_tpu/ops/segment_pallas.py:947"
# the backward's regather and elementwise block (no Pallas kernel there)
BWD_REPLACES = "hydragnn_tpu/ops/segment_pallas.py:1106"

# launches of the forward and of the backward kernel (never the plain path)
launches = LaunchCount()
bwd_launches = LaunchCount()

_lock = threading.Lock()
_fns = {}  # symbol -> bound C entry point; guarded by _lock

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {
    "hg_gather_stats": [_P, _I, _P, _P, _L, _L, _I, _I, _P, _P, _P],
    "hg_gather_stats_bwd": [_P, _I, _P, _P, _P, _P, _P, _L, _L, _I, _I, _P, _P],
}


def _kernel(symbol: str):
    with _lock:
        if symbol not in _fns:
            _fns[symbol] = bind("gather_stats.cu", symbol, _ARGTYPES[symbol])
        return _fns[symbol]


def _group_maxima(v: torch.Tensor, m: torch.Tensor, k: int) -> torch.Tensor:
    """``both`` [E/K, 2H] of ``v`` [E, H] under the mask column ``m``."""
    h = v.shape[1]
    neg = torch.full((), torch.finfo(v.dtype).min, dtype=v.dtype, device=v.device)
    return torch.cat(
        [torch.where(m, v, neg).view(-1, k, h).amax(1), torch.where(m, -v, neg).view(-1, k, h).amax(1)],
        dim=-1,
    )


def presum_stats_plain(v: torch.Tensor, mask: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(stats, both)`` of ``v`` [E, H] per K-group of slots (module
    docstring), in plain PyTorch and differentiable by autograd: the
    reference's ``_presum_stats_ref`` (reshape sums in f32, reshape
    maxima with ``amax``, whose gradient splits evenly among ties, as a
    JAX reduce-max's does). The run-aligned layout's PNA statistics when
    ``v`` is not a pure gather (edge features), which B1 cannot take."""
    h = v.shape[1]
    m = mask[:, None]
    vf = torch.where(m, v, torch.zeros((), dtype=v.dtype, device=v.device)).float()
    stats = torch.cat(
        [vf.view(-1, k, h).sum(1), (vf * vf).view(-1, k, h).sum(1)], dim=-1
    )
    return stats, _group_maxima(v, m, k)


def gather_stats_plain(
    table: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference composition (``_presum_stats_ref`` over
    ``table[ids]``) in plain PyTorch, its sums added in slot order from
    +0 as the kernel adds them (a reshape-sum's order is the host
    library's choice, and at some widths it groups the slots)."""
    v = table.index_select(0, ids.long())
    h = v.shape[1]
    m = mask[:, None]
    vf = torch.where(m, v, torch.zeros((), dtype=v.dtype, device=v.device)).float().view(-1, k, h)
    s = torch.zeros(vf.shape[0], h, dtype=torch.float32, device=v.device)
    sq = torch.zeros_like(s)
    for j in range(k):
        s = s + vf[:, j]
        sq = sq + vf[:, j] * vf[:, j]
    return torch.cat([s, sq], dim=-1), _group_maxima(v, m, k)


def gather_stats(
    table: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(stats, both)`` of ``table[ids]`` per K-group of slots (module
    docstring). Not differentiated itself: see ``gather_presum_stats``."""
    if table.dim() != 2 or ids.dim() != 1 or mask.shape != ids.shape:
        raise ValueError("gather_stats: table [N, H], ids [E] and mask [E]")
    if table.dtype not in FLOAT_CODE:
        raise TypeError(f"gather_stats: table must be float32 or bfloat16, got {table.dtype}")
    if mask.dtype != torch.bool:
        raise TypeError(f"gather_stats: mask must be bool, got {mask.dtype}")
    k = int(k)
    if k < 1 or ids.shape[0] % k:
        raise ValueError(f"gather_stats: len(ids)={ids.shape[0]} is not a multiple of K={k}")
    if table.device.type == "cpu":
        return gather_stats_plain(table, ids, mask, k)
    dev = cuda_args("gather_stats", table, ids, mask)
    if ids.dtype != torch.int32:
        raise TypeError(f"gather_stats: ids must be int32 on CUDA, got {ids.dtype}")
    n, h = table.shape
    groups = ids.shape[0] // k
    stats = torch.empty(groups, 2 * h, dtype=torch.float32, device=dev)
    both = torch.empty(groups, 2 * h, dtype=table.dtype, device=dev)
    fn = _kernel("hg_gather_stats")
    with torch.cuda.device(dev):
        rc = fn(
            table.data_ptr(), FLOAT_CODE[table.dtype], ids.data_ptr(), mask.data_ptr(),
            groups, n, h, k, stats.data_ptr(), both.data_ptr(), stream_of(dev),
        )
    check_launch("gather_stats", rc)
    launches.add(table.dtype)
    return stats, both


def presum_bwd_plain(
    v: torch.Tensor,
    mask: torch.Tensor,
    both: torch.Tensor,
    g_stats: torch.Tensor,
    g_both: torch.Tensor,
    k: int,
) -> torch.Tensor:
    """``grad_v`` [E, H] in ``v``'s type from a materialised ``v`` [E, H]:
    the elementwise block of the reference's ``_gather_presum_bwd``, one
    PyTorch op at a time (module docstring). ``both`` is the forward's,
    ``g_stats`` [E/K, 2H] f32 and ``g_both`` [E/K, 2H] the cotangents."""
    e, h = v.shape
    # [E/K, K, H] views: a group's K slots against its [E/K, 1, H] row
    v = v.view(-1, k, h)
    m = mask.view(-1, k, 1)
    neg = torch.full((), torch.finfo(v.dtype).min, dtype=v.dtype, device=v.device)
    zero = torch.zeros((), dtype=v.dtype, device=v.device)
    # tie masks in the table's dtype (0/1 are exact in bf16); the shares
    # divide in f32 at the E/K level
    tie_x = (torch.where(m, v, neg) == both[:, None, :h]).to(v.dtype)
    tie_n = (torch.where(m, -v, neg) == both[:, None, h:]).to(v.dtype)
    share_x = (g_both[:, :h].float() / torch.clamp(tie_x.sum(1).float(), min=1.0)).to(v.dtype)
    share_n = (g_both[:, h:].float() / torch.clamp(tie_n.sum(1).float(), min=1.0)).to(v.dtype)
    vf = torch.where(m, v, zero).float()
    grad = (
        g_stats[:, None, :h]
        + 2.0 * vf * g_stats[:, None, h:]
        + (tie_x * share_x[:, None]).float()
        - (tie_n * share_n[:, None]).float()
    )
    return torch.where(m, grad, 0.0).to(v.dtype).view(e, h)


def gather_presum_bwd_plain(
    table: torch.Tensor,
    ids: torch.Tensor,
    mask: torch.Tensor,
    both: torch.Tensor,
    g_stats: torch.Tensor,
    g_both: torch.Tensor,
    k: int,
) -> torch.Tensor:
    """``grad_v`` [E, H] in the table's type: the reference's
    ``_gather_presum_bwd`` before its scatter — the regather of ``v``,
    then ``presum_bwd_plain``."""
    return presum_bwd_plain(gather_rows_plain(table, ids), mask, both, g_stats, g_both, k)


def gather_presum_bwd(
    table: torch.Tensor,
    ids: torch.Tensor,
    mask: torch.Tensor,
    both: torch.Tensor,
    g_stats: torch.Tensor,
    g_both: torch.Tensor,
    k: int,
) -> torch.Tensor:
    """``gather_presum_bwd_plain``'s ``grad_v`` in one kernel on a CUDA
    tensor (the plain version on a CPU tensor). A slot whose id is out of
    range counts as masked: it gets +0."""
    if table.device.type == "cpu":
        return gather_presum_bwd_plain(table, ids, mask, both, g_stats, g_both, k)
    dev = cuda_args("gather_presum_bwd", table, ids, mask, both, g_stats, g_both)
    if ids.dtype != torch.int32 or mask.dtype != torch.bool:
        raise TypeError("gather_presum_bwd: ids int32 and mask bool on CUDA")
    if table.dtype not in FLOAT_CODE:
        raise TypeError(f"gather_presum_bwd: table must be float32 or bfloat16, got {table.dtype}")
    n, h = table.shape
    k = int(k)
    groups = ids.shape[0] // k if k >= 1 else 0
    if k < 1 or ids.shape[0] % k or mask.shape != ids.shape:
        raise ValueError(f"gather_presum_bwd: ids and mask [E], E={ids.shape[0]} a multiple of K={k}")
    for name, t, dtype in (("both", both, table.dtype), ("g_stats", g_stats, torch.float32),
                           ("g_both", g_both, table.dtype)):
        if t.shape != (groups, 2 * h) or t.dtype != dtype:
            raise ValueError(f"gather_presum_bwd: {name} must be [{groups}, {2 * h}] {dtype}, "
                             f"got {tuple(t.shape)} {t.dtype}")
    grad_v = torch.empty(ids.shape[0], h, dtype=table.dtype, device=dev)
    fn = _kernel("hg_gather_stats_bwd")
    with torch.cuda.device(dev):
        rc = fn(
            table.data_ptr(), FLOAT_CODE[table.dtype], ids.data_ptr(), mask.data_ptr(),
            both.data_ptr(), g_stats.data_ptr(), g_both.data_ptr(), groups, n, h, k,
            grad_v.data_ptr(), stream_of(dev),
        )
    check_launch("gather_presum_bwd", rc)
    bwd_launches.add(table.dtype)
    return grad_v


class _GatherPresumStats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids, mask, win, num_rows, k, real_edges):
        stats, both = gather_stats(table, ids, mask, k)
        ctx.save_for_backward(table, ids, mask, win, both)
        ctx.num_rows, ctx.k, ctx.real_edges = num_rows, k, real_edges
        return stats, both

    @staticmethod
    def backward(ctx, g_stats, g_both):
        table, ids, mask, win, both = ctx.saved_tensors
        grad_v = gather_presum_bwd(table, ids, mask, both, g_stats.contiguous(), g_both.contiguous(), ctx.k)
        grad_table = segment_sum_local(grad_v, ids, win, ctx.num_rows, real_edges=ctx.real_edges).to(table.dtype)
        return grad_table, None, None, None, None, None, None


def gather_presum_stats(
    table: torch.Tensor,
    ids: torch.Tensor,
    mask: torch.Tensor,
    win: torch.Tensor,
    num_rows: int,
    k: int,
    real_edges: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable ``(stats, both)`` of ``table[ids]`` (module
    docstring); ``win`` is the ids' window plan and ``real_edges`` its
    bound, used by the backward's scatter into ``table`` ([num_rows,
    H])."""
    return _GatherPresumStats.apply(table, ids, mask, win, int(num_rows), int(k), real_edges)
