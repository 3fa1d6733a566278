"""Masked segment reductions, with the JAX package's gradients.

The port's counterpart of ``hydragnn_tpu/graph/segment.py``. Every op
is mask-aware (padding entries contribute the reduction identity) and
safe on empty segments (mean, max and min return 0 there).

The plain ops (sum, count, mean, std, softmax) were XLA ops in the JAX
package and are plain torch here, differentiated by torch; sum (and so
softmax's denominator) is ``index_add_``, which assumes no sorted
order. The ops that reach a Pallas kernel there are
``torch.autograd.Function``s here, with the same backward as the
reference's ``custom_vjp``:

  - ``segment_max`` / ``segment_min``: XLA's scatter-max forward
    (``scatter_reduce``), and a backward that splits each segment's
    gradient evenly among its tied extrema. The tie count is a sorted
    segment sum (B2, f32 accumulation) of the 0/1 tie mask in the data's
    dtype; the share is cast to the data's dtype before the widening
    gather (B3).
  - ``segment_sum_sorted``: forward B2, backward the sorted gather B3 of
    the cotangent in ``grad_dtype``.
  - ``gather_rows``: forward B3, backward B2 for sorted ids.
  - ``gather_rows_permuted``: forward B3, backward B2 over the ids sorted
    by a given permutation (the cotangent permuted by B3), optionally
    over the unmasked positions only.
  - ``gather_rows_local``: forward B3, backward the windowed sum B4.

The B2 and B4 calls take an optional bound (``real_rows`` /
``real_edges``, an int32 scalar tensor on the data's device, read by the
kernel on the device): the rows of the summed data at or past it belong
to no segment. It is valid only where every such row adds nothing that
is read: zero, or summed into a segment whose result is not used. The
chassis passes the batch's edge occupancy (``models/convs.py``): past it
lies the batch's masked tail, one run at the padding node, whose
cotangent the masked consumers make exactly zero; in the sorted segment
max's tie count the tail's all-masked groups do tie the padding node's
fill value, but that node's cotangent is exactly zero, so its count
(which falls to 0 with the bound, and is clamped to 1) changes nothing.

On CPU tensors the kernels' plain versions run (``ops/``).
"""

from __future__ import annotations

from typing import Optional

import torch

from hydragnn_tpu_torch.ops.gather_rows import gather_rows as _gather
from hydragnn_tpu_torch.ops.segment_sum import segment_sum as _sorted_sum
from hydragnn_tpu_torch.ops.segment_sum_local import segment_sum_local as _local_sum


def _expand_mask(mask: Optional[torch.Tensor], data: torch.Tensor) -> Optional[torch.Tensor]:
    if mask is None:
        return None
    while mask.dim() < data.dim():
        mask = mask.unsqueeze(-1)
    return mask


def segment_sum(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    m = _expand_mask(mask, data)
    if m is not None:
        data = torch.where(m, data, torch.zeros((), dtype=data.dtype, device=data.device))
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]), dtype=data.dtype, device=data.device)
    return out.index_add_(0, segment_ids.long(), data)


def segment_count(
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    ones = torch.ones(segment_ids.shape[0], dtype=torch.float32, device=segment_ids.device)
    return segment_sum(ones, segment_ids, num_segments, mask)


def segment_mean(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    total = segment_sum(data, segment_ids, num_segments, mask)
    count = segment_count(segment_ids, num_segments, mask)
    count = _expand_mask(count, total)
    return total / torch.clamp(count, min=1.0)


def segment_std(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
    eps: float = 1e-5,
) -> torch.Tensor:
    """Biased per-segment standard deviation, PyG's PNA ``std``:
    ``sqrt(relu(mean(x^2) - mean(x)^2) + eps)``."""
    mean = segment_mean(data, segment_ids, num_segments, mask)
    mean_sq = segment_mean(data * data, segment_ids, num_segments, mask)
    return torch.sqrt(torch.relu(mean_sq - mean * mean) + eps)


def segment_softmax(
    logits: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Softmax of ``logits`` [E, ...] within each segment (GAT's
    attention), shifted by the segment max taken without a gradient (the
    shift cancels in the softmax); an empty segment's max is 0. Masked
    entries get exactly 0, and the denominator is at least 1e-16. The ids
    need not be sorted: the max is a scatter and the sum ``index_add_``."""
    m = _expand_mask(mask, logits)
    neg = torch.finfo(logits.dtype).min
    if m is not None:
        logits = torch.where(m, logits, torch.full((), neg, dtype=logits.dtype, device=logits.device))
    ids = segment_ids.long()
    with torch.no_grad():
        idx = ids.view((-1,) + (1,) * (logits.dim() - 1)).expand_as(logits)
        seg_max = torch.full((num_segments,) + tuple(logits.shape[1:]), float("-inf"), dtype=logits.dtype,
                             device=logits.device).scatter_reduce(0, idx, logits, "amax", include_self=True)
        seg_max = torch.where(seg_max <= neg, torch.zeros((), dtype=logits.dtype, device=logits.device), seg_max)
    e = torch.exp(logits - seg_max.index_select(0, ids))
    if m is not None:
        e = torch.where(m, e, torch.zeros((), dtype=e.dtype, device=e.device))
    denom = segment_sum(e, segment_ids, num_segments)
    return e / torch.clamp(denom.index_select(0, ids), min=1e-16)


class _SegmentExtremum(torch.autograd.Function):
    """Raw segment max (min) over ``[E, W]`` data: -inf (+inf) on empty
    segments; the backward of the reference's ``_segment_extremum``."""

    @staticmethod
    def forward(ctx, data, segment_ids, num_segments, indices_are_sorted, is_max, real_rows):
        w = data.shape[1]
        idx = segment_ids.long()[:, None].expand(-1, w)
        init = torch.full(
            (num_segments, w), float("-inf") if is_max else float("inf"),
            dtype=data.dtype, device=data.device,
        )
        out = init.scatter_reduce(0, idx, data, "amax" if is_max else "amin", include_self=True)
        ctx.save_for_backward(data, segment_ids, out)
        ctx.num_segments, ctx.sorted, ctx.real_rows = num_segments, indices_are_sorted, real_rows
        return out

    @staticmethod
    def backward(ctx, g):
        data, segment_ids, out = ctx.saved_tensors
        sel = data == _gather(out, segment_ids)
        # the 0/1 tie mask travels in the data's dtype; the count
        # accumulates in f32 (B2) and the share math stays f32
        ties = sel.to(data.dtype)
        if ctx.sorted:
            cnt = _sorted_sum(ties, segment_ids, ctx.num_segments, real_rows=ctx.real_rows)
        else:  # the reference's unsorted path is XLA's scatter-add
            cnt = segment_sum(ties.float(), segment_ids, ctx.num_segments)
        share = (g.float() / torch.clamp(cnt, min=1.0)).to(data.dtype)
        zero = torch.zeros((), dtype=data.dtype, device=data.device)
        return torch.where(sel, _gather(share, segment_ids), zero), None, None, None, None, None


def _segment_extremum(data, segment_ids, num_segments, mask, indices_are_sorted, empty_value, is_max, real_rows):
    if data.dim() != 2:
        raise ValueError(f"segment_max/min: data must be [E, W], got {tuple(data.shape)}")
    finfo = torch.finfo(data.dtype)
    fill = finfo.min if is_max else finfo.max
    m = _expand_mask(mask, data)
    if m is not None:
        data = torch.where(m, data, torch.full((), fill, dtype=data.dtype, device=data.device))
    out = _SegmentExtremum.apply(data, segment_ids, int(num_segments), bool(indices_are_sorted), is_max, real_rows)
    empty = out <= fill if is_max else out >= fill
    return torch.where(empty, torch.full((), empty_value, dtype=data.dtype, device=data.device), out)


def segment_max(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
    indices_are_sorted: bool = False,
    empty_value: float = 0.0,
    real_rows: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Masked segment max of [E, W] data; empty segments give
    ``empty_value``. With ``indices_are_sorted`` the backward's tie count
    runs on the sorted kernel (B2), bounded by ``real_rows`` (module
    docstring; the unsorted count ignores it)."""
    return _segment_extremum(data, segment_ids, num_segments, mask, indices_are_sorted, empty_value, True,
                             real_rows)


def segment_min(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
    indices_are_sorted: bool = False,
    empty_value: float = 0.0,
) -> torch.Tensor:
    return _segment_extremum(data, segment_ids, num_segments, mask, indices_are_sorted, empty_value, False, None)


class _SegmentSumSorted(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, segment_ids, num_segments, grad_dtype, real_rows):
        ctx.save_for_backward(segment_ids)
        ctx.grad_dtype = grad_dtype
        return _sorted_sum(data, segment_ids, num_segments, real_rows=real_rows).to(data.dtype)

    @staticmethod
    def backward(ctx, g):
        (segment_ids,) = ctx.saved_tensors
        gd = g if ctx.grad_dtype is None else g.to(ctx.grad_dtype)
        return _gather(gd.contiguous(), segment_ids).to(g.dtype), None, None, None, None


def segment_sum_sorted(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    grad_dtype: Optional[torch.dtype] = None,
    real_rows: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Differentiable sum of [E, W] data over SORTED ids, accumulated in
    f32 (B2, bounded by ``real_rows``: module docstring) and returned in
    the data's dtype. The backward gathers the cotangent (B3) in
    ``grad_dtype`` (None keeps its dtype)."""
    return _SegmentSumSorted.apply(data, segment_ids, int(num_segments), grad_dtype, real_rows)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ids, num_rows, indices_are_sorted, real_rows):
        ctx.save_for_backward(ids)
        ctx.num_rows, ctx.sorted, ctx.real_rows = num_rows, indices_are_sorted, real_rows
        return _gather(x, ids)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        g = g.contiguous()
        if ctx.sorted:
            grad = _sorted_sum(g, ids, ctx.num_rows, real_rows=ctx.real_rows)
        else:  # the reference's unsorted path is XLA's scatter-add
            grad = segment_sum(g.float(), ids, ctx.num_rows)
        return grad.to(g.dtype), None, None, None, None


def gather_rows(
    x: torch.Tensor,
    ids: torch.Tensor,
    num_rows: int,
    indices_are_sorted: bool = False,
    real_rows: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``x[ids]`` (B3) whose backward is a segment sum: the sorted kernel
    (B2, bounded by ``real_rows``: module docstring) when
    ``indices_are_sorted``."""
    return _GatherRows.apply(x, ids, int(num_rows), bool(indices_are_sorted), real_rows)


class _GatherRowsPermuted(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ids, perm, num_rows, mask, real_rows):
        ctx.save_for_backward(ids, perm, mask)
        ctx.num_rows, ctx.real_rows = num_rows, real_rows
        return _gather(x, ids)

    @staticmethod
    def backward(ctx, g):
        ids, perm, mask = ctx.saved_tensors
        # ids[perm] == sort(ids) by the perm contract
        sorted_ids = ids.index_select(0, perm)
        if mask is not None:
            # the masked positions sort last and carry a zero cotangent:
            # the id num_rows puts them in no segment, so the sorted sum
            # skips them instead of walking them
            sorted_ids = torch.where(mask.index_select(0, perm), sorted_ids, ctx.num_rows)
        grad = _sorted_sum(_gather(g.contiguous(), perm), sorted_ids, ctx.num_rows, real_rows=ctx.real_rows)
        return grad.to(g.dtype), None, None, None, None, None


def gather_rows_permuted(
    x: torch.Tensor,
    ids: torch.Tensor,
    perm: torch.Tensor,
    num_rows: int,
    mask: Optional[torch.Tensor] = None,
    real_rows: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``x[ids]`` (B3) for unsorted ids, whose backward permutes the
    cotangent into sorted order (B3) and sums it over the sorted ids
    (B2); ``perm`` sorts ``ids`` ascending (the batch's stable argsort,
    computed once per batch); only the backward reads it.

    ``mask`` (bool, like ``ids``) names the positions whose cotangent
    may be non-zero; the others must carry a zero cotangent and sort
    after every unmasked position, as the dense slot map's empty slots
    do (they all name the padding node, above every real sender). The
    backward then sums the unmasked positions only: the empty slots
    would otherwise form one segment walked by one thread.

    ``real_rows`` bounds the backward's sorted sum in the permuted
    (sorted) order (module docstring): on the CSR layouts the batch's
    edge occupancy, since exactly the slots past it name the padding
    node, which sorts after every real sender."""
    if perm is None and torch.is_grad_enabled() and x.requires_grad:
        raise ValueError("gather_rows_permuted: the backward needs the ids' sort permutation")
    return _GatherRowsPermuted.apply(x, ids, perm, int(num_rows), mask, real_rows)


class _GatherRowsLocal(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ids, win, num_rows, real_edges):
        ctx.save_for_backward(ids, win)
        ctx.num_rows, ctx.real_edges = num_rows, real_edges
        return _gather(x, ids)

    @staticmethod
    def backward(ctx, g):
        ids, win = ctx.saved_tensors
        grad = _local_sum(g.contiguous(), ids, win, ctx.num_rows, real_edges=ctx.real_edges)
        return grad.to(g.dtype), None, None, None, None


def gather_rows_local(
    x: torch.Tensor,
    ids: torch.Tensor,
    win: torch.Tensor,
    num_rows: int,
    real_edges: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``x[ids]`` for unsorted-but-local ids (B3), whose backward scatters
    through the window plan ``win`` (B4, bounded by ``real_edges``:
    module docstring) with no permute."""
    return _GatherRowsLocal.apply(x, ids, win, int(num_rows), real_edges)
