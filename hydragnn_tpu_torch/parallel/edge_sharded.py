"""Edge-sharded message passing: one giant graph's edges split over the
ranks of the ``edge`` axis (the port's counterpart of
``hydragnn_tpu/parallel/edge_sharded.py``).

In the JAX package GSPMD partitions the whole model over the edge
shards. The port spells it out: each rank of an edge group keeps a
contiguous, receiver-sorted slice of its sub-batch's edge list and every
node array in full, and each conv layer runs its kernel on the slice,
on the slice's own row pointers (B8 for GIN, SAGE, MFC, SchNet and
CGCNN; B5 for PNA on unaligned batches; B3, the K-group statistics and
B2 for PNA on run-aligned ones). The partial aggregates are then
reduced over the edge group (``models/convs.py``):

  - sums, sums of squares and counts with ``SUM``, through
    ``torch.distributed.nn.functional.all_reduce``, whose backward sums
    the gradients over the group too;
  - the extrema ``[max v, max -v]`` with ``MAX``, in an autograd
    Function whose backward splits the gradient evenly among the tied
    maxima across all shards: each shard counts its ties against the
    group's maximum, the counts are summed over the group, and each tied
    edge takes its share of the summed gradient (:func:`edge_max`,
    :func:`pna_aggregate_edge_sharded`).

Every edge rank computes the same node-side loss, and the backward of
each reduction sums over the group: each rank's gradient is then the
edge width times its slice's part, and averaging the gradients over
every ``data × fsdp × edge`` rank (``parallel/sharded.py``) gives the
gradient of the whole graph. Memory per rank: O(E/D) edge buffers and
O(N) node buffers.

The window plans (``sender_win``, ``dense_sender_win``) index the whole
edge list and are dropped, as the JAX package drops them; PNA's
run-aligned branch then takes its gather of the senders (B3, its
backward the permuted pair B3 and B2) in place of B1 and B4.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from hydragnn_tpu_torch.parallel.mesh import DATA_AXIS

EDGE_FIELDS = ("senders", "receivers", "edge_mask", "edge_attr", "sender_perm")


def _dist():
    import torch.distributed as dist

    return dist


def shard_edges(
    senders: np.ndarray,
    receivers: np.ndarray,
    edge_data: Optional[np.ndarray],
    num_devices: int,
) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray], np.ndarray]:
    """Host-side: pad the edge list to a multiple of ``num_devices`` and
    return (senders, receivers, edge_data, edge_mask); the padding edges
    point at node 0 and are masked."""
    e = senders.shape[0]
    e_pad = ((e + num_devices - 1) // num_devices) * num_devices
    pad = e_pad - e
    mask = np.concatenate([np.ones(e, bool), np.zeros(pad, bool)])
    senders = np.concatenate([senders, np.zeros(pad, senders.dtype)])
    receivers = np.concatenate([receivers, np.zeros(pad, receivers.dtype)])
    if edge_data is not None:
        edge_data = np.concatenate([edge_data, np.zeros((pad,) + edge_data.shape[1:], edge_data.dtype)])
    return senders, receivers, edge_data, mask


def _edge_rank(group) -> Tuple[int, int]:
    dist = _dist()
    return dist.get_world_size(group), dist.get_rank(group)


def edge_sharded_aggregate(
    group,
    message_fn: Callable[..., torch.Tensor],
    nodes: torch.Tensor,
    senders: torch.Tensor,
    receivers: torch.Tensor,
    edge_mask: torch.Tensor,
    edge_data: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Aggregated messages [N, H] of one edge-sharded graph: this rank's
    ``senders``/``receivers``/``edge_mask``/``edge_data`` are its slice
    (``place_edge_shards``), ``nodes`` are whole. ``message_fn(x_i, x_j[,
    edge_data])`` makes the slice's messages; their masked sum into the
    receivers is summed over ``group``."""
    from torch.distributed.nn.functional import all_reduce

    x_i, x_j = nodes[receivers.long()], nodes[senders.long()]
    msg = message_fn(x_i, x_j) if edge_data is None else message_fn(x_i, x_j, edge_data)
    msg = torch.where(edge_mask[:, None], msg, torch.zeros((), dtype=msg.dtype, device=msg.device))
    part = torch.zeros(nodes.shape[0], msg.shape[1], dtype=msg.dtype, device=msg.device)
    part = part.index_add(0, receivers.long(), msg)
    return all_reduce(part, group=group)


def place_edge_shards(group, *arrays):
    """This rank's contiguous slice of each edge array (None passes)."""
    d, r = _edge_rank(group)
    out = []
    for a in arrays:
        if a is None:
            out.append(None)
            continue
        e = a.shape[0]
        if e % d:
            raise ValueError(f"the edge-axis size ({d}) must divide the edge pad ({e})")
        out.append(a[r * (e // d):(r + 1) * (e // d)])
    return tuple(out)


def edge_axis_shardings(batch):
    """Which fields of ``batch`` split over the edge axis: every field
    whose leading axis is the edge axis, by shape (the JAX heuristic:
    node and edge pads may coincide, which only changes where a node
    array would live). Returns ``{field: bool}``."""
    e = batch.senders.shape[0]
    out = {}
    for f in dataclasses.fields(batch):
        v = getattr(batch, f.name)
        out[f.name] = isinstance(v, torch.Tensor) and v.dim() >= 1 and v.shape[0] == e
    return out


def _slice_batch(batch, d: int, r: int, fields):
    """Rank ``r`` of ``d``'s slice of the edge fields named in
    ``fields``; the window plans dropped; the occupancy and the senders'
    sort order made the slice's own."""
    e = batch.senders.shape[0]
    if e % d:
        raise ValueError(
            f"the edge-axis size ({d}) must divide the stacked edge "
            f"pad ({e}); build the loader with edge_multiple={d} "
            "(or a multiple of it)"
        )
    k = batch.run_align
    if k and (e // d) % k:
        # the slices' boundaries on K-groups: the pad rounded up (masked slots)
        from hydragnn_tpu_torch.graph.batch import pad_batch

        batch = pad_batch(batch, batch.num_nodes, ((e + d * k - 1) // (d * k)) * d * k, batch.num_graphs)
        e = batch.senders.shape[0]
    lo, size = r * (e // d), e // d
    upd = {name: getattr(batch, name)[lo:lo + size] for name in fields
           if name != "sender_perm" and getattr(batch, name) is not None}
    senders = upd.get("senders", batch.senders)
    upd["sender_perm"] = torch.argsort(senders, stable=True).to(torch.int32) if batch.sender_perm is not None \
        else None
    if batch.edge_occupancy is not None:
        occ = batch.edge_occupancy.to(torch.int64) - lo
        upd["edge_occupancy"] = torch.clamp(occ, 0, size).to(torch.int32)
    if batch.in_degree is None:
        from hydragnn_tpu_torch.graph import segment as S

        upd["in_degree"] = S.segment_count(batch.receivers, batch.num_nodes, batch.edge_mask)
    return dataclasses.replace(batch, sender_win=None, dense_sender_win=None, **upd)


def place_giant_batch(group, batch):
    """One giant-graph batch on this rank of the edge ``group``: the edge
    pad rounded up to a multiple of the group's width (``pad_batch``),
    the window plans dropped, and this rank's slice of every edge field
    (chosen by shape, ``edge_axis_shardings``)."""
    d, r = _edge_rank(group)
    batch = dataclasses.replace(batch, sender_win=None, dense_sender_win=None)
    e = batch.senders.shape[0]
    mult = d * (batch.run_align or 1)
    if e % mult:
        from hydragnn_tpu_torch.graph.batch import pad_batch

        batch = pad_batch(batch, n_node=batch.nodes.shape[0], n_edge=((e + mult - 1) // mult) * mult,
                          n_graph=batch.graph_mask.shape[0])
    fields = [name for name, on in edge_axis_shardings(batch).items() if on]
    return _slice_batch(batch, d, r, fields)


def place_dp_edge_batch(partitioner, batch, batch_axes=(DATA_AXIS,)):
    """This rank's part of its sub-batch on a mesh with an ``edge`` axis:
    its slice of the edge fields, chosen by field NAME (``EDGE_FIELDS``;
    a node- or graph-axis field whose pad equals the edge pad stays
    whole)."""
    group = partitioner.edge_group
    d, r = _edge_rank(group)
    return _slice_batch(batch, d, r, EDGE_FIELDS)


class _EdgeMax(torch.autograd.Function):
    """The group's maximum of each rank's partial maxima, with the
    backward of the maximum over every shard's values: the summed
    gradient split among the tied values of all shards."""

    @staticmethod
    def forward(ctx, part, data, segment_ids, num_segments, group, sorted_ids, real_rows):
        out = part.clone()
        _dist().all_reduce(out, op=_dist().ReduceOp.MAX, group=group)
        ctx.save_for_backward(data, segment_ids, out)
        ctx.group, ctx.n, ctx.sorted_ids, ctx.real_rows = group, num_segments, sorted_ids, real_rows
        return out

    @staticmethod
    def backward(ctx, g):
        from hydragnn_tpu_torch.graph import segment as S

        data, segment_ids, out = ctx.saved_tensors
        sel = data == S._gather(out, segment_ids)
        ties = sel.to(data.dtype)
        if ctx.sorted_ids:
            cnt = S._sorted_sum(ties, segment_ids, ctx.n, real_rows=ctx.real_rows).float()
        else:
            cnt = S.segment_sum(ties.float(), segment_ids, ctx.n)
        flat = torch.cat([g.float().reshape(-1), cnt.reshape(-1)])
        _dist().all_reduce(flat, group=ctx.group)
        gsum, cnt = flat[:g.numel()].view_as(g), flat[g.numel():].view_as(g)
        share = (gsum / torch.clamp(cnt, min=1.0)).to(data.dtype)
        zero = torch.zeros((), dtype=data.dtype, device=data.device)
        return None, torch.where(sel, S._gather(share, segment_ids), zero), None, None, None, None, None


def edge_max(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int, group,
             indices_are_sorted: bool = False, empty_value: float = 0.0,
             real_rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``graph/segment.py:segment_max`` of an edge-sharded [E, W]
    ``data`` (masked rows already at the type's lowest value): each
    rank's segment maxima, the group's maximum of them, empty segments
    (at or below the lowest value) set to ``empty_value``. The backward
    (``_EdgeMax``) counts the ties with B2 on sorted ids."""
    w = data.shape[1]
    lowest = torch.finfo(data.dtype).min
    init = torch.full((int(num_segments), w), lowest, dtype=data.dtype, device=data.device)
    with torch.no_grad():
        part = init.scatter_reduce(0, segment_ids.long()[:, None].expand(-1, w), data, "amax", include_self=True)
    out = _EdgeMax.apply(part, data, segment_ids, int(num_segments), group, bool(indices_are_sorted), real_rows)
    return torch.where(out <= lowest, torch.full((), empty_value, dtype=data.dtype, device=data.device), out)


class _PnaEdgeSharded(torch.autograd.Function):
    """B5 on this rank's slice, the statistics reduced over the group;
    backward: the summed cotangents, B6's tie counts against the group's
    maxima summed over the group, then B7 on the slice."""

    @staticmethod
    def forward(ctx, v, receivers, num_segments, mask, row_ptr, real_edges, group):
        from hydragnn_tpu_torch.ops.pna_aggregate import _forward

        s, sq, cnt, both, row_ptr = _forward(v, receivers, num_segments, mask, row_ptr, real_edges)
        h = v.shape[1]
        sums = torch.cat([s, sq, cnt[:, None]], dim=1)
        _dist().all_reduce(sums, group=group)
        lowest = torch.finfo(v.dtype).min
        # a row this slice holds no edge of must not win the maximum with its cleaned 0
        part = torch.where(cnt[:, None] > 0, both, torch.full((), lowest, dtype=both.dtype, device=both.device))
        _dist().all_reduce(part, op=_dist().ReduceOp.MAX, group=group)
        both_g = torch.where(part <= lowest, torch.zeros((), dtype=both.dtype, device=both.device), part)
        ctx.save_for_backward(v, receivers, mask, both_g, row_ptr, real_edges)
        ctx.num_segments, ctx.group = num_segments, group
        cnt_g = sums[:, 2 * h].contiguous()
        ctx.mark_non_differentiable(cnt_g)
        return sums[:, :h].contiguous(), sums[:, h:2 * h].contiguous(), cnt_g, both_g

    @staticmethod
    def backward(ctx, g_sum, g_sumsq, g_cnt, g_both):
        from hydragnn_tpu_torch.ops.pna_aggregate_bwd import pna_bwd_count, pna_bwd_grad

        v, receivers, mask, both, row_ptr, real_edges = ctx.saved_tensors
        n, h = ctx.num_segments, v.shape[1]
        cnt = pna_bwd_count(v, receivers, mask, both, n, row_ptr, real_edges)
        flat = torch.cat([g_sum.float(), g_sumsq.float(), g_both.float(), cnt], dim=1)
        _dist().all_reduce(flat, group=ctx.group)
        grad = pna_bwd_grad(
            v, receivers, mask, both, flat[:, :h].contiguous(), flat[:, h:2 * h].contiguous(),
            flat[:, 2 * h:4 * h].to(v.dtype).contiguous(), flat[:, 4 * h:].contiguous(), real_edges,
        )
        return grad, None, None, None, None, None, None


def pna_aggregate_edge_sharded(v, receivers, num_segments, group, mask=None, row_ptr=None, real_edges=None):
    """``ops/pna_aggregate.py:pna_aggregate`` of an edge-sharded ``v``
    (module docstring): ``(sum, sumsq, cnt, both)`` of the whole graph on
    every rank of ``group``; one B5 launch a call, and B6 and B7 once
    each in the backward."""
    from hydragnn_tpu_torch.ops.pna_aggregate import _check
    from hydragnn_tpu_torch.ops.row_pointers import row_pointers

    _check(v, receivers, num_segments, mask, row_ptr, real_edges)
    if row_ptr is None and v.device.type == "cuda":
        row_ptr = row_pointers(receivers, int(num_segments))
    return _PnaEdgeSharded.apply(v, receivers, int(num_segments), mask, row_ptr, real_edges, group)


def _step_with_count(step, with_outputs: bool):
    """The partitioned step's (loss, tasks, outputs, count) as the JAX
    step's (loss, tasks[, outputs])."""

    def run(batch):
        loss, tasks, outputs, _ = step(batch)
        return (loss, tasks, outputs) if with_outputs else (loss, tasks)

    return run


def make_dp_edge_train_step(model, optimizer, partitioner, compute_dtype=None, remat: bool = False,
                            guard_nonfinite: bool = False):
    """Data-parallel × edge-sharded training: the partitioned step of
    ``parallel/sharded.py`` on a model whose aggregations reduce over the
    edge group (set here)."""
    model.set_edge_group(partitioner.edge_group)
    return partitioner.shard_train_step(model, optimizer, compute_dtype=compute_dtype, remat=remat,
                                        guard_nonfinite=guard_nonfinite)


def make_dp_edge_eval_step(model, partitioner, with_outputs: bool = False):
    """Eval companion of :func:`make_dp_edge_train_step`:
    ``step(batch) -> (loss, tasks[, outputs])``, ``outputs`` whole on
    every edge rank."""
    model.set_edge_group(partitioner.edge_group)
    return _step_with_count(partitioner.shard_eval_step(model), with_outputs)


def make_dp_edge_stats_step(model, partitioner):
    """BatchNorm-recalibration companion of :func:`make_dp_edge_train_step`."""
    model.set_edge_group(partitioner.edge_group)
    return partitioner.shard_stats_step(model)


def edge_sharded_gin_layer(group, nodes, senders, receivers, edge_mask, w1, b1, w2, b2, eps: float = 100.0):
    """One GIN conv over an edge-sharded giant graph: the neighbour sum
    edge-parallel (:func:`edge_sharded_aggregate`), the ``(1+eps)x + sum``
    MLP on the whole nodes."""
    agg = edge_sharded_aggregate(group, lambda x_i, x_j: x_j, nodes, senders, receivers, edge_mask)
    h = (1.0 + eps) * nodes + agg
    h = torch.relu(h @ w1 + b1)
    return h @ w2 + b2
