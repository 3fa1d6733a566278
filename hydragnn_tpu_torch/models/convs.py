"""Message-passing conv layers over masked segment ops.

The port's counterpart of ``hydragnn_tpu/models/convs.py``. Message
direction matches PyG: sender j -> receiver i, aggregation grouped by
receiver. The port has:

  - ``PNAConv``, with or without edge features, on the three batch
    layouts of the loader: the dense slot map, the run-aligned CSR
    layout and the unaligned CSR layout.
  - ``GINConv``, ``SAGEConv``, ``MFConv``, ``CFConv`` (SchNet) and
    ``CGConv`` (CGCNN, in the reference's fused form), whose gather ->
    edge network -> masked scatter runs through ``ops.fused_conv`` (B8),
    with the JAX package's parameters and initializers. With
    ``Architecture.fused_conv: false`` they take the composed path
    instead (the sender gather, then the masked sorted segment sum), and
    ``Architecture.conv_bf16`` streams their operands in bfloat16 on
    either path.
  - ``GATv2Conv`` (GAT), over ``segment_softmax``.
  - the ``EdgeContext`` the chassis hands every layer.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from hydragnn_tpu_torch.graph import segment as S
from hydragnn_tpu_torch.models.layers import dense, lecun_normal_, uniform_
from hydragnn_tpu_torch.ops.fused_conv import ACTS, fused_aggregate
from hydragnn_tpu_torch.ops.gather_stats import gather_presum_stats, presum_stats_plain
from hydragnn_tpu_torch.ops.pna_aggregate import pna_aggregate
from hydragnn_tpu_torch.ops.row_pointers import row_pointers

@dataclasses.dataclass(frozen=True)
class EdgeContext:
    """Edge structure handed to every conv layer by the chassis."""

    senders: torch.Tensor  # [E] int32
    receivers: torch.Tensor  # [E] int32, sorted ascending (CSR contract)
    edge_mask: torch.Tensor  # [E] bool
    node_mask: torch.Tensor  # [N] bool
    in_degree: torch.Tensor  # [N] f32 count of REAL incoming edges
    edge_attr: Optional[torch.Tensor] = None  # [E, De]
    edge_weight: Optional[torch.Tensor] = None  # [E] distances (SchNet)
    # stable argsort of the senders (the permuted gather's backward)
    sender_perm: Optional[torch.Tensor] = None  # [E] int32
    # the senders' per-node-block edge windows (graph/batch.py)
    sender_win: Optional[torch.Tensor] = None  # [2, n_blocks] int32
    # index after the last slot that can hold a real edge: the bound of
    # every edge walk and sum (B2, B4, B5-B9); None walks every slot
    edge_occ: Optional[torch.Tensor] = None  # [] int32
    # K > 0: every K-group of edge slots has one receiver (or is batch
    # tail), and masked slots may be self-loops at real nodes
    run_align: int = 0
    # the batch's dense slot map, when it carries one (graph/batch.py)
    dense_senders: Optional[torch.Tensor] = None  # [N, D] int32
    dense_mask: Optional[torch.Tensor] = None  # [N, D] bool
    dense_edge_attr: Optional[torch.Tensor] = None  # [N·D, De]
    dense_sender_perm: Optional[torch.Tensor] = None  # [N·D] int32
    # MFC's nodes grouped by clamped degree, once per forward
    # (MFConv.degree_groups)
    degree_groups: Optional[Tuple[torch.Tensor, Tuple[int, ...]]] = None
    # Architecture.fused_conv: the fused kernel (B8) for the gather ->
    # edge network -> scatter chain, else the composed path
    fused_conv: bool = True
    # Architecture.conv_bf16: the conv stacks' streamed operands in
    # bfloat16 (sums in f32), the result cast back to the incoming dtype
    conv_bf16: bool = False
    # edge sharding (parallel/edge_sharded.py): the edges are this rank's
    # slice and every aggregation is reduced over this group
    edge_group: Optional[object] = None

    @functools.cached_property
    def row_ptr(self) -> torch.Tensor:
        """The receivers' CSR row pointers (ops/row_pointers.py), [N + 1]
        int32: built at the first read and shared by every later one, so
        a forward makes them once, and only when a layer's kernel walks
        them (B5, B8)."""
        return row_pointers(self.receivers, self.node_mask.shape[0])

    @functools.cached_property
    def group_occ(self) -> Optional[torch.Tensor]:
        """The K-group rows that can hold a real edge on run-aligned
        batches, ceil(edge_occ / K) as an int32 scalar on the device (no
        host read): the bound of the sums over the K-group rows. Built at
        the first read, once per forward."""
        if self.edge_occ is None or not self.run_align:
            return None
        k = self.run_align
        return torch.div(self.edge_occ + (k - 1), k, rounding_mode="floor")


def _edge_sum(t: torch.Tensor, ctx: EdgeContext) -> torch.Tensor:
    """On an edge-sharded batch, the sum of every rank's partial
    aggregate (the autograd all-reduce: its backward sums the gradients
    over the group); else ``t``."""
    if ctx.edge_group is None:
        return t
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(t, group=ctx.edge_group)


def _gather_senders(x: torch.Tensor, ctx: EdgeContext) -> torch.Tensor:
    """``x[senders]`` on the composed path (B3). Its backward is the
    permuted pair (B3, then B2) when the batch carries the senders' sort
    permutation, the pair PNAConv takes (faster than the JAX package's
    windowed pair on the H100, PERF.md); an unsorted scatter-add without
    one (in-forward radius graphs). The pair's sum stops at the batch's
    occupancy: every caller masks the gathered values, so the slots past
    it carry a zero cotangent."""
    if ctx.sender_perm is not None:
        return S.gather_rows_permuted(x, ctx.senders, ctx.sender_perm, x.shape[0], real_rows=ctx.edge_occ)
    return S.gather_rows(x, ctx.senders, x.shape[0])


def _segment_sum_edges(vals: torch.Tensor, ctx: EdgeContext, n: int) -> torch.Tensor:
    """The masked sum of per-edge values into their receivers, in the
    values' dtype: on run-aligned batches each K-group pre-reduced in f32
    first, then the sorted segment sum (B2 forward, f32; B3 backward),
    which stops at the batch's occupancy: the masked values past it are
    zero."""
    vm = torch.where(ctx.edge_mask[:, None], vals, torch.zeros((), dtype=vals.dtype, device=vals.device))
    if ctx.run_align:
        k = ctx.run_align
        v8 = vm.float().view(-1, k, vals.shape[1]).sum(1)
        return _edge_sum(S.segment_sum_sorted(v8, ctx.receivers[::k].contiguous(), n, grad_dtype=vals.dtype,
                                              real_rows=ctx.group_occ), ctx).to(vals.dtype)
    return _edge_sum(S.segment_sum_sorted(vm, ctx.receivers, n, real_rows=ctx.edge_occ), ctx)


def _gather_scatter(
    x: torch.Tensor, ctx: EdgeContext, n: int, scale: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """``Σ_e mask_e · x[send_e] (· scale_e)`` grouped by receiver, in x's
    dtype: the fused kernel (B8), or the composed gather and masked
    sorted segment sum (``ctx.fused_conv`` false). ``ctx.conv_bf16``
    rounds x and the scale to bfloat16 on both paths."""
    xd = x.dtype
    if ctx.conv_bf16:
        x = x.to(torch.bfloat16)
        scale = None if scale is None else scale.to(torch.bfloat16)
    if ctx.fused_conv:
        return _edge_sum(fused_aggregate(
            x, ctx.senders, ctx.receivers, ctx.edge_mask, n,
            scale=scale, win=ctx.sender_win, real_edges=ctx.edge_occ, row_ptr=ctx.row_ptr,
            perm=ctx.sender_perm if ctx.edge_group is not None else None,
        ), ctx).to(xd)
    vals = _gather_senders(x, ctx)
    if scale is not None:
        vals = vals * scale
    return _segment_sum_edges(vals, ctx, n).to(xd)


class PNAConv(nn.Module):
    """Principal Neighbourhood Aggregation conv (aggregators mean, min,
    max, std; scalers identity, amplification, attenuation, linear;
    pre/post_layers=1), in the JAX package's message-free form: with one
    pre-layer the message decomposes as ``a[recv] + bsend[send] + c_e``
    (``c_e`` the edge term), so the aggregators need only segment
    statistics of ``v = bsend[senders] + c`` (mean and the extrema shift
    by ``a``; std is shift-invariant). The statistics come from one of
    three branches, picked by the batch's layout. Where a branch gathers
    ``v`` itself, the gather's backward is the permuted pair (B3, then
    B3 and B2) on every layout, over the real slots only on the dense
    map: the JAX package's windowed pair (B4) is slower on the H100 at
    the flagship's sizes, and on the dense map both pairs would walk the
    padding node's empty slots in one thread (PERF.md, gather pairs).

      - the dense slot map (``ctx.dense_senders``; with edge features
        only when the batch carries ``dense_edge_attr``): ``v`` gathered
        into [N, D] slots, then sum, sum of squares, max and min over
        the slots in plain PyTorch (the JAX package's XLA reductions),
        empty rows cleaned from the fill value.
      - run-aligned batches (``ctx.run_align = K``): without edge
        features ``gather_presum_stats`` (B1) gathers ``v`` and
        pre-reduces each K-group of slots without writing ``v`` to
        memory; with them ``v`` is gathered and the K-groups reduced in
        plain PyTorch (``presum_stats_plain``). Then a sorted segment sum
        (B2) and a segment max over the E/K groups.
      - unaligned batches: ``ops.pna_aggregate`` (B5 forward, B6 and B7
        backward), bounded by the batch's edge occupancy.

    ``pre_kernel`` stays one [2·fin, fin] parameter ([3·fin, fin] with
    edge features) in flax's layout (receiver part, sender part, edge
    part), so ``convert.py`` copies it as it is; ``edge_proj`` is the
    edge projection ``Dense(fin)`` of the edge features; ``post`` is the
    post-layer over ``[x, scaled]``."""

    def __init__(
        self,
        in_dim: int,
        out_dim: int,
        avg_deg_lin: float,
        avg_deg_log: float,
        generator: Optional[torch.Generator] = None,
        edge_dim: int = 0,
    ):
        super().__init__()
        self.in_dim = in_dim
        self.edge_dim = int(edge_dim or 0)
        self.avg_deg_lin = float(avg_deg_lin)
        self.avg_deg_log = float(avg_deg_log)
        zdim = (3 if self.edge_dim else 2) * in_dim
        self.pre_kernel = nn.Parameter(torch.empty(zdim, in_dim))
        lecun_normal_(self.pre_kernel, zdim, generator)
        self.pre_bias = nn.Parameter(torch.zeros(in_dim))
        # flax creates the edge projection before the post-layer
        self.edge_proj = dense(self.edge_dim, in_dim, generator) if self.edge_dim else None
        self.post = dense(17 * in_dim, out_dim, generator)

    def _edge_term(self, edge_attr: Optional[torch.Tensor], w: torch.Tensor, fin: int) -> torch.Tensor:
        if edge_attr is None:
            raise ValueError("PNAConv with edge features needs the batch's edge_attr")
        return self.edge_proj(edge_attr.to(w.dtype)) @ w[2 * fin :]

    def forward(self, x: torch.Tensor, ctx: EdgeContext) -> torch.Tensor:
        n, fin = x.shape
        use_edge = bool(self.edge_dim)
        w = self.pre_kernel.to(x.dtype)
        a = x @ w[:fin] + self.pre_bias.to(x.dtype)  # receiver part [N, fin]
        bsend = x @ w[fin : 2 * fin]  # sender part [N, fin]
        v = bsend  # dtype source for the shared tail
        cnt = ctx.in_degree
        if ctx.dense_senders is not None and (not use_edge or ctx.dense_edge_attr is not None):
            nslots = ctx.dense_senders.shape[1]
            flat = ctx.dense_senders.reshape(-1)
            # the empty slots (all naming the padding node) take no part
            # in the gather's backward sum
            v = S.gather_rows_permuted(bsend, flat, ctx.dense_sender_perm, n, mask=ctx.dense_mask.reshape(-1))
            if use_edge:
                v = v + self._edge_term(ctx.dense_edge_attr, w, fin)
            v3 = v.view(n, nslots, fin)
            m3 = ctx.dense_mask[:, :, None]
            # sums in f32; maxima with amax/amin, whose gradients split
            # evenly among ties as JAX's reduce-max does
            vf = torch.where(m3, v3, torch.zeros((), dtype=v.dtype, device=v.device)).float()
            vsum = vf.sum(1)
            vsumsq = (vf * vf).sum(1)
            neg = torch.finfo(v.dtype).min
            vmax = torch.where(m3, v3, torch.full((), neg, dtype=v.dtype, device=v.device)).amax(1)
            vmin = torch.where(m3, v3, torch.full((), -neg, dtype=v.dtype, device=v.device)).amin(1)
            # empty rows cleaned from the fill value itself: in_degree
            # counts the padding node's masked edges
            zero = torch.zeros((), dtype=v.dtype, device=v.device)
            max_v = torch.where(vmax <= neg, zero, vmax)
            min_v = torch.where(vmin >= -neg, zero, vmin)
        else:
            if ctx.run_align and not use_edge and ctx.sender_win is not None:
                k = ctx.run_align
                stats8, both8 = gather_presum_stats(
                    bsend, ctx.senders, ctx.edge_mask, ctx.sender_win, n, k, real_edges=ctx.edge_occ
                )
            else:
                v = S.gather_rows_permuted(bsend, ctx.senders, ctx.sender_perm, n, real_rows=ctx.edge_occ)
                if use_edge:
                    v = v + self._edge_term(ctx.edge_attr, w, fin)
                if ctx.run_align:
                    stats8, both8 = presum_stats_plain(v, ctx.edge_mask, ctx.run_align)
            if ctx.run_align:
                recv8 = ctx.receivers[:: ctx.run_align].contiguous()
                # both sums stop at the K-groups that can hold a real
                # edge: past them the statistics are 0, and the tail's
                # all-masked groups tie only the padding node's maximum,
                # whose cotangent is 0
                pair = _edge_sum(S.segment_sum_sorted(stats8, recv8, n, grad_dtype=v.dtype, real_rows=ctx.group_occ),
                                 ctx)
                vsum, vsumsq = pair[:, :fin], pair[:, fin : 2 * fin]
                # all-masked groups carry the type's lowest value: the max
                # cleans rows at or below it to 0
                if ctx.edge_group is None:
                    both = S.segment_max(both8, recv8, n, indices_are_sorted=True, empty_value=0.0,
                                         real_rows=ctx.group_occ)
                else:
                    from hydragnn_tpu_torch.parallel.edge_sharded import edge_max

                    both = edge_max(both8, recv8, n, ctx.edge_group, indices_are_sorted=True, empty_value=0.0,
                                    real_rows=ctx.group_occ)
            elif ctx.edge_group is None:
                vsum, vsumsq, _, both = pna_aggregate(v, ctx.receivers, n, mask=ctx.edge_mask, row_ptr=ctx.row_ptr,
                                                      real_edges=ctx.edge_occ)
            else:
                from hydragnn_tpu_torch.parallel.edge_sharded import pna_aggregate_edge_sharded

                vsum, vsumsq, _, both = pna_aggregate_edge_sharded(
                    v, ctx.receivers, n, ctx.edge_group, mask=ctx.edge_mask, row_ptr=ctx.row_ptr,
                    real_edges=ctx.edge_occ)
            max_v = both[:, :fin]
            min_v = -both[:, fin:]

        # mean/var formed in f32, cast back only after the cancellation
        safe_cnt = torch.clamp(cnt, min=1.0)[:, None]
        has = (cnt > 0.0)[:, None]
        mean_v = vsum / safe_cnt
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        mean = torch.where(has, a.float() + mean_v, zero)
        var = torch.relu(vsumsq / safe_cnt - mean_v * mean_v)
        std = torch.sqrt(var + 1e-5)
        has_c = has.to(v.dtype)
        agg = torch.cat(
            [mean.to(v.dtype), (a + min_v) * has_c, (a + max_v) * has_c, std.to(v.dtype)],
            dim=-1,
        )  # [N, 4*fin]

        # padding rows scale by exactly 1
        one = torch.ones((), dtype=cnt.dtype, device=x.device)
        deg = torch.where(ctx.node_mask, torch.clamp(cnt, min=1.0), one).to(v.dtype)
        log_deg = torch.log(deg + 1.0)[:, None]
        amplification = log_deg / self.avg_deg_log
        attenuation = self.avg_deg_log / log_deg
        linear = deg[:, None] / self.avg_deg_lin
        scaled = torch.cat(
            [agg, agg * amplification, agg * attenuation, agg * linear], dim=-1
        )  # [N, 16*fin]
        return self.post(torch.cat([x, scaled], dim=-1))


class GINConv(nn.Module):
    """GIN with a 2-layer MLP and a trainable ``eps`` (an f32 scalar,
    initialized to 100.0): ``mlp((1 + eps)·x + Σ_j x_j)``."""

    def __init__(self, in_dim: int, out_dim: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.eps = nn.Parameter(torch.tensor(100.0))
        self.dense_0 = dense(in_dim, out_dim, generator)
        self.dense_1 = dense(out_dim, out_dim, generator)

    def forward(self, x: torch.Tensor, ctx: EdgeContext) -> torch.Tensor:
        agg = _gather_scatter(x, ctx, x.shape[0])
        h = (1.0 + self.eps) * x + agg
        return self.dense_1(torch.relu(self.dense_0(h)))


class SAGEConv(nn.Module):
    """GraphSAGE, mean aggregation: ``W_l·mean_j x_j + b + W_r·x_i``
    (``dense_1`` has no bias)."""

    def __init__(self, in_dim: int, out_dim: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dense_0 = dense(in_dim, out_dim, generator)
        self.dense_1 = dense(in_dim, out_dim, generator, bias=False)

    def forward(self, x: torch.Tensor, ctx: EdgeContext) -> torch.Tensor:
        total = _gather_scatter(x, ctx, x.shape[0])
        agg = total / torch.clamp(ctx.in_degree, min=1.0)[:, None].to(total.dtype)
        return self.dense_0(agg) + self.dense_1(x)


class MFConv(nn.Module):
    """Molecular-fingerprint conv with degree-indexed weights:
    ``out_i = agg_i·w_l[d_i] + b_l[d_i] + x_i·w_r[d_i]``, ``d_i`` the
    in-degree clamped to ``max_degree``. The weights keep the JAX
    package's stacked layout (``w_l``, ``w_r`` [D+1, fin, out], ``b_l``
    [D+1, out]) and its init (``variance_scaling(1/3, fan_in, uniform)``
    per degree, torch-style uniform bias).

    The degree dispatch is one product per degree present, over the
    nodes grouped by degree (``degree_groups``: one sort per forward),
    not a per-node gather of the weights — at hidden 128 on the flagship
    batch ``w_l[deg]`` alone would be [32,752, 128, 128] f32, 2.1 GB."""

    def __init__(
        self, in_dim: int, out_dim: int, max_degree: int, generator: Optional[torch.Generator] = None
    ):
        super().__init__()
        self.max_degree = int(max_degree)
        ndeg = self.max_degree + 1
        self.w_l = nn.Parameter(torch.empty(ndeg, in_dim, out_dim))
        self.b_l = nn.Parameter(torch.empty(ndeg, out_dim))
        self.w_r = nn.Parameter(torch.empty(ndeg, in_dim, out_dim))
        for t in (self.w_l, self.b_l, self.w_r):  # per degree, fan_in = in_dim
            uniform_(t, 1.0 / math.sqrt(in_dim), generator)

    @staticmethod
    def degree_groups(in_degree: torch.Tensor, max_degree: int) -> Tuple[torch.Tensor, Tuple[int, ...]]:
        """(node order sorted by clamped degree, count per degree 0..D).
        The counts are read to the host once (one synchronisation)."""
        deg = torch.clamp(in_degree.long(), 0, int(max_degree))
        order = torch.argsort(deg, stable=True)
        counts = torch.bincount(deg, minlength=int(max_degree) + 1)
        return order, tuple(int(c) for c in counts.tolist())

    def forward(self, x: torch.Tensor, ctx: EdgeContext) -> torch.Tensor:
        n = x.shape[0]
        agg = _gather_scatter(x, ctx, n)
        order, counts = ctx.degree_groups or self.degree_groups(ctx.in_degree, self.max_degree)
        xs, aggs = x.index_select(0, order), agg.index_select(0, order)
        parts, start = [], 0
        for d, c in enumerate(counts):
            if c:
                sl = slice(start, start + c)
                parts.append(aggs[sl] @ self.w_l[d] + self.b_l[d] + xs[sl] @ self.w_r[d])
                start += c
        out_sorted = torch.cat(parts, dim=0)
        return torch.empty_like(out_sorted).index_copy(0, order, out_sorted)


class CGConv(nn.Module):
    """Crystal-graph conv, aggr "add", width-preserving:
    ``out_i = x_i + Σ_j sigmoid(W_f z_ij + b_f) · softplus(W_s z_ij + b_s)``,
    ``z_ij = [x_i, x_j, e_ij]``. The JAX package's fused form: each
    Dense over the concatenation splits into a receiver part (a node-level
    product with the bias folded in, ``rtab``), a sender part (the only
    edge-level product, inside the kernel) and an edge-attribute part
    (``eterm``); the [E, 2F + De] concatenation never exists. With
    ``ctx.fused_conv`` false it takes the composed form over that
    concatenation instead (the receiver gather B3, the sender gather, two
    edge-level products, the masked sorted sum).
    ``dense_0`` is the gate and ``dense_1`` the core, each [2F + De] -> F."""

    def __init__(
        self, in_dim: int, out_dim: int, edge_dim: int = 0, generator: Optional[torch.Generator] = None
    ):
        super().__init__()
        if out_dim != in_dim:
            raise ValueError("CGConv preserves width: out_dim must equal in_dim")
        self.in_dim, self.edge_dim = in_dim, int(edge_dim or 0)
        zdim = 2 * in_dim + self.edge_dim
        self.dense_0 = dense(zdim, out_dim, generator)
        self.dense_1 = dense(zdim, out_dim, generator)

    def forward(self, x: torch.Tensor, ctx: EdgeContext) -> torch.Tensor:
        n, fin = x.shape
        # conv_bf16: x, the receiver tables, the edge features and both
        # Dense layers in bfloat16; the parameters stay f32
        xc = x.to(torch.bfloat16) if ctx.conv_bf16 else x
        wf, ws = self.dense_0.weight.T.to(xc.dtype), self.dense_1.weight.T.to(xc.dtype)  # [zdim, F]
        bf, bs = self.dense_0.bias.to(xc.dtype), self.dense_1.bias.to(xc.dtype)
        ea = ctx.edge_attr.to(xc.dtype) if self.edge_dim else None
        if not ctx.fused_conv:
            # the composed form over the [E, 2F + De] concatenation
            xi = S.gather_rows(xc, ctx.receivers, n, indices_are_sorted=True, real_rows=ctx.edge_occ)
            z = torch.cat([xi, _gather_senders(xc, ctx)] + ([ea] if ea is not None else []), dim=-1)
            msg = torch.sigmoid(z @ wf + bf) * ACTS["softplus"][0](z @ ws + bs)
            return x + _segment_sum_edges(msg, ctx, n).to(x.dtype)
        af = xc @ wf[:fin] + bf
        ac = xc @ ws[:fin] + bs
        cf = cs = None
        if ea is not None:
            cf, cs = ea @ wf[2 * fin :], ea @ ws[2 * fin :]
        agg = _edge_sum(fused_aggregate(
            xc, ctx.senders, ctx.receivers, ctx.edge_mask, n,
            branches=((wf[fin : 2 * fin], None, af, cf), (ws[fin : 2 * fin], None, ac, cs)),
            acts=("sigmoid", "softplus"), win=ctx.sender_win, real_edges=ctx.edge_occ, row_ptr=ctx.row_ptr,
            perm=ctx.sender_perm if ctx.edge_group is not None else None,
        ), ctx).to(x.dtype)
        return x + agg


class _LeakyReLU(torch.autograd.Function):
    """``jax.nn.leaky_relu``: ``x`` where ``x >= 0``, else ``slope·x``, with
    slope 1 at 0 (torch's ``leaky_relu`` takes the negative slope there,
    which moves the gradient wherever the input is exactly 0, as on zero
    features with zero biases). It saves only its output, whose sign is
    the input's (slope > 0): the [E, heads, d] input of GAT's attention
    is not kept for the backward."""

    @staticmethod
    def forward(ctx, x, slope):
        y = torch.where(x >= 0, x, x * slope)
        ctx.save_for_backward(y)
        ctx.slope = slope
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return torch.where(y >= 0, g, g * ctx.slope), None


class GATv2Conv(nn.Module):
    """GATv2 multi-head attention (the JAX package's ``GATv2Conv``, PyG
    GATv2Conv with ``add_self_loops``): a self-loop for every node row
    (masked with the node mask) is appended after the batch's edges, so
    the receivers are not sorted; ``x_l`` (the source transform) and
    ``x_r`` (the target transform) are ``Dense(heads·d)``,
    ``att`` [1, heads, d] lecun-normal (fan-in = heads, as flax counts
    it), ``bias`` zeros. Per edge ``leaky_relu(x_l[s] + x_r[r]) · att``
    summed over d gives the logits; ``segment_softmax`` by receiver;
    dropout on the attention when training (from an explicit generator,
    flax's form: keep with probability 1 - p, scale by 1/(1 - p)); the
    masked sum of ``x_l[s] · alpha`` by receiver. ``concat`` gives
    [N, heads·d], else the mean over the heads [N, d]. For its backward a
    layer keeps two [E + N, heads, d] tensors (``x_l[s]`` and the
    leaky-relu output), 2.6 GB each in f32 on the flagship's batch of
    1024 at hidden 128 and 6 heads."""

    def __init__(
        self,
        in_dim: int,
        out_dim: int,
        heads: int = 6,
        negative_slope: float = 0.05,
        dropout: float = 0.25,
        concat: bool = True,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.heads, self.out_dim = int(heads), int(out_dim)
        self.negative_slope, self.dropout, self.concat = float(negative_slope), float(dropout), bool(concat)
        self.x_l = dense(in_dim, self.heads * self.out_dim, generator)
        self.x_r = dense(in_dim, self.heads * self.out_dim, generator)
        self.att = nn.Parameter(torch.empty(1, self.heads, self.out_dim))
        lecun_normal_(self.att, self.heads, generator)
        self.bias = nn.Parameter(torch.zeros(self.heads * self.out_dim if concat else self.out_dim))

    def forward(
        self, x: torch.Tensor, ctx: EdgeContext, train: bool = False, generator: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        if ctx.edge_group is not None:
            raise ValueError("GAT's attention softmax spans the edge shards and has no edge-sharded form in the "
                             "port; drop Parallel.edge for GAT")
        n = x.shape[0]
        h, d = self.heads, self.out_dim
        loops = torch.arange(n, dtype=ctx.senders.dtype, device=x.device)
        senders = torch.cat([ctx.senders, loops]).long()
        receivers = torch.cat([ctx.receivers, loops]).long()
        emask = torch.cat([ctx.edge_mask, ctx.node_mask])
        x_l = self.x_l(x).view(n, h, d)
        x_r = self.x_r(x).view(n, h, d)
        xs = x_l.index_select(0, senders)  # [E + N, h, d]
        feat = _LeakyReLU.apply(xs + x_r.index_select(0, receivers), self.negative_slope)
        logits = (feat * self.att).sum(-1)  # [E + N, h]
        alpha = S.segment_softmax(logits, receivers, n, mask=emask[:, None])
        if train and self.dropout > 0.0:
            keep = torch.rand(alpha.shape, generator=generator, device=alpha.device) >= self.dropout
            alpha = torch.where(keep, alpha / (1.0 - self.dropout), torch.zeros((), dtype=alpha.dtype, device=alpha.device))
        msg = torch.where(emask[:, None, None], xs * alpha[..., None], torch.zeros((), dtype=xs.dtype, device=xs.device))
        # S.segment_sum's index_add_ would keep the [E + N, h, d] messages
        # for its backward; scatter_add keeps only the (expanded) ids
        out = torch.zeros(n, h, d, dtype=msg.dtype, device=msg.device).scatter_add(
            0, receivers[:, None, None].expand_as(msg), msg
        )
        out = out.reshape(n, h * d) if self.concat else out.mean(1)
        return out + self.bias


class CFConv(nn.Module):
    """SchNet continuous-filter conv:
    ``W_ij = filter_mlp(gaussian(d_ij)) · cosine_cutoff(d_ij)``,
    ``out_i = W2(Σ_j W1(x_j) · W_ij)``. Expects ``ctx.edge_weight``
    (distances) and ``ctx.edge_attr`` (their Gaussian smearing) from the
    chassis. ``dense_0``/``dense_1`` are the filter MLP (torch Linear
    init), ``dense_2`` (no bias) and ``dense_3`` are lin1/lin2 (xavier,
    zero bias); the per-edge filter is the kernel's ``scale``."""

    def __init__(
        self,
        in_dim: int,
        out_dim: int,
        num_filters: int,
        num_gaussians: int,
        cutoff: float,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.cutoff = float(cutoff)
        self.dense_0 = dense(num_gaussians, num_filters, generator, init="torch")
        self.dense_1 = dense(num_filters, num_filters, generator, init="torch")
        self.dense_2 = dense(in_dim, num_filters, generator, bias=False, init="xavier")
        self.dense_3 = dense(num_filters, out_dim, generator, init="xavier")

    def forward(self, x: torch.Tensor, ctx: EdgeContext) -> torch.Tensor:
        if ctx.edge_weight is None or ctx.edge_attr is None:
            raise ValueError("CFConv requires edge_weight and edge_attr")
        d = ctx.edge_weight
        w = self.dense_1(shifted_softplus(self.dense_0(ctx.edge_attr)))
        c = 0.5 * (torch.cos(d * math.pi / self.cutoff) + 1.0)
        c = torch.where(d <= self.cutoff, c, torch.zeros((), dtype=c.dtype, device=c.device))
        w = w * c[:, None]
        h = self.dense_2(x)
        agg = _gather_scatter(h, ctx, x.shape[0], scale=w).to(x.dtype)
        return self.dense_3(agg)


def shifted_softplus(x: torch.Tensor) -> torch.Tensor:
    """``softplus(x) - log 2`` with the JAX package's softplus
    (``logaddexp(x, 0)``, whose derivative at 0 is 1/2)."""
    return ACTS["softplus"][0](x) - math.log(2.0)


def gaussian_smearing(d: torch.Tensor, start: float, stop: float, num_gaussians: int) -> torch.Tensor:
    """PyG GaussianSmearing: the RBF expansion of distances [E] -> [E, G]."""
    offset = torch.linspace(start, stop, num_gaussians, dtype=d.dtype, device=d.device)
    coeff = -0.5 / float((stop - start) / (num_gaussians - 1)) ** 2
    diff = d[:, None] - offset[None, :]
    return torch.exp(coeff * diff * diff)


def avg_degree_stats(deg_histogram) -> Tuple[float, float]:
    """(avg_deg_lin, avg_deg_log) from a train-set degree histogram,
    mirroring PyG PNAConv's init-time computation."""
    hist = np.asarray(deg_histogram, dtype=np.float64)
    total = max(hist.sum(), 1.0)
    degrees = np.arange(len(hist), dtype=np.float64)
    lin = float((hist * degrees).sum() / total)
    log = float((hist * np.log(degrees + 1.0)).sum() / total)
    return max(lin, 1e-6), max(log, 1e-6)
