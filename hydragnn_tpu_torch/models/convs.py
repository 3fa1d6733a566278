"""Message-passing conv layers over masked segment ops.

The port's counterpart of ``hydragnn_tpu/models/convs.py``. Message
direction matches PyG: sender j -> receiver i, aggregation grouped by
receiver. The port has ``PNAConv`` without edge features, in two
branches: the run-aligned branch (training batches, ``run_align=K``)
and the unaligned CSR branch (serving batches), and the
``EdgeContext`` the chassis hands every layer. The other conv stacks
and PNA's dense branch follow (ROADMAP A4, A7).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from hydragnn_tpu_torch.graph import segment as S
from hydragnn_tpu_torch.models.layers import dense, lecun_normal_
from hydragnn_tpu_torch.ops.gather_stats import gather_presum_stats
from hydragnn_tpu_torch.ops.pna_aggregate import pna_aggregate


@dataclasses.dataclass(frozen=True)
class EdgeContext:
    """Edge structure handed to every conv layer by the chassis."""

    senders: torch.Tensor  # [E] int32
    receivers: torch.Tensor  # [E] int32, sorted ascending (CSR contract)
    edge_mask: torch.Tensor  # [E] bool
    node_mask: torch.Tensor  # [N] bool
    in_degree: torch.Tensor  # [N] f32 count of REAL incoming edges
    edge_attr: Optional[torch.Tensor] = None  # [E, De]
    # the senders' per-node-block edge windows (graph/batch.py)
    sender_win: Optional[torch.Tensor] = None  # [2, n_blocks] int32
    # K > 0: every K-group of edge slots has one receiver (or is batch
    # tail), and masked slots may be self-loops at real nodes
    run_align: int = 0


class PNAConv(nn.Module):
    """Principal Neighbourhood Aggregation conv (aggregators mean, min,
    max, std; scalers identity, amplification, attenuation, linear;
    pre/post_layers=1), in the JAX package's message-free form: with one
    pre-layer the message decomposes as ``a[recv] + bsend[send]``, so the
    aggregators need only segment statistics of ``v = bsend[senders]``
    (mean and the extrema shift by ``a``; std is shift-invariant). Those
    statistics come from one of two branches:

      - run-aligned batches (``ctx.run_align = K``): ``gather_presum_stats``
        (B1) gathers ``v`` and pre-reduces each K-group of slots without
        writing ``v`` to memory, then a sorted segment sum (B2) and a
        segment max over the E/K groups finish the statistics — every
        layer, conv_0 (H = 1) included. This branch trains.
      - unaligned batches: ``ops.pna_aggregate`` (B5), forward only.

    ``pre_kernel`` stays one [2·fin, fin] parameter in flax's layout
    (receiver half, then sender half), so ``convert.py`` copies it as it
    is; ``post`` is the post-layer over ``[x, scaled]``."""

    def __init__(
        self,
        in_dim: int,
        out_dim: int,
        avg_deg_lin: float,
        avg_deg_log: float,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.in_dim = in_dim
        self.avg_deg_lin = float(avg_deg_lin)
        self.avg_deg_log = float(avg_deg_log)
        zdim = 2 * in_dim
        self.pre_kernel = nn.Parameter(torch.empty(zdim, in_dim))
        lecun_normal_(self.pre_kernel, zdim, generator)
        self.pre_bias = nn.Parameter(torch.zeros(in_dim))
        self.post = dense(17 * in_dim, out_dim, generator)

    def forward(self, x: torch.Tensor, ctx: EdgeContext) -> torch.Tensor:
        n, fin = x.shape
        w = self.pre_kernel.to(x.dtype)
        a = x @ w[:fin] + self.pre_bias.to(x.dtype)  # receiver part [N, fin]
        bsend = x @ w[fin : 2 * fin]  # sender part [N, fin]
        v = bsend  # dtype source for the shared tail
        if ctx.run_align:
            k = ctx.run_align
            stats8, both8 = gather_presum_stats(
                bsend, ctx.senders, ctx.edge_mask, ctx.sender_win, n, k
            )
            recv8 = ctx.receivers[::k].contiguous()
            pair = S.segment_sum_sorted(stats8, recv8, n, grad_dtype=bsend.dtype)
            vsum, vsumsq = pair[:, :fin], pair[:, fin : 2 * fin]
            # all-masked groups carry the type's lowest value: the max
            # cleans rows at or below it to 0
            both = S.segment_max(both8, recv8, n, indices_are_sorted=True, empty_value=0.0)
        else:
            v = bsend.index_select(0, ctx.senders)
            vsum, vsumsq, _, both = pna_aggregate(v, ctx.receivers, n, mask=ctx.edge_mask)
        cnt = ctx.in_degree
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


def avg_degree_stats(deg_histogram) -> Tuple[float, float]:
    """(avg_deg_lin, avg_deg_log) from a train-set degree histogram,
    mirroring PyG PNAConv's init-time computation."""
    hist = np.asarray(deg_histogram, dtype=np.float64)
    total = max(hist.sum(), 1.0)
    degrees = np.arange(len(hist), dtype=np.float64)
    lin = float((hist * degrees).sum() / total)
    log = float((hist * np.log(degrees + 1.0)).sum() / total)
    return max(lin, 1e-6), max(log, 1e-6)
