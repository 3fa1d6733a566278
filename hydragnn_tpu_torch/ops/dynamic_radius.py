"""SchNet's radius graph rebuilt inside the forward, at a static shape.

The port's counterpart of ``hydragnn_tpu/ops/dynamic_radius.py``: every
node row gets exactly ``max_neighbours`` edge slots, filled with its
nearest same-graph real neighbours within the cutoff and masked beyond,
so the edge buffer is [N·K] with a boolean mask. No self-loops;
receiver-major order (receivers ascending, as the conv stacks need).

The cost is the dense [N, N] distance matrix and a sort of each row:
O(N²) in the padded node count, meant for molecular batches only (the
chassis warns above 20,000 node rows). Plain PyTorch, no kernel: the
JAX package computes it in XLA too.
"""

from __future__ import annotations

from typing import Tuple

import torch


def radius_graph_in_forward(
    pos: torch.Tensor,
    node_graph: torch.Tensor,
    node_mask: torch.Tensor,
    radius: float,
    max_neighbours: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(senders, receivers, dist, edge_mask)``, each [N·K] (int32,
    int32, f32, bool), K = min(max_neighbours, max(N - 1, 1)). Each row's
    neighbours come nearest first and, at equal distances, lower index
    first (JAX's ``top_k`` order: a stable ascending sort of the squared
    distances, not ``torch.topk``, which promises no order on ties).
    Masked slots carry ``dist = 2·radius`` and sender 0."""
    n = pos.shape[0]
    k = int(min(max_neighbours, max(n - 1, 1)))
    pos = pos.float()
    diff = pos[:, None, :] - pos[None, :, :]
    d2 = (diff * diff).sum(-1)  # [N, N], receiver-major rows
    r2 = torch.tensor(radius, dtype=torch.float32, device=pos.device) ** 2
    ok = (
        (node_graph[:, None] == node_graph[None, :])
        & (node_mask[:, None] & node_mask[None, :])
        & ~torch.eye(n, dtype=torch.bool, device=pos.device)
        & (d2 <= r2)
    )
    masked = torch.where(ok, d2, torch.full((), float("inf"), device=pos.device))
    d2k, idx = torch.sort(masked, dim=1, stable=True)
    d2k, idx = d2k[:, :k].reshape(-1), idx[:, :k].reshape(-1)
    edge_mask = torch.isfinite(d2k)
    receivers = torch.arange(n, dtype=torch.int32, device=pos.device).repeat_interleave(k)
    dist = torch.where(edge_mask, torch.sqrt(torch.clamp_min(d2k, 0.0)),
                       torch.full((), 2.0 * radius, device=pos.device))
    senders = torch.where(edge_mask, idx.to(torch.int32), torch.zeros((), dtype=torch.int32, device=pos.device))
    return senders, receivers, dist, edge_mask
