"""Static pad plans for graph batches.

The port's counterpart of the pad-plan half of
``hydragnn_tpu/data/loader.py``: ``pad_plan_for`` (one plan covering
any batch of ``batch_size`` samples) and ``bucket_pad_plans`` (the
serving ladder). The training ``GraphLoader`` waits for the training
slice (ROADMAP A2).
"""

from __future__ import annotations

import math
from typing import Sequence


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pad_plan_for(
    samples: Sequence,
    batch_size: int,
    node_multiple: int = 16,
    edge_multiple: int = 8,
) -> tuple:
    """Static (n_node_pad, n_edge_pad, n_graph_pad) covering any batch of
    ``batch_size`` samples drawn from ``samples``: the worst case is the
    ``batch_size`` largest graphs landing in one batch."""
    nodes = sorted((s.num_nodes for s in samples), reverse=True)
    edges = sorted((s.num_edges for s in samples), reverse=True)
    worst_nodes = sum(nodes[:batch_size])
    worst_edges = sum(edges[:batch_size])
    return (
        _round_up(worst_nodes + 1, node_multiple),
        max(_round_up(worst_edges + 1, edge_multiple), edge_multiple),
        batch_size + 1,
    )


class _CapSize:
    """Synthetic (num_nodes, num_edges)-only sample for pad planning."""

    __slots__ = ("num_nodes", "num_edges")

    def __init__(self, num_nodes: int, num_edges: int):
        self.num_nodes = num_nodes
        self.num_edges = num_edges


def bucket_pad_plans(
    samples: Sequence,
    batch_size: int,
    num_buckets: int = 3,
    node_multiple: int = 16,
    edge_multiple: int = 8,
) -> list:
    """Ladder of serving pad plans over the dataset's size distribution:
    an ascending, plan-deduplicated list of
    ``((cap_nodes, cap_edges), (n_node_pad, n_edge_pad, n_graph_pad))``.
    Bucket ``i`` covers graphs up to the ``(i+1)/num_buckets`` quantile
    of nodes AND of edges; each plan covers a worst-case batch of
    ``batch_size`` cap-sized graphs."""
    if not samples:
        raise ValueError("bucket_pad_plans needs a non-empty sample set")
    if num_buckets < 1:
        raise ValueError(f"num_buckets must be >= 1, got {num_buckets}")
    nodes = sorted(s.num_nodes for s in samples)
    edges = sorted(s.num_edges for s in samples)
    n = len(nodes)
    plans = []
    seen = set()
    for i in range(num_buckets):
        k = min(n - 1, max(0, math.ceil((i + 1) / num_buckets * n) - 1))
        cap_n, cap_e = int(nodes[k]), int(edges[k])
        plan = pad_plan_for(
            [_CapSize(cap_n, cap_e)] * batch_size,
            batch_size,
            node_multiple,
            edge_multiple,
        )
        if plan in seen:
            continue
        seen.add(plan)
        plans.append(((cap_n, cap_e), plan))
    return plans
