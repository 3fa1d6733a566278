"""Bucketed pad-plan ladder for serving.

The port's counterpart of ``hydragnn_tpu/serve/buckets.py`` (``Bucket``,
``build_bucket_ladder``, ``route``). Every request routes to the
smallest bucket whose per-graph caps fit it, so small graphs never pay
the big-graph pad. PyTorch runs eagerly, so there is no per-bucket
compile cache; a CUDA graph per bucket takes its place later
(ROADMAP A10).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

from hydragnn_tpu_torch.data.loader import bucket_pad_plans


@dataclasses.dataclass(frozen=True)
class Bucket:
    """One rung of the ladder: per-graph routing caps plus a pad plan
    covering any batch of up to ``max_batch`` graphs within the caps."""

    index: int
    cap_nodes: int
    cap_edges: int
    node_pad: int
    edge_pad: int
    graph_pad: int
    max_batch: int

    def fits_graph(self, num_nodes: int, num_edges: int) -> bool:
        return num_nodes <= self.cap_nodes and num_edges <= self.cap_edges

    def fits_totals(self, tot_nodes: int, tot_edges: int, n_graphs: int) -> bool:
        """Whether a concrete batch fits the pad plan (one spare node and
        one spare graph slot are needed for padding)."""
        return (
            tot_nodes < self.node_pad
            and tot_edges <= self.edge_pad
            and n_graphs < self.graph_pad
        )


def build_bucket_ladder(
    reference_samples: Sequence,
    max_batch: int,
    num_buckets: int = 3,
    node_multiple: int = 16,
    edge_multiple: int = 8,
) -> List[Bucket]:
    """Ascending ladder sized from a reference sample set (the prepared
    dataset); graphs beyond the top rung take the oversize path."""
    plans = bucket_pad_plans(
        reference_samples,
        max_batch,
        num_buckets=num_buckets,
        node_multiple=node_multiple,
        edge_multiple=edge_multiple,
    )
    return [
        Bucket(
            index=i,
            cap_nodes=cap_n,
            cap_edges=cap_e,
            node_pad=plan[0],
            edge_pad=plan[1],
            graph_pad=plan[2],
            max_batch=max_batch,
        )
        for i, ((cap_n, cap_e), plan) in enumerate(plans)
    ]


def route(buckets: Sequence[Bucket], num_nodes: int, num_edges: int) -> Optional[Bucket]:
    """Smallest bucket whose per-graph caps fit, or None (oversize)."""
    for b in buckets:
        if b.fits_graph(num_nodes, num_edges):
            return b
    return None
