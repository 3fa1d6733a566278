"""Static pad plans and the training ``GraphLoader``.

The port's counterpart of ``hydragnn_tpu/data/loader.py``:
``pad_plan_for`` (one plan covering any batch of ``batch_size``
samples), ``bucket_pad_plans`` (the serving ladder) and ``GraphLoader``,
which yields fixed-shape host batches (CPU tensors; the train loop moves
them to the card) with the JAX loader's shuffle order, pad plan,
run-aligned layout and sender windows.

Not ported yet (ROADMAP A2): the prefetch thread, multi-host sharding,
``device_stack > 1`` with its ``_mask_out`` filler batches, and
device-cached batches.
"""

from __future__ import annotations

import math
from typing import Iterator, List, Optional, Sequence

import numpy as np

from hydragnn_tpu_torch.data.dataset import samples_to_graph_dicts
from hydragnn_tpu_torch.graph.batch import GraphBatch, batch_graphs
from hydragnn_tpu_torch.utils.config import max_in_degree


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


def _aligned_edge_counts(samples, k: int) -> Optional[List[int]]:
    """Per-sample edge-slot count under run-K alignment (the sum over
    nodes of roundup(in_degree, k)), or None when any sample lacks an
    ``edge_index``."""
    out = []
    for s in samples:
        ei = getattr(s, "edge_index", None)
        if ei is None:
            return None
        r = np.asarray(ei)[1]
        if r.size:
            deg = np.bincount(r)
            out.append(int((((deg + k - 1) // k) * k * (deg > 0)).sum()))
        else:
            out.append(0)
    return out


class GraphLoader:
    """Iterable over fixed-shape host ``GraphBatch``es.

    Args:
      samples: the split's prepared samples.
      batch_size: graphs per batch.
      shuffle: reshuffle each epoch, in the order
        ``np.random.default_rng(seed + epoch).permutation`` gives.
      drop_last: drop the last partial batch.
      dense_slots: True = AUTO (the JAX loader's gate: the dense slot map,
        with D = the dataset's max in-degree, when the slot inflation
        pad_nodes x D / pad_edges stays under 1.35), an int pins D,
        False/0 disables it. ``self.dense_slots`` is D or None.
      run_align: True = AUTO (K = 8 whenever the dense map is off and the
        samples have edges), an int pins K (and then excludes the dense
        map), False/0 disables it. The edge pad widens to the aligned
        worst case, a multiple of lcm(edge_multiple, K).

    The JAX loader also rounds the aligned edge pad up to its Pallas
    kernels' chunk sizes (CE, _BCAST_CE) once it reaches 32,768 slots;
    that is TPU tiling, and this loader does not (the batches are equal
    below that size)."""

    def __init__(
        self,
        samples: Sequence,
        batch_size: int,
        shuffle: bool = False,
        seed: int = 0,
        node_multiple: int = 16,
        edge_multiple: int = 8,
        drop_last: bool = False,
        dense_slots=True,
        run_align=True,
    ):
        self.samples = list(samples)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self._epoch = 0
        self.pad_nodes, self.pad_edges, self.pad_graphs = pad_plan_for(
            self.samples, batch_size, node_multiple, edge_multiple
        )
        self.dense_slots = None
        if dense_slots is True:
            dmax = max_in_degree(self.samples)
            if dmax and self.pad_nodes * dmax / max(self.pad_edges, 1) <= 1.35:
                self.dense_slots = dmax
        elif dense_slots:
            self.dense_slots = int(dense_slots)
        if run_align is True:
            self.run_align = 8 if self.dense_slots is None else 0
        else:
            self.run_align = int(run_align) if run_align and run_align > 1 else 0
            if self.run_align and self.dense_slots is not None:
                raise ValueError(
                    "run_align and dense_slots are mutually exclusive; pass "
                    "dense_slots=False alongside an explicit run_align"
                )
        if self.run_align:
            aligned = _aligned_edge_counts(self.samples, self.run_align)
            if aligned is None:
                self.run_align = 0  # a sample without edges built: nothing to align
            else:
                worst = sorted(aligned, reverse=True)[:batch_size]
                self.pad_edges = _round_up(
                    max(sum(worst) + 1, self.pad_edges), math.lcm(edge_multiple, self.run_align)
                )
        # window-plan node block: the dataset's mean graph, at least 128
        # and at most 512 rows, so one block covers whole graphs
        mean_nodes = int(sum(s.num_nodes for s in self.samples) / max(len(self.samples), 1))
        self.win_block_rows = min(512, _round_up(max(mean_nodes, 128), 128))
        self._dicts = samples_to_graph_dicts(self.samples)

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def __len__(self) -> int:
        n = len(self.samples)
        if self.drop_last:
            return n // self.batch_size
        return math.ceil(n / self.batch_size)

    def _order(self) -> np.ndarray:
        n = len(self.samples)
        if not self.shuffle:
            return np.arange(n)
        return np.random.default_rng(self.seed + self._epoch).permutation(n)

    def make_batch(self, idx: Sequence[int]) -> GraphBatch:
        """The batch of the samples at ``idx``, on this loader's pad plan
        and layout."""
        return batch_graphs(
            [self._dicts[i] for i in idx],
            n_node_pad=self.pad_nodes,
            n_edge_pad=self.pad_edges,
            n_graph_pad=self.pad_graphs,
            run_align=self.run_align,
            win_block_rows=self.win_block_rows,
            dense_slots=self.dense_slots,
        )

    def __iter__(self) -> Iterator[GraphBatch]:
        bs = self.batch_size
        order = self._order()
        for b in range(len(self)):
            yield self.make_batch(order[b * bs : (b + 1) * bs])
