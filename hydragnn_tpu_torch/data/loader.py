"""Static pad plans and the training ``GraphLoader``.

The port's counterpart of ``hydragnn_tpu/data/loader.py``:
``pad_plan_for`` (one plan covering any batch of ``batch_size``
samples), ``bucket_pad_plans`` (the serving ladder) and ``GraphLoader``,
which yields fixed-shape batches with the JAX loader's shuffle order,
pad plan, run-aligned layout and sender windows:

  - iterating builds each batch on the host, in a producer thread
    ``prefetch`` batches ahead (``HGTORCH_NUM_PREFETCH``, default 2; 0
    builds inline), into pinned memory when the loader's device is a
    card, so the consumer's ``batch.to(dev, non_blocking=True)`` is an
    asynchronous copy (``HGTORCH_INJECT_STALL_LOADER=B:S`` sleeps S
    seconds before batch B of an epoch, in either path);
  - ``cache_device_batches`` builds every batch once, with fixed
    membership, keeps it on the device and permutes only the order;
  - ``device_batches(epoch)`` / ``epoch_order(epoch)`` are what the
    JAX package's whole-epoch scan trains on
    (``stacked_device_batches``): batch b is ``samples[b·bs:(b+1)·bs]``
    on the device, rebuilt from an epoch-seeded sample permutation every
    ``scan_reshuffle_every`` epochs, and each epoch visits them in the
    order ``default_rng(seed + epoch).permutation(n_batches)``;
  - sharding over processes: ``num_shards``/``shard_rank`` keep
    ``samples[shard_rank::num_shards]`` (wrapping around to
    ``ceil(n / num_shards)`` samples, so every rank steps alike), and
    ``device_stack = D`` splits each batch of ``batch_size`` graphs into
    the JAX loader's D sub-batches, of which this loader yields the one
    at ``stack_rank`` (``Partitioner.attach_loader`` sets it): rank r of
    a ``data × fsdp`` group trains on exactly the JAX package's
    sub-batch r, an all-padding filler (``graph/batch.py:mask_out``)
    where a short last batch has none. The pad plan is the whole
    dataset's at ``batch_size / D`` graphs, equal on every rank;
  - ``set_placer`` applies a rank's placement (the edge axis's slice of
    the edges) to every batch it yields.
"""

from __future__ import annotations

import math
import os
import queue
import threading
from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch

from hydragnn_tpu_torch.data.dataset import samples_to_graph_dicts
from hydragnn_tpu_torch.graph.batch import GraphBatch, batch_graphs, mask_out
from hydragnn_tpu_torch.resilience.inject import maybe_stall_loader
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

      cache_device_batches: build every batch once (fixed membership) on
        the loader's device and permute only the batch order each epoch.
      prefetch: batches the producer thread builds ahead; None reads
        ``HGTORCH_NUM_PREFETCH`` (default 2), 0 builds inline.
      scan_reshuffle_every: rebuild ``device_batches``' membership every
        k epochs (0 = never).
      num_shards / shard_rank: this loader sees
        ``samples[shard_rank::num_shards]``, wrapped to equal lengths.
      device_stack / stack_rank: each batch is the ``stack_rank``-th of
        ``device_stack`` sub-batches (``batch_size`` must divide).

    ``set_device`` says where ``device_batches`` and the cached batches
    live and, for a card, that host batches are pinned (the train loop
    sets the model's device).

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
        cache_device_batches: bool = False,
        prefetch: Optional[int] = None,
        scan_reshuffle_every: int = 0,
        num_shards: int = 1,
        shard_rank: int = 0,
        device_stack: int = 1,
        stack_rank: int = 0,
    ):
        if device_stack > 1 and batch_size % device_stack != 0:
            raise ValueError(f"batch_size {batch_size} must be divisible by device_stack {device_stack}")
        self.all_samples = list(samples)
        n = len(self.all_samples)
        if num_shards > 1 and n > 0:
            per_shard = math.ceil(n / num_shards)
            self.samples = [self.all_samples[(shard_rank + k * num_shards) % n] for k in range(per_shard)]
        else:
            self.samples = list(self.all_samples)
        self.num_shards, self.shard_rank = int(num_shards), int(shard_rank)
        self.device_stack, self.stack_rank = int(device_stack), int(stack_rank)
        self._placer = None
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.cache_device_batches = cache_device_batches
        self.scan_reshuffle_every = int(scan_reshuffle_every)
        if prefetch is None:
            raw = os.environ.get("HGTORCH_NUM_PREFETCH", "2")
            try:
                prefetch = int(raw)
            except ValueError:
                raise ValueError(f"HGTORCH_NUM_PREFETCH must be an integer, got {raw!r}") from None
        self.prefetch = prefetch
        self.device: Optional[torch.device] = None
        self._resident: Optional[List[GraphBatch]] = None
        self._resident_key = None
        self._epoch = 0
        # the plan, the dense map and the alignment from the whole dataset
        # at one sub-batch: equal on every rank
        sub = batch_size // self.device_stack
        self.pad_nodes, self.pad_edges, self.pad_graphs = pad_plan_for(
            self.all_samples, sub, node_multiple, edge_multiple
        )
        self.dense_slots = None
        if dense_slots is True:
            dmax = max_in_degree(self.all_samples)
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
            aligned = _aligned_edge_counts(self.all_samples, self.run_align)
            if aligned is None:
                self.run_align = 0  # a sample without edges built: nothing to align
            else:
                worst = sorted(aligned, reverse=True)[:sub]
                self.pad_edges = _round_up(
                    max(sum(worst) + 1, self.pad_edges), math.lcm(edge_multiple, self.run_align)
                )
        # window-plan node block: the dataset's mean graph, at least 128
        # and at most 512 rows, so one block covers whole graphs
        mean_nodes = int(sum(s.num_nodes for s in self.all_samples) / max(len(self.all_samples), 1))
        self.win_block_rows = min(512, _round_up(max(mean_nodes, 128), 128))
        self._dicts = samples_to_graph_dicts(self.samples)

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def set_stack_rank(self, stack_rank: int) -> None:
        """The sub-batch of each batch this loader yields."""
        if not 0 <= stack_rank < self.device_stack:
            raise ValueError(f"stack_rank {stack_rank} outside device_stack {self.device_stack}")
        if stack_rank != self.stack_rank:
            self._resident = self._resident_key = None
        self.stack_rank = int(stack_rank)

    def set_placer(self, placer) -> None:
        """A callable applied to every batch before it is yielded (the
        Partitioner's ``shard_batch``); drops the batches resident."""
        if placer is not self._placer:
            self._resident = self._resident_key = None
        self._placer = placer

    def set_device(self, device) -> None:
        """Where resident batches live and whether host batches are pinned;
        a change drops the batches already resident."""
        device = None if device is None else torch.device(device)
        if device != self.device:
            self._resident = self._resident_key = None
        self.device = device

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

    def epoch_order(self, epoch: int) -> np.ndarray:
        """The order the batches of ``device_batches`` are visited in at
        ``epoch``."""
        nb = len(self)
        if not self.shuffle:
            return np.arange(nb)
        return np.random.default_rng(self.seed + epoch).permutation(nb)

    def make_batch(self, idx: Sequence[int]) -> GraphBatch:
        """The batch of the samples at ``idx``, on this loader's pad plan
        and layout: with ``device_stack`` > 1 its ``stack_rank``-th
        sub-batch (an all-padding filler when the chunk has none)."""
        if self.device_stack > 1:
            sub = self.batch_size // self.device_stack
            part = idx[self.stack_rank * sub:(self.stack_rank + 1) * sub]
            if len(part) == 0:
                return mask_out(self._sub_batch(idx[:1]))
            return self._sub_batch(part)
        return self._sub_batch(idx)

    def _sub_batch(self, idx: Sequence[int]) -> GraphBatch:
        return batch_graphs(
            [self._dicts[i] for i in idx],
            n_node_pad=self.pad_nodes,
            n_edge_pad=self.pad_edges,
            n_graph_pad=self.pad_graphs,
            run_align=self.run_align,
            win_block_rows=self.win_block_rows,
            dense_slots=self.dense_slots,
        )

    def device_batches(self, epoch: int = 0, reshuffle: bool = True) -> List[GraphBatch]:
        """Every batch of ``epoch`` on the loader's device, membership
        fixed (batch b holds ``samples[b·bs:(b+1)·bs]``) unless
        ``scan_reshuffle_every = k`` and ``reshuffle``, which re-form it
        from ``default_rng(seed + epoch // k)``'s sample permutation
        every k epochs. Built once per membership and kept (one
        membership at a time)."""
        k = self.scan_reshuffle_every
        key = (epoch // k) if (reshuffle and self.shuffle and k > 0) else None
        if self._resident is None or key != self._resident_key:
            self._resident = None  # free the old membership before the new one is built
            n = len(self.samples)
            base = np.arange(n) if key is None else np.random.default_rng(self.seed + key).permutation(n)
            bs, dev = self.batch_size, self.device or torch.device("cpu")
            self._resident = [self._placed(self.make_batch(base[b * bs : (b + 1) * bs])).to(dev)
                              for b in range(len(self))]
            self._resident_key = key
        return self._resident

    def _placed(self, batch: GraphBatch) -> GraphBatch:
        return batch if self._placer is None else self._placer(batch)

    def _host_batch(self, idx: Sequence[int]) -> GraphBatch:
        batch = self._placed(self.make_batch(idx))
        if self.device is not None and self.device.type == "cuda":
            batch = batch.pin_memory()
        return batch

    def __iter__(self) -> Iterator[GraphBatch]:
        bs, nb = self.batch_size, len(self)
        if self.cache_device_batches:  # the fixed membership, as the JAX loader's cache
            batches = self.device_batches(self._epoch, reshuffle=False)
            for b in self.epoch_order(self._epoch):
                yield batches[b]
            return
        order = self._order()
        if self.prefetch <= 0:
            for b in range(nb):
                maybe_stall_loader(b)
                yield self._host_batch(order[b * bs : (b + 1) * bs])
            return
        # the producer builds batches ahead into a bounded queue; an
        # abandoned generator sets ``stop`` (its finally), which ends the
        # producer at its next put; a producer error is raised here
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        done = object()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for b in range(nb):
                    maybe_stall_loader(b)
                    if not put(self._host_batch(order[b * bs : (b + 1) * bs])):
                        return
                put(done)
            except BaseException as exc:  # handed to the consumer, which raises it
                put(exc)

        thread = threading.Thread(target=producer, name="GraphLoader-prefetch", daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            thread.join()
