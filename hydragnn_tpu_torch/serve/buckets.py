"""Bucketed pad-plan ladder for serving, and one CUDA graph per bucket.

The port's counterpart of ``hydragnn_tpu/serve/buckets.py``: ``Bucket``,
``build_bucket_ladder`` and ``route`` (every request routes to the
smallest bucket whose per-graph caps fit it), and
:class:`BucketGraphCache`, the counterpart of ``BucketCompileCache``.
Where the JAX package compiles one executable per bucket ahead of time,
the port captures the model's eval forward once per bucket into a CUDA
graph at ``start()`` and replays it for every batch: the kernels of the
forward (B5, B3, the row pointers on the flagship) run inside the
graphs, with no Python between them.

Two weight slots, each with its own ladder of graphs: the live model and
a standby copy. A graph reads its slot's parameters at fixed addresses,
so a reload copies the candidate weights into the standby slot
(``load_standby``), replays the standby graphs on each bucket's warm
batch (the server's canary) and swaps the active slot index
(``rebind``): no capture after ``start()``, and the live weights are
untouched until the swap. One lock a cache serialises every run (copy
in, replay, copy out) and every weight write, so a batch in flight
finishes on the weights it started with and no two graphs replay at once.
``compile_warmup`` counts the captures: 2 x buckets.

Several caches in one process (a fleet's replicas, ``fleet/``) share the
card. A capture runs under ``torch.cuda.graph``'s default global capture
mode, in which another thread's allocation, copy or synchronisation fails
the capture or itself. So every cache's device work (each run, each
weight write, each module built, :func:`build_module`) takes the shared
side of the process-wide :data:`DEVICE_LOCK`, and each capture (with its
warm-up forward and its buffers) takes the exclusive side: replays of
other caches go on side by side between one capture and the next, never
during one.

Three model configs touch the host inside their forward and cannot be
captured (MFC, an ``mlp_per_node`` head, SchNet's in-forward radius
graph); their buckets are served by the eager forward on the card,
decided from the model config before any capture (:func:`eager_reason`). On the CPU
every bucket is the eager forward, with the same counters. A capture
that fails raises: nothing falls back to eager or to the CPU.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from hydragnn_tpu_torch.data.loader import bucket_pad_plans
from hydragnn_tpu_torch.graph.batch import GraphBatch
from hydragnn_tpu_torch.models.create import create_model
from hydragnn_tpu_torch.utils import syncdebug


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


def eager_reason(cfg, device: torch.device, cuda_graphs: bool = True) -> Optional[str]:
    """Why the buckets of a model on ``device`` are served by the eager
    forward, or None when each is a CUDA graph."""
    if device.type != "cuda":
        return "the device is the CPU"
    if not cuda_graphs:
        return "ServeConfig.cuda_graphs is false"
    if cfg.model_type == "MFC":
        return "MFConv.degree_groups reads the degree counts on the host"
    if cfg.node_head_type == "mlp_per_node" and "node" in cfg.output_type:
        return "PerNodeMLP.forward reads the position counts on the host"
    if cfg.inforward_radius:
        return "radius_graph_in_forward copies its radius from the host"
    return None


def _tensor_fields(batch: GraphBatch):
    """(name, tensor) of every tensor field that is not None."""
    for f in dataclasses.fields(batch):
        v = getattr(batch, f.name)
        if isinstance(v, torch.Tensor):
            yield f.name, v


def check_like(ref: GraphBatch, batch: GraphBatch, what: str) -> None:
    """Raise unless ``batch`` has ``ref``'s fields (the same ones None),
    shapes, dtypes and layout: a captured graph reads fixed buffers of
    fixed shapes, and is never re-captured for a batch that differs."""
    for f in dataclasses.fields(ref):
        a, b = getattr(ref, f.name), getattr(batch, f.name)
        if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
            if a is None or b is None:
                raise ValueError(f"{what}: batch field {f.name!r} is {'None' if b is None else 'set'}, "
                                 f"the captured batch's {'None' if a is None else 'set'}")
            if a.shape != b.shape or a.dtype != b.dtype:
                raise ValueError(f"{what}: batch field {f.name!r} is {tuple(b.shape)} {b.dtype}, "
                                 f"the captured batch's {tuple(a.shape)} {a.dtype}")
        elif isinstance(a, dict):
            if sorted(a) != sorted(b):
                raise ValueError(f"{what}: batch field {f.name!r} holds {sorted(b)}, the captured batch {sorted(a)}")
        elif a != b:
            raise ValueError(f"{what}: batch field {f.name!r} is {b!r}, the captured batch's {a!r}")


class SharedExclusiveLock:
    """Any number of holders of the shared side, or one of the exclusive
    side; a waiting exclusive holder bars new shared ones, so a capture is
    not starved by traffic. Not reentrant."""

    def __init__(self, name: str):
        self._cond = syncdebug.maybe_wrap(threading.Condition(), name)
        self._shared = 0  # the three counts are guarded by _cond
        self._exclusive = False
        self._waiting = 0

    @contextlib.contextmanager
    def shared(self):
        with self._cond:
            while self._exclusive or self._waiting:
                self._cond.wait()
            self._shared += 1
        try:
            yield
        finally:
            with self._cond:
                self._shared -= 1
                if not self._shared:
                    self._cond.notify_all()

    @contextlib.contextmanager
    def exclusive(self):
        with self._cond:
            self._waiting += 1
            while self._exclusive or self._shared:
                self._cond.wait()
            self._waiting -= 1
            self._exclusive = True
        try:
            yield
        finally:
            with self._cond:
                self._exclusive = False
                self._cond.notify_all()


#: The process's device work against its CUDA-graph captures (module docstring).
DEVICE_LOCK = SharedExclusiveLock("buckets.DEVICE_LOCK")


def build_module(cfg, device, state_dict):
    """A fresh module of ``cfg`` on ``device`` loaded (strict) with
    ``state_dict``, built on the shared side of :data:`DEVICE_LOCK`:
    never during a capture."""
    with DEVICE_LOCK.shared():
        module = create_model(cfg, device=device)
        module.load_state_dict(state_dict, strict=True)
    return module


@dataclasses.dataclass
class _Entry:
    """One bucket of one weight slot: the warm host batch, and for a
    graph the graph, its static device batch, its page-locked staging
    batch and its static outputs."""

    warm: GraphBatch
    graph: Optional[torch.cuda.CUDAGraph] = None
    static: Optional[GraphBatch] = None
    staging: Optional[GraphBatch] = None
    outputs: Optional[List[torch.Tensor]] = None


class BucketGraphCache:
    """One CUDA graph (or eager forward) per bucket and weight slot
    (module docstring). ``build_warm_batch(bucket)`` builds the host
    batch a bucket is captured on; ``reason`` (:func:`eager_reason`)
    makes every bucket eager."""

    SLOTS = 2

    def __init__(
        self,
        model,
        build_warm_batch: Callable[[object], GraphBatch],
        device: torch.device,
        metrics=None,
        reason: Optional[str] = None,
    ):
        self.device = device
        self.reason = reason
        self.graphs = reason is None
        self.models = [model]  # slot -> HydraModel; the standby joins at warmup
        self._build_warm_batch = build_warm_batch
        self._metrics = metrics
        self._entries: Dict[Tuple[int, int], _Entry] = {}  # written under _lock
        # serialises every run and every weight write (module docstring)
        self._lock = syncdebug.maybe_wrap(threading.Lock(), "buckets.BucketGraphCache._lock")
        self.active = 0  # the live slot; written under _lock
        self.captures = 0
        self.warm_forwards = 0

    # -- building ----------------------------------------------------------

    def _standby_model(self):
        live = self.models[0]
        return build_module(live.cfg, self.device, live.state_dict())

    def _make(self, slot: int, bucket) -> _Entry:
        warm = self._build_warm_batch(bucket)
        if not self.graphs:
            return _Entry(warm)
        model = self.models[slot]
        with DEVICE_LOCK.exclusive(), torch.cuda.device(self.device):
            static = warm.to(self.device)
            # one forward off the capture first: the kernels' libraries,
            # cuBLAS's handle and workspace are made outside the graph
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side), torch.inference_mode():
                model(static, train=False)
            torch.cuda.current_stream(self.device).wait_stream(side)
            self.warm_forwards += 1
            graph = torch.cuda.CUDAGraph()
            with torch.inference_mode(), torch.cuda.graph(graph):
                outputs = list(model(static, train=False))
            self.captures += 1
            staging = warm.pin_memory()
        return _Entry(warm, graph, static, staging, outputs)

    def _fill(self, buckets: Sequence, warmup: bool) -> None:
        if len(self.models) < self.SLOTS:
            self.models.append(self._standby_model())
        for b in buckets:
            for slot in range(self.SLOTS):
                if (slot, b.index) not in self._entries:
                    entry = self._make(slot, b)
                    with self._lock:
                        self._entries[(slot, b.index)] = entry
                    if self._metrics is not None:
                        self._metrics.record_compile(hit=False, warmup=warmup)

    def warmup(self, buckets: Sequence) -> None:
        """Make the standby slot (a copy of the live weights) and every
        bucket's entry in both slots; each counts in ``compile_warmup``."""
        self._fill(buckets, warmup=True)

    def __len__(self) -> int:
        """The buckets ready in every weight slot."""
        with self._lock:
            keys = set(self._entries)
        return len({i for (_, i) in keys if all((s, i) in keys for s in range(self.SLOTS))})

    # -- running -----------------------------------------------------------

    def warm_batch(self, bucket) -> GraphBatch:
        return self._entries[(0, bucket.index)].warm

    @property
    def standby(self) -> int:
        return 1 - self.active

    def live_model(self):
        return self.models[self.active]

    def executable(self, bucket) -> Callable[[GraphBatch], List[np.ndarray]]:
        """The live slot's forward of ``bucket`` as ``f(host_batch) ->
        outputs``, counted a compile hit; a bucket not yet made is made
        here and counted a miss (only when ``warmup`` was skipped)."""
        if (0, bucket.index) not in self._entries:
            self._fill([bucket], warmup=False)
        elif self._metrics is not None:
            self._metrics.record_compile(hit=True)
        return functools.partial(self.run, None, bucket.index)

    def run(self, slot: Optional[int], bucket_index: int, batch: GraphBatch) -> List[np.ndarray]:
        """Host float32 outputs of ``batch`` (on the host, at the bucket's
        plan) through ``slot``'s entry, or the live slot's (None, read
        under the lock: a batch runs wholly on one slot)."""
        with DEVICE_LOCK.shared(), self._lock:
            slot = self.active if slot is None else slot
            entry = self._entries[(slot, bucket_index)]
            check_like(entry.warm, batch, f"bucket {bucket_index}")
            if self._metrics is not None:
                self._metrics.record_forward()
            if entry.graph is None:
                with torch.inference_mode():
                    outputs = self.models[slot](batch.to(self.device), train=False)
                return [o.float().cpu().numpy() for o in outputs]
            for (_, src), (_, stage), (_, dst) in zip(
                _tensor_fields(batch), _tensor_fields(entry.staging), _tensor_fields(entry.static)
            ):
                stage.copy_(src)
                dst.copy_(stage, non_blocking=True)
            entry.graph.replay()
            if self._metrics is not None:
                self._metrics.record_replay()
            # the copy out synchronises: the staging and static buffers
            # are free again when the lock is released, and the next
            # replay cannot touch what was handed out
            return [o.to("cpu", torch.float32, copy=True).numpy() for o in entry.outputs]

    def run_eager(self, batch: GraphBatch, model=None) -> List[np.ndarray]:
        """The live slot's eager forward of ``batch`` at any shape (the
        server's oversize path), under the same locks; or ``model``'s (a
        retrain pilot's candidate on the same device), which is not
        counted as a served forward."""
        with DEVICE_LOCK.shared(), self._lock:
            if model is None and self._metrics is not None:
                self._metrics.record_forward()
            with torch.inference_mode():
                live = self.models[self.active] if model is None else model
                outputs = live(batch.to(self.device), train=False)
            return [o.float().cpu().numpy() for o in outputs]

    # -- reload ------------------------------------------------------------

    def load_standby(self, state_dict) -> int:
        """Copy ``state_dict`` (strict) into the standby slot's weights in
        place; returns the slot. The live slot is not touched."""
        with DEVICE_LOCK.shared(), self._lock:
            slot = self.standby
            self.models[slot].load_state_dict(state_dict, strict=True)
        return slot

    def rebind(self, slot: int) -> None:
        """Make ``slot`` live; the next batch runs on it."""
        with self._lock:
            self.active = int(slot)
