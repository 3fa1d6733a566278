"""ModelServer: the batched online-inference front end.

The port's counterpart of ``hydragnn_tpu/serve/server.py``. Requests
(single prepared graphs) -> bucket router (``buckets.py``) -> deadline
micro-batcher (``batcher.py``) -> one dispatch thread that pads the
coalesced batch to the bucket's plan, replays the bucket's CUDA graph
(``buckets.py:BucketGraphCache``, captured at ``start()``) and slices
per-request results out of the padded outputs.

  - A graph over every routing cap but within the largest bucket's pad
    plan dispatches at once as a batch of one on that bucket.
  - A graph over even that takes the eager path at its own natural pad
    (``eager_fallback``, counted a compile miss per new shape), else
    fails with :class:`Oversize`.
  - A full queue rejects with :class:`Overloaded`; a stopped server
    rejects with :class:`ServerClosed`, typed and at once.
  - A request whose forward raises or whose outputs are not finite
    (``check_finite``) fails only its own future with
    :class:`RequestFailed`; a failing multi-request batch is re-run as
    singles once to find the poison, which is quarantined (a
    ``quarantine`` flight event).
  - The dispatch thread runs under ``supervise.py:DispatchSupervisor``:
    restarted with backoff when it dies (``dispatch_restart``), watched
    by a re-armed hang watchdog.
  - :meth:`ModelServer.health` is the liveness and readiness probe;
    :meth:`ModelServer.export_prometheus` writes it with the metrics to
    the Prometheus textfile ``tools/serve_probe.py`` reads.
  - :meth:`ModelServer.reload` swaps in new weights with no capture and
    no pause: into the standby weight slot, canaried on every bucket's
    graph, then made live; any failure rolls back (:class:`ReloadFailed`).
  - Every request carries a trace (``obs/trace.py``) and a tenant.

The dispatch thread sets the server's CUDA device before it runs
anything. Waiting for later slices: the spool, drift, the serving
triggers and their incidents, the retrain pilot and the Chrome trace
export (ROADMAP A-6b, A-7); fsdp-sharded serving (A-5).
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from hydragnn_tpu_torch.graph.batch import batch_graphs
from hydragnn_tpu_torch.obs.export import registry_to_prometheus
from hydragnn_tpu_torch.obs.flight import FlightRecorder
from hydragnn_tpu_torch.obs.trace import Tracer
from hydragnn_tpu_torch.resilience import inject
from hydragnn_tpu_torch.resilience.supervisor import SupervisorPolicy
from hydragnn_tpu_torch.serve.batcher import MicroBatchQueue, Overloaded, PendingRequest, ServerClosed
from hydragnn_tpu_torch.serve.buckets import Bucket, BucketGraphCache, build_bucket_ladder, eager_reason, route
from hydragnn_tpu_torch.serve.metrics import ServeMetrics
from hydragnn_tpu_torch.serve.registry import ServedModel, load_served_variables
from hydragnn_tpu_torch.serve.supervise import DispatchSupervisor


class Oversize(RuntimeError):
    """Request exceeds every bucket and the eager fallback is disabled."""


class RequestFailed(RuntimeError):
    """One request's forward raised or produced non-finite outputs.
    ``reason`` is ``"exception"``, ``"nonfinite"`` or ``"dispatch"`` (the
    dispatch thread died with the batch in hand, or its supervisor gave
    up)."""

    def __init__(self, message: str, seq: int = -1, reason: str = "exception"):
        super().__init__(message)
        self.seq = seq
        self.reason = reason


class ReloadFailed(RuntimeError):
    """A reload's candidate weights failed to load or failed the canary;
    the previous weights are still serving."""


def _corrupt_state(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Torn-reload injection: every float tensor NaN."""
    return {k: torch.full_like(v, float("nan")) if v.is_floating_point() else v for k, v in state.items()}


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Knobs of the serving path (the JAX package's names and defaults).

    max_batch: graphs coalesced per device dispatch.
    num_buckets: pad-plan ladder size (before dedup of identical plans).
    max_delay_ms: deadline before a partial batch flushes.
    max_pending: bounded queue across all buckets (then Overloaded).
    eager_fallback: natural-pad path for graphs beyond every plan.
    check_finite: fail requests whose outputs are not all finite.
    dispatch_stall_s: the watchdog's threshold for a wedged forward
      (liveness turns false after this long with a batch in flight).
    max_dispatch_restarts, dispatch_backoff_*: the restart policy of a
      dead dispatch thread (SupervisorPolicy; backoff from 50 ms).
    ready_queue_highwater: readiness turns false when the queue holds
      more than this fraction of max_pending.
    prometheus_path: when set, the supervisor's monitor writes the
      health and metrics textfile there every prometheus_every_s.
    cuda_graphs: one CUDA graph per bucket on the card; False serves
      every bucket by the eager forward on the card (the port's own
      knob: the baseline the graphs are timed against).
    """

    max_batch: int = 8
    num_buckets: int = 3
    max_delay_ms: float = 5.0
    max_pending: int = 256
    node_multiple: int = 16
    edge_multiple: int = 8
    eager_fallback: bool = True
    latency_window: int = 2048
    check_finite: bool = True
    dispatch_stall_s: float = 30.0
    max_dispatch_restarts: int = 5
    dispatch_backoff_base_s: float = 0.05
    dispatch_backoff_factor: float = 2.0
    dispatch_backoff_max_s: float = 2.0
    ready_queue_highwater: float = 0.9
    prometheus_path: Optional[str] = None
    prometheus_every_s: float = 5.0
    cuda_graphs: bool = True


def request_to_dict(sample: Any) -> Dict[str, Any]:
    """Normalize a request (GraphSample or graph dict) to the dict form
    ``batch_graphs`` consumes, without targets."""
    if isinstance(sample, dict):
        g = dict(sample)
        if "senders" not in g:
            ei = g.pop("edge_index", None)
            if ei is None:
                raise ValueError("request dict needs 'senders'/'receivers' or 'edge_index'")
            ei = np.asarray(ei)
            g["senders"], g["receivers"] = ei[0], ei[1]
    else:
        if getattr(sample, "edge_index", None) is None:
            raise ValueError("request sample has no edge_index (no edges built)")
        g = {"x": sample.x, "senders": sample.edge_index[0], "receivers": sample.edge_index[1]}
        if getattr(sample, "pos", None) is not None:
            g["pos"] = sample.pos
        if getattr(sample, "edge_attr", None) is not None:
            g["edge_attr"] = sample.edge_attr
    g.pop("graph_targets", None)
    g.pop("node_targets", None)
    return g


def _dict_sizes(g: Dict[str, Any]) -> tuple:
    return int(np.asarray(g["x"]).shape[0]), int(np.asarray(g["senders"]).shape[0])


def _result_finite(result: Dict[str, np.ndarray]) -> bool:
    return all(np.all(np.isfinite(v)) for v in result.values())


class ModelServer:
    """Batched online inference over one :class:`ServedModel`.

    ``reference_samples`` (the prepared dataset) size the bucket ladder
    and fix the request field spec every request must match. ``flight``
    (``obs/flight.py``) receives the serving manifest at ``start()``,
    the fault events and ``run_end`` at ``stop()``."""

    def __init__(
        self,
        served: ServedModel,
        reference_samples: Sequence,
        config: Optional[ServeConfig] = None,
        flight: Optional[FlightRecorder] = None,
    ):
        if not reference_samples:
            raise ValueError("reference_samples must be non-empty (sizes the buckets)")
        self.served = served
        self.device = served.device
        self.config = config or ServeConfig()
        self.reference_samples = list(reference_samples)
        self.buckets: List[Bucket] = build_bucket_ladder(
            self.reference_samples,
            self.config.max_batch,
            num_buckets=self.config.num_buckets,
            node_multiple=self.config.node_multiple,
            edge_multiple=self.config.edge_multiple,
        )
        self.metrics = ServeMetrics(len(self.buckets), latency_window=self.config.latency_window)
        ref = request_to_dict(self.reference_samples[0])
        ref_x = np.asarray(ref["x"])
        ref_ea = np.asarray(ref["edge_attr"]) if "edge_attr" in ref else None
        self._spec = {
            "feat_dim": int(ref_x.shape[1]) if ref_x.ndim > 1 else 1,
            "has_pos": "pos" in ref,
            "pos_dim": int(np.asarray(ref["pos"]).shape[-1]) if "pos" in ref else 0,
            "has_edge_attr": ref_ea is not None,
            "edge_dim": (int(ref_ea.shape[-1]) if ref_ea.ndim > 1 else 1) if ref_ea is not None else 0,
        }
        self.flight = flight if flight is not None else FlightRecorder(None, enabled=False)
        self._cache = BucketGraphCache(
            served.model,
            self._build_warm_batch,
            self.device,
            metrics=self.metrics,
            reason=eager_reason(served.cfg, self.device, self.config.cuda_graphs),
        )
        self._queue = MicroBatchQueue(
            len(self.buckets), self.config.max_batch, self.config.max_delay_ms / 1e3, self.config.max_pending
        )
        self._eager_shapes: set = set()  # guarded by _eager_lock
        self._eager_lock = threading.Lock()
        self._seq = itertools.count()  # admission sequence (the injections' anchor)
        self._dispatched_batches = 0  # the dispatch thread's alone
        self._reload_lock = threading.Lock()
        # lifecycle state, written by the owning thread in start()/stop()
        self._started = False
        self._stopped = False
        self._supervisor: Optional[DispatchSupervisor] = None
        self._tracer: Optional[Tracer] = None
        self.log_dir = "./logs/"  # reload()'s default checkpoint root (api.serve_model stamps it)

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "ModelServer":
        """Capture every bucket's graph in both weight slots, write the
        serving manifest, then start the dispatch thread under its
        supervisor. Returns self. A failed capture raises here."""
        if self._started:
            return self
        if self._stopped:
            raise ServerClosed("server was stopped; build a new one")
        t0 = time.monotonic()
        self._cache.warmup(self.buckets)
        cache = self._cache
        self.flight.start_run(
            {
                "mode": "serve",
                "serve_config": dataclasses.asdict(self.config),
                "request_spec": dict(self._spec),
                "buckets": [
                    {
                        "cap_nodes": b.cap_nodes,
                        "cap_edges": b.cap_edges,
                        "node_pad": b.node_pad,
                        "edge_pad": b.edge_pad,
                        "graph_pad": b.graph_pad,
                        "cuda_graph": cache.graphs,
                    }
                    for b in self.buckets
                ],
                "warmup_compile_s": round(time.monotonic() - t0, 3),
                "bucket_executor": "cuda_graph" if cache.graphs else "eager",
                "eager_reason": cache.reason,
                "weight_slots": cache.SLOTS,
                "compile_warmup": f"CUDA graph captures, one a bucket and weight slot: {cache.captures}",
                "model": {"model_type": self.served.cfg.model_type, "hidden_dim": self.served.cfg.hidden_dim,
                          "num_conv_layers": self.served.cfg.num_conv_layers, "heads": self.served.cfg.num_heads},
            },
            device=self.device,
        )
        cfg = self.config
        self._tracer = Tracer(flight=self.flight)
        self._supervisor = DispatchSupervisor(
            self._run,
            policy=SupervisorPolicy(
                max_restarts=cfg.max_dispatch_restarts,
                backoff_base_s=cfg.dispatch_backoff_base_s,
                backoff_factor=cfg.dispatch_backoff_factor,
                backoff_max_s=cfg.dispatch_backoff_max_s,
            ),
            stall_s=cfg.dispatch_stall_s,
            flight=self.flight,
            metrics=self.metrics,
            on_giveup=self._on_dispatch_giveup,
            on_tick=self._export_tick if cfg.prometheus_path else None,
            tick_every_s=cfg.prometheus_every_s,
        )
        self._started = True
        self._supervisor.start()
        return self

    def stop(self, timeout: Optional[float] = 10.0) -> None:
        """Stop admitting, drain what is queued, join the dispatch
        thread, write ``run_end`` with the metrics."""
        was_started = self._started
        self._stopped = True
        self._queue.close()
        try:
            if self._supervisor is not None:
                self._supervisor.stop(timeout)
        finally:
            self._started = False
            if was_started:
                self.flight.end_run(status="stopped", metrics=self.metrics_snapshot())

    def _on_dispatch_giveup(self, exc: BaseException) -> None:
        """The restart budget is spent: close admission and fail every
        queued future with the typed error."""
        self._queue.close()
        self._queue.cancel_pending(
            RequestFailed(
                f"dispatch supervisor gave up after {self.config.max_dispatch_restarts} restarts: {exc!r}",
                reason="dispatch",
            )
        )
        self.flight.error(exc, where="dispatch_giveup")

    def __enter__(self) -> "ModelServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- request path ------------------------------------------------------

    def submit(self, sample: Any, tenant: str = "default") -> Future:
        """Admit one graph; returns a Future resolving to
        ``{head_name: np.ndarray}`` (graph heads [d]; node heads
        [n_nodes, d]). Raises Overloaded, or ServerClosed after stop()
        or a supervisor give-up. ``tenant`` rides with the request."""
        if self._stopped or (self._supervisor is not None and self._supervisor.failed):
            raise ServerClosed("server is stopped; submissions are rejected")
        if not self._started:
            raise RuntimeError("server not started (call start())")
        g = self._validated(request_to_dict(sample))
        n, e = _dict_sizes(g)
        seq = next(self._seq)
        trace = self._tracer.begin(seq=seq, tenant=tenant) if self._tracer is not None else None
        bucket = route(self.buckets, n, e)
        if bucket is None:
            return self._submit_oversize(g, n, e, seq, trace, tenant)
        if trace is not None:
            trace.mark("serve.route", bucket=bucket.index)
        self.metrics.record_request(bucket.index)
        try:
            fut = self._queue.put(bucket.index, g, seq=seq, trace=trace, tenant=tenant)
        except Overloaded:
            self.metrics.record_reject()
            raise
        self.metrics.set_queue_depth(self._queue.depth(), self._queue.oldest_age_s())
        return fut

    def predict(self, sample: Any, timeout: Optional[float] = None) -> Dict[str, np.ndarray]:
        return self.submit(sample).result(timeout)

    def predict_many(self, samples: Sequence[Any], timeout: Optional[float] = None) -> List[Dict[str, np.ndarray]]:
        futures = [self.submit(s) for s in samples]
        return [f.result(timeout) for f in futures]

    def metrics_snapshot(self) -> dict:
        return self.metrics.snapshot()

    def queue_depth(self) -> int:
        """Requests queued in all buckets."""
        return self._queue.depth()

    # -- health / probes ---------------------------------------------------

    def health(self) -> Dict[str, Any]:
        """Liveness and readiness, with the JAX package's fields and
        reasons. Live: started, the dispatch thread alive and beating (a
        forward wedged past ``dispatch_stall_s`` turns it false; a
        supervisor give-up keeps it false). Ready: live, every bucket
        warm in both weight slots, the queue under the high-water mark.
        ``bucket_executor`` and ``eager_reason`` say how buckets run."""
        sup = self._supervisor
        started = self._started and not self._stopped
        alive = bool(sup is not None and sup.alive)
        stalled = bool(sup is not None and sup.stalled)
        failed = bool(sup is not None and sup.failed)
        hb_age = sup.heartbeat_age() if sup is not None else None
        live = started and alive and not stalled and not failed
        warm = len(self._cache)
        depth = self._queue.depth()
        highwater = max(1, int(self.config.ready_queue_highwater * self.config.max_pending))
        ready = live and warm >= len(self.buckets) and depth < highwater
        reasons = []
        if not started:
            reasons.append("not started" if not self._stopped else "stopped")
        if started and not alive:
            reasons.append("dispatch thread down")
        if stalled:
            reasons.append(f"dispatch stalled (heartbeat {hb_age:.1f}s)")
        if failed:
            reasons.append("dispatch supervisor gave up")
        if warm < len(self.buckets):
            reasons.append(f"buckets warming ({warm}/{len(self.buckets)})")
        if depth >= highwater:
            reasons.append(f"queue over high-water ({depth}/{highwater})")
        self.metrics.set_health(live, ready, hb_age, warm)
        self.metrics.set_queue_depth(depth, self._queue.oldest_age_s())
        return {
            "live": live,
            "ready": ready,
            "dispatch_alive": alive,
            "dispatch_stalled": stalled,
            "dispatch_failed": failed,
            "heartbeat_age_s": round(hb_age, 3) if hb_age is not None else None,
            "warm_buckets": warm,
            "num_buckets": len(self.buckets),
            "queue_depth": depth,
            "queue_highwater": highwater,
            "dispatch_restarts": sup.restarts if sup is not None else 0,
            "bucket_executor": "cuda_graph" if self._cache.graphs else "eager",
            "eager_reason": self._cache.reason,
            "reasons": reasons,
        }

    def export_prometheus(self, path: str) -> None:
        """Write the metrics as a Prometheus textfile (atomic rename),
        the health gauges refreshed first."""
        self.health()
        registry_to_prometheus(self.metrics.registry, path)

    def _export_tick(self) -> None:
        """The supervisor monitor's periodic export."""
        self.export_prometheus(self.config.prometheus_path)

    # -- reload ------------------------------------------------------------

    def reload(
        self,
        checkpoint: Optional[str] = None,
        *,
        variables: Optional[Dict[str, torch.Tensor]] = None,
        log_dir: Optional[str] = None,
    ) -> Dict[str, Any]:
        """Swap in new weights with no capture and no pause.

        ``checkpoint`` is a run name restored through the validating
        loader under ``log_dir`` (default: the server's ``log_dir``); or
        pass ``variables``, a state dict of the same architecture. The
        candidate is copied into the standby weight slot, and a canary
        replays every bucket's standby graph on its warm batch: its
        outputs must be finite. Only then does the standby slot go live
        (the next batch runs on it; a batch in flight finishes on the old
        weights). Any failure leaves the live weights untouched, records
        ``reload_failed`` and raises :class:`ReloadFailed`."""
        if (checkpoint is None) == (variables is None):
            raise ValueError("pass exactly one of checkpoint= or variables=")
        source = checkpoint if checkpoint is not None else "<variables>"
        with self._reload_lock:
            t0 = time.monotonic()
            try:
                if checkpoint is not None:
                    state = load_served_variables(self.served, checkpoint, log_dir or self.log_dir)
                else:
                    state = dict(variables)
                if inject.serve_torn_reload():
                    state = _corrupt_state(state)
                slot = self._cache.load_standby(state)
                self._canary(slot)
            except Exception as exc:
                self.metrics.record_reload(ok=False)
                self.flight.record("reload_failed", source=source, error=repr(exc)[-300:], rolled_back=True)
                raise ReloadFailed(f"reload from {source!r} failed ({exc!r}); previous weights still serving") from exc
            self._cache.rebind(slot)
            self.served.model = self._cache.live_model()
            self.metrics.record_reload(ok=True)
            info = {"source": source, "canary_buckets": len(self.buckets), "slot": slot,
                    "swap_s": round(time.monotonic() - t0, 3)}
            self.flight.record("reload", **info)
            return info

    def _canary(self, slot: int) -> None:
        """Every bucket of ``slot`` on its warm batch: all outputs
        finite, or the reload fails."""
        for b in self.buckets:
            outs = self._cache.run(slot, b.index, self._cache.warm_batch(b))
            for i, o in enumerate(outs):
                if not np.all(np.isfinite(o)):
                    raise ReloadFailed(
                        f"canary produced non-finite outputs (bucket {b.index}, head {i}): candidate weights rejected"
                    )

    # -- oversize ----------------------------------------------------------

    def _submit_oversize(self, g, n: int, e: int, seq: int, trace=None, tenant: str = "default") -> Future:
        self.metrics.record_request(None)
        fut: Future = Future()
        largest = self.buckets[-1]
        if largest.fits_totals(n, e, 1):
            # over the routing caps but within the biggest plan alone
            self.metrics.record_oversize("largest_bucket")
            if trace is not None:
                trace.mark("serve.route", oversize="largest_bucket")
            req = PendingRequest(g, fut, time.monotonic(), largest.index, seq, trace, tenant)
            self._execute_bucket(largest.index, [req], reason="oversize")
            return fut
        if not self.config.eager_fallback:
            self.metrics.record_error()
            fut.set_exception(
                Oversize(
                    f"graph ({n} nodes, {e} edges) exceeds the largest bucket plan "
                    f"{largest.node_pad}/{largest.edge_pad} and eager_fallback is disabled"
                )
            )
            return fut
        self.metrics.record_oversize("eager")
        t0 = time.monotonic()
        req = PendingRequest(g, fut, t0, -1, seq, trace, tenant)
        try:
            result = self._execute_eager(g, seq)
        except Exception as exc:
            self._quarantine(req, None, "exception", exc)
            return fut
        if self.config.check_finite and not _result_finite(result):
            self._quarantine(req, None, "nonfinite", None)
            return fut
        fut.set_result(result)
        self.metrics.observe_latency(time.monotonic() - t0)
        if trace is not None:
            trace.mark("serve.eager_execute")
            self._tracer.finish(trace)
        return fut

    def _execute_eager(self, g: Dict[str, Any], seq: int) -> Dict[str, np.ndarray]:
        """The live weights' eager forward at the graph's natural pad, on
        the server's device; a new padded shape counts a compile miss,
        a repeat a hit."""
        inject.maybe_serve_raise([seq])
        batch = batch_graphs([g], node_multiple=self.config.node_multiple, edge_multiple=self.config.edge_multiple)
        shape_key = (batch.num_nodes, batch.num_edges, batch.num_graphs)
        with self._eager_lock:
            seen = shape_key in self._eager_shapes
            self._eager_shapes.add(shape_key)
        self.metrics.record_compile(hit=seen)
        outputs = inject.maybe_serve_nan(self._cache.run_eager(batch), [seq])
        return self._slice_result(outputs, 0, 0, _dict_sizes(g)[0])

    # -- dispatch ----------------------------------------------------------

    def _run(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        sup = self._supervisor
        while True:
            sup.beat()
            got = self._queue.take_batch()
            if got is None:
                return
            bucket_index, requests, reason = got
            self.metrics.set_queue_depth(self._queue.depth(), self._queue.oldest_age_s())
            self._dispatched_batches += 1
            sup.busy(True)
            sup.beat()
            try:
                # the thread-death injection fires outside request isolation
                inject.maybe_serve_kill_dispatch(self._dispatched_batches)
                self._execute_bucket(bucket_index, requests, reason)
            except BaseException as exc:
                # dispatch-level: fail the batch in hand with the typed
                # error, then die so the supervisor restarts the loop
                self.metrics.record_error(len(requests))
                for r in requests:
                    if not r.future.done():
                        r.future.set_exception(
                            RequestFailed(f"dispatch thread died with this batch in hand: {exc!r}",
                                          seq=r.seq, reason="dispatch")
                        )
                raise
            finally:
                sup.busy(False)
                sup.beat()

    def _execute_bucket(self, bucket_index: int, requests: List[PendingRequest], reason: str,
                        singles_retry: bool = True) -> None:
        """One coalesced batch with poison isolation (module docstring)."""
        bucket = self.buckets[bucket_index]
        seqs = [r.seq for r in requests]
        for r in requests:
            if r.trace is not None:
                r.trace.mark("serve.queue_wait", reason=reason, bucket=bucket_index)
        try:
            inject.maybe_serve_wedge(seqs)
            inject.maybe_serve_raise(seqs)
            t_build0 = time.time()
            batch = batch_graphs(
                [r.item for r in requests],
                n_node_pad=bucket.node_pad,
                n_edge_pad=bucket.edge_pad,
                n_graph_pad=bucket.graph_pad,
            )
            t_exec0 = time.time()
            outputs = inject.maybe_serve_nan(self._cache.executable(bucket)(batch), seqs)
            t_exec1 = time.time()
        except Exception as exc:
            self._isolate_failure(bucket_index, requests, "exception", exc, singles_retry)
            return
        for r in requests:
            if r.trace is not None:
                r.trace.add_span("serve.batch_build", t_build0, t_exec0, occupancy=len(requests))
                r.trace.add_span("serve.device_execute", t_exec0, t_exec1, cuda_graph=self._cache.graphs)
        self.metrics.record_batch(bucket_index, len(requests), bucket.max_batch, reason)
        t_done = time.monotonic()
        node_offset = 0
        poisoned: List[PendingRequest] = []
        for gi, r in enumerate(requests):
            n, _ = _dict_sizes(r.item)
            result = self._slice_result(outputs, gi, node_offset, n)
            node_offset += n
            if self.config.check_finite and not _result_finite(result):
                poisoned.append(r)
                continue
            if not r.future.done():
                r.future.set_result(result)
                self.metrics.observe_latency(t_done - r.t_enqueue)
                if r.trace is not None:
                    r.trace.add_span("serve.postprocess", t_exec1, time.time())
                    self._tracer.finish(r.trace)
                    r.trace = None
        if poisoned:
            self._isolate_failure(bucket_index, poisoned, "nonfinite", None, singles_retry)

    def _isolate_failure(self, bucket_index, requests, kind, exc, singles_retry) -> None:
        if len(requests) > 1 and singles_retry:
            # a co-batched failure cannot be attributed: each request
            # alone on the same bucket; the poison fails again
            self.metrics.record_poison_retry(len(requests))
            for r in requests:
                self._execute_bucket(bucket_index, [r], "retry_single", singles_retry=False)
            return
        for r in requests:
            self._quarantine(r, bucket_index, kind, exc)

    def _quarantine(self, r: PendingRequest, bucket_index: Optional[int], kind: str,
                    exc: Optional[BaseException]) -> None:
        """Fail one request's future with the typed error, count it and
        record a ``quarantine`` flight event."""
        self.metrics.record_quarantine()
        self.metrics.record_error()
        detail = repr(exc) if exc is not None else "non-finite outputs"
        self.flight.record("quarantine", seq=r.seq, reason=kind, bucket=bucket_index, error=detail[-300:])
        if not r.future.done():
            r.future.set_exception(
                RequestFailed(f"request seq={r.seq} quarantined ({kind}): {detail}", seq=r.seq, reason=kind)
            )
        if r.trace is not None and self._tracer is not None:
            r.trace.mark("serve.quarantine", reason=kind)
            self._tracer.finish(r.trace)
            r.trace = None

    def _slice_result(self, outputs, graph_index: int, node_offset: int, num_nodes: int):
        cfg = self.served.cfg
        result: Dict[str, np.ndarray] = {}
        for ihead in range(cfg.num_heads):
            out = outputs[ihead]
            if cfg.output_type[ihead] == "graph":
                result[cfg.output_names[ihead]] = out[graph_index]
            else:
                result[cfg.output_names[ihead]] = out[node_offset : node_offset + num_nodes]
        return result

    # -- batch construction ------------------------------------------------

    def _validated(self, g: Dict[str, Any]) -> Dict[str, Any]:
        """Enforce the field spec at admission, not inside the executor."""
        spec = self._spec
        x = np.asarray(g["x"])
        feat = x.shape[1] if x.ndim > 1 else 1
        if feat != spec["feat_dim"]:
            raise ValueError(f"request feature width {feat} != model's {spec['feat_dim']}")
        for key, flag in (("pos", "has_pos"), ("edge_attr", "has_edge_attr")):
            if (key in g) != spec[flag]:
                raise ValueError(
                    f"request '{key}' presence does not match the serving spec "
                    f"(expected {'present' if spec[flag] else 'absent'})"
                )
        return g

    def _build_warm_batch(self, bucket: Bucket):
        """A batch at ``bucket``'s plan from one minimal graph matching
        the field spec, built as request batches are: the batch a
        bucket's graph is captured on and the canary replays."""
        spec = self._spec
        g: Dict[str, Any] = {
            "x": np.zeros((2, spec["feat_dim"]), dtype=np.float32),
            "senders": np.zeros((1,), dtype=np.int32),
            "receivers": np.ones((1,), dtype=np.int32),
        }
        if spec["has_pos"]:
            g["pos"] = np.zeros((2, spec["pos_dim"]), dtype=np.float32)
        if spec["has_edge_attr"]:
            g["edge_attr"] = np.zeros((1, spec["edge_dim"]), dtype=np.float32)
        return batch_graphs([g], n_node_pad=bucket.node_pad, n_edge_pad=bucket.edge_pad, n_graph_pad=bucket.graph_pad)
