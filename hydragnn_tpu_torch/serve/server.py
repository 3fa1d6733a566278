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
  - Every request carries a trace (``obs/trace.py``) and a tenant;
    :meth:`ModelServer.export_trace` writes the recent traces as Chrome
    trace JSON.
  - Observability planes, each off by default and contained (a failing
    plane records one ``error`` flight event and disarms; a request is
    never failed by it):

      * the request spool (``obs/spool.py``): every ``spool_sample``-th
        answered request into rotating container shards;
      * the drift monitor (``obs/drift.py``) against a training
        reference (``drift_ref``), publishing ``serve.drift.*`` gauges;
      * SLO and drift trigger rules (``obs/triggers.py``), evaluated on
        the dispatch thread after each batch; a rule that fires opens an
        incident bundle with a bounded profiler capture, and a drift
        incident carries ``drift_report.json`` and pins the offending
        spool shards until it closes.

    The spool and drift run on the dispatch thread on host arrays the
    server already holds: they add no device synchronisation.
  - :meth:`ModelServer.attach_pilot` and the spool and drift hooks beside
    it are the seam the retrain pilot (``pilot/pilot.py``) attaches to;
    a fleet (``fleet/fleet.py``) passes each replica's ``metrics``, so
    its counters live under ``fleet.<replica>.*`` in the fleet's
    registry.

The dispatch thread sets the server's CUDA device before it runs
anything. fsdp-sharded serving waits for ROADMAP A-5c.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from hydragnn_tpu_torch.graph.batch import batch_graphs
from hydragnn_tpu_torch.obs.export import registry_to_prometheus
from hydragnn_tpu_torch.obs.drift import DriftMonitor, load_reference
from hydragnn_tpu_torch.obs.flight import FlightRecorder
from hydragnn_tpu_torch.obs.spool import RequestSpool, read_shard_manifest
from hydragnn_tpu_torch.obs.trace import Tracer
from hydragnn_tpu_torch.obs.triggers import IncidentRecorder, TriggerEngine, TriggerRule, _atomic_json, _knob
from hydragnn_tpu_torch.resilience import inject
from hydragnn_tpu_torch.resilience.supervisor import SupervisorPolicy
from hydragnn_tpu_torch.serve.batcher import MicroBatchQueue, Overloaded, PendingRequest, ServerClosed
from hydragnn_tpu_torch.serve.buckets import Bucket, BucketGraphCache, build_bucket_ladder, eager_reason, route
from hydragnn_tpu_torch.serve.metrics import ServeMetrics
from hydragnn_tpu_torch.serve.registry import ServedModel, load_served_variables, structural_fingerprint
from hydragnn_tpu_torch.serve.supervise import DispatchSupervisor
from hydragnn_tpu_torch.utils import syncdebug


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
    slo_p99_ms, slo_queue_depth, slo_queue_age_s: SLO trigger rules
      (``obs/triggers.py``) on the latency p99, the queue depth and the
      oldest queued request's age; None disables a rule, so a default
      server runs as before. With any rule set, the dispatch loop
      evaluates them every trigger_eval_every_s and a firing rule opens
      an incident bundle (a bounded profiler capture and evidence files)
      under incident_dir (default: <log_dir>/serve/incidents).
    spool, spool_sample, spool_max_mb, spool_shard_mb, spool_dir: every
      spool_sample-th answered request (inputs, per-head predictions,
      trace, tenant, fingerprint) into rotating container shards under
      spool_dir (default <log_dir>/serve/spool), bounded to spool_max_mb
      on disk. On with spool=True, spool_sample>0 or HGTORCH_SPOOL=1;
      the 0 defaults resolve through HGTORCH_SPOOL_SAMPLE (8) and
      HGTORCH_SPOOL_MAX_MB (64).
    drift_ref: the training reference window (or HGTORCH_DRIFT_REF): a
      training flight.jsonl or a bare stats JSON. Arming it builds a
      DriftMonitor and, per threshold not None, a feature_drift,
      pred_drift or error_drift rule on the SLO rules' cadence.
      Prediction drift is baselined on the session's own first window,
      so its clean-traffic floor is a two-sample PSI and its threshold
      sits above feature drift's. drift_min_count: rows before a drift
      gauge leaves 0.
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
    slo_p99_ms: Optional[float] = None
    slo_queue_depth: Optional[int] = None
    slo_queue_age_s: Optional[float] = None
    trigger_eval_every_s: float = 1.0
    incident_dir: Optional[str] = None
    spool: bool = False
    spool_sample: int = 0
    spool_max_mb: float = 0.0
    spool_shard_mb: float = 1.0
    spool_dir: Optional[str] = None
    drift_ref: Optional[str] = None
    drift_feature_psi: Optional[float] = 0.25
    drift_pred_psi: Optional[float] = 0.5
    drift_error_score: Optional[float] = 3.0
    drift_min_count: int = 64
    cuda_graphs: bool = True


DRIFT_KINDS = ("feature_drift", "pred_drift", "error_drift")


def _env_on(name: str) -> bool:
    """A switch that is off unless set to something other than 0, false,
    off or no."""
    v = os.environ.get(name, "").strip().lower()
    return v not in ("", "0", "false", "off", "no")


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
    and fix the request field spec every request must match. ``metrics``
    (a :class:`ServeMetrics`, its registry and prefix the caller's) is
    used when given, else the server makes its own. ``flight``
    (``obs/flight.py``) receives the serving manifest at ``start()``,
    the fault events and ``run_end`` at ``stop()``."""

    def __init__(
        self,
        served: ServedModel,
        reference_samples: Sequence,
        config: Optional[ServeConfig] = None,
        metrics: Optional[ServeMetrics] = None,
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
        self.metrics = (metrics if metrics is not None
                        else ServeMetrics(len(self.buckets), latency_window=self.config.latency_window))
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
        self._eager_lock = syncdebug.maybe_wrap(threading.Lock(), "server.ModelServer._eager_lock")
        self._seq = itertools.count()  # admission sequence (the injections' anchor)
        self._dispatched_batches = 0  # the dispatch thread's alone
        self._reload_lock = syncdebug.maybe_wrap(threading.Lock(), "server.ModelServer._reload_lock")
        # lifecycle state, written by the owning thread in start()/stop()
        self._started = False
        self._stopped = False
        self._supervisor: Optional[DispatchSupervisor] = None
        self._tracer: Optional[Tracer] = None
        self.log_dir = "./logs/"  # reload()'s default checkpoint root (api.serve_model stamps it)
        # the triggers, the spool and the drift monitor are built in
        # start(); the dispatch thread alone feeds them, and alone
        # disarms the spool and drift after a failure
        self._triggers: Optional[TriggerEngine] = None
        self._incidents: Optional[IncidentRecorder] = None
        self._last_trigger_eval = 0.0  # the dispatch thread's alone
        self._spool: Optional[RequestSpool] = None
        self._drift: Optional[DriftMonitor] = None
        # the spool and drift blocks start() writes into run_start
        self.obs_arming: Dict[str, Any] = {"spool": {"enabled": False}, "drift": {"armed": False}}
        self._t_started = 0.0
        self._pilot = None  # attach_pilot(), before traffic
        self._pin_lock = syncdebug.maybe_wrap(threading.Lock(), "server.ModelServer._pin_lock")
        # spool shards pinned for each open incident, released by the
        # recorder's on_close: no bundle points at evicted traffic
        self._incident_pins: Dict[str, List[str]] = {}  # guarded by _pin_lock

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
        # built before start_run, so the manifest says whether they are armed
        spool_block, drift_block = self._build_spool_drift()
        self.obs_arming = {"spool": spool_block, "drift": drift_block}
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
                "spool": spool_block,
                "drift": drift_block,
            },
            device=self.device,
        )
        self._t_started = t0
        cfg = self.config
        self._tracer = Tracer(flight=self.flight)
        # the SLO and drift rules; none set leaves both None and the
        # dispatch loop pays one attribute check a batch
        mp = self.metrics.prefix
        rules = []
        for name, kind, metric, thresh in (
            ("serve_p99", "latency_p99", "latency_s", None if cfg.slo_p99_ms is None else cfg.slo_p99_ms / 1e3),
            ("serve_queue_depth", "queue_depth", "queue_depth", cfg.slo_queue_depth),
            ("serve_queue_age", "queue_age", "queue_oldest_age_s", cfg.slo_queue_age_s),
        ):
            if thresh is not None:
                rules.append(TriggerRule(name, kind, f"{mp}.{metric}", float(thresh)))
        if self._drift is not None:
            # a drift incident's bundle carries the drift report and the
            # offending spool window (_attach_drift_evidence)
            for name, kind, gauge, thresh in (
                ("serve_feature_drift", "feature_drift", "drift.feature_psi", cfg.drift_feature_psi),
                ("serve_pred_drift", "pred_drift", "drift.pred_psi", cfg.drift_pred_psi),
                ("serve_error_drift", "error_drift", "drift.error_score", cfg.drift_error_score),
            ):
                if thresh is not None:
                    rules.append(TriggerRule(name, kind, f"{mp}.{gauge}", float(thresh)))
        if rules:
            self._triggers = TriggerEngine(rules, registry=self.metrics.registry)
            self._incidents = IncidentRecorder(
                cfg.incident_dir or os.path.join(self.log_dir, "serve", "incidents"),
                registry=self.metrics.registry,
                flight_path=self.flight.path,
                on_close=self._on_incident_close,
                device=self.device,
            )
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
                self._end_run()

    def _end_run(self) -> None:
        """``run_end`` with the metrics and the planes' blocks: any open
        incident is closed first, so the triggers block counts it."""
        extra: Dict[str, Any] = {}
        if self._incidents is not None:
            self._incidents.finalize()
        if self._triggers is not None:
            extra["triggers"] = self._triggers.summary(self._incidents.capture_s if self._incidents else 0.0)
        if self._spool is not None:
            # the tail shard flushed, and the spool's cost as a share of
            # the serving wall time
            spool_summary = self._spool.finalize()
            wall = max(time.monotonic() - self._t_started, 1e-9)
            spool_summary["overhead_frac"] = round(spool_summary["overhead_s"] / wall, 6)
            extra["spool"] = spool_summary
        if self._drift is not None:
            extra["drift"] = self._drift.summary()
        self.flight.end_run(status="stopped", metrics=self.metrics_snapshot(), **extra)

    def _build_spool_drift(self) -> tuple:
        """Build the spool and the drift monitor as configured (the
        ``ServeConfig`` fields win over ``HGTORCH_SPOOL``,
        ``HGTORCH_SPOOL_SAMPLE``, ``HGTORCH_SPOOL_MAX_MB`` and
        ``HGTORCH_DRIFT_REF``); returns the two manifest blocks. A
        reference that fails to load raises here: serving unmonitored
        when monitoring was asked for is what this plane prevents."""
        cfg = self.config
        spool_block: Dict[str, Any] = {"enabled": False}
        if cfg.spool or cfg.spool_sample > 0 or _env_on("HGTORCH_SPOOL"):
            sample = int(cfg.spool_sample or _knob("HGTORCH_SPOOL_SAMPLE", 8))
            max_mb = float(cfg.spool_max_mb or _knob("HGTORCH_SPOOL_MAX_MB", 64.0))
            mcfg = self.served.cfg
            self._spool = RequestSpool(
                cfg.spool_dir or os.path.join(self.log_dir, "serve", "spool"),
                sample_every=sample,
                max_mb=max_mb,
                shard_mb=cfg.spool_shard_mb,
                model_fingerprint=structural_fingerprint(self.served.model.state_dict()),
                head_kinds={mcfg.output_names[i]: mcfg.output_type[i] for i in range(mcfg.num_heads)},
                flight=self.flight,
            )
            spool_block = {"enabled": True, "dir": self._spool.root, "sample_every": sample, "max_mb": max_mb}
        drift_block: Dict[str, Any] = {"armed": False}
        ref_path = cfg.drift_ref or os.environ.get("HGTORCH_DRIFT_REF") or None
        if ref_path:
            self._drift = DriftMonitor(load_reference(ref_path), self.metrics.registry, prefix=self.metrics.prefix,
                                       min_count=cfg.drift_min_count)
            drift_block = {
                "armed": True,
                "ref": ref_path,
                "channels": self._drift.num_channels,
                "min_count": cfg.drift_min_count,
                "thresholds": {"feature_psi": cfg.drift_feature_psi, "pred_psi": cfg.drift_pred_psi,
                               "error_score": cfg.drift_error_score},
            }
        return spool_block, drift_block

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
        # the injected covariate shift, at admission: the sketches and
        # the model both see it
        g["x"] = inject.maybe_drift_shift(g["x"])
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
        the health gauges refreshed first. On a pod host other than 0 the
        path takes the host's index (``x.host<k>.prom``,
        ``obs/podview.py:host_artifact_path``), so hosts never overwrite
        each other's file."""
        from hydragnn_tpu_torch.obs.podview import host_artifact_path

        self.health()
        registry_to_prometheus(self.metrics.registry, host_artifact_path(path))

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
        if self._drift is not None or self._spool is not None:
            self._observe_answered(g, result, trace, tenant, seq)
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
                self._maybe_trigger()
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
                # everything in hand is host-side numpy: no device sync
                if self._drift is not None or self._spool is not None:
                    self._observe_answered(r.item, result, r.trace, r.tenant, r.seq)
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

    # -- spool, drift, triggers -------------------------------------------

    def _observe_answered(self, g: Dict[str, Any], result: Dict[str, np.ndarray], trace, tenant: str,
                          seq: int) -> None:
        """Feed one answered request to the drift monitor and the spool.
        Contained: a failing plane records one ``error`` flight event
        (``where="spool_drift"``) and both planes disarm."""
        try:
            if self._drift is not None:
                self._drift.observe(np.asarray(g["x"]), result)
            if self._spool is not None:
                self._spool.offer(g, result, trace=trace.trace_id if trace is not None else None, tenant=tenant,
                                  seq=seq)
        except Exception as exc:
            self.flight.error(exc, where="spool_drift")
            self._drift = None
            self._spool = None

    def _maybe_trigger(self) -> None:
        """After each batch: drive an open incident's bounded capture,
        then (every ``trigger_eval_every_s``) evaluate the rules.
        Contained: a failure records an ``error`` flight event
        (``where="trigger_engine"``) and the dispatch thread goes on."""
        trig, inc = self._triggers, self._incidents
        if trig is None or inc is None:
            return
        try:
            inc.tick()
            now = time.monotonic()
            if now - self._last_trigger_eval < self.config.trigger_eval_every_s:
                return
            self._last_trigger_eval = now
            for verdict in trig.evaluate():
                opened = inc.open_incident(verdict, flight=self.flight)
                if opened is None:
                    continue
                if verdict.kind in DRIFT_KINDS:
                    self._attach_drift_evidence(opened, verdict)
                    if self._pilot is not None:
                        # the pilot owns its failures past this handoff
                        try:
                            self._pilot.on_drift_incident(opened, verdict)
                        except Exception as exc:
                            self.flight.error(exc, where="pilot_notify")
                opened.tick()  # the capture starts on this batch
        except Exception as exc:
            self.flight.error(exc, where="trigger_engine")

    def _attach_drift_evidence(self, opened, verdict) -> None:
        """Write the drift report and the offending spool window into the
        bundle as ``drift_report.json`` and record a ``drift`` flight
        event. The window's shards are pinned against eviction until the
        incident closes (``_on_incident_close``), and each one's
        ``spool_manifest.json`` is copied under ``spool_manifests/``."""
        report = self._drift.report() if self._drift is not None else {}
        window: Dict[str, Any] = {}
        if self._spool is not None:
            # the traffic that tripped the rule is mostly in the open
            # pending shard: cut it, so the window covers it
            self._spool.flush_pending()
            window = self._spool.window()
        pinned: List[str] = []
        if self._spool is not None and window.get("shards"):
            pinned = self._spool.pin(window["shards"])
            with self._pin_lock:
                self._incident_pins[opened.id] = list(pinned)
            mdir = os.path.join(opened.dir, "spool_manifests")
            os.makedirs(mdir, exist_ok=True)
            for name in pinned:
                try:
                    man = read_shard_manifest(os.path.join(window["dir"], name))
                except (OSError, ValueError):
                    continue  # an unreadable manifest; the pin still holds the shard
                _atomic_json(os.path.join(mdir, f"{name}.json"), man)
                opened.files[f"spool_manifest/{name}"] = os.path.join("spool_manifests", f"{name}.json")
        report["spool_window"] = window
        report["pinned_shards"] = pinned
        report["trigger"] = verdict.to_dict()
        _atomic_json(os.path.join(opened.dir, "drift_report.json"), report)
        opened.files["drift_report"] = "drift_report.json"
        self.flight.record("drift", rule=verdict.rule, rule_kind=verdict.kind, metric=verdict.metric,
                           observed=verdict.observed, threshold=verdict.threshold, spool_window=window,
                           pinned_shards=pinned)

    def _on_incident_close(self, inc, status: str) -> None:
        """The recorder's close hook: release the spool pins taken for
        the incident's drift evidence (a retrain pilot holds pins of its
        own)."""
        with self._pin_lock:
            pinned = self._incident_pins.pop(inc.id, None)
        if pinned and self._spool is not None:
            self._spool.unpin(pinned)

    # -- the retrain pilot's seam ------------------------------------------

    def attach_pilot(self, pilot) -> None:
        """Forward every drift incident to ``pilot.on_drift_incident(
        incident, verdict)`` once its evidence is in the bundle."""
        self._pilot = pilot

    def pin_spool(self, shards) -> List[str]:
        """Pin spool shards against eviction (reference counted); returns
        the names pinned, [] without a spool."""
        if self._spool is None:
            return []
        return self._spool.pin(shards)

    def unpin_spool(self, shards) -> None:
        if self._spool is not None:
            self._spool.unpin(shards)

    def spool_dir(self) -> Optional[str]:
        return self._spool.root if self._spool is not None else None

    def reset_drift(self) -> None:
        """Drop the drift monitor's sketches (the reference stays): after
        a reload, the rules re-arm against the new weights."""
        if self._drift is not None:
            self._drift.reset()

    def open_pilot_incident(self, verdict):
        """An escalation bundle for a pilot's terminal state; None while
        another incident's capture runs (one at a time). The dispatch
        loop's ticks drive its capture and close."""
        if self._incidents is None:
            return None
        return self._incidents.open_incident(verdict, flight=self.flight)

    def export_trace(self, path: str) -> Optional[str]:
        """The tracer's recent requests as Chrome/Perfetto trace JSON at
        ``path``; returns it (None with tracing off)."""
        if self._tracer is None or not self._tracer.enabled:
            return None
        return self._tracer.export_chrome(path)

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
