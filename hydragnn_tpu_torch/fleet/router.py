"""The fleet's admission front door: tenancy, quotas, priorities and
placement (the port's counterpart of ``hydragnn_tpu/fleet/router.py``,
with its gates, typed rejections, counters and trace marks).

Every request enters the fleet here. Admission runs four gates in order,
each with its typed rejection and counter:

  1. **tenant quota**: a token bucket a tenant (``rate`` tokens/s refill
     up to ``burst``; an admission costs one). An empty bucket raises
     :class:`TenantOverloaded`, an ``Overloaded`` carrying the tenant and
     the admission trace id.
  2. **priority shedding**: quotas carry a priority class (``premium``,
     ``standard``, ``batch``). At a fleet-wide in-flight load of
     ``RouterConfig.shed_load``, ``batch`` traffic is shed first; off when
     ``shed_load`` is None.
  3. **placement**: least-loaded routing among the READY replicas serving
     the model (paused and draining ones excluded); none ready ->
     ``Overloaded``.
  4. **replica-death retry**: a future that fails with the dispatch death
     signature (``RequestFailed(reason="dispatch")`` or ``ServerClosed``)
     is resubmitted once to a DIFFERENT replica: a replica killed under
     traffic costs latency, not answers.

Per-tenant metrics land on the fleet registry
(``fleet.tenant.<tenant>.{requests,rejected,latency_s}``) beside the
aggregates the autoscaler's rules read (``fleet.queue_depth``,
``fleet.latency_s``). A trace begins AT ADMISSION with the tenant and
model in its attributes (``obs/trace.py``).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, List, Optional

from hydragnn_tpu_torch.fleet.replica import FleetReplica
from hydragnn_tpu_torch.obs.trace import Tracer
from hydragnn_tpu_torch.obs.triggers import _knob
from hydragnn_tpu_torch.serve.batcher import Overloaded, ServerClosed
from hydragnn_tpu_torch.serve.server import RequestFailed
from hydragnn_tpu_torch.utils import syncdebug

PRIORITIES = ("premium", "standard", "batch")


class TenantOverloaded(Overloaded):
    """A tenant's quota (or the shed gate) rejected the request; carries
    ``tenant`` and the admission ``trace_id``."""

    def __init__(self, message: str, tenant: str, trace_id: Optional[str] = None):
        super().__init__(message)
        self.tenant = tenant
        self.trace_id = trace_id


@dataclasses.dataclass(frozen=True)
class TenantQuota:
    """One tenant's admission contract: ``rate`` requests/s refilling up
    to ``burst`` tokens (rate 0: unlimited), and the priority class the
    shed gate orders by."""

    rate: float = 0.0
    burst: float = 32.0
    priority: str = "standard"

    def __post_init__(self):
        if self.priority not in PRIORITIES:
            raise ValueError(f"unknown priority {self.priority!r} (one of {PRIORITIES})")


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    """The router's policy. ``default_rate``/``default_burst`` default to
    the ``HGTORCH_FLEET_TENANT_RATE``/``_BURST`` knobs (0 and 32) for
    tenants without a quota; ``shed_load`` is the fleet-wide in-flight
    count at which ``batch`` traffic sheds (None: never);
    ``max_death_retries`` bounds a request's replica-death retries."""

    default_rate: Optional[float] = None
    default_burst: Optional[float] = None
    shed_load: Optional[int] = None
    max_death_retries: int = 1


class _TokenBucket:
    """A token bucket; the router's lock serialises it."""

    def __init__(self, rate: float, burst: float, clock):
        self.rate = float(rate)
        self.burst = float(burst)
        self._clock = clock
        self._tokens = float(burst)
        self._last = clock()

    def try_take(self) -> bool:
        if self.rate <= 0:
            return True  # an unlimited tenant
        now = self._clock()
        self._tokens = min(self.burst, self._tokens + (now - self._last) * self.rate)
        self._last = now
        if self._tokens >= 1.0:
            self._tokens -= 1.0
            return True
        return False


class FleetRouter:
    """The admission front door over a set of :class:`FleetReplica`.

    The fleet attaches and detaches replicas as it scales; ``pause`` and
    ``resume`` take a replica out of placement without draining it (the
    rolling reload's step). ``clock`` drives the quotas (tests inject one).
    """

    def __init__(
        self,
        registry,
        flight=None,
        quotas: Optional[Dict[str, TenantQuota]] = None,
        config: Optional[RouterConfig] = None,
        clock=time.monotonic,
    ):
        cfg = config or RouterConfig()
        self.config = cfg
        self.registry = registry
        self.flight = flight
        self._clock = clock
        self._default_rate = (cfg.default_rate if cfg.default_rate is not None
                              else _knob("HGTORCH_FLEET_TENANT_RATE", 0.0))
        self._default_burst = (cfg.default_burst if cfg.default_burst is not None
                               else _knob("HGTORCH_FLEET_TENANT_BURST", 32.0))
        self._tracer = Tracer(flight=flight)
        self._lock = syncdebug.maybe_wrap(threading.Lock(), "fleet.FleetRouter._lock")
        # the five maps and sets below are guarded by _lock
        self._replicas: Dict[str, FleetReplica] = {}
        self._paused: set = set()
        self._quotas: Dict[str, TenantQuota] = dict(quotas or {})
        self._buckets: Dict[str, _TokenBucket] = {}
        self._tenant_metrics: Dict[str, dict] = {}
        r = registry
        self._requests = r.counter("fleet.requests_total")
        self._results = r.counter("fleet.results_total")
        self._rejected_quota = r.counter("fleet.rejected_quota")
        self._rejected_shed = r.counter("fleet.rejected_shed")
        self._rejected_no_replica = r.counter("fleet.rejected_no_replica")
        self._death_retries = r.counter("fleet.death_retries")
        self._failed = r.counter("fleet.failed")
        self._queue_depth = r.gauge("fleet.queue_depth")
        self._latency = r.histogram("fleet.latency_s")

    # -- the replica set ---------------------------------------------------

    def attach(self, replica: FleetReplica) -> None:
        with self._lock:
            self._replicas[replica.name] = replica
            self._paused.discard(replica.name)

    def detach(self, name: str) -> Optional[FleetReplica]:
        with self._lock:
            self._paused.discard(name)
            return self._replicas.pop(name, None)

    def pause(self, name: str) -> None:
        """Take a replica out of placement (it finishes what it holds)."""
        with self._lock:
            self._paused.add(name)

    def resume(self, name: str) -> None:
        with self._lock:
            self._paused.discard(name)

    def replicas(self) -> List[FleetReplica]:
        with self._lock:
            return list(self._replicas.values())

    def set_quota(self, tenant: str, quota: TenantQuota) -> None:
        with self._lock:
            self._quotas[tenant] = quota
            self._buckets.pop(tenant, None)  # rebuilt from the new quota

    # -- metrics -----------------------------------------------------------

    def _tenant(self, tenant: str) -> dict:
        """The tenant's metrics, made at first use (``_lock`` held)."""
        m = self._tenant_metrics.get(tenant)
        if m is None:
            p = f"fleet.tenant.{tenant.replace('.', '_')}"
            m = {"requests": self.registry.counter(f"{p}.requests"),
                 "rejected": self.registry.counter(f"{p}.rejected"),
                 "latency": self.registry.histogram(f"{p}.latency_s")}
            self._tenant_metrics[tenant] = m
        return m

    def total_load(self) -> int:
        """Unresolved requests across the fleet: what the shed gate and
        the autoscaler's queue-depth rule read."""
        return sum(r.load() for r in self.replicas())

    def _set_queue_gauge(self) -> None:
        self._queue_depth.set(self.total_load())

    # -- admission ---------------------------------------------------------

    def submit(self, sample: Any, tenant: str = "default", model: Optional[str] = None) -> Future:
        """Admit one request for ``tenant``; returns a router-owned Future
        of the model's result dict. Raises :class:`TenantOverloaded`
        (quota, shed) at once; no ready replica fails the Future with
        ``Overloaded``."""
        self._requests.inc()
        trace = self._tracer.begin(tenant=tenant, model=model or "default")
        trace_id = trace.trace_id if trace is not None else None
        with self._lock:
            tm = self._tenant(tenant)
            tm["requests"].inc()
            quota = self._quotas.get(tenant)
            bucket = self._buckets.get(tenant)
            if bucket is None:
                bucket = _TokenBucket(quota.rate if quota else self._default_rate,
                                      quota.burst if quota else self._default_burst, self._clock)
                self._buckets[tenant] = bucket
            admitted = bucket.try_take()
        if not admitted:
            tm["rejected"].inc()
            self._rejected_quota.inc()
            self._finish_reject(trace, "quota", tenant)
            raise TenantOverloaded(f"tenant {tenant!r} over admission quota "
                                   f"(rate {bucket.rate:g}/s, burst {bucket.burst:g})", tenant=tenant,
                                   trace_id=trace_id)
        priority = quota.priority if quota else "standard"
        shed = self.config.shed_load
        if shed is not None and priority == "batch" and self.total_load() >= shed:
            tm["rejected"].inc()
            self._rejected_shed.inc()
            self._finish_reject(trace, "shed", tenant)
            raise TenantOverloaded(f"batch-priority tenant {tenant!r} shed (fleet load >= {shed})", tenant=tenant,
                                   trace_id=trace_id)
        outer: Future = Future()
        t0 = time.monotonic()
        self._dispatch(sample, tenant, model, outer, trace, t0, tried=[], retries_left=self.config.max_death_retries)
        self._set_queue_gauge()
        return outer

    def _pick(self, model: Optional[str], exclude) -> Optional[FleetReplica]:
        """The least-loaded READY replica serving ``model`` (any model for
        None), paused and excluded names skipped."""
        with self._lock:
            candidates = [r for name, r in self._replicas.items()
                          if name not in self._paused and name not in exclude and (model is None or r.model == model)]
        ready = [r for r in candidates if r.ready]
        if not ready:
            return None
        return min(ready, key=lambda r: r.load())

    def _dispatch(self, sample, tenant, model, outer: Future, trace, t0: float, tried: List[str],
                  retries_left: int) -> None:
        replica = self._pick(model, exclude=set(tried))
        if replica is None and tried:
            # the retry found every untried replica unready: any ready
            # replica (a replacement may have taken a tried name's place)
            replica = self._pick(model, exclude=set())
        if replica is None:
            self._rejected_no_replica.inc()
            self._finish_reject(trace, "no_replica", tenant)
            outer.set_exception(Overloaded(f"no READY replica for model {model or 'default'!r} "
                                           f"(fleet of {len(self.replicas())})"))
            return
        if trace is not None:
            trace.mark("fleet.admit", replica=replica.name)
        try:
            inner = replica.submit(sample, tenant=tenant)
        except (Overloaded, ServerClosed) as exc:
            if retries_left > 0:
                self._death_retries.inc()
                self._dispatch(sample, tenant, model, outer, trace, t0, tried=tried + [replica.name],
                               retries_left=retries_left - 1)
                return
            self._finish_reject(trace, "replica_rejected", tenant)
            outer.set_exception(exc)
            return
        inner.add_done_callback(lambda f: self._on_result(f, sample, tenant, model, outer, trace, t0,
                                                          tried + [replica.name], retries_left, replica.name))

    def _on_result(self, inner: Future, sample, tenant, model, outer: Future, trace, t0: float, tried: List[str],
                   retries_left: int, replica_name: str) -> None:
        exc = inner.exception()
        if exc is None:
            latency = time.monotonic() - t0
            self._latency.observe(latency)
            with self._lock:
                self._tenant(tenant)["latency"].observe(latency)
            self._results.inc()
            if trace is not None:
                trace.mark("fleet.complete", replica=replica_name)
                self._tracer.finish(trace)
            outer.set_result(inner.result())
            self._set_queue_gauge()
            return
        died = isinstance(exc, ServerClosed) or (isinstance(exc, RequestFailed) and exc.reason == "dispatch")
        if died and retries_left > 0:
            self._death_retries.inc()
            if trace is not None:
                trace.mark("fleet.retry", replica=replica_name, error=type(exc).__name__)
            self._dispatch(sample, tenant, model, outer, trace, t0, tried=tried, retries_left=retries_left - 1)
            return
        self._failed.inc()
        if trace is not None:
            trace.mark("fleet.failed", replica=replica_name, error=type(exc).__name__)
            self._tracer.finish(trace)
        outer.set_exception(exc)
        self._set_queue_gauge()

    def _finish_reject(self, trace, reason: str, tenant: str) -> None:
        if trace is not None:
            trace.mark("fleet.reject", reason=reason, tenant=tenant)
            self._tracer.finish(trace)

    # -- convenience -------------------------------------------------------

    def predict(self, sample: Any, tenant: str = "default", model: Optional[str] = None,
                timeout: Optional[float] = None):
        return self.submit(sample, tenant=tenant, model=model).result(timeout)

    def traces(self):
        """The admission tracer's ring of finished traces."""
        return self._tracer.traces()
