"""Serving metrics: request counts, batch occupancy, flush reasons,
compile counts, resilience counters, health gauges and latency
percentiles.

The port's counterpart of ``hydragnn_tpu/serve/metrics.py``: a facade
over a metrics registry (``obs/registry.py``) with the JAX package's
``record_*`` methods and ``snapshot()`` key set, a parse contract, plus
the port's ``forwards_total``, ``batches_total`` and
``graph_replays_total``. Prometheus export (``to_prometheus_text``,
the same metric names) and tensorboard export (``to_tensorboard``) come
from the registry. Latencies are host-clock seconds from admission to
the future's resolution, over a rolling window.

A compile is a CUDA graph capture (``serve/buckets.py``): one a bucket
and weight slot at ``start()`` (``compile_warmup``), a hit for every
batch after. ``exec_cache_*`` stay in the key set at 0: a CUDA graph
cannot be kept across processes, so the port has no on-disk executable
cache.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from hydragnn_tpu_torch.obs.registry import MetricsRegistry

_FLUSH_REASONS = ("full", "deadline", "drain")


def latency_percentiles(values_s) -> Dict[str, float]:
    """p50/p95/p99 (nearest rank) over second-latencies, in ms."""
    vals: List[float] = sorted(values_s)
    if not vals:
        return {"p50_ms": 0.0, "p95_ms": 0.0, "p99_ms": 0.0}
    n = len(vals)

    def rank(q: float) -> float:
        return vals[min(n - 1, max(0, int(round(q * (n - 1)))))] * 1e3

    return {"p50_ms": rank(0.50), "p95_ms": rank(0.95), "p99_ms": rank(0.99)}


class ServeMetrics:
    """Thread-safe serving counters for one ModelServer, in ``registry``
    (a private one by default, so two servers never share counters)
    under ``prefix``."""

    def __init__(
        self,
        num_buckets: int,
        latency_window: int = 2048,
        registry: Optional[MetricsRegistry] = None,
        prefix: str = "serve",
    ):
        self.registry = registry if registry is not None else MetricsRegistry()
        self.prefix = prefix
        self.num_buckets = num_buckets
        r, p = self.registry, prefix
        self._c = {
            k: r.counter(f"{p}.{k}")
            for k in (
                "requests_total", "results_total", "rejected_overload", "oversize_largest_bucket",
                "oversize_eager", "errors", "quarantined", "poison_retries", "dispatch_restarts", "reloads",
                "reload_failed", "compile_warmup", "compile_hits", "compile_misses", "exec_cache_hits",
                "exec_cache_misses", "forwards_total", "graph_replays_total",
            )
        }
        self._g = {
            k: r.gauge(f"{p}.{k}")
            for k in ("queue_depth", "queue_oldest_age_s", "live", "ready", "heartbeat_age_s", "warm_buckets")
        }
        self._latency = r.histogram(f"{p}.latency_s", window=latency_window)
        self._buckets = []
        for i in range(num_buckets):
            bp = f"{p}.bucket_{i}"
            self._buckets.append(
                {
                    "requests": r.counter(f"{bp}.requests"),
                    "batches": r.counter(f"{bp}.batches"),
                    "graphs": r.counter(f"{bp}.graphs"),
                    "occupancy_sum": r.counter(f"{bp}.occupancy_sum"),
                    "flush": {reason: r.counter(f"{bp}.flush_{reason}") for reason in _FLUSH_REASONS},
                    "capacity": r.gauge(f"{bp}.capacity"),
                }
            )

    # -- recording ---------------------------------------------------------

    def record_request(self, bucket: Optional[int]) -> None:
        self._c["requests_total"].inc()
        if bucket is not None:
            self._buckets[bucket]["requests"].inc()

    def record_batch(self, bucket: int, occupancy: int, capacity: int, reason: str) -> None:
        b = self._buckets[bucket]
        b["batches"].inc()
        b["graphs"].inc(occupancy)
        b["occupancy_sum"].inc(occupancy)
        flush = b["flush"].get(reason)
        if flush is None:
            # the registry returns the one counter of a name to every caller
            flush = self.registry.counter(f"{self.prefix}.bucket_{bucket}.flush_{reason}")
            b["flush"][reason] = flush
        flush.inc()
        b["capacity"].set(capacity)

    def record_reject(self) -> None:
        self._c["rejected_overload"].inc()

    def record_oversize(self, kind: str) -> None:
        self._c["oversize_largest_bucket" if kind == "largest_bucket" else "oversize_eager"].inc()

    def record_compile(self, *, hit: bool, warmup: bool = False) -> None:
        """A capture at start (``warmup``), a later capture (a miss) or a
        batch served by one already made (a hit)."""
        self._c["compile_warmup" if warmup else "compile_hits" if hit else "compile_misses"].inc()

    def record_error(self, n: int = 1) -> None:
        self._c["errors"].inc(n)

    def record_quarantine(self, n: int = 1) -> None:
        self._c["quarantined"].inc(n)

    def record_poison_retry(self, n: int = 1) -> None:
        self._c["poison_retries"].inc(n)

    def record_dispatch_restart(self) -> None:
        self._c["dispatch_restarts"].inc()

    def record_reload(self, ok: bool) -> None:
        self._c["reloads" if ok else "reload_failed"].inc()

    def record_forward(self) -> None:
        """One model forward on the device: a graph replay or an eager
        forward (a bucket batch, a retried single, an oversize request)."""
        self._c["forwards_total"].inc()

    def record_replay(self) -> None:
        """One CUDA graph replay (a subset of the forwards)."""
        self._c["graph_replays_total"].inc()

    def set_health(self, live: bool, ready: bool, heartbeat_age_s: Optional[float], warm_buckets: int) -> None:
        self._g["live"].set(1.0 if live else 0.0)
        self._g["ready"].set(1.0 if ready else 0.0)
        if heartbeat_age_s is not None:
            self._g["heartbeat_age_s"].set(round(float(heartbeat_age_s), 3))
        self._g["warm_buckets"].set(warm_buckets)

    def observe_latency(self, seconds: float, n_results: int = 1) -> None:
        self._latency.observe(seconds)
        self._c["results_total"].inc(n_results)

    def set_queue_depth(self, depth: int, oldest_age_s: Optional[float] = None) -> None:
        self._g["queue_depth"].set(depth)
        if oldest_age_s is not None:
            self._g["queue_oldest_age_s"].set(round(float(oldest_age_s), 4))

    # -- export ------------------------------------------------------------

    def snapshot(self) -> dict:
        """Every counter and gauge, per-bucket stats and the latency
        percentiles: the JAX package's key set, and the port's
        ``forwards_total``, ``batches_total``, ``graph_replays_total``."""
        buckets = {}
        for i, b in enumerate(self._buckets):
            batches = b["batches"].snapshot()
            d = {"requests": b["requests"].snapshot(), "batches": batches, "graphs": b["graphs"].snapshot()}
            for reason, c in b["flush"].items():
                d[f"flush_{reason}"] = c.snapshot()
            if batches:
                d["capacity"] = b["capacity"].snapshot()
            d["occupancy_mean"] = b["occupancy_sum"].snapshot() / batches if batches else 0.0
            buckets[f"bucket_{i}"] = d
        out = {k: c.snapshot() for k, c in self._c.items()}
        out.update({k: g.snapshot() for k, g in self._g.items() if k not in ("heartbeat_age_s", "warm_buckets")})
        out["queue_depth_peak"] = int(self._g["queue_depth"].peak)
        out["exec_cache_miss_reasons"] = {}
        out["batches_total"] = sum(b["batches"] for b in buckets.values())
        out["latency"] = latency_percentiles(self._latency.values())
        out["buckets"] = buckets
        return out

    def to_tensorboard(self, writer, step: int, prefix: str = "serve") -> int:
        """Write a snapshot to a SummaryWriter (``utils/tensorboard.py``);
        returns the number of scalars written."""
        from hydragnn_tpu_torch.utils.tensorboard import write_scalar_dict

        return write_scalar_dict(writer, self.snapshot(), step, prefix=prefix)

    def to_prometheus_text(self) -> str:
        """The registry in Prometheus exposition format."""
        from hydragnn_tpu_torch.obs.export import registry_to_prometheus_text

        return registry_to_prometheus_text(self.registry)
