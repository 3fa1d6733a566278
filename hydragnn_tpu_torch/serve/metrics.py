"""Serving metrics: request counts, batch occupancy, flush reasons and
latency percentiles.

The port's counterpart of the core of ``hydragnn_tpu/serve/metrics.py``
(the same ``snapshot()`` keys for what the port records; the registry,
Prometheus and tensorboard export wait for the observability slice,
ROADMAP A11). Latencies are host-clock seconds from admission to the
future's resolution, over a rolling window.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Dict, List, Optional


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
    """Thread-safe serving counters for one ModelServer."""

    def __init__(self, num_buckets: int, latency_window: int = 2048):
        self._lock = threading.Lock()
        # everything below is guarded by _lock
        self._c = {
            k: 0
            for k in (
                "requests_total",
                "results_total",
                "rejected_overload",
                "oversize_largest_bucket",
                "oversize_eager",
                "errors",
                "quarantined",
                "poison_retries",
                "forwards_total",
            )
        }
        self._latency = deque(maxlen=latency_window)
        self._buckets = [
            {"requests": 0, "batches": 0, "graphs": 0, "flush": {}} for _ in range(num_buckets)
        ]

    def _inc(self, key: str, n: int = 1) -> None:
        with self._lock:
            self._c[key] += n

    def record_request(self, bucket: Optional[int]) -> None:
        with self._lock:
            self._c["requests_total"] += 1
            if bucket is not None:
                self._buckets[bucket]["requests"] += 1

    def record_batch(self, bucket: int, occupancy: int, reason: str) -> None:
        with self._lock:
            b = self._buckets[bucket]
            b["batches"] += 1
            b["graphs"] += occupancy
            b["flush"][reason] = b["flush"].get(reason, 0) + 1

    def record_reject(self) -> None:
        self._inc("rejected_overload")

    def record_oversize(self, kind: str) -> None:
        self._inc("oversize_largest_bucket" if kind == "largest_bucket" else "oversize_eager")

    def record_error(self, n: int = 1) -> None:
        self._inc("errors", n)

    def record_quarantine(self) -> None:
        self._inc("quarantined")

    def record_poison_retry(self, n: int) -> None:
        self._inc("poison_retries", n)

    def record_forward(self) -> None:
        """One model forward launched on the device (a bucket batch, a
        single-request retry or an eager oversize request)."""
        self._inc("forwards_total")

    def observe_latency(self, seconds: float) -> None:
        with self._lock:
            self._latency.append(seconds)
            self._c["results_total"] += 1

    def snapshot(self) -> dict:
        with self._lock:
            out = dict(self._c)
            lat = list(self._latency)
            buckets = {}
            for i, b in enumerate(self._buckets):
                d = {"requests": b["requests"], "batches": b["batches"], "graphs": b["graphs"]}
                for reason, n in b["flush"].items():
                    d[f"flush_{reason}"] = n
                d["occupancy_mean"] = b["graphs"] / b["batches"] if b["batches"] else 0.0
                buckets[f"bucket_{i}"] = d
        out["batches_total"] = sum(b["batches"] for b in buckets.values())
        out["latency"] = latency_percentiles(lat)
        out["buckets"] = buckets
        return out
