"""Metrics registry: counters, gauges and windowed histograms.

The port's counterpart of ``hydragnn_tpu/obs/registry.py``, the one
in-process store the serving metrics record into:

  - :class:`Counter`: a monotone accumulator (requests, compiles);
  - :class:`Gauge`: a last-write-wins level that tracks its peak (queue
    depth);
  - :class:`Histogram`: a bounded rolling window with nearest-rank
    p50/p95/p99 (request latency; early samples age out).

A disabled registry hands out process-wide null metrics whose record
methods do nothing: no lock, no allocation. Export is
:mod:`hydragnn_tpu_torch.obs.export`. ``HGTORCH_TELEMETRY`` (0, false
or off) turns tracing off (``obs/trace.py``) and makes the
process-global registry (:func:`get_registry`) a disabled one. The
training loop records into the global registry (``train.*``: the guard's
``train.nonfinite_skipped``, the epoch gauges of ``train.prom``) and the
trigger engine reads it; a server keeps a registry of its own, so the
two never share counters.
"""

from __future__ import annotations

import os
import threading
from collections import deque
from typing import Dict, Optional

from hydragnn_tpu_torch.utils import syncdebug


def _percentile_nearest_rank(sorted_vals, q: float) -> float:
    """Nearest-rank percentile of an already-sorted sample."""
    n = len(sorted_vals)
    if not n:
        return 0.0
    return float(sorted_vals[min(n - 1, max(0, int(round(q * (n - 1)))))])


def _number(v: float):
    return int(v) if float(v).is_integer() else v


class Counter:
    """Monotone float/int accumulator."""

    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str):
        self.name = name
        self._lock = syncdebug.maybe_wrap(threading.Lock(), "registry.Counter._lock")
        self._value = 0.0  # guarded by _lock

    def inc(self, n: float = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def snapshot(self):
        return _number(self.value)


class Gauge:
    """Last-write-wins level; ``peak`` is the largest value ever set."""

    __slots__ = ("name", "_lock", "_value", "_peak")

    def __init__(self, name: str):
        self.name = name
        self._lock = syncdebug.maybe_wrap(threading.Lock(), "registry.Gauge._lock")
        self._value = 0.0  # guarded by _lock
        self._peak = 0.0  # guarded by _lock

    def set(self, v: float) -> None:
        with self._lock:
            self._value = v
            if v > self._peak:
                self._peak = v

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    @property
    def peak(self) -> float:
        with self._lock:
            return self._peak

    def snapshot(self):
        return _number(self.value)


class Histogram:
    """Bounded rolling window of observations with nearest-rank
    percentiles over the window, and all-time count and sum."""

    __slots__ = ("name", "_lock", "_window", "_count", "_sum")

    def __init__(self, name: str, window: int = 2048):
        self.name = name
        self._lock = syncdebug.maybe_wrap(threading.Lock(), "registry.Histogram._lock")
        self._window: deque = deque(maxlen=window)  # guarded by _lock
        self._count = 0  # guarded by _lock
        self._sum = 0.0  # guarded by _lock

    def observe(self, v: float) -> None:
        with self._lock:
            self._window.append(v)
            self._count += 1
            self._sum += v

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def values(self):
        """The current window (a copy), oldest first."""
        with self._lock:
            return list(self._window)

    def snapshot(self) -> dict:
        with self._lock:
            vals = sorted(self._window)
            count, total = self._count, self._sum
        return {
            "count": count,
            "sum": total,
            "mean": (sum(vals) / len(vals)) if vals else 0.0,
            "p50": _percentile_nearest_rank(vals, 0.50),
            "p95": _percentile_nearest_rank(vals, 0.95),
            "p99": _percentile_nearest_rank(vals, 0.99),
        }


class _NullCounter(Counter):
    __slots__ = ()

    def inc(self, n: float = 1) -> None:
        pass


class _NullGauge(Gauge):
    __slots__ = ()

    def set(self, v: float) -> None:
        pass


class _NullHistogram(Histogram):
    __slots__ = ()

    def observe(self, v: float) -> None:
        pass


# every disabled-registry lookup returns these
NULL_COUNTER = _NullCounter("null")
NULL_GAUGE = _NullGauge("null")
NULL_HISTOGRAM = _NullHistogram("null", window=1)


def _group():
    """The ``torch.distributed`` module when a group is initialised, else None."""
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return dist
    except (ImportError, RuntimeError):
        pass
    return None


def process_rank() -> int:
    """This process's rank in a ``torch.distributed`` group, else 0."""
    dist = _group()
    return int(dist.get_rank()) if dist is not None else 0


def process_count() -> int:
    """The ``torch.distributed`` group's size, else 1."""
    dist = _group()
    return int(dist.get_world_size()) if dist is not None else 1


class MetricsRegistry:
    """Named metric store. Names are dotted paths
    (``serve.requests_total``); :meth:`snapshot` nests them back into a
    dict tree. ``enabled=False`` makes every factory return the null
    metrics, and the snapshot empty."""

    def __init__(self, enabled: bool = True, rank: Optional[int] = None):
        self.enabled = enabled
        self._rank = rank
        self._lock = syncdebug.maybe_wrap(threading.Lock(), "registry.MetricsRegistry._lock")
        self._metrics: Dict[str, object] = {}  # guarded by _lock

    def _get(self, name: str, cls, *args):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, *args)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {type(m).__name__}, requested {cls.__name__}"
                )
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter) if self.enabled else NULL_COUNTER

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge) if self.enabled else NULL_GAUGE

    def histogram(self, name: str, window: int = 2048) -> Histogram:
        return self._get(name, Histogram, window) if self.enabled else NULL_HISTOGRAM

    @property
    def rank(self) -> int:
        """This process's rank, read at first use: the simulated pod host
        ``HGTORCH_PODVIEW_HOST`` first (so each host's export is told
        apart on one machine), else ``process_rank``."""
        if self._rank is None:
            r = int(env_number("HGTORCH_PODVIEW_HOST", -1))
            self._rank = r if r >= 0 else process_rank()
        return self._rank

    def names(self):
        with self._lock:
            return sorted(self._metrics)

    def get(self, name: str):
        with self._lock:
            return self._metrics.get(name)

    def snapshot(self) -> dict:
        """Nested dict of every metric's value, keyed by the dotted
        path's segments (histograms: count, sum, mean, p50, p95, p99)."""
        with self._lock:
            items = list(self._metrics.items())
        out: dict = {}
        for name, metric in items:
            node = out
            parts = name.split(".")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = metric.snapshot()
        return out


def env_flag(name: str) -> bool:
    """An on-by-default switch: the variable set to 0, false, off or no
    turns it off."""
    return os.environ.get(name, "1").strip().lower() not in ("0", "false", "off", "no")


def env_number(name: str, default: float) -> float:
    """The number the variable ``name`` holds; ``default`` when it is
    unset, empty or not a number."""
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def telemetry_enabled() -> bool:
    """``HGTORCH_TELEMETRY`` off (0, false, off, no) disables; default on."""
    return env_flag("HGTORCH_TELEMETRY")


_GLOBAL: Optional[MetricsRegistry] = None  # guarded by _GLOBAL_LOCK
_GLOBAL_LOCK = syncdebug.maybe_wrap(threading.Lock(), "registry._GLOBAL_LOCK")


def get_registry() -> MetricsRegistry:
    """The process-global registry, made at first use and enabled as
    ``HGTORCH_TELEMETRY`` says then. A server keeps its own."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        if _GLOBAL is None:
            _GLOBAL = MetricsRegistry(enabled=telemetry_enabled())
        return _GLOBAL


def reset_registry() -> None:
    """Drop the process-global registry; the next ``get_registry`` makes
    a fresh one that reads ``HGTORCH_TELEMETRY`` again."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        _GLOBAL = None
