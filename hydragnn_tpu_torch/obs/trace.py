"""Per-request tracing: a trace id and a span list for every serve
request.

The port's counterpart of ``hydragnn_tpu/obs/trace.py`` (the
:class:`RequestTrace` and :class:`Tracer` half; the Chrome export and
the offline timeline wait for ROADMAP A-6b). ``ModelServer.submit``
begins a trace; the serve path closes the spans ``serve.route``,
``serve.queue_wait``, ``serve.batch_build``, ``serve.device_execute``
and ``serve.postprocess`` (``serve.quarantine`` or
``serve.eager_execute`` where a request takes those paths) and hands
the finished trace back to the :class:`Tracer`, which keeps a bounded
ring and writes every ``sample_every``-th into the flight record as a
``trace_capture`` event, the first one always. The training loop's
step spans (``obs/spans.py``) hand each sampled step to a tracer of
their own as a one-span ``train.sampled_step`` trace.

A disabled tracer (``HGTORCH_TELEMETRY`` or ``HGTORCH_TRACE`` off)
returns None from :meth:`Tracer.begin`; every call site checks for it.
Timestamps are ``time.time()``, the flight recorder's clock.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from hydragnn_tpu_torch.obs.registry import env_flag, telemetry_enabled


def trace_enabled() -> bool:
    """Telemetry on and ``HGTORCH_TRACE`` not off (default on)."""
    return telemetry_enabled() and env_flag("HGTORCH_TRACE")


def new_trace_id() -> str:
    """A random 64-bit hex trace id."""
    return os.urandom(8).hex()


class RequestTrace:
    """One request's spans: closed intervals ``{name, t0, dur_ms,
    ...attrs}`` with ``t0`` in wall seconds. :meth:`add_span` records an
    explicit interval (a batch's hops, shared by its requests);
    :meth:`mark` closes the span from the previous mark to now."""

    __slots__ = ("trace_id", "seq", "t_admit", "spans", "attrs", "_mark")

    def __init__(self, trace_id: str, seq: int = -1, attrs: Optional[dict] = None):
        self.trace_id = trace_id
        self.seq = seq
        self.t_admit = time.time()
        self.spans: List[Dict[str, Any]] = []
        self.attrs = dict(attrs or {})
        self._mark = self.t_admit

    def add_span(self, name: str, t0: float, t1: float, **attrs) -> None:
        span: Dict[str, Any] = {"name": name, "t0": round(t0, 6), "dur_ms": round(max(t1 - t0, 0.0) * 1e3, 3)}
        span.update(attrs)
        self.spans.append(span)

    def mark(self, name: str, **attrs) -> float:
        """Close a span from the previous mark to now; returns now."""
        now = time.time()
        self.add_span(name, self._mark, now, **attrs)
        self._mark = now
        return now

    def to_dict(self) -> dict:
        # copies: another thread may still hold the trace
        d = {"trace_id": self.trace_id, "seq": self.seq, "spans": [dict(s) for s in self.spans]}
        if self.attrs:
            d["attrs"] = dict(self.attrs)
        return d


class Tracer:
    """Mints traces at admission and keeps the ``keep`` most recent
    finished ones; every ``sample_every``-th finished trace (default
    ``HGTORCH_TRACE_SAMPLE``, 100) goes to ``flight`` as a
    ``trace_capture`` event."""

    def __init__(self, flight=None, enabled: Optional[bool] = None, sample_every: Optional[int] = None,
                 keep: int = 256):
        self.enabled = trace_enabled() if enabled is None else bool(enabled)
        if sample_every is None:
            sample_every = int(os.environ.get("HGTORCH_TRACE_SAMPLE", "100"))
        self.sample_every = max(1, int(sample_every))
        self.flight = flight
        self._lock = threading.Lock()
        self._finished: deque = deque(maxlen=max(1, keep))  # guarded by _lock
        self._count = 0  # guarded by _lock

    def begin(self, seq: int = -1, **attrs) -> Optional[RequestTrace]:
        if not self.enabled:
            return None
        return RequestTrace(new_trace_id(), seq, attrs or None)

    def finish(self, trace: Optional[RequestTrace]) -> None:
        if trace is None:
            return
        with self._lock:
            self._finished.append(trace)
            self._count += 1
            n = self._count
        if self.flight is not None and (n - 1) % self.sample_every == 0:
            self.flight.record("trace_capture", **trace.to_dict())

    def traces(self) -> List[RequestTrace]:
        """The ring (a copy), oldest first."""
        with self._lock:
            return list(self._finished)
