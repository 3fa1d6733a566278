"""Per-request tracing: a trace id and a span list for every serve
request.

The port's counterpart of ``hydragnn_tpu/obs/trace.py``.
``ModelServer.submit``
begins a trace; the serve path closes the spans ``serve.route``,
``serve.queue_wait``, ``serve.batch_build``, ``serve.device_execute``
and ``serve.postprocess`` (``serve.quarantine`` or
``serve.eager_execute`` where a request takes those paths) and hands
the finished trace back to the :class:`Tracer`, which keeps a bounded
ring and writes every ``sample_every``-th into the flight record as a
``trace_capture`` event, the first one always. The training loop's
step spans (``obs/spans.py``) hand each sampled step to a tracer of
their own as a one-span ``train.sampled_step`` trace.

Export is Chrome/Perfetto trace-event JSON: :meth:`Tracer.export_chrome`
writes the live ring (``ModelServer.export_trace``);
:func:`flight_to_chrome` rebuilds a timeline offline from a flight
record (its ``trace_capture`` spans and ``epoch`` events), so a crashed
run's JSONL alone gives its timeline.

A disabled tracer (``HGTORCH_TELEMETRY`` or ``HGTORCH_TRACE`` off)
returns None from :meth:`Tracer.begin`; every call site checks for it.
Timestamps are ``time.time()``, the flight recorder's clock.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Union

from hydragnn_tpu_torch.obs.flight import read_flight_record
from hydragnn_tpu_torch.obs.registry import env_flag, telemetry_enabled
from hydragnn_tpu_torch.utils import syncdebug


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
        self._lock = syncdebug.maybe_wrap(threading.Lock(), "trace.Tracer._lock")
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

    # -- export ------------------------------------------------------------

    def to_chrome_trace(self) -> dict:
        events: List[dict] = []
        for i, tr in enumerate(self.traces()):
            d = tr.to_dict()
            tid = tr.seq if tr.seq >= 0 else i
            args = {"trace_id": d["trace_id"]}
            args.update(d.get("attrs", {}))
            events.extend(_chrome_events(d["spans"], pid=1, tid=tid, args=args))
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def export_chrome(self, path: str) -> str:
        """Write the ring as Chrome trace-event JSON (atomic); returns
        ``path``."""
        return _atomic_json(path, self.to_chrome_trace())


def _chrome_events(spans, pid: int, tid, args: Optional[dict] = None) -> List[dict]:
    """Span dicts -> Chrome trace-event 'X' (complete) events.
    ``ts``/``dur`` are microseconds; ``t0`` wall seconds pass through
    unshifted so events from different sources stay on one axis."""
    out = []
    for s in spans:
        ev_args = dict(args or {})
        ev_args.update(
            {k: v for k, v in s.items() if k not in ("name", "t0", "dur_ms")}
        )
        out.append(
            {
                "name": s.get("name", "span"),
                "ph": "X",
                "ts": round(float(s.get("t0", 0.0)) * 1e6, 1),
                "dur": round(float(s.get("dur_ms", 0.0)) * 1e3, 1),
                "pid": pid,
                "tid": tid,
                "args": ev_args,
            }
        )
    return out


def flight_to_chrome(record: Union[str, List[dict]]) -> dict:
    """Rebuild a Chrome/Perfetto timeline from a flight record: every
    ``trace_capture`` event's spans (serve requests, sampled train
    steps) plus one synthetic span per ``epoch`` event, all keyed by
    the run name from the ``run_start`` manifest. This is the offline
    join the tracing design promises: a crashed run's JSONL alone is
    enough to reconstruct the timeline a human can open."""
    events = read_flight_record(record) if isinstance(record, str) else record
    run = "run"
    for ev in events:
        if ev.get("kind") == "run_start":
            man = ev.get("manifest")
            if isinstance(man, dict):
                run = str(man.get("log_name") or man.get("run") or run)
            break
    out: List[dict] = []
    hosts_seen: set = set()
    for i, ev in enumerate(events):
        kind = ev.get("kind")
        if kind == "trace_capture":
            spans = ev.get("spans")
            if not isinstance(spans, list):
                continue
            seq = ev.get("seq", -1)
            tid = seq if isinstance(seq, int) and seq >= 0 else i
            args = {"run": run, "trace_id": ev.get("trace_id")}
            args.update(
                {
                    k: v
                    for k, v in ev.items()
                    if k not in ("v", "kind", "t", "rank", "spans", "trace_id", "seq")
                }
            )
            out.extend(_chrome_events(spans, pid=1, tid=tid, args=args))
        elif kind == "epoch":
            # the epoch event is stamped at epoch END; reconstruct the
            # interval from the recorded epoch duration when present
            t1 = float(ev.get("t", 0.0))
            dur_s = ev.get("time") or ev.get("epoch_s") or 0.0
            try:
                dur_s = max(float(dur_s), 0.0)
            except (TypeError, ValueError):
                dur_s = 0.0
            args = {"run": run, "epoch": ev.get("epoch")}
            for key in ("train_loss", "val_loss", "steps"):
                if key in ev:
                    args[key] = ev[key]
            tid = int(ev.get("host", ev.get("rank", 0)) or 0)
            hosts_seen.add(tid)
            out.append(
                {
                    "name": f"epoch {ev.get('epoch')}",
                    "ph": "X",
                    "ts": round((t1 - dur_s) * 1e6, 1),
                    "dur": round(dur_s * 1e6, 1),
                    "pid": 0,
                    "tid": tid,
                    "args": args,
                }
            )
        elif kind == "host_epoch":
            # per-host epoch summary (obs/podview.py):
            # one interval per host per epoch, a track per host (tid =
            # host index)
            t1 = float(ev.get("t", 0.0))
            try:
                dur_s = max(float(ev.get("epoch_s") or 0.0), 0.0)
            except (TypeError, ValueError):
                dur_s = 0.0
            host = int(ev.get("host", ev.get("rank", 0)) or 0)
            hosts_seen.add(host)
            args = {"run": run, "epoch": ev.get("epoch"), "host": host}
            for key in ("data_wait_s", "steps", "mfu", "run_id"):
                if ev.get(key) is not None:
                    args[key] = ev[key]
            out.append(
                {
                    "name": f"host{host} epoch {ev.get('epoch')}",
                    "ph": "X",
                    "ts": round((t1 - dur_s) * 1e6, 1),
                    "dur": round(dur_s * 1e6, 1),
                    "pid": 0,
                    "tid": host,
                    "args": args,
                }
            )
    # name the per-host tracks so Perfetto shows "host k" instead of a
    # bare thread id (only worth the metadata rows when >1 host)
    if len(hosts_seen) > 1:
        for h in sorted(hosts_seen):
            out.append(
                {
                    "name": "thread_name",
                    "ph": "M",
                    "pid": 0,
                    "tid": h,
                    "args": {"name": f"host {h}"},
                }
            )
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def _atomic_json(path: str, data) -> str:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    # per-writer tmp name: two threads exporting to the same path each
    # replace atomically, never interleaving into one tmp
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    with open(tmp, "w") as f:
        json.dump(data, f)
    os.replace(tmp, path)
    return path


def export_flight_chrome(record_path: str, out_path: str) -> str:
    """``flight_to_chrome`` of the flight record at ``record_path`` to
    ``out_path`` (atomic write); returns ``out_path``. ``record_path`` may
    be a run directory of per-host flight shards: they are merged first
    (``obs/podview.py``), one track a host."""
    if os.path.isdir(record_path):
        from hydragnn_tpu_torch.obs.podview import merge_host_flights

        return _atomic_json(out_path, flight_to_chrome(merge_host_flights(record_path).events))
    return _atomic_json(out_path, flight_to_chrome(record_path))
