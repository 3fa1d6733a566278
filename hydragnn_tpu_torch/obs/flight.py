"""Run flight recorder: an append-only JSONL event log.

The port's counterpart of ``hydragnn_tpu/obs/flight.py``, in the same
v2 envelope (``v``, ``kind``, ``t``, ``rank``) and event kinds, so the
JAX package's ``validate_flight_record`` and ``tools/obs_report.py``
read the port's records. Each event is one line, written and flushed
under a lock (the watchdog and the supervisor record from their own
threads); a run that dies keeps every event up to the crash, the tail
at worst one truncated line, which the reader skips. An open recorder
is registered with the lock-order witness (``utils/syncdebug.py``),
whose ``lock_order`` events land in it.

The ``run_start`` manifest carries the three keys the schema requires:
``jax_version`` is None (the port runs no JAX), ``backend`` the device
type (``cuda`` or ``cpu``) and ``num_processes`` the process count;
beside them ``torch_version``, ``cuda_version`` and ``device_name``.
The serving server and the training loop (``train/loop.py``: the
``run_start`` manifest, an ``epoch`` event an epoch, ``run_end``) write
it.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Union

from hydragnn_tpu_torch.obs.registry import process_count, process_rank
from hydragnn_tpu_torch.utils import syncdebug

SCHEMA_VERSION = 2
SUPPORTED_SCHEMA_VERSIONS = (1, 2)

# kind -> the fields an event of that kind carries beyond the envelope
# (the JAX package's schema; unknown kinds and extra fields are allowed)
_REQUIRED: Dict[str, tuple] = {
    "run_start": ("manifest",),
    "epoch": ("epoch", "train_loss", "val_loss"),
    "compile": ("count",),
    "retry": ("attempt", "error"),
    "error": ("error", "error_type"),
    "profile_trace": ("path",),
    "run_end": ("status",),
    "preempt": ("signal", "epoch"),
    "resumed": ("epoch",),
    "rollback": ("epoch", "consec"),
    "watchdog": ("stall_s", "stacks"),
    "restart": ("attempt", "cause"),
    "quarantine": ("seq", "reason"),
    "dispatch_restart": ("attempt", "cause"),
    "reload": ("source",),
    "reload_failed": ("source", "error"),
    "exec_cache": ("event",),
    "trace_capture": ("trace_id", "spans"),
    "incident": ("id", "rule", "path"),
    "lock_order": ("locks", "stacks"),
    "bench_config": ("name", "result"),
    "bench_result": ("record", "passed"),
    "fleet_scale": ("action", "reason", "replicas"),
    "fleet_reload": ("model", "replica", "ok"),
    "spool_rotate": ("shard", "samples", "total_bytes"),
    "drift": ("rule", "observed", "threshold"),
    "pilot": ("state", "cycle"),
    "host_epoch": ("epoch", "host", "run_id", "epoch_s"),
    "podview": ("epoch", "skew_frac", "slowest_host"),
    "host_lost": ("host",),
    "pod_resume": ("gen",),
}

_MANIFEST_REQUIRED = ("jax_version", "backend", "num_processes")


def _jsonable(obj: Any, depth: int = 0) -> Any:
    """Best-effort conversion to JSON: tensors and numpy values to
    Python, unknown leaves to repr (a record must never raise)."""
    if depth > 8:
        return repr(obj)
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, dict):
        return {str(k): _jsonable(v, depth + 1) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v, depth + 1) for v in obj]
    if hasattr(obj, "item") and getattr(obj, "ndim", None) == 0:
        return obj.item()
    if hasattr(obj, "tolist"):
        try:
            return obj.tolist()
        except (TypeError, ValueError, RuntimeError):
            return repr(obj)
    return repr(obj)


def environment_manifest(device=None) -> Dict[str, Any]:
    """The manifest's environment keys for a run on ``device``."""
    import torch

    dev_type = getattr(device, "type", device) or "cpu"
    name = None
    if dev_type == "cuda" and torch.cuda.is_available():
        name = torch.cuda.get_device_name(device)
    return {
        "jax_version": None,
        "backend": str(dev_type),
        "num_processes": process_count(),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "device_name": name,
    }


class FlightRecorder:
    """Append-only JSONL writer for one run. A disabled recorder
    (``enabled=False`` or no path) creates no file and every method is a
    no-op, so call sites need no gate of their own."""

    def __init__(self, path: Optional[str], enabled: bool = True, host: Optional[int] = None):
        self.path = path
        # the pod host's index (``obs/podview.py``): when set, every event's
        # ``rank`` is stamped with it, so simulated hosts and real ranks
        # each get a track of their own in the merged timeline
        self.host = host
        self.enabled = bool(enabled and path)
        self._lock = syncdebug.maybe_wrap(threading.Lock(), "flight.FlightRecorder._lock")
        self._f = None  # guarded by _lock
        if self.enabled:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._f = open(path, "a", buffering=1)
            syncdebug.register_flight(self)

    def record(self, kind: str, **payload) -> None:
        if not self.enabled:
            return
        event = {
            "v": SCHEMA_VERSION,
            "kind": kind,
            "t": round(time.time(), 3),
            "rank": self.host if self.host is not None else process_rank(),
        }
        event.update({k: _jsonable(v) for k, v in payload.items()})
        try:
            with self._lock:
                if self._f is None:
                    return  # closed after the enabled check
                self._f.write(json.dumps(event) + "\n")
                self._f.flush()
        except (OSError, ValueError):
            # a full disk must not take the run down: stop recording
            self.enabled = False

    def start_run(self, manifest: Dict[str, Any], device=None) -> None:
        """The run's identity card; the environment keys the schema
        requires are filled in for ``device`` where the caller left them
        out."""
        manifest = dict(manifest)
        for k, v in environment_manifest(device).items():
            manifest.setdefault(k, v)
        self.record("run_start", manifest=manifest)

    def epoch(self, epoch: int, **payload) -> None:
        self.record("epoch", epoch=epoch, **payload)

    def compile_event(self, count: int, **payload) -> None:
        self.record("compile", count=count, **payload)

    def error(self, error: Union[BaseException, str], **payload) -> None:
        self.record(
            "error",
            error=str(error)[-400:],
            error_type=type(error).__name__ if isinstance(error, BaseException) else "str",
            **payload,
        )

    def end_run(self, status: str, **payload) -> None:
        self.record("run_end", status=status, **payload)

    def close(self) -> None:
        with self._lock:
            f, self._f = self._f, None
            self.enabled = False
        if f is not None:
            try:
                f.close()
            except OSError:
                pass

    def __enter__(self) -> "FlightRecorder":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_flight_record(path: str) -> List[dict]:
    """Parse a flight record, skipping a truncated last line; a
    malformed line elsewhere becomes ``{"kind": "_unparseable"}``."""
    events: List[dict] = []
    with open(path) as f:
        lines = f.read().split("\n")
    for i, line in enumerate(lines):
        if not line.strip():
            continue
        try:
            events.append(json.loads(line))
        except json.JSONDecodeError:
            if i == len(lines) - 1 or (i == len(lines) - 2 and not lines[-1]):
                continue
            events.append({"kind": "_unparseable", "line": line[:200]})
    return events


def validate_flight_record(record: Union[str, List[dict]], require_complete: bool = False) -> List[str]:
    """The schema check of the JAX package's validator (envelope, each
    kind's fields, the manifest's keys); returns the problems, [] when
    valid. ``require_complete`` also asks for a finished run's shape:
    exactly one ``run_start``, first; at least one ``epoch``; ``run_end``
    last. Without it a crashed run validates when every event it wrote
    is well formed."""
    events = read_flight_record(record) if isinstance(record, str) else record
    if not events:
        return ["empty flight record"]
    problems: List[str] = []
    for i, ev in enumerate(events):
        where = f"event[{i}]"
        if ev.get("kind") == "_unparseable":
            problems.append(f"{where}: unparseable line {ev.get('line')!r}")
            continue
        for field in ("v", "kind", "t", "rank"):
            if field not in ev:
                problems.append(f"{where}: missing envelope field {field!r}")
        v = ev.get("v")
        if v is not None and v not in SUPPORTED_SCHEMA_VERSIONS and not (isinstance(v, int) and v > SCHEMA_VERSION):
            problems.append(f"{where}: schema version {v!r} not in {SUPPORTED_SCHEMA_VERSIONS}")
        kind = ev.get("kind")
        for field in _REQUIRED.get(kind, ()):
            if field not in ev:
                problems.append(f"{where} ({kind}): missing field {field!r}")
        if kind == "run_start":
            man = ev.get("manifest")
            if not isinstance(man, dict):
                problems.append(f"{where}: manifest is not a dict")
            else:
                problems += [f"{where}: manifest missing field {f!r}" for f in _MANIFEST_REQUIRED if f not in man]
    if require_complete:
        kinds = [e.get("kind") for e in events]
        if kinds.count("run_start") != 1:
            problems.append(f"expected exactly one run_start, got {kinds.count('run_start')}")
        elif kinds[0] != "run_start":
            problems.append(f"first event is {kinds[0]!r}, expected run_start")
        if "epoch" not in kinds:
            problems.append("no epoch events")
        if kinds[-1] != "run_end":
            problems.append(f"last event is {kinds[-1]!r}, expected run_end")
    return problems


def flight_record_warnings(record: Union[str, List[dict]]) -> List[str]:
    """Advisories that do not fail validation: event kinds this reader
    does not know, and events of a newer schema version."""
    events = read_flight_record(record) if isinstance(record, str) else record
    warnings: List[str] = []
    for i, ev in enumerate(events):
        kind = ev.get("kind")
        if kind is not None and kind != "_unparseable" and kind not in _REQUIRED:
            warnings.append(f"event[{i}]: unknown event kind {kind!r}")
        v = ev.get("v")
        if isinstance(v, int) and v > SCHEMA_VERSION:
            warnings.append(f"event[{i}]: schema version {v} is newer than this reader (supports "
                            f"{SUPPORTED_SCHEMA_VERSIONS}); fields may be missing from views")
    return warnings
