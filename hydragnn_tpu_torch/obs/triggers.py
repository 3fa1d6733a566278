"""SLO triggers and incident bundles (the port's counterpart of
``hydragnn_tpu/obs/triggers.py``).

Declarative rules are evaluated against the live metrics registry and
against series the caller observes; a rule that fires opens an
**incident**: a bundle of evidence written at that moment and a bounded
``torch.profiler`` capture of the next few steps. The training loop
evaluates its three rules at each epoch's end (``train_nonfinite_burst``
on the ``train.nonfinite_skipped`` counter, ``train_loss_spike`` and
``train_mfu_drop`` on the epoch series) when ``Training.slo_triggers``
is set.

Rule kinds (:data:`RULE_KINDS`, the JAX package's list): ``latency_p99``
(a histogram's p99 over a threshold), ``queue_depth`` and ``queue_age``
(a gauge over a threshold), ``feature_drift``, ``pred_drift``,
``error_drift`` (drift gauges), ``mfu_drop`` (a series under threshold x
the rolling median of its previous ``window`` values), ``loss_spike``
(over threshold x that median), ``nonfinite_burst`` (a counter's rise
between two evaluations reaches the threshold), ``pilot_stuck`` (raised
directly, never evaluated), ``step_skew``, ``host_stall`` and
``host_lost`` (pod gauges).

Firing is rate limited (a cooldown, ``HGTORCH_INCIDENT_COOLDOWN_S``,
default 300 s; at most ``HGTORCH_INCIDENT_MAX`` incidents, default 5;
one verdict an evaluation) and budgeted: a capture is refused once the
capture time spent exceeds ``HGTORCH_INCIDENT_OVERHEAD_PCT`` (default
5) percent of the wall time, the run's first always admitted. A capture
stops after ``HGTORCH_INCIDENT_PROFILE_STEPS`` ticks (default 3) or
``HGTORCH_INCIDENT_PROFILE_S`` seconds (default 10).
``HGTORCH_INJECT_TRIGGER=<rule>`` force-fires that rule once a process
(``resilience/inject.py``).

A bundle under ``<run log dir>/incidents/<id>/`` holds ``trigger.json``
(the verdict), ``metrics.json`` (the registry's snapshot),
``flight_tail.jsonl`` (the flight record's last lines),
``chip_hygiene.json`` (the card's compute processes,
:func:`chip_hygiene_report`), ``memory.json`` (the card's memory,
``obs/introspect.py``), ``profile/`` (the capture's Chrome trace,
through the capture slot of ``utils/profile.py``), with a pod's skew
monitor ``podview_report.json`` and ``flight_tail.host<k>.jsonl`` (the
other hosts' shard tails, ``obs/podview.py``) and, written last and
atomically, ``incident_manifest.json``. A bundle without a manifest is
a run that died mid-capture; every reader here takes it as such. The
JAX package's ``tools/incident_report.py`` reads the port's bundles.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from hydragnn_tpu_torch.utils import syncdebug


def _knob(name: str, default: float) -> float:
    raw = os.environ.get(name)
    if raw is None or not raw.strip():
        return float(default)
    try:
        return float(raw)
    except ValueError:
        raise ValueError(f"{name} must be a number, got {raw!r}") from None


RULE_KINDS = (
    "latency_p99",
    "queue_depth",
    "queue_age",
    "feature_drift",
    "pred_drift",
    "error_drift",
    "mfu_drop",
    "loss_spike",
    "nonfinite_burst",
    "pilot_stuck",
    "step_skew",
    "host_stall",
    "host_lost",
)

#: which rule kinds read a registry metric (vs an observed series)
_REGISTRY_KINDS = (
    "latency_p99",
    "queue_depth",
    "queue_age",
    "feature_drift",
    "pred_drift",
    "error_drift",
    "nonfinite_burst",
    "step_skew",
    "host_stall",
    "host_lost",
)

#: drift kinds read a DriftMonitor-published gauge (obs/drift.py); the
#: monitor keeps its gauges at 0.0 until its warm-up row count is met,
#: so a plain over-threshold compare is safe from cold-start noise
_DRIFT_KINDS = ("feature_drift", "pred_drift", "error_drift")

INCIDENT_MANIFEST = "incident_manifest.json"
INCIDENT_MANIFEST_VERSION = 1
#: how many of the flight record's last lines an incident copies
FLIGHT_TAIL_LINES = 100


@dataclasses.dataclass(frozen=True)
class TriggerRule:
    """One declarative SLO rule. ``metric`` names a registry metric
    (``latency_p99``/``queue_depth``/``queue_age``/``nonfinite_burst``)
    or an observed series (``mfu_drop``/``loss_spike`` — values fed via
    :meth:`TriggerEngine.observe`). ``threshold`` is in the metric's
    own unit for level rules, and a RATIO of the rolling median for
    ``mfu_drop`` (fire when cur < threshold x median) and
    ``loss_spike`` (fire when cur > threshold x median)."""

    name: str
    kind: str
    metric: str
    threshold: float
    window: int = 5
    min_samples: int = 2

    def __post_init__(self):
        if self.kind not in RULE_KINDS:
            raise ValueError(
                f"unknown trigger rule kind {self.kind!r} (one of {RULE_KINDS})"
            )


@dataclasses.dataclass
class TriggerVerdict:
    """Why a rule fired: the observed value, the threshold it crossed,
    and (for median rules) the baseline — the evidence half of the
    incident bundle's ``trigger.json``."""

    rule: str
    kind: str
    metric: str
    observed: float
    threshold: float
    fired_t: float
    injected: bool = False
    detail: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _median(vals) -> float:
    s = sorted(vals)
    n = len(s)
    if not n:
        return 0.0
    mid = n // 2
    return float(s[mid]) if n % 2 else float((s[mid - 1] + s[mid]) / 2.0)


class TriggerEngine:
    """Evaluate a rule set against the live registry + observed series.

    ``evaluate()`` returns the verdicts that PASSED rate limiting (at
    most one per call — one capture at a time is all the profiler can
    do anyway); suppressed firings are counted, never lost silently.
    ``clock`` is injectable for tests (monotonic seconds).
    """

    def __init__(
        self,
        rules,
        registry=None,
        cooldown_s: Optional[float] = None,
        max_incidents: Optional[int] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.rules: List[TriggerRule] = list(rules)
        if registry is None:
            from hydragnn_tpu_torch.obs.registry import get_registry

            registry = get_registry()
        self.registry = registry
        if cooldown_s is None:
            cooldown_s = _knob("HGTORCH_INCIDENT_COOLDOWN_S", 300.0)
        if max_incidents is None:
            max_incidents = int(_knob("HGTORCH_INCIDENT_MAX", 5))
        self.cooldown_s = float(cooldown_s)
        self.max_incidents = int(max_incidents)
        self._clock = clock
        self._series: Dict[str, deque] = {}
        self._counter_last: Dict[str, float] = {}
        self._last_fire_t: Optional[float] = None
        self.fired: List[TriggerVerdict] = []
        self.suppressed = 0
        self._eval_s = 0.0
        self._t0 = clock()

    def baseline_counters(self) -> None:
        """Count each ``nonfinite_burst`` rule's counter from its value
        now, not from the process's start (the global registry outlives
        a run; the training loop calls this for each run's engine)."""
        for rule in self.rules:
            if rule.kind == "nonfinite_burst":
                c = self.registry.get(rule.metric)
                if c is not None and hasattr(c, "value"):
                    self._counter_last[rule.name] = float(c.value)

    # -- inputs ------------------------------------------------------------

    def observe(self, name: str, value) -> None:
        """Feed one sample of a named series (per-epoch MFU, loss) for
        the rolling-median rules. ``None`` samples (e.g. MFU off-TPU)
        are dropped so they never poison a median."""
        if value is None:
            return
        dq = self._series.get(name)
        if dq is None:
            dq = self._series[name] = deque(maxlen=64)
        dq.append(float(value))

    # -- evaluation --------------------------------------------------------

    def _eval_rule(self, rule: TriggerRule) -> Optional[TriggerVerdict]:
        now = time.time()
        if rule.kind == "latency_p99":
            h = self.registry.get(rule.metric)
            if h is None or not hasattr(h, "snapshot") or h.count < rule.min_samples:
                return None
            snap = h.snapshot()
            p99 = float(snap.get("p99", 0.0))
            if p99 > rule.threshold:
                return TriggerVerdict(
                    rule.name, rule.kind, rule.metric, round(p99, 6),
                    rule.threshold, now, detail={"count": snap.get("count")},
                )
            return None
        if rule.kind in (
            "queue_depth", "queue_age", "step_skew", "host_stall", "host_lost"
        ):
            g = self.registry.get(rule.metric)
            if g is None or not hasattr(g, "value"):
                return None
            v = float(g.value)
            if v > rule.threshold:
                detail: Dict[str, Any] = {}
                if rule.kind in ("step_skew", "host_stall"):
                    # evidence: which host the podview monitor blamed
                    sg = self.registry.get("podview.slowest_host")
                    if sg is not None and hasattr(sg, "value"):
                        detail["slowest_host"] = int(sg.value)
                if rule.kind == "host_lost":
                    # evidence: which host the liveness view declared lost
                    lg = self.registry.get("podview.lost_host")
                    if lg is not None and hasattr(lg, "value"):
                        detail["lost_host"] = int(lg.value)
                return TriggerVerdict(
                    rule.name, rule.kind, rule.metric, round(v, 6),
                    rule.threshold, now, detail=detail,
                )
            return None
        if rule.kind in _DRIFT_KINDS:
            g = self.registry.get(rule.metric)
            if g is None or not hasattr(g, "value"):
                return None
            v = float(g.value)
            if v > rule.threshold:
                # evidence: how many rows the sketch had folded in when
                # it breached (the DriftMonitor publishes row-count
                # gauges next to each distance gauge)
                rows = {}
                base = rule.metric.rsplit(".", 1)[0]
                for key in ("feature_rows", "pred_rows", "labeled_rows"):
                    rg = self.registry.get(f"{base}.{key}")
                    if rg is not None and hasattr(rg, "value"):
                        rows[key] = float(rg.value)
                return TriggerVerdict(
                    rule.name, rule.kind, rule.metric, round(v, 6),
                    rule.threshold, now, detail=rows,
                )
            return None
        if rule.kind == "nonfinite_burst":
            c = self.registry.get(rule.metric)
            if c is None or not hasattr(c, "value"):
                return None
            cur = float(c.value)
            last = self._counter_last.get(rule.name, 0.0)
            self._counter_last[rule.name] = cur
            delta = cur - last
            if delta >= rule.threshold:
                return TriggerVerdict(
                    rule.name, rule.kind, rule.metric, round(delta, 6),
                    rule.threshold, now, detail={"counter_total": cur},
                )
            return None
        if rule.kind == "pilot_stuck":
            # raised directly by the retrain pilot, never engine-evaluated
            return None
        # rolling-median series rules: mfu_drop / loss_spike
        dq = self._series.get(rule.metric)
        if dq is None or len(dq) < rule.min_samples + 1:
            return None
        cur = dq[-1]
        prev = list(dq)[:-1][-rule.window:]
        med = _median(prev)
        if med <= 0:
            return None
        if rule.kind == "mfu_drop":
            hit = cur < rule.threshold * med
        else:  # loss_spike: the flag_anomalies heuristic, online
            hit = cur > rule.threshold * med
        if hit:
            return TriggerVerdict(
                rule.name, rule.kind, rule.metric, round(cur, 6),
                rule.threshold, now,
                detail={"rolling_median": round(med, 6), "window": len(prev)},
            )
        return None

    def evaluate(self) -> List[TriggerVerdict]:
        """One evaluation pass: every rule is checked, the injected
        rule (``HGTORCH_INJECT_TRIGGER``) force-fires, and rate
        limiting admits at most one verdict."""
        t_eval0 = time.perf_counter()
        from hydragnn_tpu_torch.resilience.inject import injected_trigger

        forced = injected_trigger({r.name for r in self.rules})
        verdicts: List[TriggerVerdict] = []
        for rule in self.rules:
            v = self._eval_rule(rule)
            if v is None and forced == rule.name:
                v = TriggerVerdict(
                    rule.name, rule.kind, rule.metric, -1.0,
                    rule.threshold, time.time(), injected=True,
                    detail={"injected": "HGTORCH_INJECT_TRIGGER"},
                )
            if v is not None:
                verdicts.append(v)
        admitted: List[TriggerVerdict] = []
        now = self._clock()
        for v in verdicts:
            limited = len(self.fired) >= self.max_incidents or (
                self._last_fire_t is not None
                and now - self._last_fire_t < self.cooldown_s
            )
            if limited or admitted:
                self.suppressed += 1
                continue
            self._last_fire_t = now
            self.fired.append(v)
            admitted.append(v)
        self._eval_s += time.perf_counter() - t_eval0
        return admitted

    # -- accounting --------------------------------------------------------

    def overhead_frac(self, capture_s: float = 0.0) -> float:
        """(evaluation + capture) time as a fraction of wall time since
        the engine was built — the number the <1%-overhead acceptance
        gate asserts on clean runs."""
        wall = max(self._clock() - self._t0, 1e-9)
        return (self._eval_s + capture_s) / wall

    def summary(self, capture_s: float = 0.0) -> dict:
        """Flight-record-ready trigger block for ``run_end``."""
        return {
            "rules": [r.name for r in self.rules],
            "fired": len(self.fired),
            "suppressed": self.suppressed,
            "incidents": [v.rule for v in self.fired],
            "overhead_frac": round(self.overhead_frac(capture_s), 6),
        }


# ---------------------------------------------------------------------------
# incident bundles
# ---------------------------------------------------------------------------


def _atomic_json(path: str, data) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(data, f, indent=1, sort_keys=True)
    os.replace(tmp, path)


def chip_hygiene_report() -> dict:
    """The card's compute processes as ``nvidia-smi
    --query-compute-apps=pid,process_name,used_memory
    --format=csv,noheader`` lists them (another process on the card skews
    an incident's profile), or ``{"available": False}`` where the tool is
    absent or fails."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,process_name,used_memory",
                              "--format=csv,noheader"], capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.SubprocessError) as exc:
        return {"available": False, "error": str(exc)[:200]}
    if out.returncode != 0:
        return {"available": False, "error": (out.stderr or out.stdout).strip()[:200]}
    procs = []
    for ln in out.stdout.strip().splitlines():
        parts = [p.strip() for p in ln.split(",")]
        if len(parts) >= 3:
            procs.append({"pid": parts[0], "process_name": ",".join(parts[1:-1]), "used_memory": parts[-1]})
    return {"available": True, "own_pid": os.getpid(), "compute_apps": procs}


class Incident:
    """One open incident: sidecars written at open, a bounded profiler
    capture driven by :meth:`tick`, and ``incident_manifest.json``
    written LAST at :meth:`close` — a bundle without a manifest IS the
    crashed-mid-capture signature, and stays readable as such."""

    def __init__(
        self,
        incident_id: str,
        bundle_dir: str,
        verdict: TriggerVerdict,
        profile_steps: int,
        profile_s: float,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.id = incident_id
        self.dir = bundle_dir
        self.verdict = verdict
        self.profile_dir = os.path.join(bundle_dir, "profile")
        self.profile_steps = max(1, int(profile_steps))
        self.profile_s = float(profile_s)
        self._clock = clock
        self._t_open = clock()
        self._t_capture0: Optional[float] = None
        self._capturing = False
        self._capture_attempted = False
        self.steps = 0
        self.capture_s = 0.0
        self.closed = False
        self.files: Dict[str, str] = {}

    # -- sidecars ----------------------------------------------------------

    def write_sidecars(self, registry=None, flight_path: Optional[str] = None,
                       device=None, podview=None) -> None:
        _atomic_json(os.path.join(self.dir, "trigger.json"), self.verdict.to_dict())
        self.files["trigger"] = "trigger.json"
        if registry is not None:
            try:
                _atomic_json(
                    os.path.join(self.dir, "metrics.json"), registry.snapshot()
                )
                self.files["metrics"] = "metrics.json"
            except Exception:
                pass
        if flight_path and os.path.exists(flight_path):
            try:
                with open(flight_path) as f:
                    lines = f.read().splitlines()
                tail = "\n".join(lines[-FLIGHT_TAIL_LINES:])
                with open(os.path.join(self.dir, "flight_tail.jsonl"), "w") as f:
                    f.write(tail + ("\n" if tail else ""))
                self.files["flight_tail"] = "flight_tail.jsonl"
            except OSError:
                pass
        if podview is not None:
            # the pod's evidence (obs/podview.py SkewMonitor): the skew
            # report naming the host, and every other host shard's tail
            # (host 0's is flight_tail.jsonl)
            try:
                _atomic_json(os.path.join(self.dir, "podview_report.json"), podview.report())
                self.files["podview_report"] = "podview_report.json"
                for h, lines in sorted(podview.shard_tails(FLIGHT_TAIL_LINES).items()):
                    if h == 0:
                        continue
                    name = f"flight_tail.host{h}.jsonl"
                    with open(os.path.join(self.dir, name), "w") as f:
                        f.write("\n".join(lines) + ("\n" if lines else ""))
                    self.files[f"flight_tail_host{h}"] = name
            except Exception:
                pass  # evidence capture never fails the incident
        _atomic_json(
            os.path.join(self.dir, "chip_hygiene.json"), chip_hygiene_report()
        )
        self.files["chip_hygiene"] = "chip_hygiene.json"
        from hydragnn_tpu_torch.obs.introspect import device_memory_stats

        try:
            mem = device_memory_stats(device)
        except Exception:
            mem = {"available": False}
        _atomic_json(os.path.join(self.dir, "memory.json"), mem)
        self.files["memory"] = "memory.json"

    # -- bounded profiler capture ------------------------------------------

    def tick(self) -> bool:
        """Drive the capture: the first tick starts a profiler trace
        into the bundle's ``profile/``; the capture stops after
        ``profile_steps`` ticks or ``profile_s`` seconds, whichever
        first. Returns True while the incident wants more ticks."""
        from hydragnn_tpu_torch.utils import profile

        if self.closed:
            return False
        if not self._capture_attempted:
            self._capture_attempted = True
            # refused when another capture (epoch profiler, earlier
            # incident) holds the process's one profiler slot
            self._capturing = profile.try_start_capture(self.profile_dir)
            self._t_capture0 = self._clock()
        self.steps += 1
        elapsed = (
            self._clock() - self._t_capture0 if self._t_capture0 is not None else 0.0
        )
        if self.steps >= self.profile_steps or elapsed >= self.profile_s:
            self._stop_capture()
            return False
        return True

    def _stop_capture(self) -> None:
        from hydragnn_tpu_torch.utils import profile

        if self._capturing:
            try:
                profile.stop_capture()
            except Exception:
                pass
            self._capturing = False
            if self._t_capture0 is not None:
                self.capture_s = self._clock() - self._t_capture0

    def profile_nonempty(self) -> bool:
        for _root, _dirs, files in os.walk(self.profile_dir):
            if files:
                return True
        return False

    # -- close -------------------------------------------------------------

    def close(self, status: str = "ok") -> dict:
        """Finalize: stop any live capture and write the manifest LAST
        (atomic). Idempotent — the first close wins."""
        if self.closed:
            return {}
        self._stop_capture()
        self.closed = True
        manifest = {
            "schema_version": INCIDENT_MANIFEST_VERSION,
            "id": self.id,
            "rule": self.verdict.rule,
            "kind": self.verdict.kind,
            "status": status,
            "trigger": self.verdict.to_dict(),
            "files": dict(self.files),
            "profile": {
                "captured": self._capture_attempted and os.path.isdir(self.profile_dir),
                "steps": self.steps,
                "duration_s": round(self.capture_s, 3),
                "nonempty": self.profile_nonempty(),
            },
        }
        _atomic_json(os.path.join(self.dir, INCIDENT_MANIFEST), manifest)
        return manifest


class IncidentRecorder:
    """Bundle writer for one run: owns the ``incidents/`` directory,
    enforces the capture overhead budget, and keeps at most ONE
    incident open (the profiler has one trace slot; a second verdict
    during a capture is suppressed by the engine's rate limiter)."""

    def __init__(
        self,
        root: str,
        registry=None,
        flight_path: Optional[str] = None,
        profile_steps: Optional[int] = None,
        profile_s: Optional[float] = None,
        overhead_frac: Optional[float] = None,
        clock: Callable[[], float] = time.monotonic,
        on_close: Optional[Callable[[Incident, str], None]] = None,
        device=None,
        podview=None,
    ):
        self.root = root
        # obs/podview.py's SkewMonitor: every bundle then carries
        # podview_report.json and the other hosts' shard tails
        self.podview = podview
        self.registry = registry
        self.flight_path = flight_path
        # called after each incident closes (outside the lock) with
        # (incident, status): the server releases the spool shards it
        # pinned for the incident's drift evidence
        self.on_close = on_close
        # the run's device: memory.json reads its watermark
        self.device = device
        if profile_steps is None:
            profile_steps = int(_knob("HGTORCH_INCIDENT_PROFILE_STEPS", 3))
        if profile_s is None:
            profile_s = _knob("HGTORCH_INCIDENT_PROFILE_S", 10.0)
        if overhead_frac is None:
            overhead_frac = (
                _knob("HGTORCH_INCIDENT_OVERHEAD_PCT", 5.0) / 100.0
            )
        self.profile_steps = int(profile_steps)
        self.profile_s = float(profile_s)
        self.overhead_frac = float(overhead_frac)
        self._clock = clock
        self._t0 = clock()
        self._lock = syncdebug.maybe_wrap(threading.Lock(), "triggers.IncidentRecorder._lock")
        self._seq = 0
        self._open: Optional[Incident] = None
        self.capture_s = 0.0
        self.suppressed_budget = 0
        self.closed_ids: List[str] = []
    def _budget_exhausted(self) -> bool:
        # charges capture time already SPENT against wall time, so the
        # first capture of a run is always admitted (a short CI run must
        # still capture its one planned incident) and repeat captures
        # are throttled to the budgeted fraction thereafter
        wall = max(self._clock() - self._t0, 1e-9)
        return self.capture_s / wall > self.overhead_frac

    def open_incident(self, verdict: TriggerVerdict, flight=None) -> Optional[Incident]:
        """Open a bundle for a verdict; returns None (and counts a
        budget suppression) when a capture is already open or the
        overhead budget is spent. The ``incident`` flight event is
        recorded at OPEN so even a crash mid-capture leaves the
        pointer in the run's event log."""
        with self._lock:
            if self._open is not None:
                return None
            if self._budget_exhausted():
                self.suppressed_budget += 1
                return None
            self._seq += 1
            iid = f"i{self._seq:03d}-{verdict.rule}"
            bundle = os.path.join(self.root, iid)
            try:
                os.makedirs(bundle, exist_ok=True)
            except OSError:
                return None
            inc = Incident(
                iid, bundle, verdict, self.profile_steps, self.profile_s,
                clock=self._clock,
            )
            self._open = inc
        inc.write_sidecars(
            registry=self.registry,
            flight_path=self.flight_path,
            device=self.device,
            podview=self.podview,
        )
        if flight is not None:
            flight.record("incident", id=iid, rule=verdict.rule, path=bundle)
        return inc

    @property
    def open(self) -> Optional[Incident]:
        with self._lock:
            return self._open

    def tick(self) -> None:
        """Call once per unit of work (train step, serve batch): drives
        the open incident's capture and closes it when bounded."""
        inc = self.open
        if inc is None:
            return
        if not inc.tick():
            self._close(inc, "ok")

    def _close(self, inc: Incident, status: str) -> None:
        inc.close(status)
        with self._lock:
            self.capture_s += inc.capture_s
            self.closed_ids.append(inc.id)
            if self._open is inc:
                self._open = None
        if self.on_close is not None:
            try:
                self.on_close(inc, status)
            except Exception:
                pass  # a cleanup hook never fails a close

    def finalize(self) -> None:
        """Run teardown (clean or crashed): close any open incident so
        its capture is stopped and its manifest written."""
        inc = self.open
        if inc is not None:
            self._close(inc, "truncated")


# ---------------------------------------------------------------------------
# bundle validation
# ---------------------------------------------------------------------------


def validate_incident_manifest(data: Any) -> List[str]:
    """Schema-check one parsed manifest; returns problems (empty = ok)."""
    if not isinstance(data, dict):
        return [f"expected a JSON object, got {type(data).__name__}"]
    problems: List[str] = []
    for field, types in (
        ("schema_version", (int,)),
        ("id", (str,)),
        ("rule", (str,)),
        ("kind", (str,)),
        ("status", (str,)),
        ("trigger", (dict,)),
        ("files", (dict,)),
        ("profile", (dict,)),
    ):
        if field not in data:
            problems.append(f"missing required field '{field}'")
        elif not isinstance(data[field], types):
            problems.append(
                f"field '{field}' is {type(data[field]).__name__}, expected "
                + "/".join(t.__name__ for t in types)
            )
    if not problems:
        trig = data["trigger"]
        for field in ("rule", "kind", "observed", "threshold"):
            if field not in trig:
                problems.append(f"trigger missing field '{field}'")
        prof = data["profile"]
        for field in ("captured", "steps", "duration_s", "nonempty"):
            if field not in prof:
                problems.append(f"profile missing field '{field}'")
        if data.get("kind") not in RULE_KINDS:
            problems.append(f"unknown rule kind {data.get('kind')!r}")
    return problems


def validate_incident_bundle(bundle_dir: str) -> List[str]:
    """Validate one on-disk bundle: manifest schema plus existence of
    every file the manifest claims. A missing manifest is reported as
    exactly that (the crashed-mid-write case), not a parse explosion."""
    manifest_path = os.path.join(bundle_dir, INCIDENT_MANIFEST)
    if not os.path.exists(manifest_path):
        return ["manifest missing (run crashed mid-incident-write?)"]
    try:
        with open(manifest_path) as f:
            data = json.load(f)
    except (OSError, ValueError) as exc:
        return [f"unreadable manifest: {exc}"]
    problems = validate_incident_manifest(data)
    for label, rel in (data.get("files") or {}).items():
        if not isinstance(rel, str) or not os.path.exists(
            os.path.join(bundle_dir, rel)
        ):
            problems.append(f"files.{label} -> {rel!r} does not exist in bundle")
    prof = data.get("profile") or {}
    if prof.get("nonempty"):
        pdir = os.path.join(bundle_dir, "profile")
        has_file = any(files for _r, _d, files in os.walk(pdir))
        if not has_file:
            problems.append("manifest claims non-empty profile but profile/ is empty")
    return problems


def list_incidents(incidents_root: str) -> List[str]:
    """Bundle dirs under a run's ``incidents/`` root, sorted by id."""
    if not os.path.isdir(incidents_root):
        return []
    return sorted(
        os.path.join(incidents_root, name)
        for name in os.listdir(incidents_root)
        if os.path.isdir(os.path.join(incidents_root, name))
    )
