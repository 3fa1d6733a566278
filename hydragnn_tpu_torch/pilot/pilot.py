"""The retrain pilot: a fault-tolerant drift -> fine-tune -> canary ->
hot-reload state machine over one serving stack (the port's counterpart
of ``hydragnn_tpu/pilot/pilot.py``, with its states, journal, flight
events, gauges and exit codes).

States (one journaled and flight-recorded transition each)::

    idle -> drift_confirmed -> fine_tuning -> canary -> reloading
         -> cooldown -> idle            (success: drift sketches reset)
                     -> cooldown        (any failure: old weights serve)
                     -> stuck           (K consecutive failed cycles)

Every stage may fail and none can take the serving path down:

  - the fine-tune is a CHILD process (``python -m
    hydragnn_tpu_torch.pilot.tune``, started with ``subprocess``, never a
    ``multiprocessing`` fork of the serving process's CUDA context) under
    the bounded restart supervisor (``resilience/supervisor.py``), with
    exponential backoff and a hard wall clock (``wall_clock_runner``) for
    a child wedged where no in-process watchdog can fire;
  - the candidate must pass the canary gate on BOTH the held-out
    reference slice and the drifted spool window before any weight swap;
  - the reload is the server's canaried, rollback-built-in ``reload()``
    (or the fleet's ``rolling_reload``): a torn or non-finite candidate
    leaves the old weights serving;
  - a single-retrain lock and a cooldown window stop retrain storms
    (drift incidents during cooldown are counted, never acted on);
  - ``HGTORCH_PILOT_STUCK_AFTER`` consecutive failed cycles escalate to a
    terminal ``stuck`` state and a ``pilot_stuck`` incident;
  - every transition is committed to the journal (``pilot/journal.py``)
    BEFORE it takes effect, so a pilot killed mid-cycle restarts into a
    safe state instead of resuming a half-done retrain.

The pilot pins the incident's spool shards for the whole cycle (pins of
its own, independent of the incident's), so the fine-tune's inputs cannot
be evicted under it.

The canary builds the candidate's scratch model on the server's device
(``serve/buckets.py:build_module``) and scores it, and the live weights,
through the server's own eager path at the natural pad
(``BucketGraphCache.run_eager``, the oversize fallback's). Each of these
holds the shared side of the device lock (``serve/buckets.py:DEVICE_LOCK``):
beside the dispatch thread's replays, and never during a capture.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from hydragnn_tpu_torch.obs.triggers import _knob
from hydragnn_tpu_torch.pilot.journal import JOURNAL_NAME, PilotJournal
from hydragnn_tpu_torch.resilience import inject
from hydragnn_tpu_torch.utils import syncdebug

PILOT_STATES = ("idle", "drift_confirmed", "fine_tuning", "canary", "reloading", "cooldown", "stuck")
#: Gauge encoding of ``<prefix>.pilot.state`` (``tools/serve_probe.py`` reads it).
STATE_CODES = {name: i for i, name in enumerate(PILOT_STATES)}


def _knob_int(name: str, default: int) -> int:
    return int(_knob(name, default))


@dataclasses.dataclass
class PilotConfig:
    """The pilot's policy; every default is its ``HGTORCH_PILOT_*`` knob,
    read at construction (the JAX package's defaults)."""

    cooldown_s: float = dataclasses.field(default_factory=lambda: _knob("HGTORCH_PILOT_COOLDOWN_S", 60.0))
    stuck_after: int = dataclasses.field(default_factory=lambda: _knob_int("HGTORCH_PILOT_STUCK_AFTER", 3))
    tune_attempts: int = dataclasses.field(default_factory=lambda: _knob_int("HGTORCH_PILOT_TUNE_ATTEMPTS", 2))
    tune_backoff_s: float = dataclasses.field(default_factory=lambda: _knob("HGTORCH_PILOT_TUNE_BACKOFF_S", 1.0))
    max_wall_s: float = dataclasses.field(default_factory=lambda: _knob("HGTORCH_PILOT_MAX_WALL_S", 600.0))
    canary_samples: int = dataclasses.field(default_factory=lambda: _knob_int("HGTORCH_PILOT_CANARY_SAMPLES", 16))
    canary_tol: float = dataclasses.field(default_factory=lambda: _knob("HGTORCH_PILOT_CANARY_TOL", 0.2))
    tune_epochs: int = dataclasses.field(default_factory=lambda: _knob_int("HGTORCH_PILOT_TUNE_EPOCHS", 2))


class RetrainPilot:
    """One pilot a served model; ``server.attach_pilot(pilot)`` routes its
    drift incidents here.

    Seams: ``tuner(candidate) -> result dict`` replaces the supervised
    child fine-tune; ``reloader(candidate)`` replaces the hot reload (the
    server's ``reload``, or the fleet's ``rolling_reload`` when ``fleet``
    and ``fleet_model`` are given); ``clock`` drives the cooldown.
    ``async_cycles=False`` runs a cycle inline on the notifying thread
    (tests); by default each cycle runs on a worker thread of its own,
    so the dispatch thread never waits for a fine-tune.
    """

    def __init__(
        self,
        server,
        serving_run: str,
        *,
        reference_samples: Optional[Sequence] = None,
        config: Optional[PilotConfig] = None,
        tuner: Optional[Callable[[str], Dict[str, Any]]] = None,
        reloader: Optional[Callable[[str], Any]] = None,
        fleet=None,
        fleet_model: Optional[str] = None,
        journal_path: Optional[str] = None,
        flight=None,
        clock: Callable[[], float] = time.monotonic,
        async_cycles: bool = True,
    ):
        self.server = server
        self.serving_run = serving_run
        self.log_dir = server.log_dir
        self.reference_samples = list(reference_samples or [])
        self.config = config or PilotConfig()
        self.tuner = tuner or self._default_tuner
        self.reloader = reloader or self._default_reloader
        self.fleet = fleet
        self.fleet_model = fleet_model
        self.flight = flight if flight is not None else server.flight
        self.clock = clock
        self.async_cycles = async_cycles
        self.journal = PilotJournal(journal_path or os.path.join(self.log_dir, serving_run, JOURNAL_NAME))
        self._lock = syncdebug.maybe_wrap(threading.RLock(), "pilot.RetrainPilot._lock")
        # the state and counters below are written under _lock
        self.state = "idle"
        self.cycle = 0
        self.failed_cycles = 0
        self.suppressed = 0
        self.last_cycle_ok: Optional[bool] = None
        self._cooldown_t0 = 0.0
        self._pins: List[str] = []
        # written by the cycle's owner before the worker starts; joined before reuse
        self._worker: Optional[threading.Thread] = None
        reg = server.metrics.registry
        prefix = server.metrics.prefix
        self._g_state = reg.gauge(f"{prefix}.pilot.state")
        self._g_last_ok = reg.gauge(f"{prefix}.pilot.last_cycle_ok")
        self._g_cycles = reg.gauge(f"{prefix}.pilot.cycles")
        self._g_failed = reg.gauge(f"{prefix}.pilot.failed_cycles")
        self._g_suppressed = reg.gauge(f"{prefix}.pilot.suppressed")
        self._g_last_ok.set(-1.0)  # no cycle flown yet
        self._recover()

    # -- restart recovery --------------------------------------------------

    def _recover(self) -> None:
        """Apply the journal's restart class: a resting tail carries over;
        a mid-cycle tail is a pilot killed inside a retrain, whose cycle
        counts as failed and lands in cooldown (or stuck when the budget
        is spent). Its pins died with the old process."""
        rec = self.journal.recover()
        with self._lock:
            if rec["status"] == "fresh":
                self._transition_locked("idle", reason="fresh")
                return
            self.cycle = rec["cycle"]
            self.failed_cycles = rec["failed_cycles"]
            if rec["status"] == "clean":
                if rec["state"] == "stuck":
                    self._transition_locked("stuck", reason="recovered_stuck")
                elif rec["state"] == "cooldown":
                    self._cooldown_t0 = self.clock()
                    self._transition_locked("cooldown", reason="recovered_cooldown")
                else:
                    self._transition_locked("idle", reason="recovered_idle")
                return
            self.failed_cycles += 1
            self.last_cycle_ok = False
            self._g_last_ok.set(0.0)
            if self.failed_cycles >= self.config.stuck_after:
                self._escalate_stuck_locked(f"crashed in {rec['state']} (cycle {rec['cycle']})")
            else:
                self._cooldown_t0 = self.clock()
                self._transition_locked("cooldown", reason="recovered_after_crash", crashed_in=rec["state"])

    # -- transitions -------------------------------------------------------

    def _transition_locked(self, state: str, **detail: Any) -> None:
        """Commit one transition (``_lock`` held): the journal FIRST, then
        the state, the gauges and the ``pilot`` flight event."""
        self.journal.append(state, self.cycle, self.failed_cycles, **detail)
        self.state = state
        self._g_state.set(float(STATE_CODES[state]))
        self._g_cycles.set(float(self.cycle))
        self._g_failed.set(float(self.failed_cycles))
        if self.flight is not None:
            self.flight.record("pilot", state=state, cycle=self.cycle, failed_cycles=self.failed_cycles, **detail)

    def _maybe_leave_cooldown_locked(self) -> None:
        if self.state == "cooldown" and self.clock() - self._cooldown_t0 >= self.config.cooldown_s:
            self._transition_locked("idle", reason="cooldown_elapsed")

    def poll(self) -> str:
        """Advance the time-driven transition (cooldown expiry); returns
        the state."""
        with self._lock:
            self._maybe_leave_cooldown_locked()
            return self.state

    # -- incident intake (the server's dispatch thread) --------------------

    def on_drift_incident(self, incident, verdict) -> bool:
        """One drift incident, its evidence written. Starts a cycle iff
        the pilot is idle (the single-retrain lock and the cooldown live
        here); returns whether it did."""
        with self._lock:
            self._maybe_leave_cooldown_locked()
            if self.state != "idle":
                self.suppressed += 1
                self._g_suppressed.set(float(self.suppressed))
                if self.flight is not None:
                    self.flight.record("pilot", state=self.state, cycle=self.cycle,
                                       suppressed_incident=getattr(incident, "id", None),
                                       suppressed_total=self.suppressed)
                return False
            self.cycle += 1
            cycle = self.cycle
            # the pilot's OWN pins: the incident's go when its bundle
            # closes, these when the cycle ends
            window = self.server.pin_spool(self._incident_shards(incident))
            self._pins = window
            self._transition_locked("drift_confirmed", rule=verdict.rule, rule_kind=verdict.kind,
                                    incident=getattr(incident, "id", None), pinned_shards=window)
        if self.async_cycles:
            self._worker = threading.Thread(target=self._run_cycle, name=f"pilot-cycle-{cycle}", daemon=True)
            self._worker.start()
        else:
            self._run_cycle()
        return True

    @staticmethod
    def _incident_shards(incident) -> List[str]:
        """The spool shards the incident's drift report names (written by
        the server's ``_attach_drift_evidence``); [] without one."""
        try:
            with open(os.path.join(incident.dir, "drift_report.json")) as f:
                report = json.load(f)
            return list(report.get("pinned_shards") or report.get("spool_window", {}).get("shards") or [])
        except Exception:
            return []

    def join(self, timeout: Optional[float] = None) -> None:
        """Wait for a cycle's worker thread."""
        w = self._worker
        if w is not None and w.is_alive():
            w.join(timeout)

    # -- one retrain cycle -------------------------------------------------

    def _run_cycle(self) -> None:
        with self._lock:
            candidate = f"{self.serving_run}-pilot-c{self.cycle}"
        try:
            with self._lock:
                self._transition_locked("fine_tuning", candidate=candidate)
            try:
                result = self.tuner(candidate)
            except Exception as exc:
                self._fail_cycle("fine_tune_error", candidate, error=repr(exc)[-200:])
                return
            if not result or result.get("status") != "completed":
                self._fail_cycle("fine_tune_" + str((result or {}).get("status", "failed")), candidate,
                                 attempts=(result or {}).get("attempts"), cause=(result or {}).get("cause"))
                return
            with self._lock:
                self._transition_locked("canary", candidate=candidate)
            try:
                verdict = self._canary(candidate)
            except Exception as exc:
                self._fail_cycle("canary_error", candidate, error=repr(exc)[-200:])
                return
            if not verdict["ok"]:
                self._fail_cycle("canary_regression", candidate, **verdict)
                return
            if inject.pilot_torn_reload():
                _tear_checkpoint(self.log_dir, candidate)
            with self._lock:
                self._transition_locked("reloading", candidate=candidate, **verdict)
            try:
                self.reloader(candidate)
            except Exception as exc:
                # the reload's own canary and rollback kept the old
                # weights serving; the pilot records the rejection
                self._fail_cycle("reload_failed", candidate, error=repr(exc)[-200:])
                return
            # new weights must not re-trip the drift rules on the sketch
            # mass the old ones accumulated
            self.server.reset_drift()
            with self._lock:
                self.failed_cycles = 0
                self.last_cycle_ok = True
                self._g_last_ok.set(1.0)
                self._cooldown_t0 = self.clock()
                self._transition_locked("cooldown", reason="reloaded", candidate=candidate, **verdict)
        finally:
            with self._lock:
                pins, self._pins = self._pins, []
            if pins:
                self.server.unpin_spool(pins)

    def _fail_cycle(self, reason: str, candidate: str, **detail: Any) -> None:
        with self._lock:
            self.failed_cycles += 1
            self.last_cycle_ok = False
            self._g_last_ok.set(0.0)
            if self.failed_cycles >= self.config.stuck_after:
                self._escalate_stuck_locked(reason, candidate=candidate, **detail)
                return
            self._cooldown_t0 = self.clock()
            self._transition_locked("cooldown", reason=reason, candidate=candidate, **detail)

    def _escalate_stuck_locked(self, reason: str, **detail: Any) -> None:
        """The terminal state: drift the loop cannot fix. The pilot stops
        retrying and opens a ``pilot_stuck`` incident as the page."""
        self._transition_locked("stuck", reason=reason, **detail)
        from hydragnn_tpu_torch.obs.triggers import TriggerVerdict

        verdict = TriggerVerdict(
            rule="pilot",
            kind="pilot_stuck",
            metric=f"{self.server.metrics.prefix}.pilot.failed_cycles",
            observed=float(self.failed_cycles),
            threshold=float(self.config.stuck_after),
            fired_t=time.time(),
            detail={"reason": reason},
        )
        try:
            self.server.open_pilot_incident(verdict)
        except Exception:
            pass  # the journal and the flight event stay the escalation's record

    # -- the default fine-tune ---------------------------------------------

    def _default_tuner(self, candidate: str) -> Dict[str, Any]:
        """The supervised child: ``python -m hydragnn_tpu_torch.pilot.tune``
        on the server's device under the restart supervisor and the hard
        wall clock: crash-class exits retry with backoff up to
        ``tune_attempts``; a wedged child is killed after ``max_wall_s``
        and classified hung."""
        from hydragnn_tpu_torch.resilience.supervisor import Supervisor, SupervisorPolicy, wall_clock_runner

        spool = self.server.spool_dir()
        argv = [
            sys.executable, "-m", "hydragnn_tpu_torch.pilot.tune",
            "--log-dir", self.log_dir,
            "--serving-run", self.serving_run,
            "--candidate", candidate,
            "--epochs", str(self.config.tune_epochs),
            "--device", str(self.server.device),
        ]
        if spool:
            argv += ["--spool-dir", spool]
        with self._lock:
            pins = list(self._pins)
        if pins:
            argv += ["--shards", ",".join(pins)]
        policy = SupervisorPolicy(max_restarts=self.config.tune_attempts, backoff_base_s=self.config.tune_backoff_s)
        sup = Supervisor(argv, policy=policy, env=dict(os.environ), runner=wall_clock_runner(self.config.max_wall_s))
        return sup.run()

    # -- the canary gate ---------------------------------------------------

    def _default_reloader(self, candidate: str):
        if self.fleet is not None:
            return self.fleet.rolling_reload(self.fleet_model, candidate, log_dir=self.log_dir)
        return self.server.reload(candidate, log_dir=self.log_dir)

    def _canary(self, candidate: str) -> Dict[str, Any]:
        """Score the live weights and the candidate on the held-out
        reference slice AND the pinned drifted window; the candidate must
        stay within ``canary_tol`` of the live weights on both. The
        absolute ``+ tol`` matters on the window, whose targets are the
        old weights' own predictions (a baseline MAE of about 0)."""
        from hydragnn_tpu_torch.serve.buckets import build_module
        from hydragnn_tpu_torch.serve.registry import load_served_variables

        srv = self.server
        cand_state = load_served_variables(srv.served, candidate, self.log_dir)
        cand_model = build_module(srv.served.cfg, srv.device, cand_state)
        tol = self.config.canary_tol
        inflate = 1e6 if inject.pilot_canary_regress() else 0.0
        slices = {"reference": list(self.reference_samples), "window": self._window_samples()}
        out: Dict[str, Any] = {"ok": True}
        for name, samples in slices.items():
            if not samples:
                out[name] = None
                continue
            base = self._score(None, samples)
            cand = self._score(cand_model, samples) + inflate
            passed = bool(cand <= base * (1.0 + tol) + tol)
            out[name] = {"baseline_mae": round(base, 6), "candidate_mae": round(cand, 6), "passed": passed}
            if not passed:
                out["ok"] = False
        return out

    def _window_samples(self) -> List[Any]:
        from hydragnn_tpu_torch.data.container import ContainerDataset

        root = self.server.spool_dir()
        if not root:
            return []
        with self._lock:
            pins = list(self._pins)
        out: List[Any] = []
        for name in pins:
            try:
                out.extend(ContainerDataset(os.path.join(root, name)).samples())
            except Exception:
                continue  # a shard torn under the pilot makes a smaller window, not a failed canary
        return out

    def _score(self, model, samples: Sequence) -> float:
        """Mean per-sample MAE over at most ``canary_samples`` of
        ``samples``, each alone at its natural pad: the live weights'
        eager forward when ``model`` is None, else ``model``'s, both
        through the server's cache (``run_eager``)."""
        from hydragnn_tpu_torch.graph.batch import batch_graphs
        from hydragnn_tpu_torch.serve.server import request_to_dict

        srv = self.server
        errs: List[float] = []
        for s in list(samples)[: self.config.canary_samples]:
            g = request_to_dict(s)
            n = int(np.asarray(g["x"]).shape[0])
            batch = batch_graphs([g], node_multiple=srv.config.node_multiple, edge_multiple=srv.config.edge_multiple)
            outs = srv._cache.run_eager(batch, model=model)
            result = srv._slice_result(outs, graph_index=0, node_offset=0, num_nodes=n)
            errs.append(_sample_mae(result, s))
        return float(np.mean(errs)) if errs else 0.0

    # -- status ------------------------------------------------------------

    def status(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "state": self.state,
                "cycle": self.cycle,
                "failed_cycles": self.failed_cycles,
                "suppressed": self.suppressed,
                "last_cycle_ok": self.last_cycle_ok,
                "pinned_shards": list(self._pins),
            }


def _sample_mae(result: Dict[str, np.ndarray], sample) -> float:
    """MAE of one answer against the sample's targets (the graph and node
    heads the sample carries)."""
    gts = getattr(sample, "graph_targets", None) or {}
    nts = getattr(sample, "node_targets", None) or {}
    diffs: List[float] = []
    for name, pred in result.items():
        p = np.asarray(pred, dtype=np.float64).reshape(-1)
        if name in gts:
            t = np.asarray(gts[name], dtype=np.float64).reshape(-1)
        elif name in nts:
            t = np.asarray(nts[name], dtype=np.float64).reshape(-1)
        else:
            continue
        if t.size == p.size and p.size:
            diffs.append(float(np.mean(np.abs(p - t))))
    return float(np.mean(diffs)) if diffs else 0.0


def _tear_checkpoint(log_dir: str, candidate: str) -> None:
    """``HGTORCH_INJECT_PILOT_TORN_RELOAD``: truncate the candidate's
    checkpoint pointer (``<candidate>/<candidate>.pt``) after the pilot's
    canary passed, so the reload path's own validating loader must
    reject it. Where the candidate run also holds versioned checkpoints
    (``Training.checkpoint_every``), that loader restores the newest
    intact one instead and the reload succeeds, in the JAX package too
    (ROADMAP C8)."""
    from hydragnn_tpu_torch.utils.checkpoint import checkpoint_path

    path = checkpoint_path(candidate, log_dir)
    try:
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.truncate(max(size // 2, 1))
    except OSError:
        pass
