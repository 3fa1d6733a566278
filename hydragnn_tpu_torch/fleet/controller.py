"""The trigger-driven fleet autoscaler: breach -> a replica, quiet -> a
retirement (the port's counterpart of ``hydragnn_tpu/fleet/controller.py``,
with its decisions and ``fleet_scale`` events).

The controller has no load arithmetic of its own: the breach signal is a
:class:`~hydragnn_tpu_torch.obs.triggers.TriggerEngine` over the fleet
registry's aggregates (the ``fleet.queue_depth`` gauge, the
``fleet.latency_s`` p99). Around its verdicts it adds the policy:

  - **sustained breach** -> scale up: a verdict must repeat for
    ``breach_evals`` consecutive steps before a replica is spawned;
  - **cooldown**: at most one scale decision each ``cooldown_s``;
  - **bounds**: never below ``min_replicas`` (scale-down) nor above
    ``max_replicas`` (a breach at the cap records a ``hold``);
  - **quiet scale-down**: a fleet load at or below ``quiet_load`` for
    ``quiet_for_s`` retires the least-loaded replica (drain, then stop:
    no request is dropped);
  - **reap**: a replica whose server is no longer live is detached and
    replaced at once, outside the cooldown.

Every decision (up, down, replace, hold, up_failed, down_failed,
replace_failed) is one ``fleet_scale`` flight event with the action, the
reason (the rule's name, ``quiet``, ``dead_replica``) and the replica
count. Tests drive :meth:`FleetController.step` under a fake clock; a
deployment runs the same step from the background thread.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional

from hydragnn_tpu_torch.obs.triggers import TriggerEngine, TriggerRule, _knob
from hydragnn_tpu_torch.utils import syncdebug


@dataclasses.dataclass(frozen=True)
class ControllerConfig:
    """The scaling policy. A ``None`` field resolves from its
    ``HGTORCH_FLEET_*`` knob at construction (``MIN_REPLICAS`` 1,
    ``MAX_REPLICAS`` 4, ``COOLDOWN_S`` 30, ``QUIET_S`` 60,
    ``EVAL_EVERY_S`` 1), so an explicit argument wins over the environment.

    ``slo_queue_depth``/``slo_p99_ms`` make the trigger rules when no
    engine is given; ``quiet_load`` is the fleet in-flight count at or
    below which the fleet is quiet."""

    min_replicas: Optional[int] = None
    max_replicas: Optional[int] = None
    cooldown_s: Optional[float] = None
    quiet_for_s: Optional[float] = None
    eval_every_s: Optional[float] = None
    quiet_load: int = 0
    breach_evals: int = 2
    slo_queue_depth: Optional[float] = None
    slo_p99_ms: Optional[float] = None
    drain_timeout_s: float = 30.0


class FleetController:
    """The autoscaler over a fleet.

    ``fleet`` is duck-typed (the real :class:`~hydragnn_tpu_torch.fleet.
    fleet.Fleet`, or a test stub): ``replica_count()``,
    ``dead_replicas()``, ``total_load()``, ``scale_up(reason)``,
    ``scale_down(reason, timeout)`` and ``replace(name, reason)``.
    ``engine`` defaults to a TriggerEngine over ``registry`` with the
    config's SLO rules and no cooldown of its own (the controller owns
    the rate limit). ``clock`` is injectable.
    """

    def __init__(
        self,
        fleet,
        registry=None,
        config: Optional[ControllerConfig] = None,
        engine: Optional[TriggerEngine] = None,
        flight=None,
        clock=time.monotonic,
    ):
        cfg = config or ControllerConfig()
        self.fleet = fleet
        self.flight = flight
        self._clock = clock
        self.min_replicas = (cfg.min_replicas if cfg.min_replicas is not None
                             else int(_knob("HGTORCH_FLEET_MIN_REPLICAS", 1)))
        self.max_replicas = (cfg.max_replicas if cfg.max_replicas is not None
                             else int(_knob("HGTORCH_FLEET_MAX_REPLICAS", 4)))
        self.cooldown_s = cfg.cooldown_s if cfg.cooldown_s is not None else _knob("HGTORCH_FLEET_COOLDOWN_S", 30.0)
        self.quiet_for_s = cfg.quiet_for_s if cfg.quiet_for_s is not None else _knob("HGTORCH_FLEET_QUIET_S", 60.0)
        self.eval_every_s = (cfg.eval_every_s if cfg.eval_every_s is not None
                             else _knob("HGTORCH_FLEET_EVAL_EVERY_S", 1.0))
        self.quiet_load = int(cfg.quiet_load)
        self.breach_evals = max(1, int(cfg.breach_evals))
        self.drain_timeout_s = float(cfg.drain_timeout_s)
        if engine is None:
            rules = []
            if cfg.slo_queue_depth is not None:
                rules.append(TriggerRule("fleet_queue_depth", "queue_depth", "fleet.queue_depth",
                                         float(cfg.slo_queue_depth)))
            if cfg.slo_p99_ms is not None:
                rules.append(TriggerRule("fleet_p99", "latency_p99", "fleet.latency_s", cfg.slo_p99_ms / 1e3))
            # the controller owns the rate limit: the engine reports every
            # breach it sees
            engine = TriggerEngine(rules, registry=registry, cooldown_s=0.0, max_incidents=1_000_000_000, clock=clock)
        self.engine = engine
        # the decision state: only the one step() caller (the loop thread,
        # or a test) writes these
        self._last_scale_t: Optional[float] = None
        self._breach_streak = 0
        self._quiet_since: Optional[float] = None
        self._lock = syncdebug.maybe_wrap(threading.Lock(), "fleet.FleetController._lock")
        self.decisions: List[Dict[str, Any]] = []  # guarded by _lock
        self._loop: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- decisions ---------------------------------------------------------

    def _decide(self, action: str, reason: str, **detail) -> Dict[str, Any]:
        d = {"action": action, "reason": reason, "replicas": self.fleet.replica_count(), **detail}
        with self._lock:
            self.decisions.append(d)
        if self.flight is not None:
            self.flight.record("fleet_scale", **d)
        return d

    def _cooling(self, now: float) -> bool:
        return self._last_scale_t is not None and now - self._last_scale_t < self.cooldown_s

    def step(self) -> List[Dict[str, Any]]:
        """One evaluation pass; returns the decisions made. Reap first
        (restoring capacity is never rate-limited), then a breach's
        scale-up, then the quiet scale-down."""
        now = self._clock()
        out: List[Dict[str, Any]] = []

        for name in list(self.fleet.dead_replicas()):
            try:
                self.fleet.replace(name, reason="dead_replica")
                out.append(self._decide("replace", "dead_replica", dead=name))
            except Exception as exc:
                out.append(self._decide("replace_failed", "dead_replica", dead=name, error=repr(exc)[-200:]))
            self._last_scale_t = now

        verdicts = self.engine.evaluate()
        if verdicts:
            self._breach_streak += 1
            self._quiet_since = None
        else:
            self._breach_streak = 0
        if verdicts and self._breach_streak >= self.breach_evals:
            rule = verdicts[0].rule
            if self._cooling(now):
                pass  # not a decision yet: the last one is still settling
            elif self.fleet.replica_count() >= self.max_replicas:
                out.append(self._decide("hold", rule, bound="max_replicas"))
                self._last_scale_t = now
            else:
                try:
                    name = self.fleet.scale_up(reason=rule)
                    out.append(self._decide("up", rule, spawned=name))
                except Exception as exc:
                    out.append(self._decide("up_failed", rule, error=repr(exc)[-200:]))
                self._last_scale_t = now
                self._breach_streak = 0
            return out

        if self.fleet.total_load() <= self.quiet_load:
            if self._quiet_since is None:
                self._quiet_since = now
            if (now - self._quiet_since >= self.quiet_for_s and self.fleet.replica_count() > self.min_replicas
                    and not self._cooling(now)):
                try:
                    name = self.fleet.scale_down(reason="quiet", timeout=self.drain_timeout_s)
                    out.append(self._decide("down", "quiet", retired=name))
                except Exception as exc:
                    out.append(self._decide("down_failed", "quiet", error=repr(exc)[-200:]))
                self._last_scale_t = now
                self._quiet_since = now
        else:
            self._quiet_since = None
        return out

    # -- the background loop -----------------------------------------------

    def start(self) -> "FleetController":
        if self._loop is not None:
            return self
        self._stop.clear()
        self._loop = threading.Thread(target=self._run, name="hgtorch-fleet-controller", daemon=True)
        self._loop.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._loop is not None:
            self._loop.join(timeout)
            self._loop = None

    def _run(self) -> None:
        while not self._stop.wait(self.eval_every_s):
            try:
                self.step()
            except Exception as exc:
                # the controller outlives any one bad step; the failure is evidence
                if self.flight is not None:
                    self.flight.error(exc, where="fleet_controller")

    def decision_log(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self.decisions)
