"""Bounded restart supervisor (the port's counterpart of
``hydragnn_tpu/resilience/supervisor.py``): turn "the run crashed" into
"the run resumed", without looping on a run that can never succeed.

:class:`Supervisor` runs a training command again and again, classifies
each exit by the contract of :mod:`hydragnn_tpu_torch.resilience.preempt`
and decides:

  - ``completed`` (0): done;
  - ``preempted`` (75): restart at once (bounded by ``max_preemptions``:
    eviction is the steady state of preemptible machines, not a failure);
  - ``config_error`` (78) and ``rollback_exhausted`` (76): FAIL FAST,
    the failure is deterministic;
  - anything else (``crash``, signal deaths among them, and ``hung``/79
    from the watchdog): restart with exponential backoff, at most
    ``max_restarts`` times.

Every restarted child gets ``HGTORCH_AUTO_RESUME=1`` (the api layer then
turns the config into ``Training.continue`` when the checkpoint exists)
and, by default, no ``HGTORCH_INJECT_*`` variable, so an injected fault
fires once a supervised run. Children are started with ``subprocess``
(fork and exec), never a ``multiprocessing`` fork of a process that may
hold a CUDA context. ``python -m hydragnn_tpu_torch.tools.supervise`` is
the CLI; the ``runner``/``sleep`` seams make the policy testable without
processes.

:class:`SupervisorPolicy` is also the restart policy of the serving
path's in-process dispatch supervisor (``serve/supervise.py``), with
serving-scale defaults. ``PodSupervisor``, ``classify_pod_exit`` and the
pod's exit code wait for ROADMAP A-5b.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import time
from typing import Callable, Dict, List, Optional, Sequence

from hydragnn_tpu_torch.resilience.inject import strip_injection_env
from hydragnn_tpu_torch.resilience.preempt import (
    EXIT_CONFIG_ERROR,
    EXIT_HUNG,
    EXIT_OK,
    EXIT_PREEMPTED,
    EXIT_ROLLBACK_EXHAUSTED,
)

FAIL_FAST_CAUSES = frozenset({"config_error", "rollback_exhausted"})

# causes that restart at once, without the crash backoff (host_lost is
# the pod layer's, ROADMAP A-5b)
PREEMPT_CLASS_CAUSES = frozenset({"preempted", "host_lost"})


def wall_clock_runner(
    max_wall_s: float, *, grace_s: float = 5.0, popen=subprocess.Popen
) -> Callable[[Sequence[str], Dict[str, str]], int]:
    """A ``runner`` with a hard wall clock an attempt.

    The in-process watchdog (``resilience/watchdog.py``) fires only while
    the child's interpreter still schedules threads; a child wedged in a
    C extension or a full device queue never reaches it. This runner is
    the outer belt: ``Popen``, ``wait(max_wall_s)``, then SIGTERM,
    ``grace_s`` to die, SIGKILL; the timeout is reported as
    :data:`EXIT_HUNG` (79), so :func:`classify_exit` sees ``hung`` and
    the policy retries with backoff. ``popen`` is a seam for tests."""
    if max_wall_s <= 0:
        raise ValueError(f"max_wall_s must be > 0, got {max_wall_s}")

    def _run(argv: Sequence[str], env: Dict[str, str]) -> int:
        proc = popen(list(argv), env=env)
        try:
            return int(proc.wait(timeout=max_wall_s))
        except subprocess.TimeoutExpired:
            proc.terminate()
            try:
                proc.wait(timeout=grace_s)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            return EXIT_HUNG

    return _run


def classify_exit(returncode: int) -> str:
    """The exit cause of a child's return code (negative: a signal death,
    as ``subprocess`` reports SIGKILL)."""
    if returncode == EXIT_OK:
        return "completed"
    if returncode == EXIT_PREEMPTED:
        return "preempted"
    if returncode == EXIT_ROLLBACK_EXHAUSTED:
        return "rollback_exhausted"
    if returncode == EXIT_CONFIG_ERROR:
        return "config_error"
    if returncode == EXIT_HUNG:
        return "hung"
    return "crash"


@dataclasses.dataclass
class SupervisorPolicy:
    max_restarts: int = 5  # crash- and hang-class restarts
    max_preemptions: int = 1000  # preemption resumes (not failures)
    backoff_base_s: float = 1.0
    backoff_factor: float = 2.0
    backoff_max_s: float = 60.0
    auto_resume: bool = True  # HGTORCH_AUTO_RESUME=1 for restarts
    strip_injection: bool = True  # drop HGTORCH_INJECT_* from restarts

    def backoff(self, n_crashes: int) -> float:
        """Delay before the n-th crash-class restart (n >= 1)."""
        return min(self.backoff_base_s * self.backoff_factor ** max(n_crashes - 1, 0), self.backoff_max_s)


class Supervisor:
    """Run ``argv`` under the restart policy.

    ``runner(argv, env) -> returncode`` defaults to ``subprocess.call``;
    ``flight`` (an ``obs/flight.py:FlightRecorder``) gets one ``restart``
    event a re-run and a final ``run_end``.
    """

    def __init__(
        self,
        argv: Sequence[str],
        policy: Optional[SupervisorPolicy] = None,
        env: Optional[Dict[str, str]] = None,
        flight=None,
        runner: Optional[Callable[[Sequence[str], Dict[str, str]], int]] = None,
        sleep: Callable[[float], None] = time.sleep,
    ):
        self.argv = list(argv)
        self.policy = policy or SupervisorPolicy()
        self.base_env = dict(env if env is not None else os.environ)
        self.flight = flight
        self.runner = runner or (lambda a, e: subprocess.call(a, env=e))
        self.sleep = sleep
        self.history: List[dict] = []

    def _child_env(self, attempt: int) -> Dict[str, str]:
        env = dict(self.base_env)
        if attempt > 0:
            if self.policy.auto_resume:
                env["HGTORCH_AUTO_RESUME"] = "1"
            if self.policy.strip_injection:
                env = strip_injection_env(env)
        return env

    def run(self) -> dict:
        """Supervise to completion or give-up; the result holds ``status``
        (``completed``, ``failed_fast`` or ``gave_up``), the final
        ``exit_code`` and ``cause``, and the counts."""
        crashes = 0
        preemptions = 0
        attempt = 0
        while True:
            rc = self.runner(self.argv, self._child_env(attempt))
            cause = classify_exit(rc)
            self.history.append({"attempt": attempt, "exit_code": rc, "cause": cause})
            if cause == "completed":
                return self._finish("completed", rc, cause, crashes, preemptions)
            if cause in FAIL_FAST_CAUSES:
                return self._finish("failed_fast", rc, cause, crashes, preemptions)
            if cause == "preempted":
                preemptions += 1
                if preemptions > self.policy.max_preemptions:
                    return self._finish("gave_up", rc, cause, crashes, preemptions)
                delay = 0.0
            else:  # crash / hung
                crashes += 1
                if crashes > self.policy.max_restarts:
                    return self._finish("gave_up", rc, cause, crashes, preemptions)
                delay = self.policy.backoff(crashes)
            attempt += 1
            if self.flight is not None:
                self.flight.record("restart", attempt=attempt, cause=cause, exit_code=rc, delay_s=delay)
            if delay > 0:
                self.sleep(delay)

    def _finish(self, status, rc, cause, crashes, preemptions) -> dict:
        result = {
            "status": status,
            "exit_code": rc,
            "cause": cause,
            "attempts": len(self.history),
            "restarts": crashes,
            "preemptions": preemptions,
            "history": list(self.history),
        }
        if self.flight is not None:
            self.flight.end_run(status=status, exit_code=rc, cause=cause, attempts=result["attempts"],
                                restarts=crashes, preemptions=preemptions)
        return result
