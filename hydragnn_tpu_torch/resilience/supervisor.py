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
serving-scale defaults.

:class:`PodSupervisor` runs one command as a pod of N concurrent hosts
(``--pod N``): :func:`classify_pod_exit` folds an attempt's per-host exit
codes into one cause, and a host dead of a signal is ``host_lost``,
restarted at once from the last committed pod generation
(``resilience/podckpt.py``).
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

# causes that restart at once, without the crash backoff: eviction and a
# pod's host loss are the steady state of preemptible machines, and the
# run resumes from its last checkpoint or committed generation either way
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


def classify_pod_exit(returncodes: Dict[int, int]) -> str:
    """One pod attempt's per-host exit codes as one cause, worst first:

      - a fail-fast code (78 config, 76 rollback) wins: the failure is
        deterministic, and N hosts restarted fail N times;
      - else any signal death (a negative code: an evictor's SIGKILL, the
        OOM killer, a dead machine) is ``host_lost``: restart the pod at
        once from the last committed generation;
      - else preempted (75) beats hung (79) beats crash;
      - all zero: completed.
    """
    if not returncodes:
        raise ValueError("classify_pod_exit: empty returncode map")
    causes = {classify_exit(rc) for rc in returncodes.values()}
    if "config_error" in causes:
        return "config_error"
    if "rollback_exhausted" in causes:
        return "rollback_exhausted"
    if any(rc < 0 for rc in returncodes.values()):
        return "host_lost"
    for cause in ("preempted", "hung", "crash"):
        if cause in causes:
            return cause
    return "completed"


def _pod_exit_code(returncodes: Dict[int, int], cause: str) -> int:
    """The exit code that stands for a classified pod attempt."""
    table = {
        "completed": EXIT_OK,
        "config_error": EXIT_CONFIG_ERROR,
        "rollback_exhausted": EXIT_ROLLBACK_EXHAUSTED,
        "preempted": EXIT_PREEMPTED,
        "hung": EXIT_HUNG,
    }
    if cause in table:
        return table[cause]
    if cause == "host_lost":
        return next(rc for rc in returncodes.values() if rc < 0)
    return next(rc for rc in returncodes.values() if rc != EXIT_OK)


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


class PodSupervisor:
    """Supervise one training command as a pod of ``hosts`` concurrent
    processes.

    Each attempt starts every host with its pod identity
    (``HGTORCH_PODVIEW_HOST=k``, ``HGTORCH_PODVIEW_HOSTS=N`` and, given a
    ``run_id``, a shared ``HGTORCH_PODVIEW_RUN_ID``), then polls them. The
    pod lives and dies together: when a host exits non-zero the others get
    SIGTERM (they cut a last generation inside their grace window), then
    SIGKILL after ``grace_s``. :func:`classify_pod_exit` folds the
    attempt's codes into one cause; ``host_lost`` restarts at once, like a
    preemption, without spending the crash backoff. ``elastic=True``
    restarts with one host fewer after a ``host_lost`` attempt (the
    restore re-shards the committed generation onto the smaller pod).
    ``max_wall_s`` ends an attempt that outlives it, its unfinished hosts
    reported hung (79). Restarted hosts get ``HGTORCH_AUTO_RESUME=1`` and
    no injection, as :class:`Supervisor`'s children.

    ``popen`` and ``sleep`` are seams for the tests."""

    def __init__(
        self,
        argv: Sequence[str],
        hosts: int,
        policy: Optional[SupervisorPolicy] = None,
        env: Optional[Dict[str, str]] = None,
        flight=None,
        run_id: Optional[str] = None,
        popen=subprocess.Popen,
        sleep: Callable[[float], None] = time.sleep,
        grace_s: float = 30.0,
        poll_s: float = 0.05,
        max_wall_s: Optional[float] = None,
        elastic: bool = False,
    ):
        if hosts < 1:
            raise ValueError(f"hosts must be >= 1, got {hosts}")
        self.argv = list(argv)
        self.hosts = int(hosts)
        self.policy = policy or SupervisorPolicy()
        self.base_env = dict(env if env is not None else os.environ)
        self.flight = flight
        self.run_id = run_id
        self.popen = popen
        self.sleep = sleep
        self.grace_s = float(grace_s)
        self.poll_s = float(poll_s)
        self.max_wall_s = max_wall_s
        self.elastic = bool(elastic)
        self.history: List[dict] = []

    def _host_env(self, host: int, hosts: int, attempt: int) -> Dict[str, str]:
        env = dict(self.base_env)
        if attempt > 0:
            if self.policy.auto_resume:
                env["HGTORCH_AUTO_RESUME"] = "1"
            if self.policy.strip_injection:
                env = strip_injection_env(env)
        env["HGTORCH_PODVIEW_HOST"] = str(host)
        env["HGTORCH_PODVIEW_HOSTS"] = str(hosts)
        if self.run_id:
            env["HGTORCH_PODVIEW_RUN_ID"] = self.run_id
        return env

    def _stop_peers(self, procs: dict, rcs: Dict[int, int]) -> None:
        """SIGTERM every host still running, ``grace_s`` for all of them
        together, then SIGKILL to the rest."""
        live = [k for k in procs if k not in rcs]
        for k in live:
            try:
                procs[k].terminate()
            except OSError:
                pass
        deadline = time.monotonic() + self.grace_s
        for k in live:
            try:
                rcs[k] = int(procs[k].wait(timeout=max(deadline - time.monotonic(), 0.0)))
            except subprocess.TimeoutExpired:
                try:
                    procs[k].kill()
                except OSError:
                    pass
                rcs[k] = int(procs[k].wait())

    def _run_attempt(self, hosts: int, attempt: int) -> Dict[int, int]:
        procs = {k: self.popen(self.argv, env=self._host_env(k, hosts, attempt)) for k in range(hosts)}
        rcs: Dict[int, int] = {}
        deadline = time.monotonic() + self.max_wall_s if self.max_wall_s is not None else None
        while len(rcs) < hosts:
            progressed = failed = False
            for k, p in procs.items():
                if k in rcs:
                    continue
                rc = p.poll()
                if rc is not None:
                    rcs[k] = int(rc)
                    progressed = True
                    failed = failed or rc != EXIT_OK
            if failed:
                self._stop_peers(procs, rcs)
                break
            if deadline is not None and time.monotonic() > deadline:
                # the outer wall clock: the unfinished hosts are hung (79),
                # not the signal deaths the kill itself makes
                unfinished = [k for k in procs if k not in rcs]
                self._stop_peers(procs, rcs)
                for k in unfinished:
                    rcs[k] = EXIT_HUNG
                break
            if not progressed:
                self.sleep(self.poll_s)
        return rcs

    def run(self) -> dict:
        """Supervise the pod to completion or give-up: :meth:`Supervisor.run`'s
        result, with each attempt's ``exit_codes`` and ``hosts`` in the
        history, the final ``hosts``, and ``host_lost`` counted among the
        preemptions."""
        crashes = preemptions = attempt = 0
        hosts = self.hosts
        while True:
            rcs = self._run_attempt(hosts, attempt)
            cause = classify_pod_exit(rcs)
            rc = _pod_exit_code(rcs, cause)
            self.history.append({"attempt": attempt, "hosts": hosts,
                                 "exit_codes": {str(k): v for k, v in sorted(rcs.items())}, "cause": cause})
            if cause == "completed":
                return self._finish("completed", rc, cause, crashes, preemptions, hosts)
            if cause in FAIL_FAST_CAUSES:
                return self._finish("failed_fast", rc, cause, crashes, preemptions, hosts)
            if cause in PREEMPT_CLASS_CAUSES:
                preemptions += 1
                if preemptions > self.policy.max_preemptions:
                    return self._finish("gave_up", rc, cause, crashes, preemptions, hosts)
                delay = 0.0
            else:  # crash / hung
                crashes += 1
                if crashes > self.policy.max_restarts:
                    return self._finish("gave_up", rc, cause, crashes, preemptions, hosts)
                delay = self.policy.backoff(crashes)
            if cause == "host_lost":
                if self.flight is not None:
                    for k, code in sorted(rcs.items()):
                        if code < 0:
                            self.flight.record("host_lost", host=k, exit_code=code, attempt=attempt)
                if self.elastic and hosts > 1:
                    hosts -= 1
            attempt += 1
            if self.flight is not None:
                self.flight.record("restart", attempt=attempt, cause=cause, exit_code=rc, delay_s=delay, hosts=hosts)
            if delay > 0:
                self.sleep(delay)

    def _finish(self, status, rc, cause, crashes, preemptions, hosts) -> dict:
        result = {
            "status": status,
            "exit_code": rc,
            "cause": cause,
            "attempts": len(self.history),
            "restarts": crashes,
            "preemptions": preemptions,
            "hosts": hosts,
            "history": list(self.history),
        }
        if self.flight is not None:
            self.flight.end_run(status=status, exit_code=rc, cause=cause, attempts=result["attempts"],
                                restarts=crashes, preemptions=preemptions, hosts=hosts)
        return result
