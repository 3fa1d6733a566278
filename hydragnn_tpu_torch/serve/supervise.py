"""In-process dispatch supervisor: the dispatch thread under a restart
policy and a hang watchdog.

The port's counterpart of ``hydragnn_tpu/serve/supervise.py``. One
thread runs every batch; if it died, every queued future would wait
forever while the server looked healthy. Two mechanisms close that:

  - **bounded restart with backoff**: the dispatch loop runs under a
    wrapper that keeps any escaping exception; a monitor thread sees the
    death, records a ``dispatch_restart`` flight event, waits out the
    :class:`SupervisorPolicy` backoff and starts a fresh thread. Past
    ``max_restarts`` it gives up and calls ``on_giveup``, which fails
    every pending future with a typed error and closes admission;
  - **a re-armed hang watchdog** fed by the loop's heartbeat, counting a
    stall only while the loop is busy with a batch; while stalled,
    liveness is false, and a forward that returns clears it.

The monitor also runs ``on_tick`` every ``tick_every_s`` (the server's
Prometheus textfile export).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from hydragnn_tpu_torch.resilience.supervisor import SupervisorPolicy
from hydragnn_tpu_torch.resilience.watchdog import HangWatchdog


class DispatchSupervisor:
    """Supervise one dispatch-loop thread. ``target`` is the loop; a
    normal return is a clean shutdown and is never restarted. The loop
    calls :meth:`beat` once an iteration and brackets device work with
    ``busy(True)`` / ``busy(False)``."""

    def __init__(
        self,
        target: Callable[[], None],
        policy: Optional[SupervisorPolicy] = None,
        stall_s: float = 30.0,
        flight=None,
        metrics=None,
        on_giveup: Optional[Callable[[BaseException], None]] = None,
        on_tick: Optional[Callable[[], None]] = None,
        tick_every_s: float = 5.0,
        poll_s: float = 0.05,
        thread_name: str = "hgtorch-serve-dispatch",
    ):
        self._target = target
        self.policy = policy or SupervisorPolicy()
        self.flight = flight
        self.metrics = metrics
        self.on_giveup = on_giveup
        self.on_tick = on_tick
        self.tick_every_s = float(tick_every_s)
        self.poll_s = float(poll_s)
        self.thread_name = thread_name
        # single-writer state: the monitor thread writes restarts,
        # failed and _worker after a crash; the worker writes
        # last_error, _clean_exit and _busy; readers tolerate a stale
        # value for one poll
        self.restarts = 0
        self.failed = False
        self.last_error: Optional[BaseException] = None
        self._busy = False
        self._clean_exit = False
        self._stopping = False
        self._worker: Optional[threading.Thread] = None
        self._monitor: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.watchdog = HangWatchdog(
            stall_s,
            flight=flight,
            action=lambda: None,  # the fired state is the signal health() reads
            gate=lambda: self._busy,
            rearm=True,
            end_run_on_fire=False,
            warmup_beats=0,
        )

    # -- signals from the dispatch loop ------------------------------------

    def beat(self) -> None:
        self.watchdog.beat()

    def busy(self, flag: bool) -> None:
        self._busy = bool(flag)

    # -- health ------------------------------------------------------------

    @property
    def alive(self) -> bool:
        worker = self._worker
        return worker is not None and worker.is_alive()

    @property
    def stalled(self) -> bool:
        return bool(self.watchdog.fired)

    def heartbeat_age(self) -> float:
        return self.watchdog.heartbeat_age()

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "DispatchSupervisor":
        if self._monitor is not None:
            return self
        self.watchdog.beat()
        self._spawn_worker()
        self.watchdog.start()
        self._monitor = threading.Thread(target=self._run_monitor, name=f"{self.thread_name}-supervisor", daemon=True)
        self._monitor.start()
        return self

    def stop(self, timeout: Optional[float] = 10.0) -> None:
        """Join the worker (the caller closes the queue first, so the
        loop returns), then the monitor and the watchdog."""
        self._stopping = True
        worker = self._worker
        if worker is not None:
            worker.join(timeout)
        self._stop.set()
        if self._monitor is not None:
            self._monitor.join(timeout=2.0)
            self._monitor = None
        self.watchdog.stop()
        if worker is not None and worker.is_alive():
            raise RuntimeError("serve dispatch thread did not stop in time")
        self._worker = None

    # -- internals ---------------------------------------------------------

    def _spawn_worker(self) -> None:
        self._clean_exit = False
        self._worker = threading.Thread(target=self._wrapped, name=self.thread_name, daemon=True)
        self._worker.start()

    def _wrapped(self) -> None:
        try:
            self._target()
            self._clean_exit = True
        except BaseException as exc:  # noqa: BLE001 - the monitor restarts or gives up
            self.last_error = exc
        finally:
            self._busy = False

    def _run_monitor(self) -> None:
        last_tick = time.monotonic()
        while not self._stop.wait(self.poll_s):
            now = time.monotonic()
            if self.on_tick is not None and now - last_tick >= self.tick_every_s:
                last_tick = now
                try:
                    self.on_tick()
                except Exception as exc:  # an export failure must not stop supervision
                    if self.flight is not None:
                        self.flight.error(exc, where="supervisor_tick")
            if self._stopping or self.failed:
                continue
            worker = self._worker
            if worker is not None and not worker.is_alive() and not self._clean_exit:
                self._handle_crash()

    def _handle_crash(self) -> None:
        exc = self.last_error or RuntimeError("dispatch thread died")
        self.restarts += 1
        if self.metrics is not None:
            self.metrics.record_dispatch_restart()
        if self.restarts > self.policy.max_restarts:
            self.failed = True
            if self.flight is not None:
                self.flight.record("dispatch_restart", attempt=self.restarts, cause="gave_up", error=str(exc)[-300:])
            if self.on_giveup is not None:
                self.on_giveup(exc)
            return
        delay = self.policy.backoff(self.restarts)
        if self.flight is not None:
            self.flight.record("dispatch_restart", attempt=self.restarts, cause="crash", error=str(exc)[-300:],
                               delay_s=delay)
        # the backoff, abandoned at once if the server stops
        if self._stop.wait(delay) or self._stopping:
            return
        self.watchdog.beat()  # a fresh thread starts with a fresh heartbeat
        self._spawn_worker()
