"""Hang watchdog: a heartbeat-fed stall detector.

The port's counterpart of ``hydragnn_tpu/resilience/watchdog.py``. A
daemon thread watches the time since the last :meth:`HangWatchdog.beat`;
past ``stall_s`` it records every Python thread's stack in the flight
record (a ``watchdog`` event) and runs ``action``. The serving path
(``serve/supervise.py``) embeds it against a wedged forward with three
settings: ``gate`` (a stall counts only while the gate returns True, so
a server idle on its queue is not hung), ``rearm=True`` (a fresh beat
clears ``fired`` and re-arms the detector) and ``end_run_on_fire=False``
(the flight record stays open). Without an ``action`` a stall aborts
the process with exit code 79, as the JAX package's does: the training
loop (``Training.watchdog_stall_s`` or ``HGTORCH_WATCHDOG_S``) beats it
once a batch and in the BatchNorm recalibration passes, and a stall ends
its flight record with ``run_end{status:"hung"}``.
"""

from __future__ import annotations

import os
import sys
import threading
import time
import traceback
from typing import Callable, Dict, Optional

EXIT_HUNG = 79


def dump_thread_stacks() -> Dict[str, str]:
    """The formatted stack of every live Python thread, by name."""
    names = {t.ident: t.name for t in threading.enumerate()}
    return {
        names.get(ident, f"thread-{ident}"): "".join(traceback.format_stack(frame))
        for ident, frame in sys._current_frames().items()
    }


class HangWatchdog:
    """Fires once a stall of ``stall_s`` seconds is seen (module
    docstring). ``beat`` is one clock read and two stores; the detector
    arms after ``warmup_beats`` beats."""

    def __init__(
        self,
        stall_s: float,
        flight=None,
        action: Optional[Callable[[], None]] = None,
        poll_s: Optional[float] = None,
        warmup_beats: int = 2,
        gate: Optional[Callable[[], bool]] = None,
        rearm: bool = False,
        end_run_on_fire: bool = True,
    ):
        if stall_s <= 0:
            raise ValueError(f"stall_s must be > 0, got {stall_s}")
        self.stall_s = float(stall_s)
        self.flight = flight
        self.action = action if action is not None else self._default_abort
        self.poll_s = float(poll_s) if poll_s else max(self.stall_s / 4.0, 0.05)
        self.gate = gate
        self.rearm = bool(rearm)
        self.end_run_on_fire = bool(end_run_on_fire)
        self.warmup_beats = int(warmup_beats)
        # single-writer fields: the watchdog thread writes fired and
        # fire_count, the beating thread _beats and _last_beat; a stale
        # read delays a decision by one poll
        self.fire_count = 0
        self.fired = False
        self._beats = 0
        self._last_beat = time.monotonic()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def beat(self) -> None:
        self._beats += 1
        self._last_beat = time.monotonic()

    def heartbeat_age(self) -> float:
        """Seconds since the last beat."""
        return time.monotonic() - self._last_beat

    @property
    def armed(self) -> bool:
        return self._beats > self.warmup_beats

    def start(self) -> "HangWatchdog":
        if self._thread is None:
            self.beat()
            self._thread = threading.Thread(target=self._run, name="hgtorch-watchdog", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            if not self.armed:
                continue
            stalled = time.monotonic() - self._last_beat
            if self.fired:
                # only in rearm mode: a fresh beat clears the stall
                if stalled < self.stall_s:
                    self.fired = False
                continue
            if stalled >= self.stall_s and (self.gate is None or self.gate()):
                self._fire(stalled)
                if not self.rearm:
                    return

    def _fire(self, stalled: float) -> None:
        self.fired = True
        self.fire_count += 1
        if self.flight is not None:
            self.flight.record("watchdog", stall_s=round(stalled, 3), stacks=dump_thread_stacks())
            if self.end_run_on_fire:
                self.flight.end_run(status="hung", stall_s=round(stalled, 3))
                self.flight.close()
        self.action()

    def _default_abort(self) -> None:
        try:
            os.write(2, f"HangWatchdog: no heartbeat for {self.stall_s}s, aborting\n".encode())
        except OSError:
            pass
        os._exit(EXIT_HUNG)
