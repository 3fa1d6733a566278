"""Compile-event monitor (the port's counterpart of
``hydragnn_tpu/obs/compile_monitor.py``), with the JAX API: ``start``,
``stop``, ``mark``, ``count_since``, ``snapshot``.

The JAX monitor counts XLA backend compiles so an epoch record can say
"no recompile after step 1". The port's training loop runs eagerly: no
step is compiled, and there is no event stream to listen to. The
monitor therefore reports ``available: False`` with its reason, as the
JAX monitor does where it cannot listen; its counts stay 0, and a
reader takes the "no recompile" assertion as unavailable, never as
vacuously true.
"""

from __future__ import annotations

from typing import Dict

REASON = "the port's training step runs eagerly: nothing is compiled"


class CompileMonitor:
    """An unavailable compile counter with the JAX monitor's API."""

    def __init__(self):
        self.available = False
        self.reason = REASON
        self.count = 0
        self.total_duration_s = 0.0
        self._marks: Dict[str, int] = {}
        self._started = False

    def start(self) -> "CompileMonitor":
        self._started = True
        return self

    def stop(self) -> None:
        self._started = False

    def mark(self, name: str) -> int:
        self._marks[name] = self.count
        return self.count

    def count_since(self, name: str) -> int:
        return self.count - self._marks.get(name, 0)

    def snapshot(self) -> dict:
        return {"available": self.available, "reason": self.reason, "count": self.count,
                "total_duration_s": round(self.total_duration_s, 6)}
