"""Named cumulative timers with a cross-process reduction (the port's
copy of ``hydragnn_tpu/utils/time_utils.py``): a timer of a given name
is one process-global stopwatch that adds the wall time of every
start/stop pair; ``print_timers`` reports min, max and mean over the
``torch.distributed`` group's processes when there is more than one.
"""

from __future__ import annotations

import time
from typing import Dict

from hydragnn_tpu_torch.utils.print_utils import print_distributed

# every Timer of one name shares its state through this registry
_REGISTRY: Dict[str, "Timer"] = {}


class Timer:
    def __init__(self, name: str):
        self.name = name
        existing = _REGISTRY.get(name)
        if existing is not None:
            self.__dict__ = existing.__dict__
            return
        self.elapsed = 0.0
        self.count = 0
        self._start = None
        _REGISTRY[name] = self

    def start(self) -> None:
        if self._start is not None:
            raise RuntimeError(f"Timer {self.name} already running")
        self._start = time.perf_counter()

    def stop(self) -> None:
        if self._start is None:
            raise RuntimeError(f"Timer {self.name} not running")
        self.elapsed += time.perf_counter() - self._start
        self.count += 1
        self._start = None

    def stop_if_running(self) -> None:
        """Stop on an exception path: the timer is process-global, so a run
        that unwinds mid-interval must close it or the next run in the
        process fails with 'already running'."""
        if self._start is not None:
            self.stop()

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False


def reset_timers() -> None:
    _REGISTRY.clear()


def timers_snapshot() -> Dict[str, Dict[str, float]]:
    """This process's timers as numbers (no printing, no reduction); a
    running timer reports its completed start/stop pairs."""
    return {
        name: {"elapsed_s": round(t.elapsed, 6), "count": t.count}
        for name, t in sorted(_REGISTRY.items())
    }


def print_timers(verbosity: int = 1) -> Dict[str, Dict[str, float]]:
    """Each timer's min, max and mean elapsed seconds over the processes
    (``all_gather_object`` over the initialised group of more than one
    process; this process's own values otherwise), printed at
    ``verbosity`` and returned by name."""
    import numpy as np
    import torch.distributed as dist

    names = sorted(_REGISTRY)
    values = np.array([_REGISTRY[n].elapsed for n in names])
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1 and len(values):
        gathered = [None] * dist.get_world_size()
        dist.all_gather_object(gathered, values)
        all_vals = np.stack(gathered)
        vmin, vmax, vavg = all_vals.min(0), all_vals.max(0), all_vals.mean(0)
    else:
        vmin = vmax = vavg = values
    stats = {}
    for i, n in enumerate(names):
        stats[n] = {"min": float(vmin[i]), "max": float(vmax[i]), "avg": float(vavg[i])}
        print_distributed(
            verbosity,
            f"timer {n}: avg {vavg[i]:.4f}s min {vmin[i]:.4f}s max {vmax[i]:.4f}s (n={_REGISTRY[n].count})",
        )
    return stats
