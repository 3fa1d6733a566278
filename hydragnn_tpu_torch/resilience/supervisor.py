"""Restart policy (the port's counterpart of ``SupervisorPolicy`` in
``hydragnn_tpu/resilience/supervisor.py``): bounded restarts with
exponential backoff. The serving path's in-process dispatch supervisor
(``serve/supervise.py``) runs under it with serving-scale defaults; the
process-level ``Supervisor`` and ``PodSupervisor`` wait for ROADMAP
A-7."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class SupervisorPolicy:
    max_restarts: int = 5  # crash- and hang-class restarts
    max_preemptions: int = 1000  # preemption resumes (not failures)
    backoff_base_s: float = 1.0
    backoff_factor: float = 2.0
    backoff_max_s: float = 60.0
    auto_resume: bool = True
    strip_injection: bool = True  # drop HGTORCH_INJECT_* from restarts

    def backoff(self, n_crashes: int) -> float:
        """Delay before the n-th crash-class restart (n >= 1)."""
        return min(self.backoff_base_s * self.backoff_factor ** max(n_crashes - 1, 0), self.backoff_max_s)
