"""Fault-tolerant training and serving (the port's counterpart of
``hydragnn_tpu/resilience/``): the machinery that keeps a run alive on
preemptible hardware without a human in the loop.

  - :mod:`~hydragnn_tpu_torch.resilience.preempt`: SIGTERM/SIGINT -> a
    graceful-stop flag read at batch granularity; a final checkpoint and
    ``run_end{status:"preempted"}`` inside a grace window; the process
    exit-code contract (``EXIT_*``) and :func:`run_guard`.
  - :mod:`~hydragnn_tpu_torch.resilience.sentry`: the host's policy over
    the guarded train step (skipped-batch accounting, the rollback to
    the last good checkpoint).
  - :mod:`~hydragnn_tpu_torch.resilience.watchdog`: a heartbeat thread
    that writes every Python thread's stack into the flight record and
    aborts (exit 79) when the loop stalls; serving embeds it against a
    wedged forward.
  - :mod:`~hydragnn_tpu_torch.resilience.supervisor`: the bounded
    restart supervisor (``python -m hydragnn_tpu_torch.tools.supervise``):
    exponential backoff, exit-cause classification, fail-fast on config
    errors; its policy also drives serving's dispatch supervisor.
  - :mod:`~hydragnn_tpu_torch.resilience.inject`: env-gated deterministic
    fault injection (NaN batch, SIGTERM, SIGKILL mid-checkpoint, stalled
    loader, the serving faults and the retrain pilot's), so every path
    above is testable.
  - :mod:`~hydragnn_tpu_torch.resilience.hooks`: the per-batch hook
    bundle ``train/loop.py`` threads through its hot loop.

Everything flows into the flight recorder (``obs/flight.py``); the JAX
package's ``tools/obs_report.py --faults`` narrates a port run's fault
history. The retrain pilot (``pilot/``) runs its fine-tune child under
:class:`Supervisor` with ``wall_clock_runner``; the serving fleet
(``fleet/``) reaps and replaces replicas whose dispatch supervisor gave
up. The pod layer: :mod:`~hydragnn_tpu_torch.resilience.podckpt`
(per-host generation shards with a commit protocol, heartbeats,
coordinated preemption), :class:`PodSupervisor` and
:class:`PodHostLost`.
"""

from hydragnn_tpu_torch.resilience.preempt import (
    EXIT_CONFIG_ERROR,
    EXIT_HUNG,
    EXIT_OK,
    EXIT_PREEMPTED,
    EXIT_ROLLBACK_EXHAUSTED,
    NonFiniteRollbackExhausted,
    PodHostLost,
    PreemptionHandler,
    TrainingPreempted,
    auto_resume_config,
    run_guard,
)
from hydragnn_tpu_torch.resilience.sentry import NonFiniteSentry
from hydragnn_tpu_torch.resilience.watchdog import HangWatchdog, dump_thread_stacks
from hydragnn_tpu_torch.resilience.supervisor import (
    FAIL_FAST_CAUSES,
    PodSupervisor,
    Supervisor,
    SupervisorPolicy,
    classify_exit,
    classify_pod_exit,
)
from hydragnn_tpu_torch.resilience.hooks import TrainHooks

__all__ = [
    "EXIT_OK",
    "EXIT_PREEMPTED",
    "EXIT_ROLLBACK_EXHAUSTED",
    "EXIT_CONFIG_ERROR",
    "EXIT_HUNG",
    "TrainingPreempted",
    "NonFiniteRollbackExhausted",
    "PodHostLost",
    "PreemptionHandler",
    "auto_resume_config",
    "run_guard",
    "NonFiniteSentry",
    "HangWatchdog",
    "dump_thread_stacks",
    "Supervisor",
    "SupervisorPolicy",
    "PodSupervisor",
    "FAIL_FAST_CAUSES",
    "classify_exit",
    "classify_pod_exit",
    "TrainHooks",
]
