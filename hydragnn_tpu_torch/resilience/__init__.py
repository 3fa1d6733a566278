"""Fault tolerance (the port's counterpart of ``hydragnn_tpu/resilience/``):
the training loop's non-finite sentry; the serving path's fault
injections, hang watchdog and restart policy. Preemption, the
process-level supervisors, pod checkpoints and hooks wait for ROADMAP
A-7."""

from hydragnn_tpu_torch.resilience.sentry import NonFiniteRollbackExhausted, NonFiniteSentry  # noqa: F401
from hydragnn_tpu_torch.resilience.supervisor import SupervisorPolicy  # noqa: F401
from hydragnn_tpu_torch.resilience.watchdog import HangWatchdog, dump_thread_stacks  # noqa: F401
