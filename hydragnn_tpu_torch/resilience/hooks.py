"""The per-batch hook bundle the train loop threads through its hot loop
(the port's counterpart of ``hydragnn_tpu/resilience/hooks.py``): the
preemption check, the watchdog's heartbeat, the fault injections and the
non-finite sentry, in one object, so ``train_epoch``'s signature stays
flat and the all-off path is a few attribute reads.
"""

from __future__ import annotations

from hydragnn_tpu_torch.resilience import inject


class TrainHooks:
    """The resilience actors of one training run.

    ``before_step`` runs at batch granularity: it beats the watchdog,
    fires the step-indexed injections and returns the batch (a new NaN
    batch where one is injected). ``step_counter`` is the process-local
    count of steps the injections index: deterministic whatever the
    resume state.
    """

    def __init__(self, preempt=None, sentry=None, watchdog=None):
        self.preempt = preempt
        self.sentry = sentry
        self.watchdog = watchdog
        self.step_counter = 0

    @property
    def preempted(self) -> bool:
        return self.preempt is not None and self.preempt.should_stop()

    def beat(self) -> None:
        if self.watchdog is not None:
            self.watchdog.beat()

    def epoch_start(self, epoch: int) -> None:
        self.beat()
        inject.maybe_sigterm(epoch=epoch)
        if self.sentry is not None:
            self.sentry.epoch_start()

    def before_step(self, batch):
        self.beat()
        inject.maybe_sigterm(step=self.step_counter)
        batch = inject.maybe_nan_batch(batch, self.step_counter)
        self.step_counter += 1
        return batch

    def teardown(self) -> None:
        """Idempotent clean-up; every exit path of the train loop calls it."""
        if self.watchdog is not None:
            self.watchdog.stop()
        if self.preempt is not None:
            self.preempt.uninstall()
