"""Non-finite sentry: the host's policy over the guarded train step (the
port's counterpart of ``hydragnn_tpu/resilience/sentry.py``).

The device half is ``train/state.py:make_train_step(guard_nonfinite=
True)``: a batch whose loss or gradient global norm is not finite
leaves the parameters, the optimizer state, the BatchNorm statistics
and the step count as they were, and a count of consecutive bad steps
is threaded through as a device scalar. This class gathers the steps'
bad flags without reading them, reads them once an epoch, and decides
when skipping is no longer enough: an epoch that ENDS on ``patience``
consecutive bad steps rolls back to the last good checkpoint at a lower
learning rate; past ``max_rollbacks`` of those the run raises
:class:`NonFiniteRollbackExhausted`.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch


class NonFiniteRollbackExhausted(RuntimeError):
    """The run kept producing non-finite steps after its rollback budget
    (or with no checkpoint to roll back to): a data or model fault that
    retrying will not cure. A supervised run exits with 76
    (``resilience/preempt.py:EXIT_ROLLBACK_EXHAUSTED``), which the
    supervisor fails fast on."""

    exit_code = 76


class NonFiniteSentry:
    """Skip accounting and rollback policy for one training run
    (``Training.nonfinite_patience``, ``nonfinite_max_rollbacks``,
    ``nonfinite_rollback_lr_factor``)."""

    def __init__(self, patience: int = 16, max_rollbacks: int = 2, lr_factor: float = 0.5,
                 device: Optional[torch.device] = None):
        self.patience = int(patience)
        self.max_rollbacks = int(max_rollbacks)
        self.lr_factor = float(lr_factor)
        self.rollbacks = 0
        self.skipped_total = 0
        # consecutive bad steps ending at the current step (device scalar)
        self.consec = torch.zeros((), dtype=torch.int32, device=device)
        self._bads: List[torch.Tensor] = []

    def epoch_start(self) -> None:
        self._bads = []

    def observe(self, consec: torch.Tensor, bad: torch.Tensor) -> None:
        """Record one guarded step's outputs (device scalars; no sync)."""
        self.consec = consec
        self._bads.append(bad)

    def epoch_finalize(self) -> Tuple[int, int]:
        """One read per epoch: (steps skipped this epoch, consecutive bad
        steps at its end)."""
        skipped = int(torch.stack(self._bads).sum()) if self._bads else 0
        consec_end = int(self.consec)
        self.skipped_total += skipped
        self._bads = []
        return skipped, consec_end

    def needs_rollback(self, consec_end: int) -> bool:
        return consec_end >= self.patience

    def on_rollback(self) -> None:
        self.rollbacks += 1
        self.consec = torch.zeros_like(self.consec)

    @property
    def exhausted(self) -> bool:
        return self.rollbacks >= self.max_rollbacks
