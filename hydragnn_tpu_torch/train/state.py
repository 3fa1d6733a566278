"""The train, eval and BatchNorm-statistics steps (the port's
counterpart of ``hydragnn_tpu/train/state.py``).

A step takes a batch already on the model's device. The train step runs
the forward with batch statistics (which updates the BatchNorm running
statistics), the weighted multi-task loss in f32 against f32 targets,
the backward and the optimizer update. Losses are returned as device
tensors: the loop reads them once per epoch, not once per step.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from hydragnn_tpu_torch.graph.batch import GraphBatch
from hydragnn_tpu_torch.models.base import HydraModel, model_loss


def train_step(
    model: HydraModel, optimizer: torch.optim.Optimizer, batch: GraphBatch
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One update; returns (loss, per-head losses [H]), detached."""
    optimizer.zero_grad(set_to_none=True)
    outputs = model(batch, train=True)
    loss, tasks = model_loss(model.cfg, outputs, batch)
    loss.backward()
    optimizer.step()
    return loss.detach(), torch.stack(tasks).detach()


@torch.no_grad()
def eval_step(
    model: HydraModel, batch: GraphBatch
) -> Tuple[torch.Tensor, torch.Tensor, List[torch.Tensor]]:
    """Forward with the running statistics; returns (loss, per-head
    losses [H], outputs)."""
    outputs = model(batch, train=False)
    loss, tasks = model_loss(model.cfg, outputs, batch)
    return loss, torch.stack(tasks), outputs


@torch.no_grad()
def stats_step(model: HydraModel, batch: GraphBatch) -> None:
    """A batch-statistics forward that only updates the BatchNorm running
    statistics (the JAX package's ``make_stats_step``): BatchNorm in
    batch-statistics mode, dropout off."""
    model(batch, train=False, bn_train=True)
