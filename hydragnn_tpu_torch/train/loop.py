"""Epoch driver: train, validate and test with plateau LR and early stop
(the core of ``hydragnn_tpu/train/loop.py:train_validate_test``).

Semantics kept from the JAX package:

  - the loaders reshuffle per epoch (``set_epoch``);
  - losses are averaged weighted by each batch's real graph count
    (``graph_mask``), so padding never dilutes them; per-batch losses
    stay on the device and are read once per epoch;
  - ``ReduceLROnPlateau(factor=0.5, patience=5, min_lr=1e-5,
    threshold=1e-4)`` steps on the validation loss;
  - ``EarlyStopping(patience=10)`` when ``Training.EarlyStopping`` is set;
  - after the last epoch, unless ``Training.bn_recalibration`` is false,
    two batch-statistics passes over the train split re-estimate the
    BatchNorm running statistics with the final parameters.

Not ported yet: telemetry and flight records (ROADMAP A11); preemption,
the non-finite sentry, per-epoch checkpoints and continue/startfrom
(ROADMAP A5, A12).
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from hydragnn_tpu_torch.models.base import HydraModel
from hydragnn_tpu_torch.train.optimizer import current_learning_rate, set_learning_rate
from hydragnn_tpu_torch.train.state import eval_step, stats_step, train_step


class EarlyStopping:
    """Patience counter on the validation loss."""

    def __init__(self, patience: int = 10, min_delta: float = 0.0):
        self.patience = patience
        self.min_delta = min_delta
        self.count = 0
        self.min_loss = float("inf")

    def __call__(self, val_loss: float) -> bool:
        if val_loss < self.min_loss:
            self.min_loss = val_loss
            self.count = 0
        elif val_loss > self.min_loss + self.min_delta:
            self.count += 1
            if self.count >= self.patience:
                return True
        return False


class ReduceLROnPlateau:
    """Torch-semantics plateau scheduler on the optimizer's learning rate."""

    def __init__(self, factor: float = 0.5, patience: int = 5, min_lr: float = 1e-5, threshold: float = 1e-4):
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.threshold = threshold
        self.best = float("inf")
        self.num_bad_epochs = 0

    def step(self, optimizer: torch.optim.Optimizer, val_loss: float) -> None:
        if val_loss < self.best * (1.0 - self.threshold):
            self.best = val_loss
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            self.num_bad_epochs = 0
            set_learning_rate(optimizer, max(current_learning_rate(optimizer) * self.factor, self.min_lr))


class _MetricAccum:
    """Per-batch (loss, tasks, real graph count) kept on the device; one
    read at ``finalize``."""

    def __init__(self):
        self._losses: List[torch.Tensor] = []
        self._tasks: List[torch.Tensor] = []
        self._counts: List[torch.Tensor] = []

    def add(self, loss: torch.Tensor, tasks: torch.Tensor, graph_mask: torch.Tensor) -> None:
        self._losses.append(loss)
        self._tasks.append(tasks)
        self._counts.append(graph_mask.sum().float())

    def finalize(self) -> Tuple[float, np.ndarray]:
        if not self._counts:
            return 0.0, np.zeros(0, np.float32)
        counts = torch.stack(self._counts)
        total = max(float(counts.sum()), 1.0)
        loss = float((torch.stack(self._losses) * counts).sum()) / total
        tasks = (torch.stack(self._tasks) * counts[:, None]).sum(0).cpu().numpy() / total
        return loss, tasks


def _device_of(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def train_epoch(loader, model: HydraModel, optimizer) -> Tuple[float, np.ndarray]:
    dev = _device_of(model)
    acc = _MetricAccum()
    for batch in loader:
        batch = batch.to(dev)
        loss, tasks = train_step(model, optimizer, batch)
        acc.add(loss, tasks, batch.graph_mask)
    return acc.finalize()


def evaluate_epoch(loader, model: HydraModel) -> Tuple[float, np.ndarray]:
    dev = _device_of(model)
    acc = _MetricAccum()
    for batch in loader:
        batch = batch.to(dev)
        loss, tasks, _ = eval_step(model, batch)
        acc.add(loss, tasks, batch.graph_mask)
    return acc.finalize()


def test_epoch(
    loader, model: HydraModel, return_samples: bool = True
) -> Tuple[float, np.ndarray, List[np.ndarray], List[np.ndarray]]:
    """Full test pass; with ``return_samples`` also the per-head (true,
    predicted) values over the real (unpadded) rows."""
    cfg = model.cfg
    dev = _device_of(model)
    acc = _MetricAccum()
    trues: List[List[np.ndarray]] = [[] for _ in range(cfg.num_heads)]
    preds: List[List[np.ndarray]] = [[] for _ in range(cfg.num_heads)]
    for host in loader:
        batch = host.to(dev)
        loss, tasks, outputs = eval_step(model, batch)
        acc.add(loss, tasks, batch.graph_mask)
        if not return_samples:
            continue
        for ihead, name in enumerate(cfg.output_names):
            if cfg.output_type[ihead] == "graph":
                mask, target = host.graph_mask, host.graph_targets[name]
            else:
                mask, target = host.node_mask, host.node_targets[name]
            trues[ihead].append(target[mask].numpy())
            preds[ihead].append(outputs[ihead].float().cpu()[mask].numpy())
    loss, tasks = acc.finalize()
    true_values = [np.concatenate(t) if t else np.zeros((0, 1)) for t in trues]
    pred_values = [np.concatenate(p) if p else np.zeros((0, 1)) for p in preds]
    return loss, tasks, true_values, pred_values


def train_validate_test(
    model: HydraModel,
    optimizer: torch.optim.Optimizer,
    train_loader,
    val_loader,
    test_loader,
    config: Dict[str, Any],
    verbosity: int = 0,
) -> Dict[str, List]:
    """Train for ``Training.num_epoch`` epochs with validation-driven LR
    plateau and early stopping; ``config`` is the ``NeuralNetwork``
    section. Returns the history: per-epoch train/val/test losses, the
    per-head losses and the learning rate."""
    training = config["Training"]
    if training.get("continue") == 1:
        raise NotImplementedError("hydragnn_tpu_torch: Training.continue is not ported yet (ROADMAP A5)")
    num_epoch = int(training["num_epoch"])
    stopper = (
        EarlyStopping(patience=int(training.get("patience", 10)))
        if training.get("EarlyStopping", False)
        else None
    )
    scheduler = ReduceLROnPlateau()
    names: Sequence[str] = model.cfg.output_names
    history: Dict[str, List] = {k: [] for k in (
        "train_loss", "val_loss", "test_loss", "train_tasks", "val_tasks", "test_tasks", "lr")}
    for epoch in range(num_epoch):
        for loader in (train_loader, val_loader, test_loader):
            loader.set_epoch(epoch)
        train_loss, train_tasks = train_epoch(train_loader, model, optimizer)
        val_loss, val_tasks = evaluate_epoch(val_loader, model)
        test_loss, test_tasks, _, _ = test_epoch(test_loader, model, return_samples=False)
        scheduler.step(optimizer, val_loss)
        for key, val in (("train_loss", train_loss), ("val_loss", val_loss), ("test_loss", test_loss),
                         ("train_tasks", train_tasks.tolist()), ("val_tasks", val_tasks.tolist()),
                         ("test_tasks", test_tasks.tolist()), ("lr", current_learning_rate(optimizer))):
            history[key].append(val)
        if verbosity > 0:
            per_head = ", ".join(f"{n}={v:.6f}" for n, v in zip(names, train_tasks))
            print(f"Epoch: {epoch:02d}, Train Loss: {train_loss:.8f}, Val Loss: {val_loss:.8f}, "
                  f"Test Loss: {test_loss:.8f} ({per_head})", flush=True)
        if stopper is not None and stopper(val_loss):
            if verbosity > 0:
                print(f"Early stopping at epoch {epoch}", flush=True)
            break
    if training.get("bn_recalibration", True):
        for _ in range(2):
            for batch in train_loader:
                stats_step(model, batch.to(_device_of(model)))
    return history
