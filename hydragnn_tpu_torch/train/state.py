"""The train, eval and BatchNorm-statistics steps (the port's
counterpart of ``hydragnn_tpu/train/state.py``).

A step takes a batch already on the model's device. The train step runs
the forward with batch statistics (which updates the BatchNorm running
statistics), the weighted multi-task loss in f32 against f32 targets,
the backward and the optimizer update, and advances ``optimizer.steps``.
Losses are returned as device tensors: the loop reads them once per
epoch, not once per step.

``make_train_step`` builds the step the epoch loop runs, with the JAX
package's three options:

  - ``compute_dtype=torch.bfloat16`` (``Training.mixed_precision``): the
    float parameters and the batch's float fields are cast to bf16 for
    the forward and backward (the casts are part of the graph, so the
    gradients reach the f32 parameters); the outputs go back to f32 and
    the loss is taken against the uncast targets. The parameters,
    optimizer state and BatchNorm statistics stay f32.
  - ``remat=True`` (``Training.remat``): the loss function runs under
    non-reentrant ``torch.utils.checkpoint``, its activations recomputed
    in the backward. The recomputation would update the BatchNorm
    running statistics a second time and redraw dropout, so the
    statistics are put back to their first forward's values and the
    dropout generator restarts from the same state.
  - ``guard_nonfinite=True`` (``Training.nonfinite_guard``, on by
    default in the loop): ``bad`` = a non-finite loss or gradient global
    norm, decided on the device. A bad step leaves the parameters, every
    optimizer state tensor, the BatchNorm statistics and
    ``optimizer.steps`` as they were (snapshots taken before the
    forward, restored with ``torch.where``), reports a zero loss, and
    counts consecutive bad steps in a device scalar. No host sync.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import torch
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from hydragnn_tpu_torch.graph.batch import GraphBatch
from hydragnn_tpu_torch.models.base import HydraModel, model_loss
from hydragnn_tpu_torch.train.optimizer import Optimizer, keep_where, snapshot


def _cast_floats(batch: GraphBatch, dtype: torch.dtype) -> GraphBatch:
    """The batch with every float32 tensor cast to ``dtype``."""

    def cast(v):
        if isinstance(v, dict):
            return {k: cast(t) for k, t in v.items()}
        if isinstance(v, torch.Tensor) and v.dtype == torch.float32:
            return v.to(dtype)
        return v

    return dataclasses.replace(batch, **{f.name: cast(getattr(batch, f.name)) for f in dataclasses.fields(batch)})


def _loss(model: HydraModel, batch: GraphBatch, compute_dtype: Optional[torch.dtype]):
    if compute_dtype is None:
        outputs = model(batch, train=True)
    else:
        store = getattr(model, "sharded_params", None)
        if store is not None:
            store.unshard()  # FSDP's whole parameters, before the cast reads them (parallel/sharded.py)
        params = {k: p.to(compute_dtype) if p.dtype == torch.float32 else p for k, p in model.named_parameters()}
        outputs = functional_call(model, params, (_cast_floats(batch, compute_dtype),), {"train": True})
        outputs = [o.float() for o in outputs]
    loss, tasks = model_loss(model.cfg, outputs, batch)
    return loss, torch.stack(tasks)


def _loss_and_backward(model: HydraModel, batch: GraphBatch, compute_dtype, remat: bool):
    if not remat:
        loss, tasks = _loss(model, batch, compute_dtype)
        loss.backward()
        return loss, tasks
    gen = model.dropout_generator(next(model.parameters()).device) if model.uses_dropout else None
    gen_state = None if gen is None else gen.get_state()

    def fn():
        if gen is not None:
            gen.set_state(gen_state)
        return _loss(model, batch, compute_dtype)

    loss, tasks = checkpoint(fn, use_reentrant=False)
    stats = [b.detach().clone() for b in model.buffers()]
    loss.backward()
    with torch.no_grad():
        for b, s in zip(model.buffers(), stats):
            b.copy_(s)
    return loss, tasks


def make_train_step(
    model: HydraModel,
    optimizer: Optimizer,
    compute_dtype: Optional[torch.dtype] = None,
    remat: bool = False,
    guard_nonfinite: bool = False,
    sync: Optional[Callable] = None,
) -> Callable:
    """``step(batch) -> (loss, per-head losses)``, or with
    ``guard_nonfinite`` ``step(batch, consec) -> (loss, per-head losses,
    consec, bad)`` (``bad`` 0.0/1.0 as float32); all device tensors.

    ``sync(loss, tasks, batch) -> (loss, tasks, count)`` runs between
    the backward and the update (the data-parallel reduction,
    ``parallel/sharded.py``): the guard then decides on what it returns,
    and the step returns its ``count`` last."""

    def reduced(loss, tasks, batch):
        if sync is None:
            return loss, tasks, ()
        loss, tasks, count = sync(loss, tasks, batch)
        return loss, tasks, (count,)

    def step(batch: GraphBatch):
        optimizer.zero_grad(set_to_none=True)
        loss, tasks = _loss_and_backward(model, batch, compute_dtype, remat)
        loss, tasks, extra = reduced(loss, tasks, batch)
        optimizer.step()
        with torch.no_grad():
            optimizer.steps.add_(1)
        return (loss.detach(), tasks.detach()) + extra

    def guarded(batch: GraphBatch, consec: torch.Tensor):
        params = list(model.parameters())
        # a sharded optimizer names the tensors that hold the values between steps
        resident = optimizer.resident_params() if hasattr(optimizer, "resident_params") else params
        kept = [t.detach() for t in resident + list(model.buffers()) + optimizer.state_tensors()]
        snap = snapshot(kept)
        optimizer.zero_grad(set_to_none=True)
        loss, tasks = _loss_and_backward(model, batch, compute_dtype, remat)
        loss, tasks, extra = reduced(loss, tasks, batch)
        with torch.no_grad():
            sq = [(p.grad * p.grad).sum() for p in params if p.grad is not None]
            norm = torch.sqrt(torch.stack(sq).sum()) if sq else torch.zeros((), device=loss.device)
            bad = ~(torch.isfinite(loss) & torch.isfinite(norm))
        optimizer.step()
        with torch.no_grad():
            keep_where(bad, kept, snap)
            optimizer.steps.add_((~bad).to(optimizer.steps.dtype))
            consec = torch.where(bad, consec + 1, torch.zeros_like(consec))
            loss = torch.where(bad, torch.zeros_like(loss), loss.detach())
            tasks = torch.where(bad, torch.zeros_like(tasks), tasks.detach())
        return (loss, tasks, consec, bad.float()) + extra

    return guarded if guard_nonfinite else step


def train_step(
    model: HydraModel, optimizer: Optimizer, batch: GraphBatch
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One plain f32 update; returns (loss, per-head losses [H]), detached."""
    return make_train_step(model, optimizer)(batch)


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
