"""Checkpoints in the port's own format.

``save_model`` writes ``<path>/<log_name>/<log_name>.pt`` with
``torch.save``: the model's state dict (parameters and the BatchNorm
running statistics), the optimizer's state dict and the epoch count,
atomically (a temporary file, then a rename). ``load_existing_model``
restores it. Reading the JAX package's msgpack/orbax checkpoints is not
ported yet (ROADMAP A5).
"""

from __future__ import annotations

import os
from typing import Optional

import torch


def checkpoint_path(log_name: str, path: str = "./logs/") -> str:
    return os.path.join(path, log_name, f"{log_name}.pt")


def save_model(
    model: torch.nn.Module,
    log_name: str,
    path: str = "./logs/",
    optimizer: Optional[torch.optim.Optimizer] = None,
    epoch: int = 0,
) -> str:
    """Write the checkpoint; returns its path."""
    target = checkpoint_path(log_name, path)
    os.makedirs(os.path.dirname(target), exist_ok=True)
    state = {
        "model": {k: v.detach().cpu() for k, v in model.state_dict().items()},
        "optimizer": None if optimizer is None else optimizer.state_dict(),
        "epoch": int(epoch),
    }
    tmp = f"{target}.{os.getpid()}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, target)
    return target


def load_existing_model(
    model: torch.nn.Module,
    log_name: str,
    path: str = "./logs/",
    optimizer: Optional[torch.optim.Optimizer] = None,
) -> int:
    """Load the checkpoint into ``model`` (strict) and, when given,
    ``optimizer``; returns the saved epoch count."""
    dev = next(model.parameters()).device
    state = torch.load(checkpoint_path(log_name, path), map_location=dev, weights_only=True)
    model.load_state_dict(state["model"], strict=True)
    if optimizer is not None and state["optimizer"] is not None:
        optimizer.load_state_dict(state["optimizer"])
    return int(state["epoch"])
