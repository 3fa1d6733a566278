"""Optimizer selection (the port's counterpart of
``hydragnn_tpu/train/optimizer.py``).

AdamW with optax's defaults, which the JAX package uses: b1 0.9, b2
0.999, eps 1e-8 and weight decay 1e-4 on every parameter (PyTorch's own
AdamW default decay is 1e-2). The update is optax's,
``p -= lr·(m̂/(√v̂ + eps) + wd·p)``, as ``torch.optim.AdamW`` computes it.
The learning rate is read and set between steps for the plateau
scheduler (``train/loop.py``).

Not ported yet (ROADMAP A5): the other seven optimizers,
``freeze_conv_layers`` and ``grad_accum_steps``.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

ADAMW_DEFAULTS = dict(betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)


def select_optimizer(model: torch.nn.Module, training_config: Dict[str, Any]) -> torch.optim.Optimizer:
    """The optimizer of the ``Training`` config section over ``model``'s
    parameters."""
    opt_cfg = training_config.get("Optimizer", {})
    opt_type = opt_cfg.get("type", "AdamW")
    lr = float(opt_cfg.get("learning_rate", training_config.get("learning_rate", 1e-3)))
    if opt_type != "AdamW":
        raise NotImplementedError(f"hydragnn_tpu_torch: optimizer {opt_type!r} is not ported yet (ROADMAP A5)")
    if int(training_config.get("grad_accum_steps", 1)) > 1:
        raise NotImplementedError("hydragnn_tpu_torch: grad_accum_steps is not ported yet (ROADMAP A5)")
    return torch.optim.AdamW(model.parameters(), lr=lr, **ADAMW_DEFAULTS)


def current_learning_rate(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = float(lr)
