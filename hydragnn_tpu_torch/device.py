"""Device resolution for the port's entry points.

Every entry point takes ``device=`` and defaults to ``"cuda"``. A CUDA
request on a machine without a card raises: the port never carries on
quietly on the CPU. The CPU is reached only by asking for it
(``device="cpu"``), as the tests do.

Resolving a device also switches TF32 off for float32 matrix products
and convolutions: float32 means float32 on this path, so the card's
answers stay comparable with the CPU and with the JAX reference.
"""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device, None] = "cuda") -> torch.device:
    """``torch.device`` for ``device``; raises ``RuntimeError`` for a
    CUDA device when no card is present."""
    dev = torch.device("cuda" if device is None else device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "hydragnn_tpu_torch: CUDA device requested but "
                "torch.cuda.is_available() is False; pass device='cpu' to "
                "run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
