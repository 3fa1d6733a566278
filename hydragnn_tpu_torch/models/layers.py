"""Shared building blocks: masked BatchNorm, MLP and flax-style init.

The port's counterpart of ``hydragnn_tpu/models/layers.py``. Parameters
are initialized as flax initializes them (lecun-normal kernels, zero
biases, BatchNorm scale 1 and bias 0, running mean 0 and variance 1)
from an explicit ``torch.Generator``; the conv stacks that carry the
reference's torch initialization (MFC, SchNet) use the same
distributions as the JAX package: ``variance_scaling(1/3, fan_in,
uniform)`` kernels, the torch-style uniform bias and
``xavier_uniform``. The numbers differ from the JAX package's for the
same seed (different generators); the tests copy weights across with
``convert.py`` instead.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

# flax's lecun_normal: truncated normal at +-2 std, rescaled so the
# truncated distribution has variance 1 / fan_in
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(w: torch.Tensor, fan_in: int, generator: Optional[torch.Generator]) -> torch.Tensor:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def uniform_(w: torch.Tensor, limit: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """U(±limit) in place. ``limit = 1/sqrt(fan_in)`` is torch Linear's
    init of weights and biases, which the JAX package writes as
    ``variance_scaling(1/3, "fan_in", "uniform")`` and its torch-style
    bias; ``sqrt(6/(fan_in + fan_out))`` is ``xavier_uniform``."""
    with torch.no_grad():
        return w.uniform_(-limit, limit, generator=generator)


class Dense(nn.Linear):
    """``nn.Linear`` with flax ``nn.Dense``'s type rule: the input and the
    parameters are promoted to their common type (under mixed precision a
    float32 input, such as the pooled graph features, meets bf16 weights
    and the product is taken in float32, as in the JAX package)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == self.weight.dtype:
            return nn.functional.linear(x, self.weight, self.bias)
        dt = torch.promote_types(x.dtype, self.weight.dtype)
        bias = None if self.bias is None else self.bias.to(dt)
        return nn.functional.linear(x.to(dt), self.weight.to(dt), bias)


def dense(
    in_dim: int,
    out_dim: int,
    generator: Optional[torch.Generator] = None,
    bias: bool = True,
    init: str = "lecun",
) -> Dense:
    """A ``Dense`` initialized like flax's ``nn.Dense`` (weight stored
    [out, in]; ``convert.py`` transposes flax's [in, out] kernels).
    ``init``: "lecun" (flax's default, zero bias), "torch" (the
    reference's torch Linear: weight and bias U(±1/sqrt(in_dim))) or
    "xavier" (``xavier_uniform``, zero bias)."""
    lin = torch.nn.utils.skip_init(Dense, in_dim, out_dim, bias=bias)
    if init == "lecun":
        lecun_normal_(lin.weight, in_dim, generator)
    elif init == "torch":
        uniform_(lin.weight, 1.0 / math.sqrt(in_dim), generator)
    elif init == "xavier":
        uniform_(lin.weight, math.sqrt(6.0 / (in_dim + out_dim)), generator)
    else:
        raise ValueError(f"unknown init {init!r}")
    if bias:
        if init == "torch":
            uniform_(lin.bias, 1.0 / math.sqrt(in_dim), generator)
        else:
            with torch.no_grad():
                lin.bias.zero_()
    return lin


class MaskedBatchNorm(nn.Module):
    """Mask-aware BatchNorm: padding rows never enter the statistics.

    ``train=True`` normalizes with the masked batch statistics (biased
    variance, f32) and updates the running statistics in place, flax's
    way: ``ra = 0.9·ra + 0.1·batch``, with the unbiased variance
    ``var·c/max(c−1, 1)`` of the c unmasked rows. ``train=False``
    normalizes with the running statistics. ``group`` (SyncBatchNorm, the
    JAX package's ``axis_name``): the count, Σx and Σx² are summed over
    its ranks first, through the autograd all-reduce, so the gradient
    flows through the reduction."""

    group = None

    def __init__(self, features: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(features))  # flax "scale"
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None, train: bool = False):
        in_dtype = x.dtype
        x = x.float()
        if train:
            if mask is None:
                count = torch.tensor(float(x.shape[0]), device=x.device)
                total = x.sum(0)
                total_sq = (x * x).sum(0)
            else:
                m = mask.to(x.dtype)[:, None]
                count = m.sum()
                total = (x * m).sum(0)
                total_sq = (x * x * m).sum(0)
            if self.group is not None:
                from torch.distributed.nn.functional import all_reduce

                f = total.shape[0]
                red = all_reduce(torch.cat([count.reshape(1), total, total_sq]), group=self.group)
                count, total, total_sq = red[0], red[1:1 + f], red[1 + f:]
            safe = torch.clamp(count, min=1.0)
            mean = total / safe
            var = torch.clamp(total_sq / safe - mean * mean, min=0.0)
            with torch.no_grad():
                unbiased = var * safe / torch.clamp(count - 1.0, min=1.0)
                mom = self.momentum
                self.running_mean.copy_((1.0 - mom) * self.running_mean + mom * mean)
                self.running_var.copy_((1.0 - mom) * self.running_var + mom * unbiased)
        else:
            mean, var = self.running_mean, self.running_var
        y = (x - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias
        return y.to(in_dtype)


class MLP(nn.Module):
    """Dense stack: Linear(+ReLU) x hidden, then a final Linear;
    ``relu_last`` adds ReLU after the output layer too."""

    def __init__(
        self,
        in_dim: int,
        layer_dims: Sequence[int],
        relu_last: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        dims = [in_dim] + list(layer_dims)
        self.layers = nn.ModuleList(
            dense(a, b, generator) for a, b in zip(dims[:-1], dims[1:])
        )
        self.relu_last = relu_last

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = len(self.layers)
        for i, lin in enumerate(self.layers):
            x = lin(x)
            if i < n - 1 or self.relu_last:
                x = torch.relu(x)
        return x
