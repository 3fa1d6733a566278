"""Masked segment reductions in plain torch (forward only).

The port's counterpart of ``hydragnn_tpu/graph/segment.py:31-172``.
These were XLA ops in the JAX package, not Pallas kernels, so plain
torch is their port. Every op is mask-aware (padding entries contribute
the reduction identity) and safe on empty segments (mean, max and min
return 0 there). The autograd versions with the even tie split wait
for the training slice (ROADMAP A3).
"""

from __future__ import annotations

from typing import Optional

import torch


def _expand_mask(mask: Optional[torch.Tensor], data: torch.Tensor) -> Optional[torch.Tensor]:
    if mask is None:
        return None
    while mask.dim() < data.dim():
        mask = mask.unsqueeze(-1)
    return mask


def segment_sum(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    m = _expand_mask(mask, data)
    if m is not None:
        data = torch.where(m, data, torch.zeros((), dtype=data.dtype, device=data.device))
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]), dtype=data.dtype, device=data.device)
    return out.index_add_(0, segment_ids.long(), data)


def segment_count(
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    ones = torch.ones(segment_ids.shape[0], dtype=torch.float32, device=segment_ids.device)
    return segment_sum(ones, segment_ids, num_segments, mask)


def segment_mean(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    total = segment_sum(data, segment_ids, num_segments, mask)
    count = segment_count(segment_ids, num_segments, mask)
    count = _expand_mask(count, total)
    return total / torch.clamp(count, min=1.0)


def _segment_extremum(data, segment_ids, num_segments, mask, empty_value, is_max):
    finfo = torch.finfo(data.dtype)
    fill = finfo.min if is_max else finfo.max
    m = _expand_mask(mask, data)
    if m is not None:
        data = torch.where(m, data, torch.full((), fill, dtype=data.dtype, device=data.device))
    idx = segment_ids.long().view((-1,) + (1,) * (data.dim() - 1)).expand_as(data)
    init = torch.full(
        (num_segments,) + tuple(data.shape[1:]),
        float("-inf") if is_max else float("inf"),
        dtype=data.dtype,
        device=data.device,
    )
    out = init.scatter_reduce(0, idx, data, "amax" if is_max else "amin", include_self=True)
    empty = out <= fill if is_max else out >= fill
    return torch.where(empty, torch.full((), empty_value, dtype=data.dtype, device=data.device), out)


def segment_max(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
    empty_value: float = 0.0,
) -> torch.Tensor:
    return _segment_extremum(data, segment_ids, num_segments, mask, empty_value, True)


def segment_min(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
    empty_value: float = 0.0,
) -> torch.Tensor:
    return _segment_extremum(data, segment_ids, num_segments, mask, empty_value, False)
