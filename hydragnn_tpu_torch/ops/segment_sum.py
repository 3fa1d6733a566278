"""Sorted segment sum (B2): the CUDA kernel ``segment_sum`` and its plain
PyTorch version.

Port of the Pallas ``_sum_kernel`` in
``hydragnn_tpu/ops/segment_pallas.py`` (``segment_sum_fast`` with
``indices_are_sorted=True``): for ids sorted ascending,

  out [N, W] f32   out[n] = Σ_{e: ids[e] = n, mask[e]} data[e]

accumulated in float32 whatever the input type (f32 or bf16). Rows with
no edge are 0; ids outside [0, N) belong to no row and are dropped, as
the kernel's row pointers drop them. On the training path it reduces
the run-aligned K-group statistics into the nodes
(``graph/segment.py:segment_sum_sorted``), counts the tied maxima in the
extremum backward, and is the backward of every sorted gather.

``real_rows`` (an int32 scalar tensor on the data's device, or None)
bounds the walk: data rows at or past it belong to no row. The kernel
reads it on the device, so a call never synchronises with the host and
can be captured in a CUDA graph. The callers pass the batch's edge
occupancy (or its K-group count), past which every data row is zero or
adds only to the padding node's row, whose result is not read
(``graph/segment.py``, ``models/convs.py``).

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
(``csrc/segment_sum.cu``) or raises. The sorted order is the caller's
contract and is not checked on the card.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from hydragnn_tpu_torch.ops._build import (
    FLOAT_CODE,
    LaunchCount,
    bind,
    check_launch,
    cuda_args,
    stream_of,
)

SOURCE = "hydragnn_tpu_torch/ops/csrc/segment_sum.cu"
REPLACES = "hydragnn_tpu/ops/segment_pallas.py:235"

# launches of the CUDA kernel (never the plain path)
launches = LaunchCount()

_lock = threading.Lock()
_fn = None  # guarded by _lock


def _kernel():
    global _fn
    with _lock:
        if _fn is None:
            _fn = bind("segment_sum.cu", "hg_segment_sum", [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ])
        return _fn


def check_bound(name: str, bound: Optional[torch.Tensor], device: torch.device) -> None:
    """Raise unless ``bound`` is None or one int32 on ``device``."""
    if bound is not None and (bound.dtype != torch.int32 or bound.numel() != 1 or bound.device != device):
        raise TypeError(f"{name}: the bound must be one int32 on {device}, got {bound.dtype} "
                        f"{tuple(bound.shape)} on {bound.device}")


def bounded_rows(bound: Optional[torch.Tensor], n: int) -> int:
    """The rows a plain version walks: ``bound`` read on the host and
    clamped to [0, n], or n without one."""
    return n if bound is None else min(max(int(bound), 0), n)


def segment_sum_plain(
    data: torch.Tensor,
    ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
    real_rows: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``index_add_`` of the masked rows into f32 zeros (the order of the
    edges, as the kernel sums them); ids outside [0, N) are dropped, and
    so are the rows at or past ``real_rows`` (read on the host)."""
    r = bounded_rows(real_rows, data.shape[0])
    if r < data.shape[0]:
        data, ids = data[:r], ids[:r]
        mask = None if mask is None else mask[:r]
    vals = data.float()
    if mask is not None:
        vals = torch.where(mask[:, None], vals, torch.zeros((), device=data.device))
    n = int(num_segments)
    keep = (ids >= 0) & (ids < n)
    if not bool(keep.all()):
        vals, ids = vals[keep], ids[keep]
    out = torch.zeros(n, data.shape[1], dtype=torch.float32, device=data.device)
    return out.index_add_(0, ids.long(), vals)


def segment_sum(
    data: torch.Tensor,
    ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
    real_rows: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``[N, W]`` float32 sums of ``data`` [E, W] over sorted ``ids`` [E]
    (module docstring); ``mask`` is an optional bool [E], ``real_rows``
    the optional bound of the walk."""
    if data.dim() != 2 or ids.dim() != 1 or ids.shape[0] != data.shape[0]:
        raise ValueError(f"segment_sum: data [E, W] and ids [E], got {tuple(data.shape)}, {tuple(ids.shape)}")
    if data.dtype not in FLOAT_CODE:
        raise TypeError(f"segment_sum: data must be float32 or bfloat16, got {data.dtype}")
    if mask is not None and (mask.dtype != torch.bool or mask.shape != ids.shape):
        raise ValueError("segment_sum: mask must be bool [E]")
    n = int(num_segments)
    if n < 1:
        raise ValueError("segment_sum: num_segments must be >= 1")
    check_bound("segment_sum", real_rows, data.device)
    if data.device.type == "cpu":
        return segment_sum_plain(data, ids, n, mask, real_rows)
    dev = cuda_args("segment_sum", data, ids, mask)
    if ids.dtype != torch.int32:
        raise TypeError(f"segment_sum: ids must be int32 on CUDA, got {ids.dtype}")
    e, w = data.shape
    fn = _kernel()
    with torch.cuda.device(dev):
        row_ptr = torch.empty(n + 1, dtype=torch.int32, device=dev)
        out = torch.empty(n, w, dtype=torch.float32, device=dev)
        rc = fn(
            data.data_ptr(), FLOAT_CODE[data.dtype], ids.data_ptr(),
            None if mask is None else mask.data_ptr(), None if real_rows is None else real_rows.data_ptr(), e, n, w,
            row_ptr.data_ptr(), out.data_ptr(), stream_of(dev),
        )
    check_launch("segment_sum", rc)
    launches.add(data.dtype)
    return out
