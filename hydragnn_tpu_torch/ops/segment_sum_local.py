"""Windowed segment sum for unsorted-but-local ids (B4): the CUDA kernel
``segment_sum_local`` and its plain PyTorch version.

Port of the Pallas ``_sum_local_kernel`` in
``hydragnn_tpu/ops/segment_pallas.py`` (``segment_sum_local_pallas``):

  out [N, H] f32   out[n] = Σ_{e: ids[e] = n} data[e]

for ids that are unsorted but local — batched-graph senders, each graph's
confined to its own contiguous node block. ``win`` [2, n_blocks] int32
(``graph/batch.py:_block_windows``) holds, for row block i, an
edge-position window [win[0, i], win[1, i]) that contains every edge
whose id lies in the block. The block size B is not passed: it rides the
window's shape, ``local_block_rows(N, n_blocks)``, computed the same way
by the emitter and here. On the training path it scatters the gradient
of ``v = bsend[senders]`` back into ``bsend`` (the backward of
``gather_presum_stats``) with no permute of the [E, H] cotangent.

``real_edges`` (an int32 scalar tensor on the data's device, or None)
bounds every window: the edges at or past it belong to no row. The kernel
reads it on the device (no host synchronisation); the callers pass the
batch's edge occupancy, past which every slot is masked and its cotangent
zero.

A CPU tensor takes the plain version (which needs no window); a CUDA
tensor launches the kernel (``csrc/segment_sum_local.cu``) or raises.
Both check that the window plan was made for this ``num_segments``.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from typing import Optional

from hydragnn_tpu_torch.ops._build import (
    FLOAT_CODE,
    LaunchCount,
    bind,
    check_launch,
    cuda_args,
    stream_of,
)
from hydragnn_tpu_torch.ops.segment_sum import bounded_rows, check_bound

SOURCE = "hydragnn_tpu_torch/ops/csrc/segment_sum_local.cu"
REPLACES = "hydragnn_tpu/ops/segment_pallas.py:248"

# launches of the CUDA kernel (never the plain path)
launches = LaunchCount()

_lock = threading.Lock()
_fn = None  # guarded by _lock


def local_block_rows(num_segments: int, n_blocks: int) -> int:
    """The block size a window plan of ``n_blocks`` blocks implies for
    ``num_segments`` rows: the multiple of 16 at or above
    ceil(num_segments / n_blocks) (the JAX package's
    ``local_block_rows``, which the emitter and the kernel share)."""
    b = (num_segments + n_blocks - 1) // n_blocks
    return ((b + 15) // 16) * 16


def check_window_plan(win: torch.Tensor, num_segments: int) -> int:
    """The block size of ``win`` for ``num_segments`` rows; raises when
    the plan was emitted for another row count, which would derive a
    different block size and silently drop edges."""
    if win.dim() != 2 or win.shape[0] != 2 or win.shape[1] < 1:
        raise ValueError(f"segment_sum_local: win must be [2, n_blocks], got {tuple(win.shape)}")
    n_blocks = int(win.shape[1])
    b = local_block_rows(num_segments, n_blocks)
    if n_blocks > 1 and (n_blocks - 1) * b >= num_segments:
        raise ValueError(
            f"win has {n_blocks} blocks but num_segments={num_segments} needs at "
            f"most {(num_segments + b - 1) // b} at the derived block size {b} — "
            "the plan was emitted for a different num_segments (graph/batch.py:_block_windows)"
        )
    return b


def _kernel():
    global _fn
    with _lock:
        if _fn is None:
            _fn = bind("segment_sum_local.cu", "hg_segment_sum_local", [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ])
        return _fn


def segment_sum_local_plain(
    data: torch.Tensor, ids: torch.Tensor, num_segments: int, real_edges: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """``index_add_`` into f32 zeros, in edge order (the kernel's order),
    of the edges below ``real_edges`` (read on the host)."""
    r = bounded_rows(real_edges, data.shape[0])
    out = torch.zeros(int(num_segments), data.shape[1], dtype=torch.float32, device=data.device)
    return out.index_add_(0, ids[:r].long(), data[:r].float())


def segment_sum_local(
    data: torch.Tensor,
    ids: torch.Tensor,
    win: torch.Tensor,
    num_segments: int,
    real_edges: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``[N, H]`` float32 sums of ``data`` [E, H] over local ``ids`` [E]
    within the window plan ``win``, bounded by ``real_edges`` (module
    docstring)."""
    if data.dim() != 2 or ids.dim() != 1 or ids.shape[0] != data.shape[0]:
        raise ValueError(f"segment_sum_local: data [E, H] and ids [E], got {tuple(data.shape)}, {tuple(ids.shape)}")
    if data.dtype not in FLOAT_CODE:
        raise TypeError(f"segment_sum_local: data must be float32 or bfloat16, got {data.dtype}")
    n = int(num_segments)
    block_rows = check_window_plan(win, n)
    check_bound("segment_sum_local", real_edges, data.device)
    if data.device.type == "cpu":
        return segment_sum_local_plain(data, ids, n, real_edges)
    dev = cuda_args("segment_sum_local", data, ids, win)
    if ids.dtype != torch.int32 or win.dtype != torch.int32:
        raise TypeError("segment_sum_local: ids and win must be int32 on CUDA")
    e, h = data.shape
    out = torch.empty(n, h, dtype=torch.float32, device=dev)
    fn = _kernel()
    with torch.cuda.device(dev):
        rc = fn(
            data.data_ptr(), FLOAT_CODE[data.dtype], ids.data_ptr(), win.data_ptr(),
            None if real_edges is None else real_edges.data_ptr(),
            e, int(win.shape[1]), block_rows, n, h, out.data_ptr(), stream_of(dev),
        )
    check_launch("segment_sum_local", rc)
    launches.add(data.dtype)
    return out
