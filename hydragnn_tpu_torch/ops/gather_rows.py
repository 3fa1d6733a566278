"""Row gather (B3): the CUDA kernel ``gather_rows`` and its plain
PyTorch version.

Port of the Pallas ``_bcast_kernel`` in
``hydragnn_tpu/ops/segment_pallas.py`` (``gather_rows_sorted_fast`` and
``gather_rows_local_fast``): ``out[e] = table[ids[e]]``, an exact copy of
each row, for a 2-D table of any dtype. The TPU kernel had two window
plans, for sorted and for local ids; on the card both are the same
kernel. On the training path it is every widening gather of the
backward (the extremum's ``out[ids]`` and ``share[ids]``, the
cotangent of ``segment_sum_sorted``); the backward of
``gather_presum_stats`` regathers ``v`` inside its own kernel.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
(``csrc/gather_rows.cu``) or raises.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from hydragnn_tpu_torch.ops._build import LaunchCount, bind, check_launch, cuda_args, stream_of

SOURCE = "hydragnn_tpu_torch/ops/csrc/gather_rows.cu"
REPLACES = "hydragnn_tpu/ops/segment_pallas.py:854"

# launches of the CUDA kernel (never the plain path)
launches = LaunchCount()

_lock = threading.Lock()
_fn = None  # guarded by _lock


def _kernel():
    global _fn
    with _lock:
        if _fn is None:
            _fn = bind("gather_rows.cu", "hg_gather_rows", [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
            ])
        return _fn


def gather_rows_plain(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return table.index_select(0, ids.long())


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` for a [N, W] ``table`` and [E] ``ids`` (sorted or
    not); not differentiated itself (``graph/segment.py`` pairs it with
    its backward)."""
    if table.dim() != 2 or ids.dim() != 1:
        raise ValueError(f"gather_rows: table [N, W] and ids [E], got {tuple(table.shape)}, {tuple(ids.shape)}")
    if table.device.type == "cpu":
        return gather_rows_plain(table, ids)
    dev = cuda_args("gather_rows", table, ids)
    if ids.dtype != torch.int32:
        raise TypeError(f"gather_rows: ids must be int32 on CUDA, got {ids.dtype}")
    n, w = table.shape
    e = ids.shape[0]
    out = torch.empty(e, w, dtype=table.dtype, device=dev)
    if e == 0 or w == 0:
        return out
    fn = _kernel()
    with torch.cuda.device(dev):
        rc = fn(table.data_ptr(), ids.data_ptr(), e, n, w * table.element_size(),
                out.data_ptr(), stream_of(dev))
    check_launch("gather_rows", rc)
    launches.add(table.dtype)
    return out
