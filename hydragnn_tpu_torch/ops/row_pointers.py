"""The CSR row pointers of sorted receivers: the port's one source of
them, for every kernel that walks a receiver row's edges (B5's forward,
B6, B8, B9).

``ptr[r]`` is the first edge whose receiver is >= r, for r in
``[0, num_segments]``: ``num_segments + 1`` int32 entries. On the card
``row_pointers`` runs ``csrc/row_pointers.cu`` (a zero fill, then
``common.cuh:csr_row_ptr_kernel``); on the CPU it is
``row_pointers_plain`` (``torch.searchsorted``). The two agree wherever
the receivers are sorted ascending, and an id outside
``[0, num_segments)`` belongs to no row.

The chassis builds them once per forward, at the first read of
``EdgeContext.row_ptr`` (``models/convs.py``), and every layer's kernel
call of that forward walks the same tensor; a kernel wrapper called
without them builds its own here.
``check_row_ptr`` is the wrappers' check of what they are handed: shape,
type, contiguity and device. Their contents are not checked, which would
need a host synchronisation: the caller promises that they are the
receivers' row pointers.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from hydragnn_tpu_torch.ops._build import LaunchCount, bind, check_launch, cuda_args, stream_of

SOURCE = "hydragnn_tpu_torch/ops/csrc/row_pointers.cu"
# no Pallas kernel: the JAX package's CSR kernels take their row offsets
# from XLA's searchsorted over the sorted receivers
REPLACES = "hydragnn_tpu/ops/segment_pallas.py:404"

# passes on the card (never the CPU's searchsorted)
launches = LaunchCount()

_lock = threading.Lock()
_fn = None  # the bound C entry point; guarded by _lock


def _kernel():
    global _fn
    with _lock:
        if _fn is None:
            p, ll = ctypes.c_void_p, ctypes.c_longlong
            _fn = bind("row_pointers.cu", "hg_row_pointers", [p, ll, ll, p, p])
        return _fn


def row_pointers_plain(receivers: torch.Tensor, num_segments: int) -> torch.Tensor:
    """The row pointers in plain PyTorch: ``torch.searchsorted`` of
    every row id into the sorted receivers, on their device."""
    rows = torch.arange(int(num_segments) + 1, dtype=receivers.dtype, device=receivers.device)
    return torch.searchsorted(receivers.contiguous(), rows).to(torch.int32)


def row_pointers(receivers: torch.Tensor, num_segments: int) -> torch.Tensor:
    """The ``[num_segments + 1]`` int32 CSR row pointers of the sorted
    int32 ``receivers`` (module docstring). A CPU tensor takes
    ``row_pointers_plain``; a CUDA tensor launches the pass or raises."""
    s = int(num_segments)
    if s < 1:
        raise ValueError("row_pointers: num_segments must be >= 1")
    if receivers.dim() != 1:
        raise ValueError(f"row_pointers: receivers must be [E], got shape {tuple(receivers.shape)}")
    if receivers.device.type == "cpu":
        return row_pointers_plain(receivers, s)
    dev = cuda_args("row_pointers", receivers)
    if receivers.dtype != torch.int32:
        raise TypeError(f"row_pointers: receivers must be int32 on CUDA, got {receivers.dtype}")
    fn = _kernel()
    with torch.cuda.device(dev):
        row_ptr = torch.empty(s + 1, dtype=torch.int32, device=dev)
        rc = fn(receivers.data_ptr(), receivers.shape[0], s, row_ptr.data_ptr(), stream_of(dev))
    check_launch("row_pointers", rc)
    launches.add()
    return row_ptr


def check_row_ptr(name: str, row_ptr: torch.Tensor, num_segments: int, device: torch.device) -> None:
    """Raise unless ``row_ptr`` is a contiguous ``[num_segments + 1]``
    int32 tensor on ``device``."""
    want = (int(num_segments) + 1,)
    if tuple(row_ptr.shape) != want:
        raise ValueError(f"{name}: row_ptr must be [{want[0]}] (num_segments + 1), got {tuple(row_ptr.shape)}")
    if row_ptr.dtype != torch.int32:
        raise TypeError(f"{name}: row_ptr must be int32, got {row_ptr.dtype}")
    if row_ptr.device != device:
        raise ValueError(f"{name}: row_ptr on {row_ptr.device}, the tensors on {device}")
    if not row_ptr.is_contiguous():
        raise ValueError(f"{name}: row_ptr must be contiguous")
