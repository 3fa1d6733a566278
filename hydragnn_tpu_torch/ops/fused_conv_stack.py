"""L width-preserving fused conv layers (B9): the CUDA kernel behind
``fused_conv_stack``, its plain PyTorch version, and the differentiable
op.

Port of ``fused_conv_stack`` in ``hydragnn_tpu/ops/fused_conv.py`` (the
Pallas ``_make_stack_kernel`` and its ``_stack_ref_loop``). For
receivers sorted ascending and ``num_segments == N``:

  h_0 = x;   out_l = Σ_{e→r, mask_e} edge_act(h_l[send_e] @ W_l + b_l)
  h_{l+1} = inter_act(out_l)

and the result is ``out_{L-1}`` as float32 [N, H] (no ``inter_act``
after the last layer).

``fused_conv_stack_plain`` is the per-layer composition
(``_stack_ref_loop``) on ``fused_conv_plain``, intermediate layers cast
back to x's dtype. ``fused_conv_stack`` dispatches as the JAX op does,
minus the TPU's VMEM budget (the card has none to respect):

  - a float32 CUDA tensor launches B9 (``csrc/fused_conv_stack.cu``),
    or raises; it never takes the plain loop;
  - a bfloat16 CUDA tensor takes the per-layer loop of
    ``fused_aggregate`` (B8 forward), as the JAX op takes its per-layer
    fused kernels for non-f32 activations;
  - a CPU tensor takes the plain version.

The backward is the reference's ``_fused_stack_bwd``: the gradient of
the per-layer composition, recomputed through ``fused_aggregate`` (B8
forward; B3, with B4 or ``index_add_`` for ``grad_x``, backward). The
JAX package has no backward kernel for B9, and neither has the port.
``win`` (the senders' window plan) serves only that backward;
``real_edges`` (the batch's occupancy bound) bounds every layer's walk.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Sequence, Union

import torch

from hydragnn_tpu_torch.ops._build import LaunchCount, bind, check_launch, cuda_args, stream_of
from hydragnn_tpu_torch.ops.fused_conv import ACT_CODE, ACTS, fused_aggregate, fused_conv_plain
from hydragnn_tpu_torch.ops.row_pointers import row_pointers

SOURCE = "hydragnn_tpu_torch/ops/csrc/fused_conv_stack.cu"
REPLACES = "hydragnn_tpu/ops/fused_conv.py:977"

# launches of the CUDA kernel (never the plain path); one per call, which
# runs 2L kernels on the card over the row pointers the op builds once
launches = LaunchCount()

_lock = threading.Lock()
_fn = None  # guarded by _lock


def _kernel():
    global _fn
    with _lock:
        if _fn is None:
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            _fn = bind("fused_conv_stack.cu", "hg_fused_conv_stack", [
                p, p, p, p, ll, ll, i, i, i, i, p, p, p, p, p, p,
            ])
        return _fn


def _stacked(ts: Union[torch.Tensor, Sequence[torch.Tensor]]) -> torch.Tensor:
    return ts if isinstance(ts, torch.Tensor) else torch.stack(list(ts), dim=0)


def _check(x: torch.Tensor, num_segments: int, weights: torch.Tensor, biases, edge_act: str, inter_act: str) -> int:
    """The JAX op's checks, with its messages; returns L."""
    if weights.dim() != 3 or weights.shape[1] != weights.shape[2]:
        raise ValueError(f"fused_conv_stack needs square [L, H, H] weights, got {tuple(weights.shape)}")
    n, h = x.shape
    if weights.shape[1] != h:
        raise ValueError(f"weights width {weights.shape[1]} != feature width {h}")
    if num_segments != n:
        raise ValueError(
            "fused_conv_stack feeds layer outputs back as inputs; "
            f"num_segments ({num_segments}) must equal x.shape[0] ({n})"
        )
    for name in (edge_act, inter_act):
        if name not in ACTS:
            raise ValueError(f"unknown fused_conv_stack activation {name!r}")
    if biases is not None and tuple(biases.shape) != (weights.shape[0], h):
        raise ValueError(f"fused_conv_stack: biases must be [L, H], got {tuple(biases.shape)}")
    return int(weights.shape[0])


def _loop(layer, x, weights, biases, edge_act, inter_act):
    """``_stack_ref_loop``: ``layer(h, W_l, b_l)`` per layer, ``inter_act``
    between layers, cast back to x's dtype."""
    h, out = x, None
    for l in range(weights.shape[0]):
        out = layer(h, weights[l], None if biases is None else biases[l])
        if l + 1 < weights.shape[0]:
            h = ACTS[inter_act][0](out).to(x.dtype)
    return out


def fused_conv_stack_plain(
    x: torch.Tensor,
    senders: torch.Tensor,
    receivers: torch.Tensor,
    edge_mask: torch.Tensor,
    num_segments: int,
    weights: Union[torch.Tensor, Sequence[torch.Tensor]],
    biases: Optional[Union[torch.Tensor, Sequence[torch.Tensor]]] = None,
    edge_act: str = "none",
    inter_act: str = "relu",
) -> torch.Tensor:
    """The per-layer composition on ``fused_conv_plain`` (in x's dtype,
    summed in f32); returns f32 [N, H]."""
    weights = _stacked(weights)
    biases = None if biases is None else _stacked(biases)
    _check(x, int(num_segments), weights, biases, edge_act, inter_act)

    def layer(h, w, b):
        return fused_conv_plain(h, senders, receivers, edge_mask, num_segments, ((w, b, None, None),), (edge_act,))

    return _loop(layer, x, weights, biases, edge_act, inter_act)


def _stack_kernel(x, senders, row_ptr, mask, weights, biases, edge_act, inter_act, real_edges) -> torch.Tensor:
    """B9 on the card: f32 x [N, H], W [L, H, H] and b [L, H] (as f32),
    walking the receivers' ``row_ptr`` (``ops/row_pointers.py``)."""
    w = weights.float().contiguous()
    b = None if biases is None else biases.float().contiguous()
    dev = cuda_args("fused_conv_stack", x, senders, row_ptr, mask, real_edges, w, b)
    if x.dtype != torch.float32:
        raise TypeError(f"fused_conv_stack: B9 takes float32 x, got {x.dtype}")
    if senders.dtype != torch.int32:
        raise TypeError("fused_conv_stack: senders must be int32 on CUDA")
    if mask.dtype != torch.bool:
        raise TypeError(f"fused_conv_stack: mask must be bool, got {mask.dtype}")
    if real_edges is not None and (real_edges.dtype != torch.int32 or real_edges.numel() != 1):
        raise TypeError("fused_conv_stack: real_edges must be one int32")
    n, h = x.shape
    e = senders.shape[0]
    fn = _kernel()
    with torch.cuda.device(dev):
        q = torch.empty(n + 1, h, dtype=torch.float32, device=dev)  # row n: a zero row's message
        out = torch.empty(n, h, dtype=torch.float32, device=dev)
        rc = fn(
            x.data_ptr(), senders.data_ptr(), mask.data_ptr(),
            None if real_edges is None else real_edges.data_ptr(), e, n, h, w.shape[0],
            ACT_CODE[edge_act], ACT_CODE[inter_act], w.data_ptr(), None if b is None else b.data_ptr(),
            row_ptr.data_ptr(), q.data_ptr(), out.data_ptr(), stream_of(dev),
        )
    check_launch("fused_conv_stack", rc)
    launches.add()
    return out


def _aggregate_loop(x, senders, receivers, mask, num_segments, weights, biases, edge_act, inter_act, win, real_edges,
                    row_ptr=None):
    """The per-layer composition on ``fused_aggregate`` (differentiable;
    B8 on the card, every layer walking one set of row pointers: ``row_ptr``,
    or those built here)."""
    if row_ptr is None and x.device.type == "cuda":
        row_ptr = row_pointers(receivers, num_segments)

    def layer(h, w, b):
        return fused_aggregate(
            h, senders, receivers, mask, num_segments, ((w, b, None, None),), (edge_act,),
            win=win, real_edges=real_edges, row_ptr=row_ptr,
        )

    return _loop(layer, x, weights, biases, edge_act, inter_act)


class _FusedStack(torch.autograd.Function):
    @staticmethod
    def forward(ctx, edge_act, inter_act, num_segments, x, senders, receivers, mask, win, real_edges, weights, biases):
        row_ptr = None
        if x.device.type == "cpu":
            out = fused_conv_stack_plain(x, senders, receivers, mask, num_segments, weights, biases, edge_act, inter_act)
        else:
            row_ptr = row_pointers(receivers, num_segments)
            out = _stack_kernel(x, senders, row_ptr, mask, weights, biases, edge_act, inter_act, real_edges)
        ctx.save_for_backward(x, senders, receivers, mask, win, real_edges, weights, biases, row_ptr)
        ctx.acts, ctx.num_segments = (edge_act, inter_act), num_segments
        return out

    @staticmethod
    def backward(ctx, g):
        x, senders, receivers, mask, win, real_edges, weights, biases, row_ptr = ctx.saved_tensors
        needs = ctx.needs_input_grad
        # the gradient of the per-layer composition, recomputed through B8
        with torch.enable_grad():
            xs = x.detach().requires_grad_(needs[3])
            ws = weights.detach().requires_grad_(needs[9])
            bs = None if biases is None else biases.detach().requires_grad_(needs[10])
            out = _aggregate_loop(xs, senders, receivers, mask, ctx.num_segments, ws, bs, *ctx.acts, win, real_edges,
                                  row_ptr)
            wrt = [t for t in (xs, ws, bs) if t is not None and t.requires_grad]
            grads = iter(torch.autograd.grad(out, wrt, g)) if wrt else iter(())
        gx = next(grads) if needs[3] else None
        gw = next(grads) if needs[9] else None
        gb = next(grads) if biases is not None and needs[10] else None
        return (None, None, None, gx, None, None, None, None, None, gw, gb)


def fused_conv_stack(
    x: torch.Tensor,
    senders: torch.Tensor,
    receivers: torch.Tensor,
    edge_mask: torch.Tensor,
    num_segments: int,
    weights: Union[torch.Tensor, Sequence[torch.Tensor]],
    biases: Optional[Union[torch.Tensor, Sequence[torch.Tensor]]] = None,
    edge_act: str = "none",
    inter_act: str = "relu",
    win: Optional[torch.Tensor] = None,
    real_edges: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """L fused conv layers (module docstring); returns float32 [N, H].
    ``weights``: [L, H, H] or a sequence of [H, H]; ``biases``: [L, H],
    a sequence of [H], or None. Differentiable in x, the weights and the
    biases."""
    weights = _stacked(weights)
    biases = None if biases is None else _stacked(biases)
    _check(x, int(num_segments), weights, biases, edge_act, inter_act)
    mask = edge_mask.detach()
    if x.device.type == "cuda" and x.dtype != torch.float32:
        return _aggregate_loop(x, senders, receivers, mask, int(num_segments), weights, biases, edge_act,
                               inter_act, win, real_edges)
    return _FusedStack.apply(edge_act, inter_act, int(num_segments), x, senders, receivers, mask, win,
                             real_edges, weights, biases)
