"""Fused gather -> edge network -> masked scatter (B8): the CUDA kernel
``fused_conv``, its plain PyTorch version, and the differentiable
``fused_aggregate`` built on it.

Port of the Pallas ``_make_fused_kernel`` in
``hydragnn_tpu/ops/fused_conv.py`` (``fused_conv``). For receivers
sorted ascending:

  out [S, Hout] f32   out[r] = Σ_{e: recv_e = r, mask_e} msg_e

  msg_e = Π_k act_k(x[send_e] @ W_k + b_k + rtab_k[r] + eterm_k[e])
          over 1 or 2 branches (the CGCNN sigmoid·softplus gate), or
        = x[send_e] with no branch (GIN, SAGE, MFC aggregation),
  times ``scale[e]`` when given (the SchNet filter).

Each branch is ``(W [Hin, Hout], b [Hout] | None, rtab [S, Hout] | None,
eterm [E, Hout] | None)``; the absent terms are not added. The mask is
a select, not a product: a masked slot's message never enters a sum, so
an inf or NaN there (a masked run-aligned self-loop at a real node, an
``eterm`` of +inf) cannot reach the output. Rows with no edge are 0.

``fused_conv_plain`` is the reference composition (``_fused_ref``) in
the compute dtype. A CPU tensor takes it; a CUDA tensor launches the
kernel (``csrc/fused_conv.cu``) or raises. The kernel computes each
message in float32 whatever the input type (f32 or bf16) and sums in
float32, so for bf16 inputs it equals the plain version run on their
float32 values. ``real_edges`` (the batch's ``edge_occupancy``, an int32
scalar tensor) bounds the kernel's edge walk: every slot at or past it
must be masked, so the bound changes nothing but the work. ``row_ptr``
is the receivers' CSR row pointers (``row_pointers.py``), which the
chassis builds once per forward; given them, a call is one launch, and
without them the wrapper builds them first. They are checked for shape,
type and device, not for their contents; the plain version does not
read them.

``fused_aggregate`` is the autograd op, with the reference's
``_fused_conv_bwd`` as it stands: it recomputes ``v`` (B3 regather) and
the pre-activations instead of saving [E, ·] residuals, gathers the
cotangent and the receiver tables along the edges (B3), sums the
``rtab`` gradients by receiver (B2), forms ``gW`` and ``gb`` with plain
float32 products, and scatters ``grad_x`` into the senders through their
window plan (B4), or with ``index_add_`` without one (the reference's
XLA scatter-add). ``g_scale`` is taken before the message gradient is
scaled. B2 and B4 stop at ``real_edges`` too: the message gradient is
masked, so every slot past it carries a zero.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Sequence, Tuple

import torch

from hydragnn_tpu_torch.ops._build import (
    FLOAT_CODE,
    LaunchCount,
    bind,
    check_launch,
    cuda_args,
    stream_of,
)
from hydragnn_tpu_torch.ops.gather_rows import gather_rows
from hydragnn_tpu_torch.ops.row_pointers import check_row_ptr, row_pointers
from hydragnn_tpu_torch.ops.segment_sum import segment_sum
from hydragnn_tpu_torch.ops.segment_sum_local import segment_sum_local

SOURCE = "hydragnn_tpu_torch/ops/csrc/fused_conv.cu"
REPLACES = "hydragnn_tpu/ops/fused_conv.py:140"

# launches of the CUDA kernel (never the plain path)
launches = LaunchCount()

_lock = threading.Lock()
_fn = None  # guarded by _lock

Branch = Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor], Optional[torch.Tensor]]


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``logaddexp(x, 0)``, jax.nn.softplus itself (no threshold); its
    autograd derivative is sigmoid(x), 1/2 at 0, where the composed form
    ``max(x, 0) + log1p(exp(-|x|))`` would differentiate to 1."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


# edge-network activations: (f, df) with df taking (pre, f(pre)) — the
# reference's _ACTS; the kernel's codes are the keys' order
ACTS = {
    "none": (lambda x: x, lambda x, a: torch.ones_like(x)),
    "relu": (torch.relu, lambda x, a: (x > 0).to(x.dtype)),
    "sigmoid": (torch.sigmoid, lambda x, a: a * (1.0 - a)),
    "softplus": (_softplus, lambda x, a: torch.sigmoid(x)),
    "tanh": (torch.tanh, lambda x, a: 1.0 - a * a),
    "silu": (
        lambda x: x * torch.sigmoid(x),
        lambda x, a: torch.sigmoid(x) * (1.0 + x * (1.0 - torch.sigmoid(x))),
    ),
}
ACT_CODE = {name: i for i, name in enumerate(ACTS)}


def _kernel():
    global _fn
    with _lock:
        if _fn is None:
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            _fn = bind("fused_conv.cu", "hg_fused_conv", [
                p, i, p, p, p, ll, ll, ll, i, i, i, i, i, p, p, p, p, p, p, p, p,
            ])
        return _fn


def _check(x, senders, receivers, mask, num_segments, branches, acts, scale) -> int:
    """Validate the call; returns Hout."""
    if x.dim() != 2 or senders.dim() != 1 or receivers.shape != senders.shape or mask.shape != senders.shape:
        raise ValueError("fused_conv: x [N, Hin], senders, receivers and mask [E]")
    if mask.dtype != torch.bool:
        raise TypeError(f"fused_conv: mask must be bool, got {mask.dtype}")
    if len(acts) != len(branches):
        raise ValueError(f"fused_conv: {len(branches)} branches but {len(acts)} activations")
    if len(branches) > 2:
        raise ValueError("fused_conv supports at most 2 edge-network branches")
    for name in acts:
        if name not in ACTS:
            raise ValueError(f"unknown fused_conv activation {name!r}")
    if int(num_segments) < 1:
        raise ValueError("fused_conv: num_segments must be >= 1")
    e, hin = senders.shape[0], x.shape[1]
    hout = branches[0][0].shape[1] if branches else hin
    for w, b, rtab, eterm in branches:
        if w.shape != (hin, hout):
            raise ValueError(f"fused_conv: every W must be [{hin}, {hout}], got {tuple(w.shape)}")
        if b is not None and b.shape != (hout,):
            raise ValueError("fused_conv: b must be [Hout]")
        if rtab is not None and rtab.shape != (int(num_segments), hout):
            raise ValueError("fused_conv: rtab must be [num_segments, Hout]")
        if eterm is not None and eterm.shape != (e, hout):
            raise ValueError("fused_conv: eterm must be [E, Hout]")
    if scale is not None and scale.shape != (e, hout):
        raise ValueError(f"fused_conv: scale must be [E, {hout}], got {tuple(scale.shape)}")
    return hout


def _branch_pres(v: torch.Tensor, branches: Sequence[Branch], recv_gather) -> list:
    """Per-branch pre-activations of the edge network, in v's dtype."""
    pres = []
    for w, b, rtab, eterm in branches:
        pre = v @ w.to(v.dtype)
        if b is not None:
            pre = pre + b.to(pre.dtype)
        if rtab is not None:
            pre = pre + recv_gather(rtab.to(pre.dtype))
        if eterm is not None:
            pre = pre + eterm.to(pre.dtype)
        pres.append(pre)
    return pres


def fused_conv_plain(
    x: torch.Tensor,
    senders: torch.Tensor,
    receivers: torch.Tensor,
    mask: torch.Tensor,
    num_segments: int,
    branches: Sequence[Branch] = (),
    acts: Sequence[str] = (),
    scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The reference composition (``_fused_ref``): the messages in the
    compute dtype, selected by the mask, summed by receiver in f32 in
    edge order (``index_add_``)."""
    hout = _check(x, senders, receivers, mask, num_segments, branches, acts, scale)
    recv = receivers.long()
    v = x.index_select(0, senders.long())
    if branches:
        pres = _branch_pres(v, branches, lambda t: t.index_select(0, recv))
        msg = None
        for pre, name in zip(pres, acts):
            a = ACTS[name][0](pre)
            msg = a if msg is None else msg * a
    else:
        msg = v
    if scale is not None:
        msg = msg * scale.to(msg.dtype)
    msg = torch.where(mask[:, None], msg, torch.zeros((), dtype=msg.dtype, device=msg.device)).float()
    out = torch.zeros(int(num_segments), hout, dtype=torch.float32, device=x.device)
    return out.index_add_(0, recv, msg)


def _cat_branches(branches: Sequence[Branch], n_rows: int, n_edges: int):
    """The branches stacked on the output axis for the kernel: W_cat
    [Hin, K·Hout] f32, b_cat [K·Hout] f32, rtab_cat [S, K·Hout] and
    eterm_cat [E, K·Hout] (zeros for the branches without one; None when
    no branch has one) — the reference's ``_cat_branches``."""
    hout = branches[0][0].shape[1]
    like = branches[0][0]
    zeros = lambda rows, dt: torch.zeros(rows, hout, dtype=dt, device=like.device)  # noqa: E731
    w_cat = torch.cat([w.float() for w, _, _, _ in branches], dim=1).contiguous()
    b_cat = torch.cat([
        b.float() if b is not None else torch.zeros(hout, device=like.device) for _, b, _, _ in branches
    ]).contiguous()
    cats = []
    for pos, rows in ((2, n_rows), (3, n_edges)):
        present = [br[pos] for br in branches if br[pos] is not None]
        if not present:
            cats.append(None)
            continue
        dt = present[0].dtype
        cats.append(torch.cat([
            br[pos] if br[pos] is not None else zeros(rows, dt) for br in branches
        ], dim=1).contiguous())
    return w_cat, b_cat, cats[0], cats[1]


def fused_conv(
    x: torch.Tensor,
    senders: torch.Tensor,
    receivers: torch.Tensor,
    mask: torch.Tensor,
    num_segments: int,
    branches: Sequence[Branch] = (),
    acts: Sequence[str] = (),
    scale: Optional[torch.Tensor] = None,
    real_edges: Optional[torch.Tensor] = None,
    row_ptr: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``[num_segments, Hout]`` float32 aggregate of the edge messages
    (module docstring). Not differentiated itself: see
    ``fused_aggregate``."""
    branches = tuple(tuple(br) for br in branches)
    acts = tuple(acts)
    hout = _check(x, senders, receivers, mask, num_segments, branches, acts, scale)
    if x.dtype not in FLOAT_CODE:
        raise TypeError(f"fused_conv: x must be float32 or bfloat16, got {x.dtype}")
    if row_ptr is not None:
        check_row_ptr("fused_conv", row_ptr, num_segments, x.device)
    if x.device.type == "cpu":
        return fused_conv_plain(x, senders, receivers, mask, num_segments, branches, acts, scale)
    s = int(num_segments)
    e, hin = senders.shape[0], x.shape[1]
    w_cat = b_cat = rtab = eterm = None
    if branches:
        w_cat, b_cat, rtab, eterm = _cat_branches(branches, s, e)
    dev = cuda_args("fused_conv", x, senders, receivers, mask, scale, real_edges, w_cat, rtab, eterm)
    if senders.dtype != torch.int32 or receivers.dtype != torch.int32:
        raise TypeError("fused_conv: senders and receivers must be int32 on CUDA")
    for name, t in (("scale", scale), ("rtab", rtab), ("eterm", eterm)):
        if t is not None and t.dtype != x.dtype:
            raise TypeError(f"fused_conv: {name} must have x's dtype {x.dtype} on CUDA, got {t.dtype}")
    if real_edges is not None and (real_edges.dtype != torch.int32 or real_edges.numel() != 1):
        raise TypeError("fused_conv: real_edges must be one int32")
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    if row_ptr is None:
        row_ptr = row_pointers(receivers, s)
    fn = _kernel()
    with torch.cuda.device(dev):
        out = torch.empty(s, hout, dtype=torch.float32, device=dev)
        codes = [ACT_CODE[a] for a in acts] + [0, 0]
        rc = fn(
            x.data_ptr(), FLOAT_CODE[x.dtype], senders.data_ptr(), mask.data_ptr(),
            ptr(real_edges), e, x.shape[0], s, hin, hout, len(branches), codes[0], codes[1],
            ptr(w_cat), ptr(b_cat), ptr(rtab), ptr(eterm), ptr(scale), row_ptr.data_ptr(), out.data_ptr(),
            stream_of(dev),
        )
    check_launch("fused_conv", rc)
    launches.add()
    return out


class _FusedAggregate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, acts, num_segments, x, senders, receivers, mask, win, real_edges, row_ptr, perm, scale, *flat):
        branches = tuple(tuple(flat[i : i + 4]) for i in range(0, len(flat), 4))
        out = fused_conv(x, senders, receivers, mask, num_segments, branches, acts, scale, real_edges, row_ptr)
        ctx.save_for_backward(x, senders, receivers, mask, win, perm, scale, *flat)
        ctx.acts, ctx.real_edges = acts, real_edges
        return out

    @staticmethod
    def backward(ctx, g):
        x, senders, receivers, mask, win, perm, scale, *flat = ctx.saved_tensors
        needs = ctx.needs_input_grad
        need_x, need_scale, need_flat = needs[2], needs[10], needs[11:]
        branches = [tuple(flat[i : i + 4]) for i in range(0, len(flat), 4)]
        dt, n = x.dtype, x.shape[0]

        def egather(t):
            return gather_rows(t.contiguous(), receivers)

        ge = egather(g.to(dt))  # [E, Hout]
        g_msg = ge * mask[:, None].to(dt)
        g_scale = None
        g_flat = [None] * len(flat)
        if branches:
            v = gather_rows(x, senders)
            pres = _branch_pres(v, branches, egather)
            a = [ACTS[name][0](pre) for name, pre in zip(ctx.acts, pres)]
            if scale is not None:
                prod_all = a[0]
                for ak in a[1:]:
                    prod_all = prod_all * ak
                # the scale's gradient comes before the scaling
                g_scale = (g_msg * prod_all).to(scale.dtype) if need_scale else None
                g_msg = g_msg * scale.to(g_msg.dtype)
            grad_v = None
            for k, (w, b, rtab, eterm) in enumerate(branches):
                others = None
                for j, aj in enumerate(a):
                    if j != k:
                        others = aj if others is None else others * aj
                g_pre = g_msg if others is None else g_msg * others
                g_pre = g_pre * ACTS[ctx.acts[k]][1](pres[k], a[k])
                if need_x:
                    term = g_pre @ w.to(g_pre.dtype).T
                    grad_v = term if grad_v is None else grad_v + term
                if need_flat[4 * k]:
                    g_flat[4 * k] = (v.float().T @ g_pre.float()).to(w.dtype)
                if b is not None and need_flat[4 * k + 1]:
                    g_flat[4 * k + 1] = g_pre.float().sum(0).to(b.dtype)
                if rtab is not None and need_flat[4 * k + 2]:
                    g_flat[4 * k + 2] = segment_sum(g_pre.contiguous(), receivers, n,
                                                    real_rows=ctx.real_edges).to(rtab.dtype)
                if eterm is not None and need_flat[4 * k + 3]:
                    g_flat[4 * k + 3] = g_pre.to(eterm.dtype)
        elif scale is not None:
            if need_scale:
                g_scale = (g_msg * gather_rows(x, senders)).to(scale.dtype)
            grad_v = g_msg * scale.to(g_msg.dtype)
        else:
            grad_v = g_msg
        grad_x = None
        if need_x:
            grad_v = grad_v.contiguous()
            if win is not None:
                grad_x = segment_sum_local(grad_v, senders, win, n, real_edges=ctx.real_edges).to(dt)
            elif perm is not None:
                # the permuted pair: the cotangent in sorted-sender order
                # (B3), summed over the sorted senders (B2)
                grad_x = segment_sum(gather_rows(grad_v, perm), senders.index_select(0, perm), n,
                                     real_rows=ctx.real_edges).to(dt)
            else:
                zero = torch.zeros(n, grad_v.shape[1], dtype=torch.float32, device=grad_v.device)
                grad_x = zero.index_add_(0, senders.long(), grad_v.float()).to(dt)
        return (None, None, grad_x, None, None, None, None, None, None, None, g_scale, *g_flat)


def fused_aggregate(
    x: torch.Tensor,
    senders: torch.Tensor,
    receivers: torch.Tensor,
    mask: torch.Tensor,
    num_segments: int,
    branches: Sequence[Branch] = (),
    acts: Sequence[str] = (),
    scale: Optional[torch.Tensor] = None,
    win: Optional[torch.Tensor] = None,
    real_edges: Optional[torch.Tensor] = None,
    row_ptr: Optional[torch.Tensor] = None,
    perm: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Differentiable ``fused_conv`` (module docstring): gradients for
    ``x``, ``scale`` and every branch tensor. ``win`` is the senders'
    window plan for ``grad_x`` (B4); without one, ``perm`` (the senders'
    stable argsort) takes ``grad_x`` through the permuted pair (B3, B2),
    as an edge shard does (``parallel/edge_sharded.py``), and without
    either through ``index_add_``. ``row_ptr`` is the receivers' row
    pointers; the result is float32."""
    flat = [t for br in branches for t in tuple(br)]
    if any(len(tuple(br)) != 4 for br in branches):
        raise ValueError("fused_aggregate: each branch is (W, b, rtab, eterm)")
    return _FusedAggregate.apply(
        tuple(acts), int(num_segments), x, senders, receivers, mask, win, real_edges, row_ptr, perm, scale, *flat
    )
