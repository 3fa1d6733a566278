"""The training path's CUDA kernels (B1 and its backward kernel, B2–B4,
B6–B9) against their plain PyTorch versions, and the autograd ops of B1,
B8, B9 and of ``pna_aggregate`` (B5 forward, B6 and B7 backward) on the
card against the CPU. Every test here
needs a card and skips without one; this file imports no JAX, so it runs
on the card machine:
``python -m pytest tests/test_torch_cuda_kernels.py -m cuda --noconftest``.

Tolerances: B2's sums ``rtol=1e-6, atol=1e-6`` (the inputs are on a 1/4
grid, so every order sums them exactly and the kernel matches bit for
bit in practice); gathers and maxima bit-equal; two launches bitwise
equal (no atomics). B1 adds each K-group in slot order, as its plain
version does, and its backward kernel follows the plain chain op for
op: both bit-equal, f32 and bf16, on normal values too, and so is the
autograd op's table gradient on the card against the CPU. B8's branch variants ``rtol=atol=1e-5``: each edge's
pre-activation is a dot product taken in another order than the host's
matrix product, and expf/log1pf on the card round differently from the
host's. Its backward on the card against the CPU: each gradient within
a relative L2 norm of 1e-5 (the weight gradients are sums over every
edge, taken by cuBLAS on one side and the host's BLAS on the other, so
entries near 0 carry the rounding of the large ones). B6's tie counts
exact; B7 bit-equal to its plain version in f32 and within
``rtol=atol=2e-2`` in bf16 (the plain version combines in bf16 op by op,
as the JAX package's unfused backward does; the kernel in f32, rounding
once, as its Pallas kernel does). B9 equal to the loop of B8 launches it
replaces, value for value, at H 1 to 256, every edge activation, 1 and 6
layers, and against the exact result (its function in float64 on the
host) within 1e-5 of the output's largest magnitude plus twice the f32
plain version's own distance from that result (``_check_stack``: each
layer's product sums in another order than the host's BLAS, and over 6
tanh layers f32 itself is off by more than 1e-5 of the scale on these
inputs).

B4 and B8's identity and scale variants sum each output element in edge
order, as ``index_add_`` does on the host, so they must equal their plain
versions bit for bit on random normal inputs too, in f32 and on bf16
inputs (the plain version on their f32 values), on the edge cases of
``b4_edge_case`` and ``b8_edge_case``: overlapping windows, an empty
block, a row with 20,000 edges; 50,000 masked slots in one row, the
occupancy bound below E, out-of-range senders, inputs at an odd offset.
``tests/test_torch_segment_ops.py`` and ``tests/test_torch_fused_conv.py``
hold the same inputs' plain versions to the JAX package.

B2 (redesigned for Hopper) also sums each element in edge order: on
``b2_tail_case`` (a 60,000-slot hub row, a masked tail of 30,000 slots
at the padding row, empty rows, out-of-range ids) it equals its plain
version bit for bit, f32 and bf16, with the batch's occupancy bound and
without it, in a CUDA graph too; B4 with a bound that falls inside its
windows equals its plain version with that bound.

B6 and B7 (redesigned for Hopper: B6's long rows split over CTAs whose
integer counts meet by atomicAdd, exact in any order; B7 edge-parallel)
on ``b67_case`` (a 60,000-slot hub row, empty and all-masked rows, a
masked tail of 30,000 slots at the padding row, receivers outside
[0, N) at both ends): B6's counts and f32 B7 bit-equal to their plain
versions, bf16 B7 within ``rtol=atol=2e-2`` as above, with the
occupancy bound and without it, at H 1, 3, 32 and 128; two launches
bitwise equal; a CUDA graph replayed with the bound moved into the hub
row gives the plain versions' result with that bound. B5 with the bound
is bit-equal to B5 without it on the same tail.
"""

import importlib

import numpy as np
import pytest
import torch

from hydragnn_tpu_torch.graph.batch import batch_graphs
from hydragnn_tpu_torch.ops import gather_rows as gr_mod
from hydragnn_tpu_torch.ops import gather_stats as gs_mod
from hydragnn_tpu_torch.ops import row_pointers as rp_mod
from hydragnn_tpu_torch.ops import segment_sum as ss_mod
from hydragnn_tpu_torch.ops import segment_sum_local as sl_mod
from hydragnn_tpu_torch.ops.gather_stats import gather_stats, gather_stats_plain
from hydragnn_tpu_torch.ops.row_pointers import row_pointers

SUM_TOL = dict(rtol=1e-6, atol=1e-6)
GATE_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_REL_L2 = 1e-5
K = 8


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _aligned_batch(seed, k=K):
    rng = np.random.default_rng(seed)
    graphs = []
    for _ in range(40):
        n = int(rng.integers(4, 30))
        e = int(rng.integers(10, 200))
        s, r = rng.integers(0, n, e), rng.integers(0, n, e)
        order = np.lexsort((s, r))
        graphs.append({"x": np.zeros((n, 1), np.float32), "senders": s[order], "receivers": r[order]})
    b = batch_graphs(graphs, n_node_pad=1200, n_edge_pad=12000, n_graph_pad=41, run_align=k, win_block_rows=128)
    mask = b.edge_mask.clone()
    mask[8:16] = False  # whole K-groups masked
    return b, mask


def _grid(shape, seed, dtype):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((np.round(rng.normal(size=shape) * 4.0) / 4.0 + 0.0).astype(np.float32)).to(dtype)


def _bits(t):
    """The raw bits of a float tensor (so -0.0 differs from 0.0)."""
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t.view(torch.int32)


def _values(shape, rng, values):
    """numpy f32: "grid" on the 1/4 grid (every order sums exactly),
    "normal" standard normal (only the same order sums alike)."""
    v = rng.normal(size=shape)
    return ((np.round(v * 4.0) / 4.0 + 0.0) if values == "grid" else v).astype(np.float32)


def b4_edge_case(h, seed, values="normal"):
    """B4's edge cases as numpy: (data [E, h] f32, ids [E] int32, win
    [2, 5] int32, num_segments 300). Five blocks of 64 rows; block 2 has
    no edge (an empty window); row 70 has 20,000 edges; neighbouring
    blocks' edges interleave, so windows overlap and hold other blocks'
    ids; blocks 0 and 3 get windows widened by 50 positions both ways."""
    from hydragnn_tpu_torch.graph.batch import _block_windows

    rng = np.random.default_rng(seed)
    n, b = 300, 64
    ids = [np.full(20_000, 70)]
    for blk in (0, 1, 3, 4):
        rows = np.arange(blk * b, min(n, (blk + 1) * b))
        ids.append(rng.choice(rows, size=int(rng.integers(300, 700))))
    ids = np.concatenate(ids)
    key = ids // b + rng.uniform(0.0, 1.5, ids.size)  # neighbouring blocks interleave
    ids = ids[np.argsort(key, kind="stable")].astype(np.int32)
    win = _block_windows(ids, np.argsort(ids, kind="stable"), n, b).astype(np.int64)
    assert win.shape == (2, 5) and win[0, 2] == win[1, 2]
    for blk in (0, 3):
        win[:, blk] = np.clip(win[:, blk] + [-50, 50], 0, ids.size)
    return _values((ids.size, h), rng, values), ids, win.astype(np.int32), n


def b8_edge_case(h, seed, values="normal", with_scale=False):
    """B8 (K = 0) edge cases as numpy: (x [n, h], senders, receivers
    (sorted), mask, num_segments, real_edges, scale [E, h] or None,
    clean_mask, clean_senders). Row 7 holds 3 real slots, 50,000 masked
    ones and 2 more real slots; other rows 0-12 slots, about a quarter
    masked; two real slots carry senders out of range (n + 5 and -1),
    which the kernel drops; 300 masked slots at the padding row past the
    occupancy bound. ``clean_*``: the same edges with the dropped ones
    masked and their senders set to 0, for the plain version and JAX,
    which would index out of range."""
    rng = np.random.default_rng(seed)
    n = 1_500
    recv, mask = [], []
    for r in range(n - 1):
        if r == 7:
            k = 50_005
            m = np.zeros(k, bool)
            m[[0, 1, 2, k - 2, k - 1]] = True
        else:
            k = int(rng.integers(0, 13))
            m = rng.random(k) > 0.25
        recv.append(np.full(k, r))
        mask.append(m)
    real_edges = sum(len(r) for r in recv)
    recv.append(np.full(300, n - 1))
    mask.append(np.zeros(300, bool))
    recv, mask = np.concatenate(recv).astype(np.int32), np.concatenate(mask)
    send = rng.integers(0, n - 1, recv.size).astype(np.int32)
    real = np.flatnonzero(mask)
    send[real[len(real) // 3]] = n + 5
    send[real[2 * len(real) // 3]] = -1
    clean = mask & (send >= 0) & (send < n)
    clean_send = np.where(clean, send, 0).astype(np.int32)
    x = _values((n, h), rng, values)
    scale = _values((recv.size, h), rng, values) if with_scale else None
    return x, send, recv, mask, n, real_edges, scale, clean, clean_send


def _at_odd_offset(t, dev):
    """``t`` copied to the card one element past an allocation's start
    (a contiguous view whose address is only element-aligned)."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
    return flat[1:].view(t.shape).copy_(t)


def _b1_case(h, dtype, k, dev):
    """B1's forward (``gather_stats``) and backward kernel
    (``gather_presum_bwd``) against their plain versions on the host, bit
    for bit: the run-aligned batch (K = ``k``) with whole K-groups
    masked, the table on the 1/4 grid (ties) and normal, each on a fresh
    allocation and at an odd offset with the cotangents there too; two
    launches bitwise equal; one count per launch."""
    b, mask = _aligned_batch(h + k, k=k)
    n, e = b.num_nodes, b.num_edges
    rng = np.random.default_rng(h + 100 * k)
    ids, m = b.senders.to(dev), mask.to(dev)
    for values in ("grid", "normal"):
        table = torch.from_numpy(_values((n, h), rng, values)).to(dtype)
        g_stats = torch.from_numpy(_values((e // k, 2 * h), rng, "normal"))
        g_both = torch.from_numpy(_values((e // k, 2 * h), rng, "normal")).to(dtype)
        ref = gather_stats_plain(table, b.senders, mask, k)
        ref_g = gs_mod.gather_presum_bwd_plain(table, b.senders, mask, ref[1], g_stats, g_both, k)
        if values == "grid":  # ties in some group, and a group all masked
            v = table.float()[b.senders.long()].view(-1, k, h)
            assert ((v == v.amax(1, keepdim=True)) & mask.view(-1, k, 1)).sum(1).max() > 1
            assert bool((ref[1][(~mask).view(-1, k).all(1)] == torch.finfo(dtype).min).all())
        for place in (lambda t: t.to(dev), lambda t: _at_odd_offset(t, dev)):
            t_d, gs_d, gb_d = place(table), place(g_stats), place(g_both)
            f0, b0 = gs_mod.launches.value, gs_mod.bwd_launches.value
            outs = [gather_stats(t_d, ids, m, k) for _ in range(2)]
            grads = [gs_mod.gather_presum_bwd(t_d, ids, m, outs[0][1], gs_d, gb_d, k) for _ in range(2)]
            torch.cuda.synchronize()
            assert (gs_mod.launches.value - f0, gs_mod.bwd_launches.value - b0) == (2, 2)
            for out in outs:
                for a, r in zip(out, ref):
                    assert torch.equal(_bits(a.cpu()), _bits(r)), f"gather_stats {values}"
            for gv in grads:
                assert torch.equal(_bits(gv.cpu()), _bits(ref_g)), f"gather_presum_bwd {values}"


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["grid", "normal", "edges", "b1_k8", "b1_k4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h", [1, 3, 126, 128, 256])
def test_cuda_kernels_match_plain(h, dtype, case):
    """B1-B4 on the run-aligned batch's 1/4 grid ("grid"); B4 alone on
    random normal data ("normal") and on ``b4_edge_case`` with the data
    at an odd offset ("edges"), where it must equal its plain version bit
    for bit; B1's forward and backward kernels bit-equal to their plain
    versions at K = 8 and 4 (``_b1_case``)."""
    dev = _cuda()

    def on_card(*ts):
        return [t.to(dev) for t in ts]

    if case.startswith("b1_"):
        _b1_case(h, dtype, int(case[4:]), dev)
        return
    if case == "edges":
        data_np, ids_np, win_np, n = b4_edge_case(h, h)
        data, ids, win = torch.from_numpy(data_np).to(dtype), torch.from_numpy(ids_np), torch.from_numpy(win_np)
        cases = [("segment_sum_local",
                  lambda d: sl_mod.segment_sum_local(_at_odd_offset(data, dev), *d(ids, win), n),
                  sl_mod.segment_sum_local_plain(data, ids, n))]
    else:
        b, mask = _aligned_batch(h)
        n, e = b.num_nodes, b.num_edges
        send, recv8, win = b.senders, b.receivers[::K].contiguous(), b.sender_win
        if case == "normal":
            data = torch.from_numpy(_values((e, h), np.random.default_rng(h), "normal")).to(dtype)
            cases = []
        else:
            table = _grid((n, h), h, dtype)
            data = _grid((e, h), h + 1, dtype)
            stats8 = _grid((e // K, 2 * h), h + 2, torch.float32)
            cases = [
                ("gather_stats", lambda d: gather_stats(*d(table, send, mask), K),
                 gather_stats_plain(table, send, mask, K)),
                ("segment_sum", lambda d: ss_mod.segment_sum(*d(stats8, recv8), n),
                 ss_mod.segment_sum_plain(stats8, recv8, n)),
                ("gather_rows", lambda d: gr_mod.gather_rows(*d(table, send)), gr_mod.gather_rows_plain(table, send)),
            ]
        cases.append(("segment_sum_local", lambda d: sl_mod.segment_sum_local(*d(data, send, win), n),
                      sl_mod.segment_sum_local_plain(data, send, n)))

    for name, run, ref in cases:
        ref = ref if isinstance(ref, tuple) else (ref,)
        before = sl_mod.launches.value
        out1, out2 = run(on_card), run(on_card)
        torch.cuda.synchronize()
        if name == "segment_sum_local":
            assert sl_mod.launches.value == before + 2
        out1 = out1 if isinstance(out1, tuple) else (out1,)
        out2 = out2 if isinstance(out2, tuple) else (out2,)
        for a, c, r in zip(out1, out2, ref):
            assert torch.equal(a, c), name
            if r.dtype == torch.float32 and name == "segment_sum":
                np.testing.assert_allclose(a.cpu().numpy(), r.numpy(), err_msg=name, **SUM_TOL)
            else:
                assert torch.equal(_bits(a.cpu()), _bits(r)), name


@pytest.mark.cuda
@pytest.mark.parametrize("k", [8, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_gather_presum_backward_matches_cpu(dtype, k):
    """The autograd ``gather_presum_stats`` on the card (B1, then its
    backward kernel and B4; no regather by B3) against the same op on the
    CPU: the outputs and the table's gradient bit for bit."""
    dev = _cuda()
    b, mask = _aligned_batch(70 + k, k=k)
    h = 128
    rng = np.random.default_rng(k)
    table = _grid((b.num_nodes, h), 71 + k, dtype)
    cots = (torch.from_numpy(_values((b.num_edges // k, 2 * h), rng, "normal")),
            torch.from_numpy(_values((b.num_edges // k, 2 * h), rng, "normal")).to(dtype))
    res = {}
    for where in ("cpu", "cuda"):
        d = torch.device(where) if where == "cpu" else dev
        t = table.detach().to(d).requires_grad_(True)  # detach: on the CPU .to() returns table itself
        b3, bw = gr_mod.launches.value, gs_mod.bwd_launches.value
        out = gs_mod.gather_presum_stats(t, b.senders.to(d), mask.to(d), b.sender_win.to(d), b.num_nodes, k)
        torch.autograd.backward(out, tuple(c.to(d) for c in cots))
        res[where] = [o.detach().cpu() for o in out] + [t.grad.cpu()]
        if where == "cuda":
            assert (gr_mod.launches.value - b3, gs_mod.bwd_launches.value - bw) == (0, 1)
    for a, r in zip(res["cuda"], res["cpu"]):
        assert torch.equal(_bits(a), _bits(r))


@pytest.mark.cuda
@pytest.mark.parametrize("h", [1, 128])
def test_cuda_gather_stats_out_of_range_ids(h):
    """An unmasked slot whose id is out of range (N + 5, -1) reads
    nothing and counts as masked: the forward equals the plain version
    with those slots masked, and the backward writes +0 there."""
    dev = _cuda()
    b, mask = _aligned_batch(80 + h)
    n = b.num_nodes
    live = torch.nonzero(mask).view(-1)
    bad = live[torch.tensor([3, len(live) // 2])]
    ids = b.senders.clone()
    ids[bad[0]], ids[bad[1]] = n + 5, -1
    clean_mask, clean_ids = mask.clone(), ids.clone()
    clean_mask[bad], clean_ids[bad] = False, 0
    rng = np.random.default_rng(h)
    table = _grid((n, h), 81 + h, torch.float32)
    g_stats = torch.from_numpy(_values((b.num_edges // K, 2 * h), rng, "normal"))
    g_both = torch.from_numpy(_values((b.num_edges // K, 2 * h), rng, "normal"))
    ref = gather_stats_plain(table, clean_ids, clean_mask, K)
    ref_g = gs_mod.gather_presum_bwd_plain(table, clean_ids, clean_mask, ref[1], g_stats, g_both, K)
    d = [t.to(dev) for t in (table, ids, mask)]
    out = gather_stats(*d, K)
    grad_v = gs_mod.gather_presum_bwd(*d, out[1], g_stats.to(dev), g_both.to(dev), K)
    torch.cuda.synchronize()
    for a, r in zip(out, ref):
        assert torch.equal(_bits(a.cpu()), _bits(r))
    assert torch.equal(_bits(grad_v.cpu()), _bits(ref_g))
    assert torch.equal(_bits(grad_v.cpu()[bad]), torch.zeros(2, h, dtype=torch.int32))


def _pna_case(h, dtype, seed, n=400, e=6000):
    """Sorted receivers with empty rows (odd ids), two all-masked rows, a
    padding row whose masked edges carry v = 0 (its cleaned max), random
    masked edges, values and cotangents on the 1/4 grid (ties)."""
    rng = np.random.default_rng(seed)
    recv = np.sort(rng.choice(np.arange(0, n, 2), size=e)).astype(np.int32)
    v = _grid((e, h), seed, dtype)
    mask = rng.random(e) > 0.25
    for dead in (4, 10, n - 2):
        mask[recv == dead] = False
    v[torch.from_numpy(recv == n - 2)] = 0.0
    cots = (_grid((n, h), seed + 1, torch.float32), _grid((n, h), seed + 2, torch.float32),
            _grid((n, 2 * h), seed + 3, dtype))
    return v, torch.from_numpy(recv), n, torch.from_numpy(mask), cots


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h", [1, 5, 128])
def test_cuda_pna_bwd_kernels_match_plain(h, dtype):
    """B6 counts exact; B7 bit-equal to the plain version in f32 and
    within bf16 rounding (rtol=atol=2e-2) in bf16, where the plain version
    combines in bf16 and the kernel in f32; two launches bitwise equal;
    one launch counted per call."""
    dev = _cuda()
    from hydragnn_tpu_torch.ops import pna_aggregate_bwd as bwd
    from hydragnn_tpu_torch.ops.pna_aggregate import pna_aggregate_plain

    v, recv, n, mask, (g_sum, g_sumsq, g_both) = _pna_case(h, dtype, 50 + h)
    both = pna_aggregate_plain(v, recv, n, mask)[3]
    cnt_ref = bwd.pna_bwd_count_plain(v, recv, mask, both, n)
    grad_ref = bwd.pna_bwd_grad_plain(v, recv, mask, both, g_sum, g_sumsq, g_both, cnt_ref)
    d = [t.to(dev) for t in (v, recv, mask, both, g_sum, g_sumsq, g_both)]
    c0, g0 = bwd.count_launches.value, bwd.grad_launches.value
    ptr = row_pointers(d[1], n)
    cnt1, cnt2 = (bwd.pna_bwd_count(d[0], d[1], d[2], d[3], n, ptr) for _ in range(2))
    grad1 = bwd.pna_bwd_grad(*d, cnt1)
    grad2 = bwd.pna_bwd_grad(*d, cnt1)
    torch.cuda.synchronize()
    assert (bwd.count_launches.value - c0, bwd.grad_launches.value - g0) == (2, 2)
    assert torch.equal(cnt1, cnt2) and torch.equal(grad1, grad2)
    assert torch.equal(cnt1.cpu(), cnt_ref) and float(cnt_ref.max()) >= 2
    if dtype == torch.float32:
        assert torch.equal(grad1.cpu(), grad_ref)
    else:
        np.testing.assert_allclose(grad1.cpu().float().numpy(), grad_ref.float().numpy(), rtol=2e-2, atol=2e-2)
    assert (grad1.cpu()[~mask] == 0).all()


@pytest.mark.cuda
def test_cuda_pna_aggregate_backward_matches_cpu():
    """The autograd ``pna_aggregate`` on the card (B5, then B6 and B7)
    against the same op on the CPU (plain versions), f32: bit-equal; the
    row pointers B5 walks and hands B6 and B7 equal ``row_pointers``'
    on the host."""
    dev = _cuda()
    from hydragnn_tpu_torch.ops import pna_aggregate_bwd as bwd
    from hydragnn_tpu_torch.ops.pna_aggregate import pna_aggregate

    v, recv, n, mask, cots = _pna_case(128, torch.float32, 7)
    grads = {}
    for where in ("cpu", dev):
        vt = v.detach().to(where).requires_grad_(True)  # on the CPU .to() returns v itself
        s, sq, _, both = pna_aggregate(vt, recv.to(where), n, mask.to(where))
        torch.autograd.backward((s, sq, both), tuple(c.to(where) for c in cots))
        grads[str(where)] = vt.grad.cpu()
    assert torch.equal(grads["cpu"], grads[str(dev)])
    assert bwd.count_launches.value >= 1 and bwd.grad_launches.value >= 1
    # the row pointers the forward kernel built, which B6 and B7 walk
    from hydragnn_tpu_torch.ops.pna_aggregate import _forward

    recv_d = recv.to(dev)
    assert torch.equal(_forward(v.to(dev), recv_d, n, mask.to(dev), None, None)[4].cpu(), row_pointers(recv, n))


def b5_edge_case(h, seed, values="normal"):
    """B5's edge cases as numpy: (v [E, h] f32, receivers (sorted), mask,
    num_segments). 400 rows: the odd ones empty; rows 4 and 10 all
    masked; row 9 of 60,000 slots, 5 of them real (the first three and
    the last two); the padding row n - 2, all masked, with v = 0 there;
    other rows 0-40 slots, about a quarter masked."""
    rng = np.random.default_rng(seed)
    n = 400
    counts = np.where(np.arange(n) % 2 == 1, 0, rng.integers(0, 41, n))
    counts[9] = 60_000
    recv = np.repeat(np.arange(n), counts).astype(np.int32)
    mask = rng.random(recv.size) > 0.25
    row9 = np.flatnonzero(recv == 9)
    mask[row9] = False
    mask[row9[[0, 1, 2, -2, -1]]] = True
    for dead in (4, 10, n - 2):
        mask[recv == dead] = False
    v = _values((recv.size, h), rng, values)
    v[recv == n - 2] = 0.0
    return v, recv, mask, n


def _graph_replay(fn):
    """``fn()``'s outputs from one capture into a CUDA graph, replayed
    twice (the outputs are the graph's own tensors)."""
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = fn()
    g.replay()
    g.replay()
    torch.cuda.synchronize()
    return out


def b2_tail_case(w, seed, values="normal"):
    """B2's edge cases as numpy: (data [E, w] f32, ids (sorted), mask,
    num_segments, occupancy). 500 rows: the odd ones empty; row 9 of
    60,000 real slots (a hub, no mask); rows 0-40 slots otherwise, about
    a quarter masked; ids -1 and 500 (out of range) at the two ends; then
    the padding row 498's masked tail of 30,000 slots past the occupancy,
    with data 0 there, as a batch's masked tail is."""
    rng = np.random.default_rng(seed)
    n = 500
    counts = np.where(np.arange(n) % 2 == 1, 0, rng.integers(0, 41, n))
    counts[9] = 60_000
    counts[n - 2] = 0
    ids = np.concatenate([[-1, -1], np.repeat(np.arange(n), counts), [n, n]]).astype(np.int32)
    occ = ids.size
    ids = np.concatenate([ids[:-2], np.full(30_000, n - 2), [n, n]]).astype(np.int32)
    mask = rng.random(ids.size) > 0.25
    mask[ids == 9] = True
    mask[occ - 2:] = False
    data = _values((ids.size, w), rng, values)
    data[occ - 2:] = 0.0
    return data, ids, mask, n, occ - 2


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("w", [1, 2, 3, 31, 32, 128, 256])
def test_cuda_segment_sum_tail_hub_and_bound(w, dtype, masked):
    """B2 on ``b2_tail_case``, data on a fresh allocation and at an odd
    offset: with the occupancy bound and without it (the whole tail
    walked by the CTA's ring), bit-equal to the plain version on the host
    (both sum each element in edge order in f32); NaN written past the
    bound changes nothing; a bound of 0 gives zeros; two launches
    bitwise equal; the 60,000-slot row is summed."""
    dev = _cuda()
    data_np, ids_np, mask_np, n, occ = b2_tail_case(w, 70 + w)
    data, ids = torch.from_numpy(data_np).to(dtype), torch.from_numpy(ids_np)
    mask = torch.from_numpy(mask_np) if masked else None
    ref = ss_mod.segment_sum_plain(data, ids, n, mask)
    bound = torch.tensor(occ, dtype=torch.int32)
    assert torch.equal(_bits(ss_mod.segment_sum_plain(data, ids, n, mask, real_rows=bound)), _bits(ref))
    poisoned = data.clone()
    poisoned[occ:] = float("nan")
    ids_d, mask_d, bound_d = ids.to(dev), None if mask is None else mask.to(dev), bound.to(dev)
    for place in (lambda t: t.to(dev), lambda t: _at_odd_offset(t, dev)):
        d, p = place(data), place(poisoned)
        before = ss_mod.launches.value
        outs = [ss_mod.segment_sum(d, ids_d, n, mask_d, real_rows=bound_d) for _ in range(2)]
        outs += [ss_mod.segment_sum(d, ids_d, n, mask_d), ss_mod.segment_sum(p, ids_d, n, mask_d, real_rows=bound_d)]
        zero = ss_mod.segment_sum(d, ids_d, n, mask_d, real_rows=torch.zeros((), dtype=torch.int32, device=dev))
        torch.cuda.synchronize()
        assert ss_mod.launches.value == before + 5
        for out in outs:
            assert torch.equal(_bits(out.cpu()), _bits(ref)), f"w={w} {dtype}"
        assert not bool(zero.any())
    assert bool(ref[9].any()) and not bool(ref[n - 2].any())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("w", [2, 256])
def test_cuda_segment_sum_graph_replay(w, dtype):
    """B2 captured in a CUDA graph with the bound as a device scalar:
    the replays equal the eager call; changing the bound's value between
    replays changes the walk (the kernel reads it on the device)."""
    dev = _cuda()
    data_np, ids_np, mask_np, n, occ = b2_tail_case(w, 90 + w)
    data, ids, mask = (torch.from_numpy(a).to(dev) for a in (data_np, ids_np, mask_np))
    data = data.to(dtype)
    bound = torch.tensor(occ, dtype=torch.int32, device=dev)
    eager = ss_mod.segment_sum(data, ids, n, mask, real_rows=bound)
    out = _graph_replay(lambda: ss_mod.segment_sum(data, ids, n, mask, real_rows=bound))
    assert torch.equal(_bits(out), _bits(eager))
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = ss_mod.segment_sum(data, ids, n, mask, real_rows=bound)
    bound.fill_(1000)
    g.replay()
    torch.cuda.synchronize()
    want = ss_mod.segment_sum_plain(data.cpu(), ids.cpu(), n, mask.cpu(), real_rows=bound.cpu())
    assert torch.equal(_bits(out.cpu()), _bits(want))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h", [1, 3, 128])
def test_cuda_segment_sum_local_bound_inside_a_window(h, dtype):
    """B4 on ``b4_edge_case`` with bounds that fall inside windows (block
    0's, the 20,000-edge row's, an overlapping one's) and with NaN past
    them: bit-equal to the plain version with the same bound; in a CUDA
    graph too."""
    dev = _cuda()
    data_np, ids_np, win_np, n = b4_edge_case(h, 50 + h)
    data, ids, win = torch.from_numpy(data_np).to(dtype), torch.from_numpy(ids_np), torch.from_numpy(win_np)
    ids_d, win_d = ids.to(dev), win.to(dev)
    row70 = np.flatnonzero(ids_np == 70)
    for r in ((win_np[0, 0] + win_np[1, 0]) // 2, int(row70[len(row70) // 2]), int(win_np[1, 3]) - 7, 0):
        bound = torch.tensor(int(r), dtype=torch.int32)
        ref = sl_mod.segment_sum_local_plain(data, ids, n, bound)
        poisoned = data.clone()
        poisoned[int(r):] = float("nan")
        d, p, b = data.to(dev), _at_odd_offset(poisoned, dev), bound.to(dev)
        before = sl_mod.launches.value
        outs = [sl_mod.segment_sum_local(d, ids_d, win_d, n, real_edges=b),
                sl_mod.segment_sum_local(p, ids_d, win_d, n, real_edges=b),
                _graph_replay(lambda: sl_mod.segment_sum_local(d, ids_d, win_d, n, real_edges=b))]
        torch.cuda.synchronize()
        assert sl_mod.launches.value == before + 3
        for out in outs:
            assert torch.equal(_bits(out.cpu()), _bits(ref)), f"bound {r}"


def b67_case(h, seed):
    """B6 and B7's edge cases as numpy: (v [E, h] f32 on the 1/4 grid,
    receivers (sorted), mask, num_segments, occupancy). 500 rows: the
    odd ones empty; rows 4 and 10 all masked; row 9 of 60,000 slots, a
    quarter of them masked; rows 0-40 slots otherwise, about a quarter
    masked; ids -1 (three unmasked slots) before them; then the padding
    row 498's masked tail of 30,000 slots with v = 0 past the occupancy,
    and ids 500 (out of range, unmasked) after it."""
    rng = np.random.default_rng(seed)
    n = 500
    counts = np.where(np.arange(n) % 2 == 1, 0, rng.integers(0, 41, n))
    counts[9] = 60_000
    counts[n - 2] = 0
    recv = np.concatenate([[-1, -1, -1], np.repeat(np.arange(n), counts)])
    occ = recv.size
    recv = np.concatenate([recv, np.full(30_000, n - 2), [n, n]]).astype(np.int32)
    mask = rng.random(recv.size) > 0.25
    mask[:3] = True
    for dead in (4, 10):
        mask[recv == dead] = False
    mask[occ:] = False
    mask[-2:] = True
    v = _values((recv.size, h), rng, "grid")
    v[occ:-2] = 0.0
    return v, recv, mask, n, occ


def _b67_inputs(h, dtype, seed):
    """``b67_case`` as tensors with the forward's maxima over the edges
    that take part and the backward's cotangents (on the 1/4 grid)."""
    from hydragnn_tpu_torch.ops.pna_aggregate import pna_aggregate_plain

    v_np, recv_np, mask_np, n, occ = b67_case(h, seed)
    v, recv, mask = torch.from_numpy(v_np).to(dtype), torch.from_numpy(recv_np), torch.from_numpy(mask_np)
    keep = (recv >= 0) & (recv < n)
    both = pna_aggregate_plain(v[keep], recv[keep], n, mask[keep])[3]
    cots = (_grid((n, h), seed + 1, torch.float32), _grid((n, h), seed + 2, torch.float32),
            _grid((n, 2 * h), seed + 3, dtype))
    return v, recv, mask, n, occ, both, cots


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h", [1, 3, 32, 128])
def test_cuda_pna_bwd_tail_hub_and_bound(h, dtype):
    """B6 and B7 on ``b67_case``, v on a fresh allocation and at an odd
    offset: with the occupancy bound and without it, equal to the plain
    versions (counts exact; B7 bit-equal in f32, within bf16 rounding in
    bf16); two launches bitwise equal; one launch counted per call; the
    hub's ties counted, the tail's and the out-of-range edges' gradient
    exact zeros."""
    from hydragnn_tpu_torch.ops import pna_aggregate_bwd as bwd

    dev = _cuda()
    v, recv, mask, n, occ, both, (g_sum, g_sumsq, g_both) = _b67_inputs(h, dtype, 80 + h)
    bound = torch.tensor(occ, dtype=torch.int32)
    cnt_ref = bwd.pna_bwd_count_plain(v, recv, mask, both, n)
    assert torch.equal(bwd.pna_bwd_count_plain(v, recv, mask, both, n, bound), cnt_ref)
    grad_ref = bwd.pna_bwd_grad_plain(v, recv, mask, both, g_sum, g_sumsq, g_both, cnt_ref)
    assert torch.equal(_bits(bwd.pna_bwd_grad_plain(v, recv, mask, both, g_sum, g_sumsq, g_both, cnt_ref, bound)),
                       _bits(grad_ref))
    assert float(cnt_ref.max()) >= 2 and float(cnt_ref[9].min()) >= 1 and not bool(cnt_ref[4].any())
    recv_d, mask_d, both_d, bound_d = recv.to(dev), mask.to(dev), both.to(dev), bound.to(dev)
    g_d = (g_sum.to(dev), g_sumsq.to(dev), g_both.to(dev))
    ptr = row_pointers(recv_d, n)
    for place in (lambda t: t.to(dev), lambda t: _at_odd_offset(t, dev)):
        v_d = place(v)
        c0, k0 = bwd.count_launches.value, bwd.grad_launches.value
        cnts = [bwd.pna_bwd_count(v_d, recv_d, mask_d, both_d, n, ptr, real_edges=bound_d) for _ in range(2)]
        cnts.append(bwd.pna_bwd_count(v_d, recv_d, mask_d, both_d, n, ptr))
        grads = [bwd.pna_bwd_grad(v_d, recv_d, mask_d, both_d, *g_d, cnts[0], real_edges=bound_d) for _ in range(2)]
        grads.append(bwd.pna_bwd_grad(v_d, recv_d, mask_d, both_d, *g_d, cnts[0]))
        torch.cuda.synchronize()
        assert (bwd.count_launches.value - c0, bwd.grad_launches.value - k0) == (3, 3)
        for cnt in cnts:
            assert torch.equal(_bits(cnt.cpu()), _bits(cnt_ref)), f"h={h} {dtype}"
        for grad in grads:
            assert torch.equal(_bits(grad), _bits(grads[0]))
        got = grads[0].cpu()
        if dtype == torch.float32:
            assert torch.equal(_bits(got), _bits(grad_ref)), f"h={h}"
        else:
            np.testing.assert_allclose(got.float().numpy(), grad_ref.float().numpy(), rtol=2e-2, atol=2e-2)
        dead = ~mask | (recv < 0) | (recv >= n)
        dead[occ:] = True
        assert not bool(got[dead].any()) and not bool(torch.signbit(got[dead].float()).any())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h", [1, 128])
def test_cuda_pna_bwd_graph_replay_with_the_bound_changed(h, dtype):
    """B6 and B7 captured in one CUDA graph with the bound as a device
    scalar: the replay equals the eager calls, and with the bound moved
    into the hub row (so the hub's walk is cut, still longer than one
    CTA's share) the replay equals the plain versions with that bound."""
    from hydragnn_tpu_torch.ops import pna_aggregate_bwd as bwd

    dev = _cuda()
    v, recv, mask, n, occ, both, cots = _b67_inputs(h, dtype, 90 + h)
    v_d, recv_d, mask_d, both_d = v.to(dev), recv.to(dev), mask.to(dev), both.to(dev)
    g_d = tuple(c.to(dev) for c in cots)
    ptr = row_pointers(recv_d, n)
    bound = torch.tensor(occ, dtype=torch.int32, device=dev)

    def calls():
        cnt = bwd.pna_bwd_count(v_d, recv_d, mask_d, both_d, n, ptr, real_edges=bound)
        return cnt, bwd.pna_bwd_grad(v_d, recv_d, mask_d, both_d, *g_d, cnt, real_edges=bound)

    eager = [t.clone() for t in calls()]
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = calls()
    g.replay()
    torch.cuda.synchronize()
    for a, b in zip(out, eager):
        assert torch.equal(_bits(a), _bits(b))
    hub = np.flatnonzero(recv.numpy() == 9)
    r = int(hub[len(hub) // 2])
    bound.fill_(r)
    g.replay()
    torch.cuda.synchronize()
    cut = torch.tensor(r, dtype=torch.int32)
    cnt_ref = bwd.pna_bwd_count_plain(v, recv, mask, both, n, cut)
    grad_ref = bwd.pna_bwd_grad_plain(v, recv, mask, both, *cots, cnt_ref, cut)
    assert torch.equal(out[0].cpu(), cnt_ref) and not torch.equal(cnt_ref, eager[0].cpu())
    if dtype == torch.float32:
        assert torch.equal(_bits(out[1].cpu()), _bits(grad_ref))
    else:
        np.testing.assert_allclose(out[1].cpu().float().numpy(), grad_ref.float().numpy(), rtol=2e-2, atol=2e-2)
    assert not bool(out[1][r:].any())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h", [1, 3, 32, 128])
def test_cuda_pna_aggregate_bound_changes_no_bit(h, dtype):
    """B5 on ``b67_case``'s edges in range (a 30,000-slot masked tail at
    the padding row past the occupancy, a 60,000-slot hub): with the
    bound bit-equal to B5 without it and to the plain version; the
    padding row empty and cleaned to 0; a CUDA graph's replay with the
    bound moved into the hub equals the plain version with that bound."""
    from hydragnn_tpu_torch.ops import pna_aggregate as pna_mod

    dev = _cuda()
    v_np, recv_np, mask_np, n, occ = b67_case(h, 100 + h)
    keep = (recv_np >= 0) & (recv_np < n)
    occ -= int((~keep[:occ]).sum())
    v, recv, mask = (torch.from_numpy(a[keep]) for a in (v_np, recv_np, mask_np))
    v = v.to(dtype)
    ref = pna_mod.pna_aggregate_plain(v, recv, n, mask)
    v_d, recv_d, mask_d = v.to(dev), recv.to(dev), mask.to(dev)
    ptr = row_pointers(recv_d, n)
    bound = torch.tensor(occ, dtype=torch.int32, device=dev)
    k0 = pna_mod.launches.value
    outs = [pna_mod.pna_aggregate(v_d, recv_d, n, mask_d, row_ptr=ptr, real_edges=bound),
            pna_mod.pna_aggregate(v_d, recv_d, n, mask_d, row_ptr=ptr)]
    torch.cuda.synchronize()
    assert pna_mod.launches.value - k0 == 2
    for out in outs:
        for name, a, r in zip(("sum", "sumsq", "cnt", "both"), out, ref):
            assert torch.equal(_bits(a.cpu()), _bits(r)), f"{name} h={h} {dtype}"
    assert float(ref[2][n - 2]) == 0.0 and not bool(ref[3][n - 2].any())
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = pna_mod.pna_aggregate(v_d, recv_d, n, mask_d, row_ptr=ptr, real_edges=bound)
    hub = np.flatnonzero(recv.numpy() == 9)
    r = int(hub[len(hub) // 2])
    bound.fill_(r)
    g.replay()
    torch.cuda.synchronize()
    want = pna_mod.pna_aggregate_plain(v, recv, n, mask, torch.tensor(r, dtype=torch.int32))
    for name, a, w in zip(("sum", "sumsq", "cnt", "both"), out, want):
        assert torch.equal(_bits(a.cpu()), _bits(w)), f"{name} h={h} {dtype} cut"


@pytest.mark.cuda
@pytest.mark.parametrize("values", ["grid", "normal"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h", [1, 3, 31, 32, 126, 128])
def test_cuda_pna_aggregate_bit_equal_with_and_without_row_ptr(h, dtype, values):
    """B5 on ``b5_edge_case`` (all-masked and empty rows, a 60,000-slot
    row), v on a fresh allocation and at an odd offset: all four outputs
    bit-equal to the plain version on the host, f32 and bf16 (the kernel
    and the plain version both sum the same f32 values in edge order);
    with the shared ``row_ptr`` (one launch) and without it (the wrapper
    builds its own, one more pass counted); two launches bitwise equal;
    a CUDA graph's capture of the call replays to the same bits."""
    from hydragnn_tpu_torch.ops import pna_aggregate as pna_mod

    dev = _cuda()
    v_np, recv_np, mask_np, n = b5_edge_case(h, 30 + h, values)
    v, recv, mask = torch.from_numpy(v_np).to(dtype), torch.from_numpy(recv_np), torch.from_numpy(mask_np)
    ref = pna_mod.pna_aggregate_plain(v, recv, n, mask)
    recv_d, mask_d = recv.to(dev), mask.to(dev)
    r0 = rp_mod.launches.value
    ptr = row_pointers(recv_d, n)
    assert rp_mod.launches.value == r0 + 1
    assert torch.equal(ptr.cpu(), row_pointers(recv, n))
    for place in (lambda t: t.to(dev), lambda t: _at_odd_offset(t, dev)):
        v_d = place(v)
        r0, k0 = rp_mod.launches.value, pna_mod.launches.value
        outs = [pna_mod.pna_aggregate(v_d, recv_d, n, mask_d, row_ptr=ptr) for _ in range(2)]
        outs.append(pna_mod.pna_aggregate(v_d, recv_d, n, mask_d))
        outs.append(_graph_replay(lambda: pna_mod.pna_aggregate(v_d, recv_d, n, mask_d, row_ptr=ptr)))
        torch.cuda.synchronize()
        assert (rp_mod.launches.value - r0, pna_mod.launches.value - k0) == (1, 4)
        for out in outs:
            for name, a, r in zip(("sum", "sumsq", "cnt", "both"), out, ref):
                assert torch.equal(_bits(a.cpu()), _bits(r)), f"{name} h={h} {dtype}"
    assert float(ref[2][9]) == 5.0 and float(ref[2][4]) == 0.0 and (ref[3][4] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["identity", "scale"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h", [1, 3, 31, 32, 126, 128])
def test_cuda_fused_conv_walk_with_and_without_row_ptr(h, dtype, variant):
    """B8's K = 0 walks (the group walk at one column, the warp walk
    from two) on ``b8_edge_case`` (a row of 50,005 slots, out-of-range
    senders, the occupancy bound below E), x and the scale at an odd
    offset: bit-equal to the plain version with the shared ``row_ptr``
    and without it, two launches bitwise equal, and a CUDA graph's
    capture replays to the same bits."""
    from hydragnn_tpu_torch.ops import fused_conv as fc

    dev = _cuda()
    x_np, send, recv, mask, n, real, sc_np, clean, clean_send = b8_edge_case(h, 21 + h, with_scale=variant == "scale")
    x = torch.from_numpy(x_np).to(dtype)
    scale = None if sc_np is None else torch.from_numpy(sc_np).to(dtype)
    ref = fc.fused_conv_plain(x.float(), torch.from_numpy(clean_send), torch.from_numpy(recv),
                              torch.from_numpy(clean), n, (), (), None if scale is None else scale.float())
    send_d, recv_d, mask_d = (torch.from_numpy(t).to(dev) for t in (send, recv, mask))
    real_d = torch.tensor(real, dtype=torch.int32, device=dev)
    x_d = _at_odd_offset(x, dev)
    sc_d = None if scale is None else _at_odd_offset(scale, dev)
    ptr = row_pointers(recv_d, n)

    def call(row_ptr):
        return fc.fused_conv(x_d, send_d, recv_d, mask_d, n, (), (), sc_d, real_d, row_ptr)

    r0, k0 = rp_mod.launches.value, fc.launches.value
    outs = [call(ptr), call(ptr), call(None), _graph_replay(lambda: call(ptr))]
    torch.cuda.synchronize()
    assert (rp_mod.launches.value - r0, fc.launches.value - k0) == (1, 4)
    for out in outs:
        assert torch.equal(_bits(out.cpu()), _bits(ref)), f"{variant} h={h} {dtype}"


def _b8_inputs(b, variant, dtype, seed):
    """(x, branches, acts, scale) of one B8 variant, on the host, in
    ``dtype`` (W and b f32); identity and scale on the 1/4 grid."""
    rng = np.random.default_rng(seed)
    n, e = b.num_nodes, b.num_edges

    def f32(*shape, s=0.3):
        return torch.from_numpy((rng.normal(size=shape) * s).astype(np.float32))

    if variant.startswith("identity"):
        h = int(variant.split("_h")[1])
        return _grid((n, h), seed, dtype), (), (), None
    if variant.startswith("scale"):
        h = int(variant.split("_")[1][1:])
        return _grid((n, h), seed, dtype), (), (), _grid((e, h), seed + 1, dtype)
    if variant == "gate_w1":
        branches = ((f32(1, 1), None, f32(n, 1).to(dtype), None), (f32(1, 1), None, f32(n, 1).to(dtype), None))
        return f32(n, 1, s=1.0).to(dtype), branches, ("sigmoid", "softplus"), None
    w = int(variant.split("_w")[1])  # 16: the narrow kernel; 128: the staged one
    branches = (
        (f32(w, w, s=0.1), f32(w), f32(n, w).to(dtype), f32(e, w).to(dtype)),
        (f32(w, w, s=0.1), None, f32(n, w).to(dtype), f32(e, w).to(dtype)),
    )
    return f32(n, w, s=1.0).to(dtype), branches, ("sigmoid", "softplus"), None


def _on(dev, branches):
    return tuple(tuple(None if t is None else t.to(dev) for t in br) for br in branches)


def _f32(branches):
    return tuple(tuple(None if t is None else t.float() for t in br) for br in branches)


B8_WALKS = [f"identity_h{h}" for h in (1, 3, 31, 32, 64, 126, 128, 256)] + [
    f"scale_h{h}" for h in (1, 3, 31, 64, 128, 256)] + ["scale_f126"]
B8_CASES = [(v, c) for v in B8_WALKS for c in ("grid", "normal", "edges")] + [
    (v, "grid") for v in ("gate_w1", "gate_w16", "gate_w128")]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant,case", B8_CASES)
def test_cuda_fused_conv_matches_plain(variant, case, dtype):
    """B8 against its plain version on the f32 values of the same inputs
    (the kernel computes in f32). "grid": the run-aligned batch with its
    fillers, empty rows, +inf in the masked slots' edge terms, the
    occupancy bound below E and at E, values on the 1/4 grid. "normal":
    the same batch on random normal values, and "edges": ``b8_edge_case``
    with x and the scale at an odd offset; both bit-equal (K = 0 sums in
    edge order, as ``index_add_``)."""
    from hydragnn_tpu_torch.ops import fused_conv as fc

    dev = _cuda()
    if case == "edges":
        h = int(variant.split("_")[1][1:])
        x_np, send, recv, mask, n, real, sc_np, clean, clean_send = b8_edge_case(
            h, 11, with_scale=variant.startswith("scale"))
        x = torch.from_numpy(x_np).to(dtype)
        scale = None if sc_np is None else torch.from_numpy(sc_np).to(dtype)
        ref = fc.fused_conv_plain(x.float(), torch.from_numpy(clean_send), torch.from_numpy(recv),
                                  torch.from_numpy(clean), n, (), (), None if scale is None else scale.float())
        d_args = [torch.from_numpy(t).to(dev) for t in (send, recv, mask)] + [n]
        for real_d in (torch.tensor(real, dtype=torch.int32, device=dev),
                       torch.tensor(recv.size, dtype=torch.int32, device=dev)):
            run = lambda: fc.fused_conv(  # noqa: E731
                _at_odd_offset(x, dev), *d_args, (), (), None if scale is None else _at_odd_offset(scale, dev), real_d)
            before = fc.launches.value
            out1, out2 = run(), run()
            torch.cuda.synchronize()
            assert fc.launches.value == before + 2
            assert torch.equal(_bits(out1), _bits(out2))
            assert torch.equal(_bits(out1.cpu()), _bits(ref)), variant
        return
    b, mask = _aligned_batch(3)
    x, branches, acts, scale = _b8_inputs(b, variant, dtype, 11)
    if case == "normal":
        rng = np.random.default_rng(12)
        x = torch.from_numpy(_values(tuple(x.shape), rng, "normal")).to(dtype)
        scale = None if scale is None else torch.from_numpy(_values(tuple(scale.shape), rng, "normal")).to(dtype)
    if variant in ("gate_w16", "gate_w128"):  # +inf edge terms on masked slots never reach a sum
        for br in branches:
            br[3][~mask] = float("inf")
    args = (b.senders, b.receivers, mask, b.num_nodes)
    ref = fc.fused_conv_plain(x.float(), *args, _f32(branches), acts, None if scale is None else scale.float())
    assert torch.isfinite(ref).all()
    tol = SUM_TOL if not branches else GATE_TOL
    occ = b.edge_occupancy
    assert int(occ) < b.num_edges
    for real in (occ, torch.tensor(b.num_edges, dtype=torch.int32)):
        d_args = [t.to(dev) for t in args[:3]] + [b.num_nodes]
        run = lambda: fc.fused_conv(  # noqa: E731
            x.to(dev), *d_args, _on(dev, branches), acts, None if scale is None else scale.to(dev), real.to(dev)
        )
        before = fc.launches.value
        out1, out2 = run(), run()
        torch.cuda.synchronize()
        assert fc.launches.value == before + 2
        assert torch.equal(out1, out2)
        if case == "normal":
            assert torch.equal(_bits(out1.cpu()), _bits(ref)), variant
        else:
            np.testing.assert_allclose(out1.cpu().numpy(), ref.numpy(), err_msg=variant, **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["identity_h128", "scale_f126", "gate_w16", "gate_w128"])
def test_cuda_fused_aggregate_backward_matches_cpu(variant):
    """B8's autograd op on the card (B8, then B3, B2, B4 in the
    backward) against the same op on the CPU: every gradient."""
    from hydragnn_tpu_torch.ops.fused_conv import fused_aggregate

    dev = _cuda()
    b, mask = _aligned_batch(4)
    x, branches, acts, scale = _b8_inputs(b, variant, torch.float32, 12)
    hout = branches[0][0].shape[1] if branches else x.shape[1]
    g = torch.from_numpy(np.random.default_rng(2).normal(size=(b.num_nodes, hout)).astype(np.float32))
    grads = {}
    for where in ("cpu", "cuda"):
        d = torch.device(where) if where == "cpu" else dev
        # detach: on the CPU .to() returns the host tensor itself
        leaves = [x.detach().to(d).requires_grad_(True)]
        br = tuple(tuple(None if t is None else t.detach().to(d).requires_grad_(True) for t in bb) for bb in branches)
        sc = None if scale is None else scale.detach().to(d).requires_grad_(True)
        out = fused_aggregate(leaves[0], b.senders.to(d), b.receivers.to(d), mask.to(d), b.num_nodes, br, acts, sc,
                              win=b.sender_win.to(d), real_edges=b.edge_occupancy.to(d))
        out.backward(g.to(d))
        tensors = leaves + [t for bb in br for t in bb if t is not None] + ([sc] if sc is not None else [])
        grads[where] = [out.detach().cpu()] + [t.grad.cpu() for t in tensors]
    np.testing.assert_allclose(grads["cuda"][0].numpy(), grads["cpu"][0].numpy(), err_msg=variant, **GATE_TOL)
    for i, (a, r) in enumerate(zip(grads["cuda"][1:], grads["cpu"][1:])):
        rel = float((a - r).norm() / r.norm().clamp_min(1e-30))
        assert rel <= GRAD_REL_L2, f"{variant} gradient #{i}: relative L2 {rel}"


def _stack_inputs(b, mask, h, layers, seed):
    """B9's inputs on the host: x on a 1/4 grid (ties), W ~ N(0, 1/h)
    (the product keeps the scale), b ~ N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)
    x = _grid((b.num_nodes, h), seed, torch.float32)
    w = torch.from_numpy((rng.normal(size=(layers, h, h)) / np.sqrt(h)).astype(np.float32))
    bias = torch.from_numpy((rng.normal(size=(layers, h)) * 0.1).astype(np.float32))
    return x, w, bias


STACK_ACTS = ["none", "relu", "sigmoid", "softplus", "tanh", "silu"]
STACK_WIDTHS = [1, 3, 6, 16, 31, 64, 128, 256]  # 1: the group walk; 64-256: the tiled product


def _stack_reference(x, send, recv, mask, n, w, bias, edge_act, dtype):
    """B9's function on the host in ``dtype``, relu between layers: a
    masked-in slot's message is edge_act(h[send] @ W + b), and a sender
    outside [0, n) reads a zero row (its message is edge_act(b)). In
    float32 it is the plain version extended to that rule (equal to
    ``fused_conv_stack_plain`` when every sender is in range, up to the
    host BLAS's order); in float64 the exact result up to float64
    rounding."""
    from hydragnn_tpu_torch.ops.fused_conv import ACTS

    act = ACTS[edge_act][0]
    rows = torch.where((send >= 0) & (send < n), send, torch.full_like(send, n)).long()
    hh, out = x.to(dtype), None
    for layer in range(w.shape[0]):
        hz = torch.cat([hh, hh.new_zeros(1, hh.shape[1])])
        msg = act(hz[rows] @ w[layer].to(dtype) + bias[layer].to(dtype))
        msg = torch.where(mask[:, None], msg, torch.zeros((), dtype=dtype))
        out = torch.zeros(n, hh.shape[1], dtype=dtype).index_add_(0, recv.long(), msg)
        hh = torch.relu(out)
    return out


def _check_stack(b9, send, recv, mask, n, x, w, bias, edge_act, reals, plain):
    """B9 on the card for each occupancy bound in ``reals``: one count a
    call, two launches and a CUDA graph's replay bitwise equal, equal to
    the loop of B8 launches with relu between them value for value, and
    against the exact result (``_stack_reference`` in float64) within
    1e-5 of the output's largest magnitude plus twice the f32 plain
    version's own distance from it. The second term is what float32
    allows on the input: over 6 tanh layers with relu between them the
    plain version itself (the host BLAS's order) lies farther than 1e-5
    of the output's scale from the exact result, because a layer's
    pre-activations carry terms far larger than the bounded messages they
    become. Where the plain version is within 1e-7 of it, the bound is
    1e-5 of the scale."""
    from hydragnn_tpu_torch.ops import fused_conv as fc

    dev = _cuda()
    exact = _stack_reference(x, send, recv, mask, n, w, bias, edge_act, torch.float64)
    scale = float(exact.abs().max())
    assert torch.isfinite(plain).all() and scale > 0
    tol = 1e-5 * scale + 2 * float((plain.double() - exact).abs().max())
    d_args = [t.to(dev) for t in (send, recv, mask)] + [n]
    xd, wd, bd = x.to(dev), w.to(dev), bias.to(dev)
    for real in reals:
        rd = real.to(dev)
        before = b9.launches.value
        out1 = b9.fused_conv_stack(xd, *d_args, wd, bd, edge_act, "relu", real_edges=rd)
        out2 = b9.fused_conv_stack(xd, *d_args, wd, bd, edge_act, "relu", real_edges=rd)
        torch.cuda.synchronize()
        assert b9.launches.value == before + 2
        assert torch.equal(_bits(out1), _bits(out2))
        replayed = _graph_replay(lambda: b9.fused_conv_stack(xd, *d_args, wd, bd, edge_act, "relu", real_edges=rd))
        assert torch.equal(_bits(out1), _bits(replayed))
        hh, loop = xd, None
        for layer in range(w.shape[0]):
            loop = fc.fused_conv(hh, *d_args, ((wd[layer], bd[layer], None, None),), (edge_act,), real_edges=rd)
            hh = torch.relu(loop)
        assert torch.equal(out1, loop)
        err = float((out1.cpu().double() - exact).abs().max())
        assert err <= tol, f"max abs err {err} against the exact result, bound {tol} (output scale {scale})"


@pytest.mark.cuda
@pytest.mark.parametrize("layers", [1, 6])
@pytest.mark.parametrize("edge_act", STACK_ACTS)
@pytest.mark.parametrize("h", STACK_WIDTHS)
def test_cuda_fused_conv_stack_matches_plain(h, edge_act, layers):
    """B9 against the B8 loop and the exact result (``_check_stack``),
    relu between layers: 1,200 rows (not a multiple
    of the product's 128-row tile), run-aligned fillers, whole K-groups
    masked, empty rows, the occupancy bound below E and at E."""
    _cuda()
    b9 = importlib.import_module("hydragnn_tpu_torch.ops.fused_conv_stack")
    b, mask = _aligned_batch(5)
    x, w, bias = _stack_inputs(b, mask, h, layers, 13)
    plain = b9.fused_conv_stack_plain(x, b.senders, b.receivers, mask, b.num_nodes, w, bias, edge_act, "relu")
    _check_stack(b9, b.senders, b.receivers, mask, b.num_nodes, x, w, bias, edge_act,
                 (b.edge_occupancy, torch.tensor(b.num_edges, dtype=torch.int32)), plain)


@pytest.mark.cuda
@pytest.mark.parametrize("layers", [1, 6])
@pytest.mark.parametrize("h", [1, 31, 128])
def test_cuda_fused_conv_stack_out_of_range_senders(h, layers):
    """Live slots whose sender lies outside [0, N) (N + 7, N, -1) take
    edge_act(b), as B8's per-edge branch gives them, on every layer."""
    _cuda()
    b9 = importlib.import_module("hydragnn_tpu_torch.ops.fused_conv_stack")
    b, mask = _aligned_batch(7)
    send = b.senders.clone()
    live = torch.nonzero(mask[: int(b.edge_occupancy)]).flatten()
    n = b.num_nodes
    for k, j in zip((3, 100, live.numel() // 2, live.numel() - 2), (n + 7, n, -1, n + 7)):
        send[live[k]] = j
    x, w, bias = _stack_inputs(b, mask, h, layers, 17)
    plain = _stack_reference(x, send, b.receivers, mask, n, w, bias, "sigmoid", torch.float32)
    _check_stack(b9, send, b.receivers, mask, n, x, w, bias, "sigmoid",
                 (b.edge_occupancy, torch.tensor(b.num_edges, dtype=torch.int32)), plain)


@pytest.mark.cuda
@pytest.mark.parametrize("h", [1, 128])
def test_cuda_fused_conv_stack_long_row(h):
    """A row of 60,000 slots (5 of them live) among 4,096 rows of 24
    (``ab_kernels.py:long_row_inputs``), 6 layers."""
    _cuda()
    b9 = importlib.import_module("hydragnn_tpu_torch.ops.fused_conv_stack")
    rng = np.random.default_rng(0)
    rows = 4096
    counts = np.full(rows, 24)
    counts[100] = 60_000
    recv = np.repeat(np.arange(rows), counts).astype(np.int32)
    mask = rng.random(recv.size) > 0.25
    row100 = np.flatnonzero(recv == 100)
    mask[row100] = False
    mask[row100[[0, 1, 2, -2, -1]]] = True
    send = rng.integers(0, rows, recv.size).astype(np.int32)
    x = torch.from_numpy((np.round(rng.normal(size=(rows, h)) * 4.0) / 4.0).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(6, h, h)) / np.sqrt(h)).astype(np.float32))
    bias = torch.from_numpy((rng.normal(size=(6, h)) * 0.1).astype(np.float32))
    send_t, recv_t, mask_t = (torch.from_numpy(a) for a in (send, recv, mask))
    plain = b9.fused_conv_stack_plain(x, send_t, recv_t, mask_t, rows, w, bias, "sigmoid", "relu")
    _check_stack(b9, send_t, recv_t, mask_t, rows, x, w, bias, "sigmoid",
                 (torch.tensor(recv.size, dtype=torch.int32),), plain)


@pytest.mark.cuda
def test_cuda_fused_conv_stack_backward_matches_cpu():
    """The autograd op on the card (B9 forward; the backward recomputes
    through B8, B3 and B4) against the same op on the CPU: x, W and b."""
    from hydragnn_tpu_torch.ops.fused_conv_stack import fused_conv_stack

    dev = _cuda()
    b, mask = _aligned_batch(6)
    x, w, bias = _stack_inputs(b, mask, 128, 3, 14)
    g = torch.from_numpy(np.random.default_rng(3).normal(size=(b.num_nodes, 128)).astype(np.float32))
    grads = {}
    for where in ("cpu", "cuda"):
        d = torch.device(where) if where == "cpu" else dev
        leaves = [t.detach().to(d).requires_grad_(True) for t in (x, w, bias)]
        out = fused_conv_stack(leaves[0], b.senders.to(d), b.receivers.to(d), mask.to(d), b.num_nodes,
                               leaves[1], leaves[2], "sigmoid", "relu", win=b.sender_win.to(d),
                               real_edges=b.edge_occupancy.to(d))
        out.backward(g.to(d))
        grads[where] = [t.grad.cpu() for t in leaves]
    for name, a, r in zip(("x", "W", "b"), grads["cuda"], grads["cpu"]):
        rel = float((a - r).norm() / r.norm().clamp_min(1e-30))
        assert rel <= GRAD_REL_L2, f"grad {name}: relative L2 {rel}"


# ---------------------------------------------------------------- Dataset.path on the card
# The data helpers below import no JAX: tests/test_torch_data_formats.py
# takes them from here.

EAM_CONFIG = "examples/eam/NiNb_EAM_bulk_multitask.json"
GDB9 = "tests/data/gdb9_fixture"
# Ni and Nb: proton number, mass
SPECIES = {"Ni": (28, 58.693), "Nb": (41, 92.906)}


def _repo_path(rel):
    import os

    return os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), rel)


def write_cfg_dir(path, n_files, seed, a=3.30, cells=(2, 4)):
    """Synthetic AtomEye CFG files as the EAM examples read them: BCC
    supercells of ``cells`` unit cells a side (high end exclusive) at
    lattice constant ``a``, each atom Ni or Nb, seeded ``c_peratom``,
    ``fx``, ``fy``, ``fz``, and a ``.bulk`` sidecar whose column 2 holds
    a seeded bulk modulus."""
    import os

    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(seed)
    for k in range(n_files):
        reps = rng.integers(cells[0], cells[1], 3)
        frac = np.array([[i, j, l] for i in range(reps[0]) for j in range(reps[1]) for l in range(reps[2])],
                        dtype=np.float64)
        frac = np.concatenate([frac, frac + 0.5]) / reps
        names = np.where(rng.random(frac.shape[0]) < 0.5, "Ni", "Nb")
        aux = rng.normal(size=(frac.shape[0], 4))
        lines = [f"Number of particles = {frac.shape[0]}", "A = 1.0 Angstrom (basic length-scale)"]
        for i in range(3):
            for j in range(3):
                lines.append(f"H0({i + 1},{j + 1}) = {float(a * reps[i]) if i == j else 0.0!r} A")
        lines += [".NO_VELOCITY.", "entry_count = 7", "auxiliary[0] = c_peratom", "auxiliary[1] = fx",
                  "auxiliary[2] = fy", "auxiliary[3] = fz"]
        for name in ("Ni", "Nb"):
            rows = np.nonzero(names == name)[0]
            if rows.size == 0:
                continue
            lines += [repr(SPECIES[name][1]), name]
            lines += [" ".join(repr(float(v)) for v in (*frac[r], *aux[r])) for r in rows]
        stem = os.path.join(path, f"cfg{k:05d}")
        with open(stem + ".cfg", "w") as f:
            f.write("\n".join(lines) + "\n")
        with open(stem + ".bulk", "w") as f:
            f.write(" ".join(repr(float(v)) for v in (k, frac.shape[0], 150.0 + 40.0 * rng.random())) + "\n")


def eam_config(path, hidden=8, layers=2, epochs=1):
    """The NiNb multitask example config, only ``Dataset.path`` (and, for
    a small run, width, depth and epochs) changed."""
    import json

    with open(_repo_path(EAM_CONFIG)) as f:
        cfg = json.load(f)
    cfg["Dataset"]["path"] = {"total": path}
    arch = cfg["NeuralNetwork"]["Architecture"]
    arch["hidden_dim"], arch["num_conv_layers"] = hidden, layers
    cfg["NeuralNetwork"]["Training"]["num_epoch"] = epochs
    cfg["Verbosity"]["level"] = 0
    return cfg


def plain_gdb9_files():
    """The GDB9 fixture files whose atom rows hold plain floats (the
    others use Fortran ``*^`` exponents, which the XYZ reader refuses)."""
    import os

    from hydragnn_tpu_torch.data.formats import read_xyz_file

    out = []
    for f in sorted(f for f in os.listdir(_repo_path(GDB9)) if f.endswith(".xyz")):
        try:
            read_xyz_file(os.path.join(_repo_path(GDB9), f))
        except ValueError:
            continue
        out.append(f)
    return out


def write_xyz_dir(path, n):
    """Copies of the GDB9 fixture's first ``n`` plain files with seeded
    ``_energy.txt`` sidecars (two columns)."""
    import os
    import shutil

    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(4)
    for f in plain_gdb9_files()[:n]:
        shutil.copy(os.path.join(_repo_path(GDB9), f), os.path.join(path, f))
        with open(os.path.join(path, f[:-4] + "_energy.txt"), "w") as fh:
            fh.write(f"{rng.normal()!r} {rng.normal()!r}\n")


def xyz_config(path, base):
    """``base`` (a single-graph-head config) reading XYZ files: x = [Z],
    the sidecar's column 1 as the graph target."""
    base["Dataset"].update(
        format="XYZ", path=path, compositional_stratified_splitting=False,
        node_features={"name": ["atomic_number"], "dim": [1], "column_index": [0]},
        graph_features={"name": ["energy"], "dim": [1], "column_index": [1]},
    )
    base["NeuralNetwork"]["Variables_of_interest"].update(
        input_node_features=[0], output_names=["energy"], output_index=[0], type=["graph"])
    base["NeuralNetwork"]["Architecture"].update(radius=1.6, task_weights=[1.0])
    return base


def _path_config(tmp_path, fmt):
    """A small config reading ``fmt`` files under ``Dataset.path.total``."""
    from hydragnn_tpu_torch.data.container import ContainerWriter
    from hydragnn_tpu_torch.data.synthetic import deterministic_graph_data, write_lsms_files
    from hydragnn_tpu_torch.flagship import flagship_config

    d = str(tmp_path / fmt)
    if fmt == "CFG":
        write_cfg_dir(d, 24, seed=3)
        return eam_config(d)
    cfg = flagship_config(hidden_dim=8, num_conv_layers=2, batch_size=8)
    cfg["Dataset"].update(format=fmt, path={"total": d})
    if fmt == "XYZ":
        write_xyz_dir(d, 24)
        return xyz_config(cfg["Dataset"]["path"], cfg)
    if fmt == "HGC":
        w = ContainerWriter(d)
        w.add(deterministic_graph_data(number_configurations=24, seed=7))
        w.save()
    else:
        write_lsms_files(d, number_configurations=24, seed=7)
    return cfg


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["unit_test", "XYZ", "CFG", "HGC"])
def test_cuda_dataset_path_step_equals_samples_step(tmp_path, fmt):
    """One train step on the card from ``Dataset.path`` (the port's
    readers, native radius graph, PBC and rotation for CFG) equals, bit
    for bit, the step on the same raw samples passed as ``samples=``,
    under deterministic algorithms."""
    import copy
    import os
    import warnings

    from hydragnn_tpu_torch.api import prepare_loaders_and_config
    from hydragnn_tpu_torch.data.ingest import load_raw_samples
    from hydragnn_tpu_torch.models.create import create_model_config
    from hydragnn_tpu_torch.train.optimizer import select_optimizer
    from hydragnn_tpu_torch.train.state import train_step

    dev = _cuda()
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    cfg = _path_config(tmp_path, fmt)
    sides = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            for where in ("path", "samples"):
                raw = None if where == "path" else load_raw_samples(cfg, cfg["Dataset"]["path"]["total"])
                train_loader, _, _, done = prepare_loaders_and_config(copy.deepcopy(cfg), raw)
                model = create_model_config(done["NeuralNetwork"], seed=0, device=dev)
                opt = select_optimizer(model, done["NeuralNetwork"]["Training"])
                loss, tasks = train_step(model, opt, next(iter(train_loader)).to(dev))
                sides[where] = [loss, tasks] + [p.detach() for p in model.parameters()]
    finally:
        torch.use_deterministic_algorithms(False)
    assert torch.isfinite(sides["path"][0])
    for a, b in zip(sides["path"], sides["samples"]):
        assert torch.equal(a, b)


def _serve_on_card(model_type="PNA", seed=0):
    """A small flagship-shaped server on the card (hidden 16, 2 layers,
    24 BCC graphs), started: its buckets captured."""
    import hydragnn_tpu_torch
    from hydragnn_tpu_torch.data.synthetic import deterministic_graph_data
    from hydragnn_tpu_torch.flagship import flagship_config
    from hydragnn_tpu_torch.serve import ServeConfig

    cfg = flagship_config(hidden_dim=16, num_conv_layers=2)
    cfg["NeuralNetwork"]["Architecture"]["model_type"] = model_type
    raw = deterministic_graph_data(number_configurations=24, unit_cell_x_range=(2, 4), unit_cell_y_range=(2, 4),
                                   unit_cell_z_range=(2, 4), seed=seed)
    return hydragnn_tpu_torch.serve_model(cfg, raw, device="cuda", seed=seed,
                                          serve_config=ServeConfig(max_batch=4, max_delay_ms=5.0))


@pytest.mark.cuda
def test_cuda_serve_graph_replay_equals_eager_and_reload_captures_nothing():
    """Every bucket's CUDA graph, replayed on a batch of real requests,
    equals the eager forward of the same padded batch bit for bit (under
    deterministic algorithms: the pooling's ``index_add_``); a reload
    through the standby slot captures nothing, serves the new weights
    bit-equal to their eager forward and leaves the old slot as it was."""
    import os
    import warnings

    from hydragnn_tpu_torch.serve import request_to_dict

    _cuda()
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            server = _serve_on_card()
            try:
                cache = server._cache
                assert cache.graphs and cache.captures == 2 * len(server.buckets)
                reqs = [request_to_dict(s) for s in server.reference_samples]

                def check(model):
                    for b in server.buckets:
                        group = [g for g in reqs if b.fits_graph(g["x"].shape[0], len(g["senders"]))][: b.max_batch]
                        hb = batch_graphs(group, n_node_pad=b.node_pad, n_edge_pad=b.edge_pad,
                                          n_graph_pad=b.graph_pad)
                        got = cache.run(None, b.index, hb)
                        with torch.inference_mode():
                            want = [o.cpu().numpy() for o in model(hb.to(server.device), train=False)]
                        for g_, w_ in zip(got, want):
                            assert g_.shape == w_.shape and np.array_equal(g_.view(np.int32), w_.view(np.int32))

                check(server.served.model)
                old = {k: v.clone() for k, v in server.served.model.state_dict().items()}
                new = {k: v * 1.25 if v.is_floating_point() else v for k, v in old.items()}
                captures = cache.captures
                server.reload(variables=new)
                assert cache.captures == captures and server.metrics_snapshot()["compile_misses"] == 0
                assert cache.active == 1 and server.served.model is cache.models[1]
                check(server.served.model)
                assert all(torch.equal(cache.models[0].state_dict()[k], v) for k, v in old.items())
                res = server.predict(reqs[0], timeout=120)
                assert all(np.all(np.isfinite(v)) for v in res.values())
            finally:
                server.stop()
    finally:
        torch.use_deterministic_algorithms(False)


@pytest.mark.cuda
def test_cuda_serve_mfc_buckets_are_eager():
    """MFC reads its degree counts on the host: its buckets are the
    eager forward on the card, decided from the config, said by
    health()."""
    _cuda()
    server = _serve_on_card("MFC")
    try:
        h = server.health()
        assert h["bucket_executor"] == "eager" and "degree" in h["eager_reason"]
        assert server._cache.captures == 0 and h["ready"]
        res = server.predict(server.reference_samples[0], timeout=120)
        assert all(np.all(np.isfinite(v)) for v in res.values())
    finally:
        server.stop()
