"""The training path's kernels (B1–B4) and autograd segment ops against
the JAX package: the plain versions against the JAX Pallas kernels in
interpret mode and against the XLA path, and every autograd op's
gradient against ``jax.vjp``, on run-aligned batches with deliberate
ties (values on a 1/4 grid), all-masked K-groups and empty rows. The
CUDA kernels against these plain versions are in
``tests/test_torch_cuda_kernels.py``.

Tolerances and why:
  - gathers and maxima bit-equal (a copy, and a max, are exact in any
    order);
  - sums ``rtol=1e-6, atol=1e-6`` (f32 accumulation in another order:
    the Pallas kernels sum 3-term bf16-split matmuls);
  - operation gradients ``rtol=1e-5, atol=1e-6`` (the same sums, then a
    few f32 products).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hydragnn_tpu.graph import segment as jseg
from hydragnn_tpu.graph.batch import batch_graphs as jax_batch_graphs
from hydragnn_tpu.ops import segment_pallas as jsp

from hydragnn_tpu_torch.graph import segment as tseg
from hydragnn_tpu_torch.graph.batch import batch_graphs
from hydragnn_tpu_torch.ops import gather_rows as gr_mod
from hydragnn_tpu_torch.ops import gather_stats as gs_mod
from hydragnn_tpu_torch.ops import segment_sum as ss_mod
from hydragnn_tpu_torch.ops import segment_sum_local as sl_mod
from hydragnn_tpu_torch.ops.gather_stats import gather_presum_stats, gather_stats

from test_torch_cuda_kernels import b4_edge_case

SUM_TOL = dict(rtol=1e-6, atol=1e-6)
GRAD_TOL = dict(rtol=1e-5, atol=1e-6)
K = 8


def _bits(a):
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype == jnp.bfloat16 or a.dtype == np.dtype("V2"):
        return a.view(np.uint16)
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)


def _tbits(t: torch.Tensor):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy().view(np.uint32)


def _aligned_batch(seed, n_edge_pad=1024, k=K):
    """A run-aligned (K=8, or ``k``) batch of small graphs: local unsorted
    senders, sorted receivers, empty (padding) rows; slots 8..15 (one or
    two whole groups) are masked on top of the layout's own masked
    groups."""
    rng = np.random.default_rng(seed)
    graphs = []
    for _ in range(8):
        n = int(rng.integers(4, 14))
        e = int(rng.integers(10, 40))
        s, r = rng.integers(0, n, e), rng.integers(0, n, e)
        order = np.lexsort((s, r))
        graphs.append({"x": np.zeros((n, 1), np.float32), "senders": s[order], "receivers": r[order]})
    kw = dict(n_node_pad=128, n_edge_pad=n_edge_pad, n_graph_pad=9, run_align=k, win_block_rows=32)
    b = batch_graphs(graphs, **kw)
    mask = b.edge_mask.numpy().copy()
    mask[8:16] = False
    return b, jax_batch_graphs(graphs, **kw), mask


def _table(seed, n, h):
    rng = np.random.default_rng(seed)
    return (np.round(rng.normal(size=(n, h)) * 4.0) / 4.0 + 0.0).astype(np.float32)  # ties, no -0.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h", [1, 24])
def test_gather_stats_plain_matches_jax_ref(h, dtype):
    b, jb, mask = _aligned_batch(h)
    table = _table(h, b.num_nodes, h)
    tt = torch.from_numpy(table).to(getattr(torch, dtype))
    stats, both = gather_stats(tt, b.senders, torch.from_numpy(mask), K)
    jt = jnp.asarray(table).astype(getattr(jnp, dtype))
    rs, rb = jsp._presum_stats_ref(jt[jb.senders], jnp.asarray(mask), K)
    assert stats.dtype == torch.float32 and both.dtype == tt.dtype
    np.testing.assert_allclose(stats.numpy(), np.asarray(rs), **SUM_TOL)
    np.testing.assert_array_equal(_tbits(both), _bits(rb))
    # all-masked groups keep the type's lowest value (no clean here)
    lowest = torch.finfo(tt.dtype).min
    assert (both[1] == lowest).all() and (stats[1] == 0).all()


def test_gather_presum_matches_pallas_kernel_interpret(monkeypatch):
    """B1's plain version and autograd against ``gather_presum_stats``
    with the Pallas ``_gather_stats_kernel`` in interpret mode (len(ids)
    a multiple of 1024, H = 128), values and gradients."""
    monkeypatch.setenv("HYDRAGNN_PALLAS", "interpret")
    monkeypatch.setenv("HYDRAGNN_LOCAL_MIN_ROWS", "0")
    b, jb, mask = _aligned_batch(5, n_edge_pad=2048)
    table = _table(5, b.num_nodes, 128)
    rng = np.random.default_rng(6)
    g_stats = rng.normal(size=(2048 // K, 256)).astype(np.float32)
    g_both = rng.normal(size=(2048 // K, 256)).astype(np.float32)

    def jax_loss(t):
        s, m = jsp.gather_presum_stats(t, jb.senders, jnp.asarray(mask), jb.sender_win, b.num_nodes, K)
        return (s * g_stats).sum() + (m * g_both).sum(), (s, m)

    (_, (js, jm)), jg = jax.value_and_grad(jax_loss, has_aux=True)(jnp.asarray(table))
    t = torch.from_numpy(table).requires_grad_(True)
    s, m = gather_presum_stats(t, b.senders, torch.from_numpy(mask), b.sender_win, b.num_nodes, K)
    ((s * torch.from_numpy(g_stats)).sum() + (m * torch.from_numpy(g_both)).sum()).backward()
    np.testing.assert_allclose(s.detach().numpy(), np.asarray(js), **SUM_TOL)
    np.testing.assert_array_equal(m.detach().numpy(), np.asarray(jm))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), **GRAD_TOL)


@pytest.mark.parametrize("h", [1, 24])
def test_gather_presum_vjp_matches_jax(h):
    """The closed-form backward against ``jax.vjp`` of the reference
    composition (plain AD: the even tie split of reduce-max)."""
    b, jb, mask = _aligned_batch(20 + h)
    table = _table(20 + h, b.num_nodes, h)
    rng = np.random.default_rng(h)
    g_stats = rng.normal(size=(b.num_edges // K, 2 * h)).astype(np.float32)
    g_both = rng.normal(size=(b.num_edges // K, 2 * h)).astype(np.float32)

    def ref(t):
        return jsp._presum_stats_ref(t[jb.senders], jnp.asarray(mask), K)

    (js, jm), vjp = jax.vjp(ref, jnp.asarray(table))
    (jg,) = vjp((jnp.asarray(g_stats), jnp.asarray(g_both)))
    t = torch.from_numpy(table).requires_grad_(True)
    s, m = gather_presum_stats(t, b.senders, torch.from_numpy(mask), b.sender_win, b.num_nodes, K)
    torch.autograd.backward((s, m), (torch.from_numpy(g_stats), torch.from_numpy(g_both)))
    np.testing.assert_allclose(s.detach().numpy(), np.asarray(js), **SUM_TOL)
    np.testing.assert_array_equal(m.detach().numpy(), np.asarray(jm))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), **GRAD_TOL)
    # the ties were real: some group has a tied maximum
    v = table[b.senders.numpy()].reshape(-1, K, h)
    assert ((v == v.max(1, keepdims=True)).sum(1) > 1).any()


# bf16 gradients of the table: grad_v is the same chain on both sides, but
# the scatter sums it in f32 in another order and rounds once to bf16
BF16_GRAD_TOL = dict(rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("values", ["grid", "normal"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [8, 4])
def test_gather_presum_bwd_plain_matches_jax_vjp_interpret(k, dtype, values, monkeypatch):
    """B1's backward kernel's plain version, ``gather_presum_bwd_plain``,
    then the scatter's (``segment_sum_local_plain``), against ``jax.vjp``
    of the JAX ``gather_presum_stats`` with ``_gather_stats_kernel`` in
    interpret mode: tables on the 1/4 grid (ties in many groups) or
    normal, whole K-groups masked, K = 8 and 4, f32 and bf16."""
    monkeypatch.setenv("HYDRAGNN_PALLAS", "interpret")
    monkeypatch.setenv("HYDRAGNN_LOCAL_MIN_ROWS", "0")
    b, jb, mask = _aligned_batch(30 + k, n_edge_pad=2048, k=k)
    h, g = 128, 2048 // k
    rng = np.random.default_rng(31 + k)
    table = _table(32 + k, b.num_nodes, h)
    if values == "normal":
        table = rng.normal(size=table.shape).astype(np.float32)
    g_stats = rng.normal(size=(g, 2 * h)).astype(np.float32)
    g_both = rng.normal(size=(g, 2 * h)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def fwd(t):
        return jsp.gather_presum_stats(t, jb.senders, jnp.asarray(mask), jb.sender_win, b.num_nodes, k)

    (js, jm), vjp = jax.vjp(fwd, jnp.asarray(table).astype(jdt))
    (jg,) = vjp((jnp.asarray(g_stats), jnp.asarray(g_both).astype(jdt)))
    tt, tm = torch.from_numpy(table).to(tdt), torch.from_numpy(mask)
    stats, both = gather_stats(tt, b.senders, tm, k)
    np.testing.assert_array_equal(_tbits(both), _bits(jm))
    np.testing.assert_allclose(stats.numpy(), np.asarray(js), **SUM_TOL)
    grad_v = gs_mod.gather_presum_bwd_plain(tt, b.senders, tm, both, torch.from_numpy(g_stats),
                                            torch.from_numpy(g_both).to(tdt), k)
    assert grad_v.dtype == tdt and grad_v.shape == (b.num_edges, h)
    assert (grad_v[~tm] == 0).all() and not torch.signbit(grad_v[~tm]).any()
    grad = sl_mod.segment_sum_local_plain(grad_v, b.senders, b.num_nodes).to(tdt)
    tol = GRAD_TOL if dtype == "float32" else BF16_GRAD_TOL
    np.testing.assert_allclose(grad.float().numpy(), np.asarray(jg).astype(np.float32), **tol)
    if values == "grid":  # the ties were real, and some group is all masked
        v = table[b.senders.numpy()].reshape(-1, k, h)
        assert ((v == v.max(1, keepdims=True)).sum(1) > 1).any()
        assert (~mask.reshape(-1, k)).all(1).any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [8, 4])
def test_gather_presum_autograd_is_plain_bwd_then_scatter(k, dtype):
    """On the CPU the autograd op's table gradient is, bit for bit,
    ``gather_presum_bwd_plain`` scattered by ``segment_sum_local_plain``;
    ``gather_presum_bwd`` on a CPU tensor is its plain version."""
    b, _, mask = _aligned_batch(40 + k, k=k)
    h = 24
    rng = np.random.default_rng(k)
    table = torch.from_numpy(_table(41 + k, b.num_nodes, h)).to(dtype)
    tm = torch.from_numpy(mask)
    g_stats = torch.from_numpy(rng.normal(size=(b.num_edges // k, 2 * h)).astype(np.float32))
    g_both = torch.from_numpy(rng.normal(size=(b.num_edges // k, 2 * h)).astype(np.float32)).to(dtype)
    t = table.clone().requires_grad_(True)
    s, m = gather_presum_stats(t, b.senders, tm, b.sender_win, b.num_nodes, k)
    torch.autograd.backward((s, m), (g_stats, g_both))
    args = (table, b.senders, tm, m.detach(), g_stats, g_both, k)
    grad_v = gs_mod.gather_presum_bwd_plain(*args)
    assert torch.equal(gs_mod.gather_presum_bwd(*args), grad_v)
    ref = sl_mod.segment_sum_local_plain(grad_v, b.senders, b.num_nodes).to(dtype)
    assert t.grad.dtype == dtype
    np.testing.assert_array_equal(_tbits(t.grad), _tbits(ref))


@pytest.mark.parametrize("k", [8, 4])
@pytest.mark.parametrize("h", [1, 3, 126, 128])
def test_gather_stats_plain_sums_in_slot_order(h, k):
    """``gather_stats_plain`` adds each group's slots in slot order from
    +0 (what the kernel does), bit for bit against a numpy loop on normal
    values, and its maxima equal ``presum_stats_plain``'s."""
    b, _, mask = _aligned_batch(50 + h, k=k)
    rng = np.random.default_rng(h)
    table = rng.normal(size=(b.num_nodes, h)).astype(np.float32)
    stats, both = gather_stats(torch.from_numpy(table), b.senders, torch.from_numpy(mask), k)
    vf = np.where(mask[:, None], table[b.senders.numpy()], np.float32(0)).reshape(-1, k, h)
    s, sq = np.zeros(vf[:, 0].shape, np.float32), np.zeros(vf[:, 0].shape, np.float32)
    for j in range(k):
        s, sq = s + vf[:, j], sq + vf[:, j] * vf[:, j]
    np.testing.assert_array_equal(_tbits(stats), np.concatenate([s, sq], -1).view(np.uint32))
    _, ref_both = gs_mod.presum_stats_plain(torch.from_numpy(table)[b.senders.long()], torch.from_numpy(mask), k)
    np.testing.assert_array_equal(_tbits(both), _tbits(ref_both))


def _sorted_case(seed, n=40, e=600, w=6):
    rng = np.random.default_rng(seed)
    ids = np.sort(rng.choice(np.arange(0, n, 2), size=e)).astype(np.int32)  # odd rows empty
    data = _table(seed, e, w)
    mask = rng.random(e) > 0.3
    mask[ids == 4] = False  # an all-masked row
    return data, ids, n, mask


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
def test_segment_sum_plain_matches_jax(masked, dtype, monkeypatch):
    data, ids, n, mask = _sorted_case(3)
    td = torch.from_numpy(data).to(getattr(torch, dtype))
    m = mask if masked else None
    out = ss_mod.segment_sum(td, torch.from_numpy(ids), n, None if m is None else torch.from_numpy(m))
    assert out.dtype == torch.float32
    jd = jnp.asarray(data).astype(getattr(jnp, dtype))
    jm = None if m is None else jnp.asarray(m)
    xla = jsp.segment_sum_fast(jd, jnp.asarray(ids), n, jm, indices_are_sorted=True)
    monkeypatch.setenv("HYDRAGNN_PALLAS", "interpret")
    pallas = jsp.segment_sum_fast(jd, jnp.asarray(ids), n, jm, indices_are_sorted=True)
    for ref in (xla, pallas):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **SUM_TOL)
    assert (out.numpy()[1::2] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("order", ["sorted", "local"])
def test_gather_rows_plain_matches_pallas_bcast(order, dtype):
    b, jb, _ = _aligned_batch(9)
    ids = (b.receivers if order == "sorted" else b.senders).numpy()
    table = _table(9, b.num_nodes, 128)
    out = gr_mod.gather_rows(torch.from_numpy(table).to(getattr(torch, dtype)), torch.from_numpy(ids))
    jt = jnp.asarray(table).astype(getattr(jnp, dtype))
    ref = jsp._bcast_kernel_call(jt, jnp.asarray(ids), interpret=True, sorted_ids=order == "sorted")
    np.testing.assert_array_equal(_tbits(out), _bits(ref))
    np.testing.assert_array_equal(_tbits(out), _bits(jt[jnp.asarray(ids)]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_segment_sum_local_plain_matches_jax(dtype):
    b, jb, _ = _aligned_batch(12)
    data = _table(12, b.num_edges, 24)  # quarter grid: every order sums exactly
    td = torch.from_numpy(data).to(getattr(torch, dtype))
    out = sl_mod.segment_sum_local(td, b.senders, b.sender_win, b.num_nodes)
    jd = jnp.asarray(data).astype(getattr(jnp, dtype))
    pallas = jsp.segment_sum_local_pallas(jd, jb.senders, jb.sender_win, b.num_nodes, interpret=True)
    xla = jax.ops.segment_sum(jd.astype(jnp.float32), jb.senders, b.num_nodes)
    for ref in (pallas, xla):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **SUM_TOL)


@pytest.mark.parametrize("h", [3, 24])
def test_segment_sum_local_edge_cases_match_jax(h):
    """The card tests' B4 edge cases (``b4_edge_case``: overlapping
    windows holding other blocks' ids, an empty block, a row with 20,000
    edges) through the plain version, the Pallas kernel in interpret
    mode and XLA's segment sum, on the 1/4 grid."""
    data, ids, win, n = b4_edge_case(h, h, values="grid")
    out = sl_mod.segment_sum_local(torch.from_numpy(data), torch.from_numpy(ids), torch.from_numpy(win), n)
    jd, jids = jnp.asarray(data), jnp.asarray(ids)
    pallas = jsp.segment_sum_local_pallas(jd, jids, jnp.asarray(win), n, interpret=True)
    xla = jax.ops.segment_sum(jd, jids, n)
    for ref in (pallas, xla):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **SUM_TOL)
    assert (ids == 70).sum() >= 20_000 and out[70].abs().sum() > 0
    assert not out[128:192].any()  # the empty block


def test_segment_sum_local_rejects_a_foreign_window_plan():
    b, _, _ = _aligned_batch(13)
    data = torch.zeros(b.num_edges, 4)
    # 4 blocks of 32 rows cover 128 rows; for 40 rows the derived block
    # is 16, and 3 blocks would do: the plan was made for another size
    with pytest.raises(ValueError, match="different num_segments"):
        sl_mod.segment_sum_local(data, b.senders, b.sender_win, 40)
    with pytest.raises(ValueError, match="different num_segments"):
        jsp.segment_sum_local_pallas(jnp.zeros((b.num_edges, 4)), jnp.asarray(b.senders.numpy()),
                                     jnp.asarray(b.sender_win.numpy()), 40, interpret=True)


@pytest.mark.parametrize("is_max", [True, False])
def test_segment_extremum_vjp_matches_jax(is_max):
    """``segment_max``/``segment_min`` over sorted ids: values bit-equal,
    and the gradient split evenly among tied extrema (as
    ``_segment_extremum_bwd``), with masked entries, an all-masked row
    and empty rows cleaned to 0."""
    data, ids, n, mask = _sorted_case(7 + is_max)
    rng = np.random.default_rng(1)
    g = rng.normal(size=(n, data.shape[1])).astype(np.float32)
    op_t = tseg.segment_max if is_max else tseg.segment_min
    op_j = jseg.segment_max if is_max else jseg.segment_min

    def ref(d):
        return op_j(d, jnp.asarray(ids), n, mask=jnp.asarray(mask), indices_are_sorted=True)

    jout, vjp = jax.vjp(ref, jnp.asarray(data))
    (jg,) = vjp(jnp.asarray(g))
    d = torch.from_numpy(data).requires_grad_(True)
    out = op_t(d, torch.from_numpy(ids), n, torch.from_numpy(mask), indices_are_sorted=True)
    out.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(jout))
    np.testing.assert_allclose(d.grad.numpy(), np.asarray(jg), **GRAD_TOL)
    assert (out.detach().numpy()[4] == 0).all() and (out.detach().numpy()[1::2] == 0).all()


@pytest.mark.parametrize("grad_dtype", [None, "bfloat16"])
def test_segment_sum_sorted_vjp_matches_jax(grad_dtype):
    data, ids, n, _ = _sorted_case(4)
    g = np.random.default_rng(2).normal(size=(n, data.shape[1])).astype(np.float32)
    jgd = None if grad_dtype is None else jnp.bfloat16
    tgd = None if grad_dtype is None else torch.bfloat16
    jout, vjp = jax.vjp(lambda d: jseg.segment_sum_sorted(d, jnp.asarray(ids), n, jgd), jnp.asarray(data))
    (jg,) = vjp(jnp.asarray(g))
    d = torch.from_numpy(data).requires_grad_(True)
    out = tseg.segment_sum_sorted(d, torch.from_numpy(ids), n, grad_dtype=tgd)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **SUM_TOL)
    np.testing.assert_array_equal(d.grad.numpy(), np.asarray(jg))  # a gather of g: exact


@pytest.mark.parametrize("kind", ["sorted", "unsorted", "local"])
def test_gather_rows_vjp_matches_jax(kind):
    b, jb, _ = _aligned_batch(15)
    table = _table(15, b.num_nodes, 5)
    ids = b.receivers if kind == "sorted" else b.senders
    jids = jb.receivers if kind == "sorted" else jb.senders
    g = np.random.default_rng(3).normal(size=(b.num_edges, 5)).astype(np.float32)
    if kind == "local":
        jfn = lambda t: jseg.gather_rows_local(t, jids, jb.sender_win, b.num_nodes)  # noqa: E731
    else:
        jfn = lambda t: jseg.gather_rows(t, jids, b.num_nodes, kind == "sorted")  # noqa: E731
    jout, vjp = jax.vjp(jfn, jnp.asarray(table))
    (jg,) = vjp(jnp.asarray(g))
    t = torch.from_numpy(table).requires_grad_(True)
    if kind == "local":
        out = tseg.gather_rows_local(t, ids, b.sender_win, b.num_nodes)
    else:
        out = tseg.gather_rows(t, ids, b.num_nodes, indices_are_sorted=kind == "sorted")
    out.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(jout))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), **SUM_TOL)


def test_cpu_path_never_counts_a_launch():
    b, _, mask = _aligned_batch(1)
    mods = (gs_mod, ss_mod, gr_mod, sl_mod)
    before = [m.launches.value for m in mods]
    t = torch.from_numpy(_table(1, b.num_nodes, 3)).requires_grad_(True)
    s, m = gather_presum_stats(t, b.senders, torch.from_numpy(mask), b.sender_win, b.num_nodes, K)
    recv8 = b.receivers[::K].contiguous()
    (tseg.segment_sum_sorted(s, recv8, b.num_nodes).sum()
     + tseg.segment_max(m, recv8, b.num_nodes, indices_are_sorted=True).sum()).backward()
    assert [m.launches.value for m in mods] == before
    with pytest.raises(ValueError):
        gather_stats(t.detach(), b.senders[:-1], torch.from_numpy(mask)[:-1], K)  # not a multiple of K
