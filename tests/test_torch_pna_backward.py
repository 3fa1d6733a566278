"""The backward of ``pna_aggregate`` (B6 and B7's plain versions), the
permuted gather and the run-aligned statistics with edge features,
against the JAX package: ``jax.vjp`` of the JAX op on its XLA path
(``HYDRAGNN_PALLAS=0``, the unfused composition) and on its Pallas
kernels in interpret mode (``HYDRAGNN_PALLAS=interpret``, K1/K2), set
through ``monkeypatch`` as ``tests/test_ops_pallas.py`` does. Inputs are
made with numpy from a seed: values on a 1/4 grid (deliberate ties),
empty segments, all-masked segments and random masked edges.

Tolerances and why:
  - f32 gradients ``rtol=1e-5, atol=1e-6`` (the same arithmetic; the
    tie terms are added in another order in the JAX package's unfused
    composition, and XLA may contract a multiply-add);
  - bf16 gradients ``rtol=2e-2, atol=2e-2``, the JAX package's own bf16
    bar for this op (``tests/test_ops_pallas.py``): the port's plain
    version combines in bf16 op by op, as the unfused composition does,
    while the Pallas K2 combines in f32 and rounds once, and XLA on the
    CPU may keep bf16 intermediates in f32;
  - tie counts exact; forward values as ``tests/test_torch_pna_aggregate.py``;
  - the permuted gather: values exact, gradients ``rtol=1e-6, atol=1e-6``
    (f32 sums in another order);
  - ``presum_stats_plain``: sums ``rtol=1e-6, atol=1e-6``, maxima exact,
    gradients ``rtol=1e-5, atol=1e-6``;
  - ``row_pointers`` (the row pointers B5, B6 and B7 walk on the card)
    exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hydragnn_tpu.graph import segment as JS
from hydragnn_tpu.ops.segment_pallas import _presum_stats_ref
from hydragnn_tpu.ops.segment_pallas import pna_aggregate as jax_pna_aggregate

from hydragnn_tpu_torch.graph import segment as S
from hydragnn_tpu_torch.ops import pna_aggregate as pna_mod
from hydragnn_tpu_torch.ops import pna_aggregate_bwd as bwd_mod
from hydragnn_tpu_torch.ops.gather_stats import presum_stats_plain
from hydragnn_tpu_torch.ops.row_pointers import row_pointers
from hydragnn_tpu_torch.ops.pna_aggregate import pna_aggregate
from hydragnn_tpu_torch.ops.pna_aggregate_bwd import (
    pna_aggregate_bwd,
    pna_aggregate_bwd_plain,
    pna_bwd_count_plain,
)

GRAD_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-6), torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
SUM_TOL = dict(rtol=1e-6, atol=1e-6)
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _grid(rng, shape, scale=4.0):
    return (np.round(rng.normal(size=shape) * scale) / 4.0 + 0.0).astype(np.float32)


def _case(h, seed, n=60, e=700, grid=True):
    """Sorted receivers (odd rows empty), rows 4 and 10 all masked,
    random masked edges; v and the cotangents on a 1/4 grid (ties, and
    every product exact) or, with ``grid=False``, normal draws (no ties;
    the products round)."""
    rng = np.random.default_rng(seed)
    recv = np.sort(rng.choice(np.arange(0, n, 2), size=e)).astype(np.int32)
    draw = _grid if grid else (lambda r, shape, scale=4.0: (r.normal(size=shape) * scale / 4.0).astype(np.float32))
    v = draw(rng, (e, h))
    mask = rng.random(e) > 0.25
    for dead in (4, 10):
        mask[recv == dead] = False
    g_sum, g_sumsq = draw(rng, (n, h), 1.0), draw(rng, (n, h), 1.0)
    g_both = draw(rng, (n, 2 * h), 1.0)
    return v, recv, n, mask, (g_sum, g_sumsq, g_both)


def _jax_grad(v, recv, n, mask, cots, dtype):
    g_sum, g_sumsq, g_both = cots
    vj = jnp.asarray(v).astype(JNP[dtype])
    mj = None if mask is None else jnp.asarray(mask)
    _, vjp = jax.vjp(lambda x: jax_pna_aggregate(x, jnp.asarray(recv), n, mask=mj, indices_are_sorted=True), vj)
    (g,) = vjp((jnp.asarray(g_sum), jnp.asarray(g_sumsq), jnp.zeros(n, jnp.float32),
                jnp.asarray(g_both).astype(JNP[dtype])))
    return np.asarray(g.astype(jnp.float32))


def _port_grad(v, recv, n, mask, cots, dtype):
    g_sum, g_sumsq, g_both = cots
    vt = torch.from_numpy(v).to(dtype).requires_grad_(True)
    mt = None if mask is None else torch.from_numpy(mask)
    s, sq, cnt, both = pna_aggregate(vt, torch.from_numpy(recv), n, mt)
    assert not cnt.requires_grad
    (g,) = torch.autograd.grad(
        (s, sq, both), vt,
        (torch.from_numpy(g_sum), torch.from_numpy(g_sumsq), torch.from_numpy(g_both).to(dtype)),
    )
    assert g.dtype == dtype
    return g.float().numpy()


@pytest.mark.parametrize("knob", ["0", "interpret"])
@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,grid", [(1, True), (128, True), (128, False)])
def test_pna_aggregate_grad_matches_jax_vjp(h, grid, dtype, masked, knob, monkeypatch):
    v, recv, n, mask, cots = _case(h, seed=10 * h + masked, grid=grid)
    if not masked:
        mask = None
    monkeypatch.setenv("HYDRAGNN_PALLAS", knob)
    want = _jax_grad(v, recv, n, mask, cots, dtype)
    got = _port_grad(v, recv, n, mask, cots, dtype)
    np.testing.assert_allclose(got, want, **GRAD_TOL[dtype])
    # the grid case really exercises ties, and the masked edges get nothing
    mt = None if mask is None else torch.from_numpy(mask)
    vt = torch.from_numpy(v).to(dtype)
    cnt = pna_bwd_count_plain(vt, torch.from_numpy(recv), mt, pna_aggregate(vt, torch.from_numpy(recv), n, mt)[3], n)
    assert float(cnt.max()) >= (2 if grid else 1)
    if mask is not None:
        assert (got[~mask] == 0).all()


def test_tie_counts_skip_masked_edges_by_mask_not_value():
    """Masked edges at the padding node carry v = 0 while that node's
    cleaned max is 0: they must not count (counts checked against a
    loop in numpy)."""
    rng = np.random.default_rng(3)
    n, h = 12, 3
    recv = np.sort(np.concatenate([rng.integers(0, n - 1, 50), np.full(9, n - 1)])).astype(np.int32)
    v = _grid(rng, (recv.size, h))
    mask = rng.random(recv.size) > 0.3
    mask[recv == n - 1] = False  # the padding node: every edge masked...
    v[recv == n - 1] = 0.0  # ...with v = 0, equal to its cleaned max
    vt, rt, mt = torch.from_numpy(v), torch.from_numpy(recv), torch.from_numpy(mask)
    both = pna_aggregate(vt, rt, n, mt)[3]
    assert (both[n - 1] == 0).all()
    cnt = pna_bwd_count_plain(vt, rt, mt, both, n).numpy()
    want = np.zeros((n, 2 * h), np.float32)
    for e in range(recv.size):
        if mask[e]:
            r = recv[e]
            want[r, :h] += v[e] == both[r, :h].numpy()
            want[r, h:] += -v[e] == both[r, h:].numpy()
    np.testing.assert_array_equal(cnt, want)
    assert (cnt[n - 1] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_dispatch_on_cpu_is_plain_and_counts_no_launch(dtype):
    v, recv, n, mask, (g_sum, g_sumsq, g_both) = _case(5, seed=4)
    args = (torch.from_numpy(v).to(dtype), torch.from_numpy(recv), torch.from_numpy(mask))
    both = pna_aggregate(args[0], args[1], n, args[2])[3]
    cot = (torch.from_numpy(g_sum), torch.from_numpy(g_sumsq), torch.from_numpy(g_both).to(dtype))
    before = (bwd_mod.count_launches.value, bwd_mod.grad_launches.value, pna_mod.launches.value)
    got = pna_aggregate_bwd(args[0], args[1], args[2], both, *cot, n)
    want = pna_aggregate_bwd_plain(args[0], args[1], args[2], both, *cot, n)
    assert got.dtype == dtype and torch.equal(got, want)
    assert (bwd_mod.count_launches.value, bwd_mod.grad_launches.value, pna_mod.launches.value) == before
    with pytest.raises(ValueError):
        pna_aggregate_bwd(args[0], args[1], args[2], both[:-1], *cot, n)


@pytest.mark.parametrize("h", [1, 16])
def test_gather_rows_permuted_matches_jax(h):
    rng = np.random.default_rng(20 + h)
    n, e = 50, 400
    x = _grid(rng, (n, h))
    ids = rng.integers(0, n, e).astype(np.int32)
    perm = np.argsort(ids, kind="stable").astype(np.int32)
    g = _grid(rng, (e, h), 1.0)
    out_j, vjp = jax.vjp(lambda t: JS.gather_rows_permuted(t, jnp.asarray(ids), jnp.asarray(perm), n), jnp.asarray(x))
    (gx_j,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = S.gather_rows_permuted(xt, torch.from_numpy(ids), torch.from_numpy(perm), n)
    out.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(out_j))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_j), **SUM_TOL)


@pytest.mark.parametrize("h", [1, 8])
def test_presum_stats_plain_matches_jax(h):
    """Values and gradients of the K-group statistics with ties and
    all-masked groups (the run-aligned layout with edge features)."""
    rng = np.random.default_rng(30 + h)
    k, groups = 8, 40
    v = _grid(rng, (k * groups, h))
    mask = rng.random(k * groups) > 0.3
    mask[16:24] = False  # a whole group masked
    g_stats = _grid(rng, (groups, 2 * h), 1.0)
    g_both = _grid(rng, (groups, 2 * h), 1.0)
    (js, jb), vjp = jax.vjp(lambda t: _presum_stats_ref(t, jnp.asarray(mask), k), jnp.asarray(v))
    (gv_j,) = vjp((jnp.asarray(g_stats), jnp.asarray(g_both)))
    vt = torch.from_numpy(v).requires_grad_(True)
    stats, both = presum_stats_plain(vt, torch.from_numpy(mask), k)
    torch.autograd.backward((stats, both), (torch.from_numpy(g_stats), torch.from_numpy(g_both)))
    np.testing.assert_allclose(stats.detach().numpy(), np.asarray(js), **SUM_TOL)
    np.testing.assert_array_equal(both.detach().numpy(), np.asarray(jb))
    np.testing.assert_allclose(vt.grad.numpy(), np.asarray(gv_j), rtol=1e-5, atol=1e-6)
    # ties split evenly: some group's max is shared
    assert float((vt.grad.abs() > 0).sum()) > 0 and (both.detach()[2] == torch.finfo(torch.float32).min).all()


@pytest.mark.parametrize("ids", ["in_range", "padding_tail", "out_of_range"])
def test_csr_row_ptr_is_first_edge_at_or_above_each_row(ids):
    """``row_pointers`` on the CPU gives what the pass on the card builds
    and B5, B6 and B7 walk: ``ptr[r]`` = the first edge whose receiver
    is >= r, for r in [0, N]; ids below 0 or at or above N belong to no
    row."""
    rng = np.random.default_rng(40)
    n = 30
    recv = np.sort(rng.integers(0, n, 200)).astype(np.int32)
    recv[recv == 7] = 8  # an empty row
    if ids == "padding_tail":
        recv[-20:] = n - 1
    elif ids == "out_of_range":
        recv = np.sort(np.concatenate([recv, [-3, -1, n, n + 5]])).astype(np.int32)
    ptr = row_pointers(torch.from_numpy(recv), n)
    want = np.array([(recv < r).sum() for r in range(n + 1)], dtype=np.int32)
    assert ptr.dtype == torch.int32
    np.testing.assert_array_equal(ptr.numpy(), want)


def test_gather_rows_permuted_needs_perm_only_for_its_backward():
    x = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    ids = torch.tensor([5, 0, 3, 3], dtype=torch.int32)
    with torch.no_grad():
        assert torch.equal(S.gather_rows_permuted(x, ids, None, 6), x[ids.long()])
    with pytest.raises(ValueError, match="permutation"):
        S.gather_rows_permuted(x.requires_grad_(True), ids, None, 6)


@pytest.mark.parametrize("h", [1, 16])
def test_gather_rows_permuted_masked_backward_matches_jax(h):
    """With a mask, the backward sums the unmasked positions only; where
    the masked ones carry a zero cotangent and name the largest id (the
    dense map's empty slots), that is JAX's full permuted backward."""
    rng = np.random.default_rng(50 + h)
    n, e = 40, 500
    x = _grid(rng, (n, h))
    mask = rng.random(e) > 0.4
    ids = np.where(mask, rng.integers(0, n - 1, e), n - 1).astype(np.int32)
    perm = np.argsort(ids, kind="stable").astype(np.int32)
    g = np.where(mask[:, None], _grid(rng, (e, h), 1.0), 0.0).astype(np.float32)
    _, vjp = jax.vjp(lambda t: JS.gather_rows_permuted(t, jnp.asarray(ids), jnp.asarray(perm), n), jnp.asarray(x))
    (gx_j,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = S.gather_rows_permuted(xt, torch.from_numpy(ids), torch.from_numpy(perm), n, mask=torch.from_numpy(mask))
    out.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(out.detach().numpy(), x[ids])
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_j), **SUM_TOL)
    assert (xt.grad[n - 1] == 0).all()


def test_segment_sum_plain_drops_ids_outside_the_rows():
    """B2's plain version drops ids outside [0, N), as the kernel's row
    pointers do (the masked permuted backward gives empty slots id N)."""
    from hydragnn_tpu_torch.ops.segment_sum import segment_sum

    data = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    ids = torch.tensor([-1, 0, 0, 2, 3, 3], dtype=torch.int32)
    got = segment_sum(data, ids, 3)
    want = torch.tensor([[6.0, 8.0], [0.0, 0.0], [6.0, 7.0]])
    assert torch.equal(got, want)
