"""The occupancy bound of the sorted segment sum (B2), the windowed
segment sum (B4) and the PNA aggregation forward and backward (B5, B6,
B7), on the CPU: the plain versions with a bound, and the model's steps
at batch 128 with the batch's ``edge_occupancy`` and without it.

At batch 128 the loader's pad plan covers the 128 largest graphs, so a
batch of smaller ones ends in a masked tail: one run of slots at the
padding node past ``edge_occupancy``. The chassis hands that bound to
every B2 and B4 call on the shipped paths (``models/convs.py``); B2 and
B4 then never walk the tail. The bound is valid only where every data
row past it adds nothing that is read, so each caller is held here to
the result without the bound, bit for bit: the loss, every gradient,
the BatchNorm statistics and the padding node's aggregates (exact
zeros). The sorted segment max's tie count is the one caller whose
data past the bound is not zero (the tail's all-masked K-groups tie the
padding node's fill value); its gradient stays bit-equal because the
padding node's cotangent is exactly zero.

The flagship's batch-128 step, on the run-aligned layout and on the
unaligned one (whose masked tail is one receiver row at the padding
node, which B5, B6 and B7 walk), is also held to the JAX package's step
on the same batch and weights, within ``tests/test_torch_train.py``'s
tiers (loss and per-head losses ``rtol=1e-4``; gradients and BatchNorm
statistics ``rtol=1e-4, atol=1e-5``: matrix products and sums
accumulate in another order in the two frameworks). The PNA plain
versions are held bit for bit: a bound over a masked tail changes no
bit, and with junk past the bound (unmasked, NaN, inf) they equal their
results on the input cut at the bound.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hydragnn_tpu.data.ingest import prepare_dataset as jax_prepare_dataset
from hydragnn_tpu.data.loader import GraphLoader as JaxGraphLoader
from hydragnn_tpu.data.synthetic import deterministic_graph_data as jax_data
from hydragnn_tpu.flagship import flagship_config as jax_flagship_config
from hydragnn_tpu.models.base import HydraModel as JaxHydraModel
from hydragnn_tpu.models.base import model_loss as jax_model_loss
from hydragnn_tpu.models.create import model_config_from_dict as jax_model_config
from hydragnn_tpu.utils.config import update_config as jax_update_config

from hydragnn_tpu_torch.convert import variables_from_flax
from hydragnn_tpu_torch.data.ingest import prepare_dataset
from hydragnn_tpu_torch.data.loader import GraphLoader
from hydragnn_tpu_torch.data.synthetic import deterministic_graph_data
from hydragnn_tpu_torch.flagship import flagship_config
from hydragnn_tpu_torch.graph import segment as S
from hydragnn_tpu_torch.models.base import model_loss
from hydragnn_tpu_torch.models.create import create_model_config
from hydragnn_tpu_torch.ops import pna_aggregate as pna_mod
from hydragnn_tpu_torch.ops import pna_aggregate_bwd as bwd_mod
from hydragnn_tpu_torch.ops import segment_sum as ss_mod
from hydragnn_tpu_torch.ops import segment_sum_local as sl_mod
from hydragnn_tpu_torch.ops.gather_stats import gather_presum_stats
from hydragnn_tpu_torch.utils.config import update_config

from test_torch_cuda_kernels import b4_edge_case

TOL = dict(rtol=1e-4, atol=1e-5)
UNIT = dict(unit_cell_x_range=(2, 4), unit_cell_y_range=(2, 4), unit_cell_z_range=(2, 4))
BATCH, HIDDEN, LAYERS, SAMPLES = 128, 8, 2, 200


def _bits(t):
    t = t.detach()
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t.view(torch.int32)


def _same_bits(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))


def _sorted_case(seed, dtype, w=5, e=3000, n=200):
    """Sorted ids over ``n`` rows (some empty, some out of range at both
    ends), data [e, w] of ``dtype`` and a mask."""
    rng = np.random.default_rng(seed)
    ids = np.sort(rng.integers(-3, n + 3, e)).astype(np.int32)
    data = torch.from_numpy(rng.normal(size=(e, w)).astype(np.float32)).to(dtype)
    mask = torch.from_numpy(rng.random(e) > 0.2)
    return data, torch.from_numpy(ids), mask, n


def _bound(r):
    return torch.tensor(r, dtype=torch.int32)


# -- the plain versions ------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", [False, True])
def test_segment_sum_plain_bound_skips_a_zero_tail_and_ignores_what_lies_past_it(masked, dtype):
    data, ids, mask, n = _sorted_case(1, dtype)
    mask = mask if masked else None
    for r in (0, 1, 1234, 2999):
        tail_zero = data.clone()
        tail_zero[r:] = 0
        want = ss_mod.segment_sum_plain(tail_zero, ids, n, mask)
        # on data whose tail is zero the bound changes nothing
        assert _same_bits(ss_mod.segment_sum(tail_zero, ids, n, mask, real_rows=_bound(r)), want)
        # non-zero data past the bound (inf and NaN too) are never read
        garbage = data.clone()
        garbage[r:] = float("nan")
        garbage[r::3] = float("inf")
        assert _same_bits(ss_mod.segment_sum(garbage, ids, n, mask, real_rows=_bound(r)), want)
        assert _same_bits(ss_mod.segment_sum_plain(garbage, ids, n, mask, real_rows=_bound(r)), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_segment_sum_plain_bound_zero_gives_zeros_and_a_bound_past_the_end_changes_nothing(dtype):
    data, ids, mask, n = _sorted_case(2, dtype)
    zero = ss_mod.segment_sum(data, ids, n, mask, real_rows=_bound(0))
    assert _same_bits(zero, torch.zeros(n, data.shape[1]))
    want = ss_mod.segment_sum(data, ids, n, mask)
    for r in (data.shape[0], data.shape[0] + 7, 2 ** 31 - 1):
        assert _same_bits(ss_mod.segment_sum(data, ids, n, mask, real_rows=_bound(r)), want)
    assert _same_bits(ss_mod.segment_sum(data, ids, n, mask, real_rows=_bound(-5)), zero)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h", [1, 128])
def test_segment_sum_local_plain_bound(h, dtype):
    """B4's plain version on its edge cases (overlapping windows, an
    empty block, a row of 20,000 edges): a bound cuts every window."""
    data_np, ids_np, win_np, n = b4_edge_case(h, h + 11)
    data, ids, win = torch.from_numpy(data_np).to(dtype), torch.from_numpy(ids_np), torch.from_numpy(win_np)
    e = data.shape[0]
    assert _same_bits(sl_mod.segment_sum_local(data, ids, win, n, real_edges=_bound(0)), torch.zeros(n, h))
    full = sl_mod.segment_sum_local(data, ids, win, n)
    for r in (e, e + 1):
        assert _same_bits(sl_mod.segment_sum_local(data, ids, win, n, real_edges=_bound(r)), full)
    for r in (1, 5000, e - 3):
        tail_zero = data.clone()
        tail_zero[r:] = 0
        want = sl_mod.segment_sum_local_plain(tail_zero, ids, n)
        garbage = data.clone()
        garbage[r:] = float("nan")
        assert _same_bits(sl_mod.segment_sum_local(tail_zero, ids, win, n, real_edges=_bound(r)), want)
        assert _same_bits(sl_mod.segment_sum_local(garbage, ids, win, n, real_edges=_bound(r)), want)


@pytest.mark.parametrize("bad", [torch.tensor([3, 4], dtype=torch.int32), torch.tensor(3, dtype=torch.int64),
                                 torch.tensor(3.0)])
def test_bound_must_be_one_int32(bad):
    data, ids, mask, n = _sorted_case(3, torch.float32)
    with pytest.raises(TypeError):
        ss_mod.segment_sum(data, ids, n, real_rows=bad)
    data_np, ids_np, win_np, n4 = b4_edge_case(4, 3)
    with pytest.raises(TypeError):
        sl_mod.segment_sum_local(torch.from_numpy(data_np), torch.from_numpy(ids_np), torch.from_numpy(win_np), n4,
                                 real_edges=bad)


def _pna_tail_case(seed, dtype, h=5, n=60, e=700, tail=300):
    """Sorted receivers over rows 0..n-2 (some empty), values on a 1/4
    grid (ties) and random masked edges, then a masked tail of ``tail``
    slots at the padding row n - 1 with v = 0 (its cleaned max), as a
    batch's tail past its occupancy ``e``; the backward's cotangents."""
    rng = np.random.default_rng(seed)
    recv = np.concatenate([np.sort(rng.integers(0, n - 1, e)), np.full(tail, n - 1)]).astype(np.int32)
    v = (np.round(rng.normal(size=(e + tail, h)) * 4.0) / 4.0 + 0.0).astype(np.float32)
    v[e:] = 0.0
    mask = rng.random(e + tail) > 0.2
    mask[e:] = False
    cots = [rng.normal(size=(n, h)).astype(np.float32), rng.normal(size=(n, h)).astype(np.float32),
            rng.normal(size=(n, 2 * h)).astype(np.float32)]
    t = torch.from_numpy
    return (t(v).to(dtype), t(recv), t(mask), n, e,
            (t(cots[0]), t(cots[1]), t(cots[2]).to(dtype)))


def _pna_plain(v, recv, mask, n, cots, bound):
    """B5's four outputs, B6's counts and B7's gradient from the plain
    versions with ``bound``; B6 and B7 on the unbounded forward's maxima
    (the backward's inputs)."""
    fwd = pna_mod.pna_aggregate_plain(v, recv, n, mask, real_edges=bound)
    both = pna_mod.pna_aggregate_plain(v, recv, n, mask)[3]
    cnt = bwd_mod.pna_bwd_count_plain(v, recv, mask, both, n, real_edges=bound)
    grad = bwd_mod.pna_bwd_grad_plain(v, recv, mask, both, *cots, cnt, real_edges=bound)
    return list(fwd) + [cnt, grad]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pna_plain_bound_over_a_masked_tail_changes_no_bit(dtype):
    v, recv, mask, n, occ, cots = _pna_tail_case(4, dtype)
    want = _pna_plain(v, recv, mask, n, cots, None)
    for r in (occ, occ + 1, occ + 299):
        for a, b in zip(_pna_plain(v, recv, mask, n, cots, _bound(r)), want):
            assert _same_bits(a, b)
    # the padding row: no count, maxima cleaned to 0, no tie, no gradient
    s, sq, cnt, both, ties, grad = want
    assert float(cnt[n - 1]) == 0.0 and not bool(both[n - 1].any()) and not bool(ties[n - 1].any())
    assert not bool(grad[occ:].any()) and float(ties.max()) >= 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r", [1, 123, 699])
def test_pna_plain_bound_ignores_junk_past_it(r, dtype):
    """Unmasked junk (normal values, NaN, inf) past the bound: B5 and B6
    equal their results on the input cut at the bound, and B7 equals its
    result there on the first ``r`` edges and is 0 past them."""
    v, recv, mask, n, _, cots = _pna_tail_case(5, dtype)
    junk = v.clone()
    junk[r:] = torch.randn(junk.shape[0] - r, junk.shape[1]).to(dtype)
    junk[r::3] = float("nan")
    junk[r + 1::5] = float("inf")
    open_mask = mask.clone()
    open_mask[r:] = True
    bound = _bound(r)
    fwd = pna_mod.pna_aggregate_plain(junk, recv, n, open_mask, real_edges=bound)
    cut = pna_mod.pna_aggregate_plain(v[:r], recv[:r], n, mask[:r])
    for a, b in zip(fwd, cut):
        assert _same_bits(a, b)
    both = cut[3]
    cnt = bwd_mod.pna_bwd_count_plain(junk, recv, open_mask, both, n, real_edges=bound)
    assert _same_bits(cnt, bwd_mod.pna_bwd_count_plain(v[:r], recv[:r], mask[:r], both, n))
    grad = bwd_mod.pna_bwd_grad_plain(junk, recv, open_mask, both, *cots, cnt, real_edges=bound)
    want = bwd_mod.pna_bwd_grad_plain(v[:r], recv[:r], mask[:r], both, *cots, cnt)
    assert _same_bits(grad[:r], want)
    assert _same_bits(grad[r:], torch.zeros(grad.shape[0] - r, grad.shape[1], dtype=dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pna_plain_bound_zero_gives_zeros_and_a_bound_past_the_end_changes_nothing(dtype):
    v, recv, mask, n, _, cots = _pna_tail_case(6, dtype)
    mask = torch.ones_like(mask)  # every slot real: the bound alone decides
    zero = _pna_plain(v, recv, mask, n, cots, _bound(0))
    for t in zero:
        assert not bool(t.any()) and not bool(torch.signbit(t.float()).any())
    want = _pna_plain(v, recv, mask, n, cots, None)
    for r in (v.shape[0], v.shape[0] + 7, 2 ** 31 - 1):
        for a, b in zip(_pna_plain(v, recv, mask, n, cots, _bound(r)), want):
            assert _same_bits(a, b)
    for a, b in zip(_pna_plain(v, recv, mask, n, cots, _bound(-5)), zero):
        assert _same_bits(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pna_bwd_plain_drops_receivers_out_of_range(dtype):
    """B6 and B7's plain versions, as the kernels do: an edge whose
    receiver lies outside [0, N) belongs to no row (no count) and gets a
    zero gradient; the other edges are as without it."""
    v, recv, mask, n, occ, cots = _pna_tail_case(7, dtype)
    out = recv.clone()
    out[:9] = -1
    out[-9:] = n
    keep = (out >= 0) & (out < n)
    both = pna_mod.pna_aggregate_plain(v[keep], out[keep], n, mask[keep])[3]
    cnt = bwd_mod.pna_bwd_count_plain(v, out, mask, both, n)
    assert _same_bits(cnt, bwd_mod.pna_bwd_count_plain(v[keep], out[keep], mask[keep], both, n))
    grad = bwd_mod.pna_bwd_grad_plain(v, out, mask, both, *cots, cnt)
    assert _same_bits(grad[keep], bwd_mod.pna_bwd_grad_plain(v[keep], out[keep], mask[keep], both, *cots, cnt))
    assert not bool(grad[~keep].any())


@pytest.mark.parametrize("bad", [torch.tensor([3, 4], dtype=torch.int32), torch.tensor(3, dtype=torch.int64),
                                 torch.tensor(3.0)])
def test_pna_bound_must_be_one_int32(bad):
    v, recv, mask, n, _, (g_sum, g_sumsq, g_both) = _pna_tail_case(8, torch.float32)
    both = pna_mod.pna_aggregate_plain(v, recv, n, mask)[3]
    cnt = bwd_mod.pna_bwd_count_plain(v, recv, mask, both, n)
    calls = [
        lambda: pna_mod.pna_aggregate(v, recv, n, mask, real_edges=bad),
        lambda: pna_mod.pna_aggregate(v.clone().requires_grad_(True), recv, n, mask, real_edges=bad),
        lambda: bwd_mod.pna_bwd_count(v, recv, mask, both, n, real_edges=bad),
        lambda: bwd_mod.pna_bwd_grad(v, recv, mask, both, g_sum, g_sumsq, g_both, cnt, real_edges=bad),
        lambda: bwd_mod.pna_aggregate_bwd(v, recv, mask, both, g_sum, g_sumsq, g_both, n, real_edges=bad),
    ]
    for call in calls:
        with pytest.raises(TypeError, match="bound"):
            call()


# -- the model's steps at batch 128 ---------------------------------------------


def _prepared(model_type="PNA", **arch):
    cfg = flagship_config(HIDDEN, LAYERS, BATCH)
    cfg["NeuralNetwork"]["Architecture"].update(model_type=model_type, **arch)
    samples = deterministic_graph_data(number_configurations=SAMPLES, seed=2, **UNIT)
    tr, va, te, _, _ = prepare_dataset(samples, cfg)
    return tr, update_config(cfg, tr, va, te)


@pytest.fixture(scope="module")
def flagship_128():
    return _prepared()


def _first_batch(tr, **loader):
    batch = next(iter(GraphLoader(tr, BATCH, **loader)))
    occ = int(batch.edge_occupancy)
    # the masked tail: every slot past the occupancy is masked, at the
    # padding node, and there are many of them
    assert occ < batch.num_edges - 1000
    pad = int(batch.n_real_nodes)
    assert not bool(batch.edge_mask[occ:].any())
    assert bool((batch.receivers[occ:] == pad).all()) and bool((batch.senders[occ:] == pad).all())
    return batch


def _step(model, batch):
    """Loss, per-head losses, every gradient and the BatchNorm statistics
    of one train-mode forward and backward on a copy of ``model``."""
    m = copy.deepcopy(model)
    loss, tasks = model_loss(m.cfg, m(batch, train=True), batch)
    loss.backward()
    grads = {k: p.grad.detach().clone() for k, p in m.named_parameters()}
    stats = {k: v.clone() for k, v in m.state_dict().items() if "running" in k}
    return loss.detach(), torch.stack(tasks).detach(), grads, stats


def _assert_bit_equal_with_and_without_the_bound(model, batch):
    unbounded = dataclasses.replace(batch, edge_occupancy=None)
    (l1, t1, g1, s1), (l0, t0, g0, s0) = _step(model, batch), _step(model, unbounded)
    assert _same_bits(l1, l0) and _same_bits(t1, t0)
    assert g1.keys() == g0.keys() and s1.keys() == s0.keys()
    for k in g0:
        assert _same_bits(g1[k], g0[k]), k
        assert bool(torch.isfinite(g1[k]).all()), k
    for k in s0:
        assert _same_bits(s1[k], s0[k]), k
    assert bool(torch.isfinite(l1))
    return l1, t1, g1, s1


def test_flagship_run_aligned_step_at_batch_128_is_bit_equal_with_and_without_the_bound(flagship_128):
    tr, cfg = flagship_128
    batch = _first_batch(tr)
    assert batch.run_align == 8
    model = create_model_config(cfg["NeuralNetwork"], seed=3, device="cpu")
    _assert_bit_equal_with_and_without_the_bound(model, batch)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flagship_run_aligned_aggregates_and_padding_node_with_and_without_the_bound(flagship_128, dtype):
    """The run-aligned PNA aggregation's ops at batch 128, as PNAConv calls
    them: B1's op, the K-group sum (B2) and the sorted segment max, whose
    backward counts ties with B2. Outputs and the table's gradient
    bit-equal with the bound and without it; the padding node's sums
    exact zeros and its maxima cleaned to 0 either way."""
    tr, _ = flagship_128
    b = _first_batch(tr)
    k, n, pad = b.run_align, b.num_nodes, int(b.n_real_nodes)
    recv8 = b.receivers[::k].contiguous()
    group_occ = torch.div(b.edge_occupancy + (k - 1), k, rounding_mode="floor")
    assert int(group_occ) * k == int(b.edge_occupancy)
    rng = np.random.default_rng(7)
    table_np = (np.round(rng.normal(size=(n, 6)) * 4.0) / 4.0).astype(np.float32)  # ties
    g_pair = torch.from_numpy(rng.normal(size=(n, 12)).astype(np.float32))
    g_max = torch.from_numpy(rng.normal(size=(n, 12)).astype(np.float32)).to(dtype)
    out = {}
    for label, occ, gocc in (("bound", b.edge_occupancy, group_occ), ("none", None, None)):
        table = torch.from_numpy(table_np).to(dtype).requires_grad_(True)
        stats8, both8 = gather_presum_stats(table, b.senders, b.edge_mask, b.sender_win, n, k, real_edges=occ)
        pair = S.segment_sum_sorted(stats8, recv8, n, grad_dtype=dtype, real_rows=gocc)
        both = S.segment_max(both8, recv8, n, indices_are_sorted=True, empty_value=0.0, real_rows=gocc)
        torch.autograd.backward((pair, both), (g_pair, g_max))
        out[label] = (pair.detach(), both.detach(), table.grad)
    for a, c in zip(out["bound"], out["none"]):
        assert _same_bits(a, c)
    pair, both, grad = out["bound"]
    assert _same_bits(pair[pad], torch.zeros(12)) and _same_bits(both[pad], torch.zeros(12, dtype=dtype))
    assert bool(torch.isfinite(grad.float()).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flagship_unaligned_aggregates_and_padding_node_with_and_without_the_bound(flagship_128, dtype):
    """``pna_aggregate`` (B5 forward, B6 and B7 backward) on the
    flagship's unaligned batch of 128, as PNAConv calls it: the four
    outputs and v's gradient bit-equal with the batch's occupancy and
    without it; the padding node's row (the masked tail) empty and
    cleaned to 0 either way, and the tail's gradient exact zeros."""
    tr, _ = flagship_128
    b = _first_batch(tr, run_align=False, dense_slots=False)
    n, e, occ, pad = b.num_nodes, b.num_edges, int(b.edge_occupancy), int(b.n_real_nodes)
    assert bool((b.receivers[occ:] == pad).all())
    rng = np.random.default_rng(9)
    v_np = (np.round(rng.normal(size=(e, 6)) * 4.0) / 4.0).astype(np.float32)  # ties
    v_np[~b.edge_mask.numpy()] = 0.0  # gathered from the padding node's zero row
    cots = [torch.from_numpy(rng.normal(size=(n, w)).astype(np.float32)) for w in (6, 6, 12)]
    cots[2] = cots[2].to(dtype)
    out = {}
    for label, bound in (("bound", b.edge_occupancy), ("none", None)):
        v = torch.from_numpy(v_np).to(dtype).requires_grad_(True)
        s, sq, cnt, both = pna_mod.pna_aggregate(v, b.receivers, n, b.edge_mask, real_edges=bound)
        torch.autograd.backward((s, sq, both), tuple(cots))
        out[label] = (s.detach(), sq.detach(), cnt, both.detach(), v.grad)
    for a, c in zip(out["bound"], out["none"]):
        assert _same_bits(a, c)
    s, sq, cnt, both, grad = out["bound"]
    assert float(cnt[pad]) == 0.0 and not bool(both[pad].any()) and not bool(s[pad].any())
    assert not bool(grad[occ:].any()) and bool(grad[:occ].any())


def _step_matches_jax(tr, cfg, **layout):
    """The port's batch-128 step with the bound (held bit-equal to the
    step without it) against the JAX package's step on the same batch
    and weights, on the loaders' ``layout``."""
    jcfg = jax_flagship_config(HIDDEN, LAYERS, BATCH)
    jsamples = jax_data(number_configurations=SAMPLES, seed=2, **UNIT)
    jtr, jva, jte, _, _ = jax_prepare_dataset(jsamples, jcfg)
    jcfg = jax_update_config(jcfg, jtr, jva, jte)
    jbatch = next(iter(JaxGraphLoader(jtr, BATCH, prefetch=0, **layout)))
    batch = _first_batch(tr, **layout)
    # the same real slots (the JAX loader pads the tail further, to its
    # TPU grid: 110,592 slots against the port's 108,840 run-aligned)
    occ = int(batch.edge_occupancy)
    assert occ == int(jbatch.edge_occupancy) and batch.num_edges <= jbatch.senders.shape[0]
    np.testing.assert_array_equal(batch.senders[:occ].numpy(), np.asarray(jbatch.senders)[:occ])
    np.testing.assert_array_equal(batch.edge_mask[:occ].numpy(), np.asarray(jbatch.edge_mask)[:occ])
    jmodel = JaxHydraModel(jax_model_config(jcfg["NeuralNetwork"]))
    variables = jax.jit(lambda bb: jmodel.init(jax.random.PRNGKey(0), bb, train=False))(jbatch)

    @jax.jit
    def jgrads(params, stats, bb):
        def loss_fn(p):
            outs, mut = jmodel.apply({"params": p, "batch_stats": stats}, bb, train=True, mutable=["batch_stats"])
            total, tasks = jax_model_loss(jmodel.cfg, [o.astype(jnp.float32) for o in outs], bb)
            return total, (jnp.stack(tasks), mut["batch_stats"])

        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    (jloss, (jtasks, jstats)), jg = jgrads(variables["params"], variables["batch_stats"], jbatch)
    model = create_model_config(cfg["NeuralNetwork"], device="cpu")
    model.load_state_dict(variables_from_flax(variables), strict=True)
    loss, tasks, grads, stats = _assert_bit_equal_with_and_without_the_bound(model, batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    np.testing.assert_allclose(tasks.numpy(), np.asarray(jtasks), rtol=1e-4)
    want = variables_from_flax({"params": jax.tree_util.tree_map(np.asarray, jg)})
    for name, grad in grads.items():
        np.testing.assert_allclose(grad.numpy(), want[name].numpy(), err_msg=name, **TOL)
    want_stats = variables_from_flax({"params": variables["params"], "batch_stats": jstats})
    for name, value in stats.items():
        np.testing.assert_allclose(value.numpy(), want_stats[name].numpy(), err_msg=name, **TOL)
    return batch


def test_flagship_step_at_batch_128_matches_jax(flagship_128):
    """The port's run-aligned batch-128 step with the bound against the
    JAX package's step on the same batch and weights."""
    batch = _step_matches_jax(*flagship_128)
    assert batch.run_align == 8


def test_flagship_unaligned_step_at_batch_128_matches_jax(flagship_128):
    """The same on the unaligned layout: PNAConv's B5 forward and B6/B7
    backward take the bound (the masked tail is one row at the padding
    node)."""
    batch = _step_matches_jax(*flagship_128, run_align=False, dense_slots=False)
    assert batch.run_align == 0 and batch.dense_senders is None


@pytest.mark.parametrize("model_type,fused", [("GIN", True), ("GIN", False), ("CGCNN", True), ("CGCNN", False),
                                              ("PNA-unaligned", None)])
def test_stack_steps_at_batch_128_are_bit_equal_with_and_without_the_bound(model_type, fused):
    """GIN and CGCNN on the fused path (B8, then B4 and, for CGCNN's
    receiver tables, B2 in its backward) and on the composed path (the
    permuted sender gather and, for CGCNN, the sorted receiver gather,
    both with B2 backward; the masked sorted sum), and PNA on the
    unaligned layout (the permuted sender gather): bit-equal with the
    bound and without it."""
    if model_type == "PNA-unaligned":
        tr, cfg = _prepared()
        batch = _first_batch(tr, run_align=False, dense_slots=False)
        assert batch.run_align == 0
    else:
        tr, cfg = _prepared(model_type, fused_conv=fused)
        batch = _first_batch(tr)
    model = create_model_config(cfg["NeuralNetwork"], seed=4, device="cpu")
    _assert_bit_equal_with_and_without_the_bound(model, batch)
