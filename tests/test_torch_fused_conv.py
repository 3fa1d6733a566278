"""B8's plain version and its autograd op against the JAX package's
``fused_conv``: the XLA path (``_fused_ref``, every variant and every
activation of ``_ACTS``) and the Pallas kernel in interpret mode (one
case per variant, as ``tests/test_fused_conv.py`` runs it), on a
run-aligned batch with masked self-loop fillers, empty receivers and an
occupancy bound; gradients against ``jax.vjp`` of the same call.

Tolerances and why:
  - forward sums ``rtol=atol=1e-6``: the inputs are small, both sides
    sum the same f32 messages in another order; the branch variants'
    products ``v @ W`` run through two BLAS libraries;
  - gradients ``rtol=1e-5, atol=1e-6``: the same closed-form backward,
    its products and sums taken in another order.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hydragnn_tpu.ops.fused_conv import _ACTS as JAX_ACTS
from hydragnn_tpu.ops.fused_conv import fused_conv as jax_fused_conv

from hydragnn_tpu_torch.graph.batch import batch_graphs
from hydragnn_tpu_torch.ops import fused_conv as fc

from test_torch_cuda_kernels import b8_edge_case

SUM_TOL = dict(rtol=1e-6, atol=1e-6)
GRAD_TOL = dict(rtol=1e-5, atol=1e-6)
H = 8


def _batch():
    """A run-aligned batch (K = 8): 12 random graphs, receivers sorted,
    masked self-loop fillers at real nodes, a padding tail, and nodes
    with no incoming edge."""
    rng = np.random.default_rng(5)
    graphs = []
    for _ in range(12):
        n = int(rng.integers(3, 12))
        e = int(rng.integers(4, 30))
        s, r = rng.integers(0, n, e), rng.integers(1, n, e)  # node 0 of each graph: no edge in
        graphs.append({"x": np.zeros((n, 1), np.float32), "senders": s, "receivers": r})
    return batch_graphs(graphs, n_node_pad=128, n_edge_pad=560, n_graph_pad=13, run_align=8)


BATCH = _batch()


def _inputs(case, seed=0):
    """numpy inputs of one variant: (x, branches, acts, scale)."""
    rng = np.random.default_rng(seed)
    n, e = BATCH.num_nodes, BATCH.num_edges

    def arr(*shape, s=0.5):
        return (rng.normal(size=shape) * s).astype(np.float32)

    x = arr(n, H, s=1.0)
    scale = None
    if case == "identity":
        return x, (), (), None
    if case == "scale":
        return x, (), (), arr(e, H)
    if case.startswith("mlp_"):
        return x, ((arr(H, H), arr(H), None, None),), (case[4:],), None
    if case == "gate_rtab":
        return x, ((arr(H, H), None, arr(n, H), None), (arr(H, H), None, arr(n, H), None)), ("sigmoid", "softplus"), None
    if case == "gate_rtab_eterm":
        branches = ((arr(H, H), arr(H), arr(n, H), arr(e, H)), (arr(H, H), None, arr(n, H), arr(e, H)))
        return x, branches, ("sigmoid", "softplus"), None
    if case == "gate_scale":
        scale = arr(e, H)
        return x, ((arr(H, H), arr(H), None, arr(e, H)), (arr(H, H), None, arr(n, H), None)), ("tanh", "silu"), scale
    raise ValueError(case)


ALL_CASES = ["identity", "scale", "gate_rtab", "gate_rtab_eterm", "gate_scale"] + [f"mlp_{a}" for a in fc.ACTS]


def _torch_args(x, branches, scale, requires_grad=False):
    def t(a):
        if a is None:
            return None
        return torch.from_numpy(a).requires_grad_(requires_grad)

    return t(x), tuple(tuple(t(a) for a in br) for br in branches), t(scale)


def _jax_args(x, branches, scale):
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    return j(x), tuple(tuple(j(a) for a in br) for br in branches), j(scale)


def _jax_call(x, branches, acts, scale, win=True, occupancy=True):
    b = BATCH
    return jax_fused_conv(
        x, jnp.asarray(b.senders.numpy()), jnp.asarray(b.receivers.numpy()), jnp.asarray(b.edge_mask.numpy()),
        b.num_nodes, branches=branches, acts=acts, scale=scale,
        win=jnp.asarray(b.sender_win.numpy()) if win else None,
        real_edges=jnp.asarray(b.edge_occupancy.numpy()) if occupancy else None,
    )


def test_port_activations_are_the_reference_activations():
    assert list(fc.ACTS) == list(JAX_ACTS)
    z = np.linspace(-30.0, 30.0, 241).astype(np.float32)
    for name, (f, df) in fc.ACTS.items():
        jf, jdf = JAX_ACTS[name]
        a = f(torch.from_numpy(z))
        np.testing.assert_allclose(a.numpy(), np.asarray(jf(jnp.asarray(z))), rtol=1e-6, atol=1e-7, err_msg=name)
        np.testing.assert_allclose(
            df(torch.from_numpy(z), a).numpy(), np.asarray(jdf(jnp.asarray(z), jnp.asarray(a.numpy()))),
            rtol=1e-6, atol=1e-7, err_msg=name,
        )


@pytest.mark.parametrize("case", ALL_CASES)
def test_plain_matches_jax_xla_path(case, monkeypatch):
    monkeypatch.setenv("HYDRAGNN_PALLAS", "0")
    x, branches, acts, scale = _inputs(case)
    jx, jb, js = _jax_args(x, branches, scale)
    ref = _jax_call(jx, jb, acts, js)
    b = BATCH
    xt, bt, st = _torch_args(x, branches, scale)
    out = fc.fused_conv_plain(xt, b.senders, b.receivers, b.edge_mask, b.num_nodes, bt, acts, st)
    assert out.dtype == torch.float32 and out.shape == (b.num_nodes, H)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **SUM_TOL)
    # rows with no real edge in are exactly 0
    empty = b.in_degree.numpy() == 0
    assert empty.sum() > 10 and not out.numpy()[empty].any()
    # on a CPU tensor the wrapper is the plain version
    wrapped = fc.fused_conv(xt, b.senders, b.receivers, b.edge_mask, b.num_nodes, bt, acts, st, b.edge_occupancy)
    assert torch.equal(wrapped, out)


@pytest.mark.parametrize("case", ["identity", "scale", "mlp_relu", "gate_rtab_eterm"])
def test_plain_matches_jax_pallas_interpret(case, monkeypatch):
    """The TPU kernel itself (interpret mode), with the occupancy bound
    and the sender windows; 0.5-1 s per call on the CPU."""
    monkeypatch.setenv("HYDRAGNN_PALLAS", "interpret")
    x, branches, acts, scale = _inputs(case, seed=1)
    jx, jb, js = _jax_args(x, branches, scale)
    ref = _jax_call(jx, jb, acts, js)
    b = BATCH
    assert int(b.edge_occupancy) < b.num_edges
    xt, bt, st = _torch_args(x, branches, scale)
    out = fc.fused_conv_plain(xt, b.senders, b.receivers, b.edge_mask, b.num_nodes, bt, acts, st)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **SUM_TOL)


@pytest.mark.parametrize("h", [3, 126])
@pytest.mark.parametrize("variant", ["identity", "scale"])
@pytest.mark.parametrize("pallas", ["0", "interpret"])
def test_plain_matches_jax_on_walk_edge_cases(pallas, variant, h, monkeypatch):
    """The card tests' B8 walk edge cases (``b8_edge_case``: 50,000
    masked slots in one row between real ones, the occupancy bound below
    E, 300 masked slots past it) through the plain version and the JAX
    package's XLA path and Pallas kernel (interpret mode), on the 1/4
    grid. The two out-of-range senders, which the card's kernel drops,
    go to both as masked slots with sender 0."""
    monkeypatch.setenv("HYDRAGNN_PALLAS", pallas)
    x, _, recv, mask, n, real, scale, clean, clean_send = b8_edge_case(
        h, 11, values="grid", with_scale=variant == "scale")
    assert (recv == 7).sum() == 50_005 and real < recv.size and (mask & ~clean).sum() == 2
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    out = fc.fused_conv_plain(t(x), t(clean_send), t(recv), t(clean), n, (), (), t(scale))
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    ref = jax_fused_conv(j(x), j(clean_send), j(recv), j(clean), n, scale=j(scale), real_edges=jnp.int32(real))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **SUM_TOL)
    assert out[7].abs().sum() > 0


def test_masked_slots_never_reach_the_output():
    """A select, not a product: +inf in the masked slots' edge term and
    scale leaves the output finite and equal to the clean call."""
    x, branches, acts, scale = _inputs("gate_scale", seed=2)
    b = BATCH
    masked = ~b.edge_mask.numpy()
    dirty_scale = scale.copy()
    dirty_scale[masked] = np.inf
    w0, b0, r0, e0 = branches[0]
    e0 = e0.copy()
    e0[masked] = np.inf
    dirty = ((w0, b0, r0, e0), branches[1])
    args = (b.senders, b.receivers, b.edge_mask, b.num_nodes)
    xt, bt, st = _torch_args(x, branches, scale)
    clean = fc.fused_conv_plain(xt, *args, bt, acts, st)
    xt, bt, st = _torch_args(x, dirty, dirty_scale)
    out = fc.fused_conv_plain(xt, *args, bt, acts, st)
    assert torch.isfinite(out).all()
    assert torch.equal(out, clean)


@pytest.mark.parametrize("win", [True, False])
@pytest.mark.parametrize("case", ["identity", "scale", "mlp_softplus", "gate_rtab_eterm", "gate_scale"])
def test_fused_aggregate_grads_match_jax_vjp(case, win, monkeypatch):
    monkeypatch.setenv("HYDRAGNN_PALLAS", "0")
    x, branches, acts, scale = _inputs(case, seed=3)
    g = np.random.default_rng(9).normal(size=(BATCH.num_nodes, H)).astype(np.float32)
    jx, jb, js = _jax_args(x, branches, scale)

    def f(xx, bb, ss):
        return _jax_call(xx, bb, acts, ss, win=win)

    ref, vjp = jax.vjp(f, jx, jb, js)
    jgx, jgb, jgs = vjp(jnp.asarray(g))

    b = BATCH
    xt, bt, st = _torch_args(x, branches, scale, requires_grad=True)
    out = fc.fused_aggregate(
        xt, b.senders, b.receivers, b.edge_mask, b.num_nodes, bt, acts, st,
        win=b.sender_win if win else None, real_edges=b.edge_occupancy,
    )
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **SUM_TOL)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), err_msg="grad_x", **GRAD_TOL)
    if st is not None:
        np.testing.assert_allclose(st.grad.numpy(), np.asarray(jgs), err_msg="g_scale", **GRAD_TOL)
    for k, (tbr, jbr) in enumerate(zip(bt, jgb)):
        for name, t, r in zip(("W", "b", "rtab", "eterm"), tbr, jbr):
            if t is not None:
                np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), err_msg=f"branch {k} {name}", **GRAD_TOL)


def test_grad_x_skipped_when_x_needs_none():
    """The backward forms no grad_x (no scatter) when x needs no
    gradient; the branch parameters still get theirs."""
    x, branches, acts, scale = _inputs("gate_rtab", seed=4)
    b = BATCH
    xt = torch.from_numpy(x)
    w = torch.from_numpy(branches[0][0]).requires_grad_(True)
    bt = ((w,) + tuple(torch.from_numpy(a) if a is not None else None for a in branches[0][1:]),
          tuple(torch.from_numpy(a) if a is not None else None for a in branches[1]))
    out = fc.fused_aggregate(xt, b.senders, b.receivers, b.edge_mask, b.num_nodes, bt, acts, win=b.sender_win)
    out.sum().backward()
    assert xt.grad is None and w.grad is not None and torch.isfinite(w.grad).all()


def test_fused_conv_rejects_bad_calls():
    b = BATCH
    x = torch.zeros(b.num_nodes, H)
    w = torch.zeros(H, H)
    args = (x, b.senders, b.receivers, b.edge_mask, b.num_nodes)
    with pytest.raises(ValueError, match="activations"):
        fc.fused_conv(*args, branches=((w, None, None, None),), acts=())
    with pytest.raises(ValueError, match="at most 2"):
        fc.fused_conv(*args, branches=((w, None, None, None),) * 3, acts=("relu",) * 3)
    with pytest.raises(ValueError, match="unknown"):
        fc.fused_conv(*args, branches=((w, None, None, None),), acts=("gelu",))
    with pytest.raises(ValueError, match="scale"):
        fc.fused_conv(*args, scale=torch.zeros(3, H))
    with pytest.raises(TypeError, match="bool"):
        fc.fused_conv(x, b.senders, b.receivers, b.edge_mask.int(), b.num_nodes)
    assert fc.REPLACES == "hydragnn_tpu/ops/fused_conv.py:140"
    assert fc.launches.value == 0  # the plain path never counts
