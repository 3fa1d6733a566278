"""B9's plain version and the port's ``fused_conv_stack`` against the JAX
package's ``fused_conv_stack``: the XLA path (its per-layer loop) and
the resident Pallas kernel in interpret mode (``HYDRAGNN_PALLAS=
interpret``), forward and the gradients for x, W and b, on
``occ_case``-style inputs (``tests/test_conv_traffic.py``): tied values,
masked slots, receivers whose every edge is masked, rows with no edge,
and an occupancy bound below E; both activation pairs of the JAX tests,
L = 1, 3 and 6; the four validation errors with the JAX messages.

Tolerances and why:
  - forward ``rtol=atol=1e-5``: both sides sum the same f32 messages in
    another order and take ``h @ W`` through two BLAS libraries, and a
    layer's rounding feeds the next;
  - gradients ``rtol=1e-5, atol=1e-6``: the same composed backward (the
    JAX op's is ``jax.vjp`` of its per-layer loop, the port's that of its
    per-layer ``fused_aggregate``), products and sums in another order;
    over 6 layers ``atol`` is 1e-6 of the gradient's largest magnitude
    (``deep_grad_tol``): the sums carry terms of that size through six
    layers, and one W entry of 1,536 differs by more than 1e-6;
  - the wrapper on a CPU tensor against the plain version, and a masked
    slot's inf against the clean input: equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hydragnn_tpu.ops.fused_conv import fused_conv_stack as jax_stack

import hydragnn_tpu_torch.ops as ops
from hydragnn_tpu_torch.ops.fused_conv_stack import fused_conv_stack, fused_conv_stack_plain

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-5, atol=1e-6)


def deep_grad_tol(ref):
    """``GRAD_TOL`` over 6 layers: atol 1e-6 of the gradient's largest
    magnitude (at least 1e-6)."""
    return dict(rtol=1e-5, atol=1e-6 * max(1.0, float(np.abs(ref).max())))

N, E, H, REAL = 40, 300, 16, 200
ACT_PAIRS = [("sigmoid", "relu"), ("none", "relu")]


def _case(layers, seed=42):
    """numpy inputs: x on a 1/4 grid (ties), sorted receivers, masked
    slots, every slot at or past REAL masked, rows 0-2 and the last 5
    with no edge in, row 10's edges all masked."""
    rng = np.random.default_rng(seed)
    recv = np.sort(rng.integers(3, N - 5, E)).astype(np.int32)
    send = rng.integers(0, N, E).astype(np.int32)
    mask = rng.random(E) > 0.2
    mask[REAL:] = False
    mask[recv == 10] = False
    x = (np.round(rng.normal(size=(N, H)) * 4.0) / 4.0).astype(np.float32)
    w = (rng.normal(size=(layers, H, H)) * 0.3).astype(np.float32)
    b = (rng.normal(size=(layers, H)) * 0.3).astype(np.float32)
    g = rng.normal(size=(N, H)).astype(np.float32)
    return x, send, recv, mask, w, b, g


def _jax(x, send, recv, mask, w, b, acts, real=True):
    return jax_stack(
        x, jnp.asarray(send), jnp.asarray(recv), jnp.asarray(mask), N, w, b,
        edge_act=acts[0], inter_act=acts[1], real_edges=jnp.asarray(REAL, jnp.int32) if real else None,
    )


def _port(x, send, recv, mask, w, b, acts, real=True):
    return fused_conv_stack(
        x, torch.from_numpy(send), torch.from_numpy(recv), torch.from_numpy(mask), N, w, b,
        edge_act=acts[0], inter_act=acts[1], real_edges=torch.tensor(REAL, dtype=torch.int32) if real else None,
    )


@pytest.mark.parametrize("layers", [1, 3, 6])
@pytest.mark.parametrize("acts", ACT_PAIRS, ids=["-".join(a) for a in ACT_PAIRS])
@pytest.mark.parametrize("pallas", ["0", "interpret"])
def test_forward_matches_jax(pallas, acts, layers, monkeypatch):
    """``interpret`` runs the JAX package's B9 itself (its resident
    kernel in interpret mode); ``0`` its per-layer XLA loop."""
    monkeypatch.setenv("HYDRAGNN_PALLAS", pallas)
    x, send, recv, mask, w, b, _ = _case(layers)
    ref = np.asarray(_jax(jnp.asarray(x), send, recv, mask, jnp.asarray(w), jnp.asarray(b), acts))
    out = _port(torch.from_numpy(x), send, recv, mask, torch.from_numpy(w), torch.from_numpy(b), acts)
    assert out.dtype == torch.float32 and out.shape == (N, H)
    np.testing.assert_allclose(out.numpy(), ref, **FWD_TOL)
    # rows with no edge in (and row 10, every edge masked) are exactly 0
    dead = np.ones(N, bool)
    dead[recv[mask]] = False
    assert dead[10] and dead[:3].all() and not out.numpy()[dead].any()


@pytest.mark.parametrize("layers", [1, 3, 6])
@pytest.mark.parametrize("acts", ACT_PAIRS, ids=["-".join(a) for a in ACT_PAIRS])
def test_grads_match_jax_vjp(acts, layers, monkeypatch):
    monkeypatch.setenv("HYDRAGNN_PALLAS", "0")
    x, send, recv, mask, w, b, g = _case(layers, seed=7)

    def f(xx, ww, bb):
        return _jax(xx, send, recv, mask, ww, bb, acts)

    ref, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    jgx, jgw, jgb = vjp(jnp.asarray(g))
    xt, wt, bt = (torch.from_numpy(a).requires_grad_(True) for a in (x, w, b))
    out = _port(xt, send, recv, mask, wt, bt, acts)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **FWD_TOL)
    out.backward(torch.from_numpy(g))
    for name, t, r in (("x", xt, jgx), ("W", wt, jgw), ("b", bt, jgb)):
        tol = deep_grad_tol(np.asarray(r)) if layers == 6 else GRAD_TOL
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), err_msg=f"grad {name}", **tol)


def test_grads_match_jax_interpret_kernel(monkeypatch):
    """The JAX op's own resident kernel in interpret mode, differentiated
    (its backward recomputes through its per-layer fused kernels)."""
    monkeypatch.setenv("HYDRAGNN_PALLAS", "interpret")
    acts = ("sigmoid", "relu")
    x, send, recv, mask, w, b, g = _case(2, seed=11)

    def f(xx, ww, bb):
        return _jax(xx, send, recv, mask, ww, bb, acts)

    ref, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    jgx, jgw, jgb = vjp(jnp.asarray(g))
    xt, wt, bt = (torch.from_numpy(a).requires_grad_(True) for a in (x, w, b))
    out = _port(xt, send, recv, mask, wt, bt, acts)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **FWD_TOL)
    out.backward(torch.from_numpy(g))
    for name, t, r in (("x", xt, jgx), ("W", wt, jgw), ("b", bt, jgb)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), err_msg=f"grad {name}", **GRAD_TOL)


def test_wrapper_is_plain_on_cpu_and_takes_sequences():
    """On a CPU tensor the op is its plain version; weights and biases
    may be sequences; no biases is zero biases; no occupancy bound walks
    every slot (the masked tail adds nothing). Exported from ``ops``."""
    assert ops.fused_conv_stack is fused_conv_stack
    x, send, recv, mask, w, b, _ = _case(3, seed=3)
    args = (torch.from_numpy(x), torch.from_numpy(send), torch.from_numpy(recv), torch.from_numpy(mask), N)
    wt, bt = torch.from_numpy(w), torch.from_numpy(b)
    plain = fused_conv_stack_plain(*args, wt, bt, "sigmoid", "relu")
    assert torch.equal(fused_conv_stack(*args, list(wt), list(bt), "sigmoid", "relu"), plain)
    assert torch.equal(_port(args[0], send, recv, mask, wt, bt, ("sigmoid", "relu"), real=False), plain)
    assert torch.equal(fused_conv_stack(*args, wt, None, "tanh", "relu"),
                       fused_conv_stack_plain(*args, wt, torch.zeros(3, H), "tanh", "relu"))


def test_masked_slots_never_reach_the_output():
    """A select, not a product: a node that sends only on masked slots
    may hold inf; the output equals the clean call's."""
    x, send, recv, mask, w, b, _ = _case(3, seed=5)
    send = send.copy()
    send[~mask] = 0
    send[mask & (send == 0)] = 1  # node 0 sends on masked slots only
    dirty = x.copy()
    dirty[0] = np.inf
    clean_x = x.copy()
    clean_x[0] = 0.0
    outs = [_port(torch.from_numpy(v), send, recv, mask, torch.from_numpy(w), torch.from_numpy(b),
                  ("sigmoid", "relu")) for v in (dirty, clean_x)]
    assert torch.isfinite(outs[0]).all() and torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("bad", ["not_square", "width", "num_segments", "activation"])
def test_validation_errors_match_jax(bad):
    x, send, recv, mask, w, b, _ = _case(2)
    n, w_, act = N, w, ("sigmoid", "relu")
    if bad == "not_square":
        w_ = w[:, :, : H - 1]
    elif bad == "width":
        w_ = np.zeros((2, H + 1, H + 1), np.float32)
    elif bad == "num_segments":
        n = N + 1
    else:
        act = ("gelu", "relu")
    with pytest.raises(ValueError) as jerr:
        jax_stack(jnp.asarray(x), jnp.asarray(send), jnp.asarray(recv), jnp.asarray(mask), n, jnp.asarray(w_),
                  None, edge_act=act[0], inter_act=act[1])
    with pytest.raises(ValueError) as terr:
        fused_conv_stack(torch.from_numpy(x), torch.from_numpy(send), torch.from_numpy(recv), torch.from_numpy(mask),
                         n, torch.from_numpy(w_), None, edge_act=act[0], inter_act=act[1])
    assert str(terr.value) == str(jerr.value)
