"""GAT, SchNet's in-forward radius graph, ``conv_bf16`` and
``fused_conv: false`` against the JAX package: ``segment_softmax`` and
``segment_std`` (values and gradients, ties, all-masked segments,
unsorted ids); ``GATv2Conv`` and the GAT chassis with converted weights
(outputs, per-head losses, every parameter gradient), a 3-step training
trajectory with dropout 0 and the GAT smoke bar through
``run_training`` -> ``run_prediction``; ``radius_graph_in_forward`` on
lattice positions (equal distances) and SchNet on it; the conv knobs on
the five conv stacks. Small sizes: hidden 8, 2 conv layers, about 40
BCC samples.

The port's side of every chassis comparison runs on one intra-op
thread (``tests/test_torch_conv_stacks.py``'s ``one_thread``, which says
why).

Tolerances and why:
  - segment ops ``rtol=1e-6, atol=1e-7`` (f32, sums in another order);
  - the conv, the chassis, losses, gradients and the trajectory as
    ``tests/test_torch_conv_stacks.py`` holds the stacks: ``rtol=1e-4,
    atol=1e-5`` (products and sums in another order), the trajectory's
    parameters ``rtol=1e-4, atol=2e-5``;
  - ``radius_graph_in_forward``: ids and masks equal, distances within
    ``rtol=1e-6``; SchNet in-forward against precomputed edges ``rtol=
    1e-4, atol=1e-5`` (the same edges in another slot order);
  - ``fused_conv: false`` against the fused path and against JAX: the
    stacks' ``rtol=1e-4, atol=1e-5``;
  - ``conv_bf16`` against the f32 path: the JAX package's own bound
    (``tests/test_conv_traffic.py``): loss within 5e-2 relative, every
    gradient within 8e-2 of the largest; the port against JAX with the
    knob on: loss within 1e-2 relative, every gradient within 2e-2 of the
    largest (bf16 products round in another order in the two frameworks,
    and bf16 keeps 8 bits).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from hydragnn_tpu.data.ingest import prepare_dataset as jax_prepare_dataset
from hydragnn_tpu.data.synthetic import deterministic_graph_data as jax_data
from hydragnn_tpu.flagship import flagship_config as jax_flagship_config
from hydragnn_tpu.graph import segment as JS
from hydragnn_tpu.models import convs as JC
from hydragnn_tpu.models.base import HydraModel as JaxHydraModel
from hydragnn_tpu.models.base import model_loss as jax_model_loss
from hydragnn_tpu.models.create import model_config_from_dict as jax_model_config
from hydragnn_tpu.ops.dynamic_radius import radius_graph_in_forward as jax_radius
from hydragnn_tpu.train.optimizer import select_optimizer as jax_select_optimizer
from hydragnn_tpu.utils.config import update_config as jax_update_config

import hydragnn_tpu_torch as hg
from hydragnn_tpu_torch.convert import variables_from_flax
from hydragnn_tpu_torch.data.ingest import prepare_dataset
from hydragnn_tpu_torch.data.loader import GraphLoader
from hydragnn_tpu_torch.data.radius_graph import radius_graph
from hydragnn_tpu_torch.data.synthetic import deterministic_graph_data
from hydragnn_tpu_torch.flagship import flagship_config
from hydragnn_tpu_torch.graph import segment as S
from hydragnn_tpu_torch.graph.batch import batch_graphs
from hydragnn_tpu_torch.models import convs as C
from hydragnn_tpu_torch.models.base import HydraModel, ModelConfig, model_loss
from hydragnn_tpu_torch.models.create import create_model, model_config_from_dict
from hydragnn_tpu_torch.ops.dynamic_radius import radius_graph_in_forward
from hydragnn_tpu_torch.train.optimizer import select_optimizer
from hydragnn_tpu_torch.utils.config import update_config

from test_torch_conv_stacks import STACKS, TOL, _both, _jax_grad_fn, _jax_model, one_thread, stack_config  # noqa: F401

SEG_TOL = dict(rtol=1e-6, atol=1e-7)
BF16_LOSS, BF16_GRAD = 5e-2, 8e-2  # the JAX package's bound, against f32
BF16_PORT_LOSS, BF16_PORT_GRAD = 1e-2, 2e-2  # the port against JAX, both in bf16


@pytest.fixture(autouse=True, scope="module")
def _diagnostics_off():
    """The training loop's per-head diagnostics and hardware ledger off in
    this file (``test_torch_{introspect,train_obs}.py`` test them): they
    add a forward and H + 1 backward pulls an epoch, and a counted
    forward and backward a run, to every run here."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HGTORCH_DIAGNOSTICS", "0")
        yield


# ---- segment_softmax, segment_std ------------------------------------------

def _segments(seed, width):
    """Unsorted ids over 12 segments (2 and 7 empty, 5 all masked), data
    on a 1/2 grid (ties within segments)."""
    rng = np.random.default_rng(seed)
    e = 90
    ids = rng.choice([0, 1, 3, 4, 5, 6, 8, 9, 10, 11], size=e).astype(np.int32)
    mask = rng.random(e) > 0.2
    mask[ids == 5] = False
    shape = (e,) if width is None else (e, width)
    data = (np.round(rng.normal(size=shape) * 2.0) / 2.0).astype(np.float32)
    g = rng.normal(size=(e,) if width is None else (e, width)).astype(np.float32)
    return data, ids, mask, g


@pytest.mark.parametrize("width", [None, 3])
def test_segment_softmax_matches_jax(width):
    data, ids, mask, g = _segments(1, width)
    m = mask if width is None else mask[:, None]
    ref, vjp = jax.vjp(lambda d: JS.segment_softmax(d, jnp.asarray(ids), 12, mask=jnp.asarray(m)), jnp.asarray(data))
    (jg,) = vjp(jnp.asarray(g))
    t = torch.from_numpy(data).requires_grad_(True)
    out = S.segment_softmax(t, torch.from_numpy(ids), 12, mask=torch.from_numpy(m))
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **SEG_TOL)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), **SEG_TOL)
    assert not out.detach().numpy()[~mask].any()  # masked entries exactly 0
    sums = np.zeros((12,) + out.shape[1:])
    np.add.at(sums, ids, out.detach().numpy())
    np.testing.assert_allclose(sums[[0, 1, 3]], 1.0, rtol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_segment_std_matches_jax(masked):
    data, ids, mask, g = _segments(2, 4)
    m = mask if masked else None

    def jf(d):
        return JS.segment_std(d, jnp.asarray(ids), 12, mask=None if m is None else jnp.asarray(m))

    ref, vjp = jax.vjp(jf, jnp.asarray(data))
    (jg,) = vjp(jnp.asarray(g[:12]))
    t = torch.from_numpy(data).requires_grad_(True)
    out = S.segment_std(t, torch.from_numpy(ids), 12, mask=None if m is None else torch.from_numpy(m))
    out.backward(torch.from_numpy(g[:12]))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **SEG_TOL)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-6)


# ---- GAT -------------------------------------------------------------------


def _gat_conv_case(concat, seed=3):
    """A small sorted batch (unmasked padding rows, masked edges) as a
    JAX and a port EdgeContext, and node features."""
    rng = np.random.default_rng(seed)
    graphs = []
    for _ in range(4):
        n = int(rng.integers(3, 8))
        e = int(rng.integers(4, 16))
        graphs.append({"x": rng.normal(size=(n, 5)).astype(np.float32),
                       "senders": rng.integers(0, n, e), "receivers": rng.integers(0, n, e)})
    b = batch_graphs(graphs, n_node_pad=40, n_edge_pad=80, n_graph_pad=5)
    mask = b.edge_mask.clone()
    mask[::5] = False
    ctx = C.EdgeContext(senders=b.senders, receivers=b.receivers, edge_mask=mask, node_mask=b.node_mask,
                        in_degree=b.in_degree)
    jctx = JC.EdgeContext(senders=jnp.asarray(b.senders.numpy()), receivers=jnp.asarray(b.receivers.numpy()),
                          edge_mask=jnp.asarray(mask.numpy()), node_mask=jnp.asarray(b.node_mask.numpy()))
    return b.nodes.numpy(), ctx, jctx


@pytest.mark.parametrize("concat", [True, False])
def test_gat_conv_matches_jax(concat):
    """The conv alone (eval: no dropout), forward and every gradient;
    flax's ``Dense_0`` is the source transform ``x_l`` (read from the
    tree: its captured output is ``x_l(x)``)."""
    x, ctx, jctx = _gat_conv_case(concat)
    jconv = JC.GATv2Conv(4, heads=3, concat=concat)
    variables = jconv.init(jax.random.PRNGKey(0), jnp.asarray(x), jctx)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    assert sorted(params) == ["Dense_0", "Dense_1", "att", "bias"]
    conv = C.GATv2Conv(5, 4, heads=3, concat=concat)
    with torch.no_grad():
        conv.x_l.weight.copy_(torch.from_numpy(params["Dense_0"]["kernel"].T))
        conv.x_l.bias.copy_(torch.from_numpy(params["Dense_0"]["bias"]))
        conv.x_r.weight.copy_(torch.from_numpy(params["Dense_1"]["kernel"].T))
        conv.x_r.bias.copy_(torch.from_numpy(params["Dense_1"]["bias"]))
        conv.att.copy_(torch.from_numpy(params["att"]))
        conv.bias.copy_(torch.from_numpy(params["bias"]) + 0.1)
    params["bias"] = params["bias"] + 0.1
    _, inter = jconv.apply({"params": params}, jnp.asarray(x), jctx, capture_intermediates=True)
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(conv.x_l(xt).detach().numpy(), np.asarray(inter["intermediates"]["Dense_0"]["__call__"][0]),
                               rtol=1e-6, atol=1e-6)
    g = np.random.default_rng(4).normal(size=(x.shape[0], 12 if concat else 4)).astype(np.float32)
    ref, vjp = jax.vjp(lambda p, xx: jconv.apply({"params": p}, xx, jctx), params, jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(g))
    xt.requires_grad_(True)
    out = conv(xt, ctx)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), **TOL)
    for name, t, r in (("x_l", conv.x_l.weight, jgp["Dense_0"]["kernel"].T), ("x_r", conv.x_r.weight, jgp["Dense_1"]["kernel"].T),
                       ("att", conv.att, jgp["att"]), ("bias", conv.bias, jgp["bias"])):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), err_msg=name, **TOL)


def test_gat_dropout_is_flax_dropout_in_distribution():
    """Training drops each attention weight with probability 0.25 and
    scales the rest by 1/0.75, from the generator it is given; eval and
    dropout 0 drop nothing."""
    x, ctx, _ = _gat_conv_case(True)
    conv = C.GATv2Conv(5, 4, heads=3, concat=True, generator=torch.Generator().manual_seed(0))
    xt = torch.from_numpy(x)
    gen = torch.Generator().manual_seed(5)
    a = conv(xt, ctx, train=True, generator=gen)
    b = conv(xt, ctx, train=True, generator=torch.Generator().manual_seed(5))
    assert torch.equal(a, b) and not torch.equal(a, conv(xt, ctx))
    alpha = torch.full((200_000,), 1.0)
    keep = torch.rand(alpha.shape, generator=torch.Generator().manual_seed(1)) >= 0.25
    assert abs(float(keep.float().mean()) - 0.75) < 0.01
    conv.dropout = 0.0
    assert torch.equal(conv(xt, ctx, train=True, generator=gen), conv(xt, ctx))


def _gat_both(dropout=None, node_head=None):
    cfg, jcfg, loader, jloader = _both("GAT", inputs=(0, 1))
    if node_head:
        for c in (cfg, jcfg):
            c["NeuralNetwork"]["Architecture"]["output_heads"]["node"]["type"] = node_head
    mcfg = model_config_from_dict(cfg["NeuralNetwork"])
    jmcfg = jax_model_config(jcfg["NeuralNetwork"])
    assert (mcfg.gat_heads, mcfg.gat_negative_slope, mcfg.dropout) == (jmcfg.gat_heads, jmcfg.gat_negative_slope,
                                                                        jmcfg.dropout) == (6, 0.05, 0.25)
    if dropout is not None:
        mcfg, jmcfg = dataclasses.replace(mcfg, dropout=dropout), dataclasses.replace(jmcfg, dropout=dropout)
    return mcfg, jmcfg, loader, jloader


def _jax_gat(jmcfg, jbatch):
    jmodel = JaxHydraModel(jmcfg)
    return jmodel, jax.jit(lambda b: jmodel.init(jax.random.PRNGKey(0), b, train=False))(jbatch)


@pytest.mark.parametrize("node_head", ["mlp", "conv"])
def test_gat_chassis_eval_matches_jax(node_head, one_thread):
    """Eval mode (running statistics, no dropout): outputs, per-head
    losses and every parameter gradient; the ``conv`` node head's GAT
    convs widen by the heads as the encoder's do."""
    mcfg, jmcfg, loader, jloader = _gat_both(node_head=node_head)
    batch, jbatch = next(iter(loader)), next(iter(jloader))
    jmodel, variables = _jax_gat(jmcfg, jbatch)

    def loss_fn(p):
        outs = jmodel.apply({"params": p, "batch_stats": variables["batch_stats"]}, jbatch, train=False)
        total, tasks = jax_model_loss(jmodel.cfg, outs, jbatch)
        return total, (jnp.stack(tasks), outs)

    (jloss, (jtasks, jouts)), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    model = create_model(mcfg, device="cpu")
    sd = variables_from_flax(jax.tree_util.tree_map(np.asarray, variables), mcfg)
    assert len(sd) == len(model.state_dict())
    model.load_state_dict(sd, strict=True)
    outs = model(batch, train=False)
    loss, tasks = model_loss(model.cfg, outs, batch)
    loss.backward()
    for o, r in zip(outs, jouts):
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(r), **TOL)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-4)
    np.testing.assert_allclose(torch.stack(tasks).detach().numpy(), np.asarray(jtasks), rtol=1e-4)
    want = variables_from_flax({"params": jax.tree_util.tree_map(np.asarray, jgrads)}, mcfg)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), err_msg=name, **TOL)


def test_gat_three_step_training_trajectory_matches_jax(one_thread):
    """Training mode with dropout 0 (the two frameworks' random streams
    cannot match): batch statistics, AdamW, three steps; losses,
    gradients, BatchNorm statistics and parameters after each step.
    Entries whose gradient is 0 up to rounding are held to move by at
    most lr per step and carried across, as the stacks' trajectory test
    does."""
    mcfg, jmcfg, loader, jloader = _gat_both(dropout=0.0)
    batches, jbatches = list(loader)[:3], list(jloader)[:3]
    jmodel, variables = _jax_gat(jmcfg, jbatches[0])
    cfg, jcfg, _, _ = _both("GAT", n=16, inputs=(0, 1))
    tx = jax_select_optimizer(jcfg["NeuralNetwork"]["Training"])
    grad_fn = _jax_grad_fn(jmodel)
    model = create_model(mcfg, device="cpu")
    model.load_state_dict(variables_from_flax(variables), strict=True)
    optimizer = select_optimizer(model, cfg["NeuralNetwork"]["Training"])
    params, stats, opt_state = variables["params"], variables["batch_stats"], tx.init(variables["params"])
    for step, (batch, jbatch) in enumerate(zip(batches, jbatches)):
        (jloss, (jtasks, _, stats)), jgrads = grad_fn(params, stats, jbatch)
        updates, opt_state = tx.update(jgrads, opt_state, params)
        params = optax.apply_updates(params, updates)
        optimizer.zero_grad()
        loss, tasks = model_loss(model.cfg, model(batch, train=True), batch)
        loss.backward()
        np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-4, err_msg=f"step {step}")
        want = variables_from_flax({"params": jax.tree_util.tree_map(np.asarray, jgrads)})
        zero_grad = {}
        for name, p in model.named_parameters():
            np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), err_msg=f"step {step} {name}", **TOL)
            zero_grad[name] = want[name].abs() < TOL["atol"]
        optimizer.step()
        now = variables_from_flax({"params": params, "batch_stats": stats})
        sd = model.state_dict()
        for name in now:
            if name in zero_grad:
                z = zero_grad[name]
                moved = torch.where(z, (sd[name] - now[name]).abs(), torch.zeros(()))
                assert float(moved.max()) <= 2e-3 * (step + 1), name
                with torch.no_grad():
                    sd[name].copy_(torch.where(z, now[name], sd[name]))
            tol = TOL if "running" in name else dict(rtol=1e-4, atol=2e-5)
            np.testing.assert_allclose(sd[name].numpy(), now[name].numpy(), err_msg=f"step {step} {name}", **tol)


def test_gat_smoke_bar_run_training_then_prediction(tmp_path):
    """``tests/test_train_e2e.py``'s GAT smoke cell (150 samples, 15
    epochs, batch 32, lr 0.02, hidden 8, 2 layers, 6 heads, dropout
    0.25) through ``run_training`` -> ``run_prediction`` on the CPU:
    every head below ``SMOKE_THRESHOLDS["GAT"]`` (0.12 / 0.25)."""
    from test_train_e2e import SMOKE_THRESHOLDS, make_config

    def cfg():
        c = make_config("GAT", False, str(tmp_path), num_epoch=15)
        c["NeuralNetwork"]["Training"]["batch_size"] = 32
        c["NeuralNetwork"]["Training"]["Optimizer"]["learning_rate"] = 0.02
        return c

    log_dir = str(tmp_path / "logs")
    hg.run_training(cfg(), deterministic_graph_data(number_configurations=150, seed=0), log_dir=log_dir, device="cpu")
    _, err, trues, preds = hg.run_prediction(cfg(), deterministic_graph_data(number_configurations=150, seed=0),
                                             log_dir=log_dir, device="cpu")
    rmse_bar, mae_bar = SMOKE_THRESHOLDS["GAT"]
    for i, (t, p) in enumerate(zip(trues, preds)):
        mae = float(np.mean(np.abs(t - p)))
        assert float(err[i]) < rmse_bar and mae < mae_bar, f"head {i}: {float(err[i])}, {mae}"


# ---- radius_graph_in_forward -------------------------------------------------


def _lattice_graphs(seed=0):
    """Three graphs on a cubic lattice of spacing 0.5 (many equal
    distances), random node order, some positions repeated."""
    rng = np.random.default_rng(seed)
    graphs = []
    for _ in range(3):
        n = int(rng.integers(6, 14))
        pos = (rng.integers(0, 3, size=(n, 3)) * 0.5).astype(np.float32)
        graphs.append({"x": rng.normal(size=(n, 2)).astype(np.float32), "pos": pos,
                       "senders": np.zeros(0, np.int32), "receivers": np.zeros(0, np.int32)})
    return graphs


@pytest.mark.parametrize("cap", [4, 30])
def test_radius_graph_in_forward_matches_jax_on_ties(cap):
    b = batch_graphs(_lattice_graphs(), n_node_pad=48, n_edge_pad=8, n_graph_pad=4)
    radius = 0.8
    ref = jax_radius(jnp.asarray(b.pos.numpy()), jnp.asarray(b.node_graph.numpy()), jnp.asarray(b.node_mask.numpy()),
                     radius, cap)
    out = radius_graph_in_forward(b.pos, b.node_graph, b.node_mask, radius, cap)
    names = ("senders", "receivers", "dist", "edge_mask")
    for name, o, r in zip(names, out, ref):
        assert o.numpy().dtype == np.asarray(r).dtype, name
        if name == "dist":
            np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(o.numpy(), np.asarray(r), err_msg=name)
    d = out[2].numpy()[out[3].numpy()]
    if cap == 4:  # the cap cuts through groups of equal distances
        assert len(np.unique(d)) < len(d)


def test_schnet_inforward_matches_precomputed_edges():
    """SchNet with the in-forward graph equals SchNet on the host-built
    radius graph with the same cutoff and cap (as JAX's
    ``tests/test_models.py`` holds it), fused and composed."""
    rng = np.random.default_rng(11)
    radius, cap = 0.8, 6
    graphs = []
    for _ in range(3):
        n = int(rng.integers(4, 8))
        pos = rng.random((n, 3)).astype(np.float32)
        ei = radius_graph(pos, radius, max_num_neighbors=cap)
        graphs.append({"x": rng.random((n, 2)).astype(np.float32), "senders": ei[0].astype(np.int32),
                       "receivers": ei[1].astype(np.int32), "pos": pos,
                       "graph_targets": {"energy": np.array([rng.random()])},
                       "node_targets": {"charge": rng.random((n, 1)).astype(np.float32)}})
    b = batch_graphs(graphs, n_node_pad=32, n_edge_pad=256, n_graph_pad=4)
    base = ModelConfig(model_type="SchNet", input_dim=2, hidden_dim=8, output_dim=(1, 1),
                       output_type=("graph", "node"), output_names=("energy", "charge"), task_weights=(1.0, 1.0),
                       num_conv_layers=2, graph_num_sharedlayers=1, graph_dim_sharedlayers=8,
                       graph_num_headlayers=1, graph_dim_headlayers=(8,), node_num_headlayers=1,
                       node_dim_headlayers=(8,), num_gaussians=10, num_filters=12, radius=radius,
                       max_neighbours=cap)
    for fused in (True, False):
        c = dataclasses.replace(base, fused_conv=fused)
        model = HydraModel(c, generator=torch.Generator().manual_seed(0)).eval()
        dyn = HydraModel(dataclasses.replace(c, inforward_radius=True)).eval()
        dyn.load_state_dict(model.state_dict())
        with torch.no_grad():
            for a, r in zip(dyn(b), model(b)):
                np.testing.assert_allclose(a.numpy(), r.numpy(), **TOL)


def _molecular_both(model_type, arch_updates, n=40):
    """The e2e molecular data under the flagship chassis at hidden 8 in
    both packages (dense-map loaders), ``arch_updates`` applied before
    ``update_config``: [(train split, completed config)] port, then JAX."""
    out = []
    for data, prep, update, flagship in ((deterministic_graph_data, prepare_dataset, update_config, flagship_config),
                                         (jax_data, jax_prepare_dataset, jax_update_config, jax_flagship_config)):
        cfg = stack_config(flagship, model_type, batch=16)
        cfg["Dataset"]["compositional_stratified_splitting"] = True
        cfg["NeuralNetwork"]["Training"]["perc_train"] = 0.7
        cfg["NeuralNetwork"]["Architecture"].update(arch_updates)
        tr, va, te, _, _ = prep(data(number_configurations=n, seed=0), cfg)
        out.append((tr, update(cfg, tr, va, te)))
    return out


def test_schnet_inforward_chassis_matches_jax(one_thread):
    """SchNet with ``radius_graph_in_forward`` on the e2e molecular data
    (radius 2.0, max_neighbours from the data): forward, losses and
    every gradient against the JAX chassis in training mode."""
    from hydragnn_tpu.data.loader import GraphLoader as JaxGraphLoader

    (tr, cfg), (jtr, jcfg) = _molecular_both("SchNet", {"radius_graph_in_forward": True, "radius": 2.0})
    batch = next(iter(GraphLoader(tr, 16)))
    jbatch = next(iter(JaxGraphLoader(jtr, 16, prefetch=0)))
    jmodel, variables = _jax_model(jcfg, jbatch)
    assert jmodel.cfg.inforward_radius
    (jloss, (jtasks, jouts, _)), jgrads = _jax_grad_fn(jmodel)(variables["params"], variables["batch_stats"], jbatch)
    model = create_model(model_config_from_dict(cfg["NeuralNetwork"]), device="cpu")
    assert model.cfg.inforward_radius
    model.load_state_dict(variables_from_flax(jax.tree_util.tree_map(np.asarray, variables)), strict=True)
    outs = model(batch, train=True)
    loss, _ = model_loss(model.cfg, outs, batch)
    loss.backward()
    for o, r in zip(outs, jouts):
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(r), **TOL)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-4)
    want = variables_from_flax({"params": jax.tree_util.tree_map(np.asarray, jgrads)})
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), err_msg=name, **TOL)


def test_inforward_radius_warns_on_large_pad(monkeypatch):
    """Above 20,000 node rows the O(N_pad²) build warns first (the build
    itself is stubbed here); a small pad builds [N·K] slots silently."""
    import warnings

    import hydragnn_tpu_torch.models.base as base_mod

    b = batch_graphs(_lattice_graphs(), n_node_pad=48, n_edge_pad=8, n_graph_pad=4)
    cfg = ModelConfig(model_type="SchNet", input_dim=2, hidden_dim=4, output_dim=(1,), output_type=("graph",),
                      output_names=("y",), task_weights=(1.0,), num_conv_layers=1, num_gaussians=4,
                      num_filters=4, radius=0.8, max_neighbours=4, inforward_radius=True)
    model = HydraModel(cfg).eval()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert model.edge_context(b).senders.shape == (48 * 4,)
    small = radius_graph_in_forward(b.pos, b.node_graph, b.node_mask, 0.8, 4)
    monkeypatch.setattr(base_mod, "radius_graph_in_forward", lambda *a: small)
    big = dataclasses.replace(b, pos=torch.zeros(20_001, 3))
    with pytest.warns(RuntimeWarning, match="O\\(N_pad\\^2\\)"):
        model.edge_context(big)


# ---- the conv knobs ------------------------------------------------------------


def _grads_loss(model, batch, train=True):
    model.zero_grad(set_to_none=True)
    outs = model(batch, train=train)
    loss, tasks = model_loss(model.cfg, outs, batch)
    loss.backward()
    return outs, float(loss.detach()), {k: p.grad.detach().clone() for k, p in model.named_parameters()}


@pytest.mark.parametrize("model_type,edge_features", [(m, False) for m in STACKS] + [("CGCNN", True)])
def test_fused_conv_false_equals_fused_and_jax(model_type, edge_features, one_thread):
    """The composed path (sender gather, masked sorted segment sum)
    equals the fused one and the JAX package with the same setting:
    forward, loss and every gradient, in training mode."""
    cfg, jcfg, loader, jloader = _both(model_type, edge_features)
    for c in (cfg, jcfg):
        c["NeuralNetwork"]["Architecture"]["fused_conv"] = False
    batch, jbatch = next(iter(loader)), next(iter(jloader))
    jmodel, variables = _jax_model(jcfg, jbatch)
    assert not jmodel.cfg.fused_conv
    (jloss, (_, jouts, _)), jgrads = _jax_grad_fn(jmodel)(variables["params"], variables["batch_stats"], jbatch)
    sd = variables_from_flax(jax.tree_util.tree_map(np.asarray, variables))
    runs = {}
    for fused in (False, True):
        mcfg = dataclasses.replace(model_config_from_dict(cfg["NeuralNetwork"]), fused_conv=fused)
        model = create_model(mcfg, device="cpu")
        model.load_state_dict(sd, strict=True)
        runs[fused] = _grads_loss(model, batch)
    want = variables_from_flax({"params": jax.tree_util.tree_map(np.asarray, jgrads)})
    for label, ref_outs, ref_loss, ref_grads in (("jax", [np.asarray(o) for o in jouts], float(jloss), want),
                                                 ("fused", [o.detach().numpy() for o in runs[True][0]],
                                                  runs[True][1], runs[True][2])):
        outs, loss, grads = runs[False]
        for o, r in zip(outs, ref_outs):
            np.testing.assert_allclose(o.detach().numpy(), r, err_msg=label, **TOL)
        np.testing.assert_allclose(loss, ref_loss, rtol=1e-4, err_msg=label)
        for name, g in grads.items():
            np.testing.assert_allclose(g.numpy(), ref_grads[name].numpy(), err_msg=f"{label} {name}", **TOL)


def _bf16_close(l1, g1, l0, g0, loss_tol, grad_tol, label):
    assert np.isfinite(l1) and abs(l1 - l0) <= loss_tol * max(abs(l0), 1.0), (label, l1, l0)
    gmax = max(float(g.abs().max()) for g in g0.values())
    gerr = max(float((g1[k].float() - g0[k].float()).abs().max()) for k in g0)
    assert np.isfinite(gerr) and gerr / max(gmax, 1e-9) < grad_tol, (label, gerr, gmax)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("model_type", ["GIN", "CGCNN"])
def test_conv_bf16_within_the_jax_bound_and_matches_jax(model_type, fused, one_thread):
    """``conv_bf16`` in eval mode: the port against its own f32 path
    within the JAX package's bound, and against the JAX package with the
    knob on (which runs its composed path on the CPU)."""
    cfg, jcfg, loader, jloader = _both(model_type, inputs=(0, 1, 2) if model_type == "GIN" else (0,))
    jcfg["NeuralNetwork"]["Architecture"]["conv_bf16"] = True
    batch, jbatch = next(iter(loader)), next(iter(jloader))
    jmodel, variables = _jax_model(jcfg, jbatch)
    assert jmodel.cfg.conv_bf16

    def loss_fn(p):
        outs = jmodel.apply({"params": p, "batch_stats": variables["batch_stats"]}, jbatch, train=False)
        return jax_model_loss(jmodel.cfg, outs, jbatch)[0]

    jl, jg = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])
    jgrads = variables_from_flax({"params": jax.tree_util.tree_map(np.asarray, jg)})
    sd = variables_from_flax(jax.tree_util.tree_map(np.asarray, variables))
    runs = {}
    for bf16 in (False, True):
        mcfg = dataclasses.replace(model_config_from_dict(cfg["NeuralNetwork"]), conv_bf16=bf16, fused_conv=fused)
        model = create_model(mcfg, device="cpu")
        model.load_state_dict(sd, strict=True)
        outs, loss, grads = _grads_loss(model, batch, train=False)
        assert all(o.dtype == torch.float32 for o in outs)
        runs[bf16] = (loss, grads)
    _bf16_close(*runs[True], *runs[False], BF16_LOSS, BF16_GRAD, "bf16 vs f32")
    _bf16_close(*runs[True], float(jl), jgrads, BF16_PORT_LOSS, BF16_PORT_GRAD, "port vs jax")


def test_softplus_and_leaky_relu_gradients_at_zero_match_jax():
    """At exactly 0 (zero features with zero biases): softplus'(0) = 1/2
    (``jax.nn.softplus`` is ``logaddexp(x, 0)``; the form ``max(x, 0) +
    log1p(exp(-|x|))`` differentiates to 1 under autograd), SchNet's
    shifted softplus alike, and leaky_relu'(0) = 1 (torch's takes the
    negative slope there)."""
    from hydragnn_tpu_torch.ops.fused_conv import ACTS

    z = np.array([-1.5, 0.0, 0.0, 2.0], np.float32)
    cases = [
        ("softplus", ACTS["softplus"][0], jax.nn.softplus),
        ("shifted_softplus", C.shifted_softplus, JC.shifted_softplus),
        ("leaky_relu", lambda t: C._LeakyReLU.apply(t, 0.05), lambda t: jax.nn.leaky_relu(t, 0.05)),
    ]
    for name, f, jf in cases:
        t = torch.from_numpy(z).requires_grad_(True)
        f(t).sum().backward()
        want = jax.grad(lambda a: jf(a).sum())(jnp.asarray(z))
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), rtol=1e-6, err_msg=name)
        np.testing.assert_allclose(f(torch.from_numpy(z)).detach().numpy(), np.asarray(jf(jnp.asarray(z))),
                                   rtol=1e-6, atol=1e-7, err_msg=name)
