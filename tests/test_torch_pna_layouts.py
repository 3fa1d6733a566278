"""PNA on every batch layout against the JAX package: the dense slot
map, the run-aligned CSR layout and the unaligned CSR layout, each with
and without edge features; the ``conv`` and ``mlp_per_node`` node heads;
``convert.py`` on every new configuration (the completed configs are
held key for key in ``tests/test_torch_conv_stacks.py``); a
3-step trajectory on the dense map; and ``run_training`` ->
``run_prediction`` on ``tests/test_train_e2e.py``'s PNA config at the
reference accuracy bar. Weights are carried across by ``convert.py``;
data comes from the seeded synthetic generator of each package. Small
sizes: hidden 8, 2 conv layers, 40 BCC samples of 16 atoms (2 unit
cells a side), batch 8.

Tolerances and why:
  - forward, losses, every gradient and BatchNorm statistics
    ``rtol=1e-4, atol=1e-5`` in f32 (matrix products and sums accumulate
    in another order in the two frameworks; both split tied maxima
    evenly);
  - trajectory: losses ``rtol=1e-4``, gradients ``rtol=1e-4, atol=1e-5``,
    parameters after each AdamW step ``rtol=1e-4, atol=2e-5``, with the
    post-layer biases that feed a BatchNorm (gradient 0 up to rounding)
    and entries whose gradient is below the atol held to move by at most
    lr per step, as ``tests/test_torch_conv_stacks.py`` does;
  - accuracy: the reference thresholds, "RMSE" (the per-head test error
    ``error_rmse_task``, as that test reads it) and MAE below 0.20 on
    every head (``tests/test_train_e2e.py:26-34``, from the reference's
    ``tests/test_graphs.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from hydragnn_tpu.data.ingest import prepare_dataset as jax_prepare_dataset
from hydragnn_tpu.data.loader import GraphLoader as JaxGraphLoader
from hydragnn_tpu.data.synthetic import deterministic_graph_data as jax_data
from hydragnn_tpu.flagship import flagship_config as jax_flagship_config
from hydragnn_tpu.models.base import HydraModel as JaxHydraModel
from hydragnn_tpu.models.base import model_loss as jax_model_loss
from hydragnn_tpu.models.create import model_config_from_dict as jax_model_config
from hydragnn_tpu.train.optimizer import select_optimizer as jax_select_optimizer
from hydragnn_tpu.utils.config import update_config as jax_update_config

import hydragnn_tpu_torch as hg
from hydragnn_tpu_torch.convert import variables_from_flax
from hydragnn_tpu_torch.data.ingest import prepare_dataset
from hydragnn_tpu_torch.data.loader import GraphLoader
from hydragnn_tpu_torch.data.synthetic import deterministic_graph_data
from hydragnn_tpu_torch.flagship import flagship_config
from hydragnn_tpu_torch.models.base import ConvHead, PerNodeMLP, model_loss
from hydragnn_tpu_torch.models.create import create_model_config
from hydragnn_tpu_torch.train.optimizer import select_optimizer
from hydragnn_tpu_torch.utils.config import max_in_degree, update_config

from test_train_e2e import make_config

TOL = dict(rtol=1e-4, atol=1e-5)
UNIT = dict(unit_cell_x_range=(2, 3), unit_cell_y_range=(2, 3), unit_cell_z_range=(2, 3))
# reference thresholds, (RMSE, MAE) per head: tests/test_train_e2e.py:26-34
PNA_THRESHOLDS = (0.20, 0.20)
LAYOUTS = ("dense", "run_aligned", "unaligned")


@pytest.fixture(autouse=True, scope="module")
def _diagnostics_off():
    """The training loop's per-head diagnostics and hardware ledger off in
    this file (``test_torch_{introspect,train_obs}.py`` test them): they
    add a forward and H + 1 backward pulls an epoch, and a counted
    forward and backward a run, to every run here."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HGTORCH_DIAGNOSTICS", "0")
        yield


def pna_config(make, edge=False, head="mlp", model_type="PNA", batch=8, epochs=1):
    cfg = make(8, 2, batch, epochs)
    arch = cfg["NeuralNetwork"]["Architecture"]
    arch["model_type"] = model_type
    arch["output_heads"]["node"]["type"] = head
    if edge:
        arch["edge_features"] = ["lengths"]
    return cfg


def _splits(mod_data, mod_prep, mod_update, cfg, n, seed=2):
    samples = mod_data(number_configurations=n, seed=seed, **UNIT)
    tr, va, te, _, _ = mod_prep(samples, cfg)
    return tr, mod_update(cfg, tr, va, te)


def _layout_args(layout, train):
    """The loader options that pick ``layout`` (the same in both
    packages); the dense map gets the dataset's max in-degree, as the
    JAX package's ``tools/ab_dense.py`` pins it. (On these equal-size
    graphs the loaders' AUTO pick is the dense map.)"""
    if layout == "dense":
        return dict(dense_slots=max_in_degree(train), run_align=False)
    if layout == "unaligned":
        return dict(dense_slots=False, run_align=False)
    return dict(dense_slots=False, run_align=8)


def _both(layout, edge=False, head="mlp", model_type="PNA", n=40, batch=8):
    """(port config, JAX config, port loader, JAX loader) over the same
    prepared BCC samples, shuffled, in ``layout``."""
    tr, cfg = _splits(deterministic_graph_data, prepare_dataset, update_config,
                      pna_config(flagship_config, edge, head, model_type, batch), n)
    jtr, jcfg = _splits(jax_data, jax_prepare_dataset, jax_update_config,
                        pna_config(jax_flagship_config, edge, head, model_type, batch), n)
    loader = GraphLoader(tr, batch, shuffle=True, **_layout_args(layout, tr))
    jloader = JaxGraphLoader(jtr, batch, shuffle=True, prefetch=0, **_layout_args(layout, jtr))
    return cfg, jcfg, loader, jloader


def _check_layout(batch, layout):
    assert (batch.dense_senders is not None) == (layout == "dense")
    assert batch.run_align == (8 if layout == "run_aligned" else 0)


def _jax_model(jcfg, jbatch):
    jmodel = JaxHydraModel(jax_model_config(jcfg["NeuralNetwork"]))
    return jmodel, jax.jit(lambda b: jmodel.init(jax.random.PRNGKey(0), b, train=False))(jbatch)


def _jax_grad_fn(jmodel):
    @jax.jit
    def fn(params, stats, batch):
        def loss_fn(p):
            outs, mut = jmodel.apply({"params": p, "batch_stats": stats}, batch, train=True, mutable=["batch_stats"])
            total, tasks = jax_model_loss(jmodel.cfg, [o.astype(jnp.float32) for o in outs], batch)
            return total, (jnp.stack(tasks), outs, mut["batch_stats"])

        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    return fn


def _tree(x):
    return jax.tree_util.tree_map(np.asarray, x)


def _port_model(cfg, variables):
    """The port's model with the JAX weights; every JAX leaf consumed
    once, every port entry filled."""
    model = create_model_config(cfg["NeuralNetwork"], device="cpu")
    sd = variables_from_flax(_tree(variables), model.cfg)
    assert len(sd) == len(jax.tree_util.tree_leaves(variables)) == len(model.state_dict())
    model.load_state_dict(sd, strict=True)
    return model


def _compare_step(cfg, jcfg, batch, jbatch):
    """One train-mode forward and backward in both packages: outputs,
    losses, every gradient and the BatchNorm statistics."""
    jmodel, variables = _jax_model(jcfg, jbatch)
    (jloss, (jtasks, jouts, jstats)), jgrads = _jax_grad_fn(jmodel)(
        variables["params"], variables["batch_stats"], jbatch
    )
    model = _port_model(cfg, variables)
    outs = model(batch, train=True)
    loss, tasks = model_loss(model.cfg, outs, batch)
    loss.backward()
    for o, r in zip(outs, jouts):
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(r), **TOL)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-4)
    np.testing.assert_allclose(torch.stack(tasks).detach().numpy(), np.asarray(jtasks), rtol=1e-4)
    want = variables_from_flax({"params": _tree(jgrads)}, model.cfg)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), err_msg=name, **TOL)
    stats = variables_from_flax({"batch_stats": _tree(jstats)}, model.cfg)
    for name, v in stats.items():
        np.testing.assert_allclose(model.state_dict()[name].numpy(), v.numpy(), err_msg=name, **TOL)
    return model


@pytest.mark.parametrize("edge", [False, True])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_pna_forward_losses_and_grads_match_jax(layout, edge):
    cfg, jcfg, loader, jloader = _both(layout, edge)
    batch, jbatch = next(iter(loader)), next(iter(jloader))
    _check_layout(batch, layout)
    model = _compare_step(cfg, jcfg, batch, jbatch)
    assert (model.convs[0].edge_proj is not None) == edge
    assert model.convs[1].pre_kernel.shape == ((3 if edge else 2) * 8, 8)


@pytest.mark.parametrize("head,model_type,layout,edge", [
    ("conv", "PNA", "dense", False),
    ("conv", "PNA", "run_aligned", True),
    ("conv", "PNA", "unaligned", False),
    ("conv", "SAGE", "run_aligned", False),
    ("mlp_per_node", "PNA", "unaligned", False),
    ("mlp_per_node", "PNA", "run_aligned", True),
])
def test_node_heads_match_jax(head, model_type, layout, edge):
    cfg, jcfg, loader, jloader = _both(layout, edge, head, model_type)
    batch, jbatch = next(iter(loader)), next(iter(jloader))
    _check_layout(batch, layout)
    model = _compare_step(cfg, jcfg, batch, jbatch)
    kind = ConvHead if head == "conv" else PerNodeMLP
    assert sum(isinstance(h, kind) for h in model.heads) == 3


@pytest.mark.parametrize("edge,head", [(True, "mlp"), (False, "conv"), (True, "conv"), (False, "mlp_per_node")])
def test_variables_from_flax_consumes_every_leaf_once(edge, head):
    """Flax's creation-order names (``Dense_0`` the edge projection when
    there are edge features, the conv head's unnamed convs and its
    continued BatchNorm numbers, PerNodeMLP's ``w_i``/``b_i``) map onto
    distinct port entries of the same shapes, and the mapping needs the
    cfg exactly when a conv head is present."""
    cfg, jcfg, loader, jloader = _both("run_aligned", edge, head, n=16)
    _, variables = _jax_model(jcfg, next(iter(jloader)))
    model = create_model_config(cfg["NeuralNetwork"], device="cpu")
    sd = variables_from_flax(_tree(variables), model.cfg)
    assert len(sd) == len(jax.tree_util.tree_leaves(variables))
    assert sorted(sd) == sorted(model.state_dict())
    for name, t in model.state_dict().items():
        assert sd[name].shape == t.shape, name
    if edge:
        assert "convs.0.edge_proj.weight" in sd and "convs.0.post.weight" in sd
    if head == "conv":
        assert "heads.1.convs.2.post.weight" in sd and "heads.3.norms.2.running_var" in sd
        with pytest.raises(ValueError, match="cfg"):
            variables_from_flax(_tree(variables))
    if head == "mlp_per_node":
        assert sd["heads.1.w_0"].shape == (16, 8, 8)


def _molecular(mod_data, mod_prep, mod_update, n=60):
    """``tests/test_train_e2e.py``'s data (default unit cells, seed 0,
    stratified split) under its PNA config: tight degrees, so both
    loaders pick the dense slot map."""
    cfg = make_config("PNA", True, "")
    cfg["NeuralNetwork"]["Training"]["Optimizer"]["learning_rate"] = 1e-3
    samples = mod_data(number_configurations=n, seed=0)
    tr, va, te, _, _ = mod_prep(samples, cfg)
    return tr, mod_update(cfg, tr, va, te)


def test_three_step_trajectory_on_the_dense_map_matches_jax():
    tr, cfg = _molecular(deterministic_graph_data, prepare_dataset, update_config)
    jtr, jcfg = _molecular(jax_data, jax_prepare_dataset, jax_update_config)
    loader, jloader = GraphLoader(tr, 14, shuffle=True), JaxGraphLoader(jtr, 14, shuffle=True, prefetch=0)
    assert loader.dense_slots == jloader.dense_slots and loader.dense_slots > 0 and loader.run_align == 0
    batches, jbatches = list(loader)[:3], list(jloader)[:3]
    assert len(batches) == 3 and batches[0].dense_senders is not None
    jmodel, variables = _jax_model(jcfg, jbatches[0])
    tx = jax_select_optimizer(jcfg["NeuralNetwork"]["Training"])
    grad_fn = _jax_grad_fn(jmodel)
    model = _port_model(cfg, variables)
    optimizer = select_optimizer(model, cfg["NeuralNetwork"]["Training"])
    params, stats, opt_state = variables["params"], variables["batch_stats"], tx.init(variables["params"])
    lr = cfg["NeuralNetwork"]["Training"]["Optimizer"]["learning_rate"]
    for step, (batch, jbatch) in enumerate(zip(batches, jbatches)):
        (jloss, (jtasks, _, stats)), jgrads = grad_fn(params, stats, jbatch)
        updates, opt_state = tx.update(jgrads, opt_state, params)
        params = optax.apply_updates(params, updates)
        optimizer.zero_grad()
        loss, tasks = model_loss(model.cfg, model(batch, train=True), batch)
        loss.backward()
        np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-4, err_msg=f"step {step}")
        np.testing.assert_allclose(torch.stack(tasks).detach().numpy(), np.asarray(jtasks), rtol=1e-4)
        want = variables_from_flax({"params": _tree(jgrads)})
        zero_grad = {}  # entries whose gradient is 0 up to rounding
        for name, p in model.named_parameters():
            np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), err_msg=f"step {step} {name}", **TOL)
            zero_grad[name] = want[name].abs() < TOL["atol"]
            if name.startswith("convs.") and name.endswith("post.bias"):  # feeds a BatchNorm
                zero_grad[name] = torch.ones_like(want[name], dtype=torch.bool)
        optimizer.step()
        now = variables_from_flax({"params": _tree(params), "batch_stats": _tree(stats)})
        sd = model.state_dict()
        for name in now:
            if name in zero_grad:
                z = zero_grad[name]
                moved = torch.where(z, (sd[name] - now[name]).abs(), torch.zeros(()))
                assert float(moved.max()) <= 2 * lr * (step + 1), name
                with torch.no_grad():
                    sd[name].copy_(torch.where(z, now[name], sd[name]))
            tol = TOL if "running" in name else dict(rtol=1e-4, atol=2e-5)
            np.testing.assert_allclose(sd[name].numpy(), now[name].numpy(), err_msg=f"step {step} {name}", **tol)


@pytest.mark.parametrize("multihead", [False, True])
def test_run_training_then_prediction_meets_reference_accuracy(multihead, tmp_path):
    """``tests/test_train_e2e.py``'s PNA run (300 samples, 40 epochs,
    batch 16, the dense slot map with 7 slots) through the port on the
    CPU: every head's RMSE and MAE below the reference bar."""
    log_dir = str(tmp_path / "logs")
    model, _, history, done = hg.run_training(
        make_config("PNA", multihead, str(tmp_path)), deterministic_graph_data(number_configurations=300, seed=0),
        log_dir=log_dir, device="cpu",
    )
    assert len(history["train_loss"]) == 40
    train_loader, _, _, _ = hg.api.prepare_loaders_and_config(
        make_config("PNA", multihead, str(tmp_path)), deterministic_graph_data(number_configurations=300, seed=0)
    )
    assert train_loader.dense_slots == 7 and train_loader.run_align == 0
    # error_rmse_task as tests/test_train_e2e.py names and reads it (the
    # per-head test loss), and the sample MAE
    _, error_rmse_task, trues, preds = hg.run_prediction(
        make_config("PNA", multihead, str(tmp_path)), deterministic_graph_data(number_configurations=300, seed=0),
        log_dir=log_dir, device="cpu",
    )
    assert len(preds) == (4 if multihead else 1)
    for ihead, (t, p) in enumerate(zip(trues, preds)):
        mae = float(np.mean(np.abs(t - p)))
        assert float(error_rmse_task[ihead]) < PNA_THRESHOLDS[0], (ihead, float(error_rmse_task[ihead]))
        assert mae < PNA_THRESHOLDS[1], (ihead, mae)


def test_build_flagship_with_edge_lengths_trains():
    """``build_flagship(edge_lengths=True)`` sets the length edge feature
    (edge_dim 1), so every PNA conv carries the edge projection, and a
    run-aligned step runs the edge branch with finite gradients."""
    config, model, loader = hg.flagship.build_flagship(
        n_samples=24, hidden_dim=8, num_conv_layers=2, batch_size=6, device="cpu", edge_lengths=True
    )
    assert config["NeuralNetwork"]["Architecture"]["edge_dim"] == 1
    assert all(c.edge_proj is not None and c.pre_kernel.shape[0] == 3 * c.in_dim for c in model.convs)
    batch = next(iter(loader))
    assert batch.run_align == 8 and batch.edge_attr is not None
    loss, _ = model_loss(model.cfg, model(batch, train=True), batch)
    loss.backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in model.parameters())


def test_chip_smoke_accuracy_config_is_the_e2e_config():
    """``chip_smoke.py`` holds its own copy of the e2e config (it imports
    nothing of the JAX package's tests); the copy must equal
    ``tests/test_train_e2e.py:make_config`` for PNA."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    for multihead in (False, True):
        assert smoke.e2e_config(multihead) == make_config("PNA", multihead, "")
    assert smoke.E2E_THRESHOLDS == PNA_THRESHOLDS


def test_gin_conv_head_f32_error_is_rounding_as_in_jax(monkeypatch):
    """A ``conv`` node head of GIN convs is ill-conditioned in f32 (eps =
    100 scales each node's own features by 101 before a BatchNorm): the
    port's and the JAX package's f32 outputs differ by more than the
    model tolerance on a few entries. Both are rounding: against the
    port's model evaluated in float64 (the B8 plain version, which takes
    any float type), the port's f32 error is no larger than the JAX
    package's (up to a factor 2) on every head."""
    import dataclasses

    from hydragnn_tpu_torch.ops import fused_conv as b8

    kernel = b8.fused_conv

    def any_float(x, *a, **k):
        if x.dtype == torch.float64:
            return b8.fused_conv_plain(x, *a[:7])
        return kernel(x, *a, **k)

    monkeypatch.setattr(b8, "fused_conv", any_float)
    cfg, jcfg, loader, jloader = _both("run_aligned", False, "conv", "GIN")
    batch, jbatch = next(iter(loader)), next(iter(jloader))
    jmodel, variables = _jax_model(jcfg, jbatch)
    jouts = jmodel.apply(variables, jbatch, train=True, mutable=["batch_stats"])[0]
    outs = _port_model(cfg, variables)(batch, train=True)
    outs64 = _port_model(cfg, variables).double()(dataclasses.replace(batch, nodes=batch.nodes.double()), train=True)
    for o, r, d in zip(outs, jouts, outs64):
        d = d.detach().numpy()
        port_err = np.abs(o.detach().numpy() - d).max()
        jax_err = np.abs(np.asarray(r) - d).max()
        assert port_err <= max(2 * jax_err, 1e-6), (port_err, jax_err)


@pytest.mark.parametrize("source", ["bcc_pinned_dense", "molecules_auto_dense"])
def test_dense_sender_perm_sorts_the_empty_slots_last(source):
    """What the dense branch's gather backward relies on to sum over the
    real slots only: every empty slot names the padding node, above
    every real sender, so the batch's stable argsort of the flat dense
    senders puts all empty slots after all real ones."""
    if source == "bcc_pinned_dense":
        tr, _ = _splits(deterministic_graph_data, prepare_dataset, update_config, pna_config(flagship_config), 40)
        loader = GraphLoader(tr, 8, shuffle=True, **_layout_args("dense", tr))
    else:
        tr, _ = _molecular(deterministic_graph_data, prepare_dataset, update_config)
        loader = GraphLoader(tr, 14, shuffle=True)
    empty_seen = 0
    for batch in list(loader)[:4]:
        mask = batch.dense_mask.reshape(-1)
        perm = batch.dense_sender_perm.long()
        flat = batch.dense_senders.reshape(-1)
        real_sorted = mask[perm]
        n_real = int(mask.sum())
        assert bool(real_sorted[:n_real].all()) and not bool(real_sorted[n_real:].any())
        assert bool((flat[~mask] == batch.n_real_nodes).all())
        assert bool((flat[mask] < batch.n_real_nodes).all())
        empty_seen += int((~mask).sum())
    assert empty_seen > 0
