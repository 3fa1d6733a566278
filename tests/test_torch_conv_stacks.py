"""The GIN, SAGE, MFC, SchNet and CGCNN stacks against the JAX package:
the completed config, each stack's forward, per-head losses and every
parameter gradient (weights carried across by ``convert.py``), a 3-step
training trajectory, the dense slot map, the refusals of what is not
ported, and ``run_training`` -> ``run_prediction`` on the CPU. Small
sizes throughout: hidden 8, 2 conv layers, about 40 BCC samples.

Tolerances and why:
  - forward, losses and gradients ``rtol=1e-4, atol=1e-5`` in float32
    (matrix products and sums accumulate in another order in the two
    frameworks; the JAX package on the CPU takes its composed path,
    numerically the same function as its fused kernel);
  - trajectory losses ``rtol=1e-4``, gradients and BatchNorm statistics
    ``rtol=1e-4, atol=1e-5``, parameters after each AdamW step
    ``rtol=1e-4, atol=2e-5`` (2% of the learning rate: Adam divides each
    gradient by its own magnitude). Entries whose gradient is 0 up to
    rounding (below the gradients' atol, where the two signs cannot be
    told apart, and the conv biases that feed a BatchNorm) are held to
    move by at most lr per step and carried across, as in
    ``tests/test_torch_train.py``: a BatchNorm removes any shift, and
    after GIN's conv_0, whose input has width 1, also the scale, of what
    feeds it;
  - the dense slot map: every field equal;
  - CPU round trip: exact (the same computation twice).

The port's side of every JAX comparison here runs on one intra-op
thread (``one_thread``). In about one pytest process in ten that also
runs the JAX package, the first multi-threaded ``torch.exp`` of the
process returned one thread's chunk (1/8 of the elements) off by up to
1.06e-4, SchNet's Gaussian smearing being the first such call; the
second identical call, and the same call on one thread, agree with each
other. Changing the rounding mode moves ``exp`` by at most 1.8e-7, so it
is not that; bare processes never showed it (0 of 80). One thread takes
the intra-op pool out of the comparison; the tolerances are unchanged.
"""

import copy
import dataclasses

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
from hydragnn_tpu_torch.models import convs as C
from hydragnn_tpu_torch.models.base import model_loss
from hydragnn_tpu_torch.models.create import create_model_config, model_config_from_dict
from hydragnn_tpu_torch.train import loop as t_loop
from hydragnn_tpu_torch.train.optimizer import select_optimizer
from hydragnn_tpu_torch.utils.config import update_config

TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _diagnostics_off():
    """The training loop's per-head diagnostics and hardware ledger off in
    this file (``test_torch_{introspect,train_obs}.py`` test them): they
    add a forward and H + 1 backward pulls an epoch, and a counted
    forward and backward a run, to every run here."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HGTORCH_DIAGNOSTICS", "0")
        yield


@pytest.fixture
def one_thread():
    """The port's CPU ops on one intra-op thread for one test (module
    docstring), the thread count restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

UNIT = dict(unit_cell_x_range=(2, 4), unit_cell_y_range=(2, 4), unit_cell_z_range=(2, 4))
STACKS = ["GIN", "SAGE", "MFC", "SchNet", "CGCNN"]
JAX_ONLY_KEYS = {"diagnostics", "diag_every", "Parallel"}
# conv biases that feed a BatchNorm (their gradient is 0 up to rounding)
BN_FED_BIASES = {
    "GIN": ("dense_1.bias",),
    "SAGE": ("dense_0.bias",),
    "SchNet": ("dense_3.bias",),
}


def stack_config(make, model_type, edge_features=False, hidden=8, layers=2, batch=8, epochs=1, inputs=(0,)):
    cfg = make(hidden, layers, batch, epochs)
    cfg["NeuralNetwork"]["Variables_of_interest"]["input_node_features"] = list(inputs)
    arch = cfg["NeuralNetwork"]["Architecture"]
    arch["model_type"] = model_type
    if model_type == "SchNet":
        arch["num_gaussians"], arch["num_filters"] = 10, 12
    if edge_features:
        arch["edge_features"] = ["lengths"]
    return cfg


def _splits(mod_data, mod_prep, mod_update, cfg, n, seed=2):
    samples = mod_data(number_configurations=n, seed=seed, **UNIT)
    tr, va, te, _, _ = mod_prep(samples, cfg)
    return tr, mod_update(cfg, tr, va, te)


def _both(model_type, edge_features=False, n=40, batch=8, inputs=(0,), hidden=8):
    """(port config, JAX config, port loader, JAX loader): the same
    prepared BCC samples in both packages, shuffled run-aligned loaders."""
    tr, cfg = _splits(deterministic_graph_data, prepare_dataset, update_config,
                      stack_config(flagship_config, model_type, edge_features, hidden, batch=batch, inputs=inputs), n)
    jtr, jcfg = _splits(jax_data, jax_prepare_dataset, jax_update_config,
                        stack_config(jax_flagship_config, model_type, edge_features, hidden, batch=batch,
                                     inputs=inputs), n)
    return cfg, jcfg, GraphLoader(tr, batch, shuffle=True), JaxGraphLoader(jtr, batch, shuffle=True, prefetch=0)


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


KNOBS = {"inforward": {"radius_graph_in_forward": True}, "bf16": {"conv_bf16": True},
         "residency": {"conv_residency": True}, "composed": {"fused_conv": False}}


@pytest.mark.parametrize("model_type", STACKS + ["PNA-edge", "PNA-conv", "PNA-mlp_per_node", "GAT", "GAT-conv",
                                                 "SchNet-inforward", "GIN-bf16", "CGCNN-bf16", "GIN-residency",
                                                 "GIN-composed"])
def test_update_config_matches_jax_key_for_key(model_type):
    """The completed configs are equal, ``fused_conv`` (default on)
    included; only the JAX package's runtime knobs stay out. The PNA
    cases add edge features and the two other node head types; GAT, the
    in-forward radius graph and the conv knobs (``conv_bf16``,
    ``conv_residency``, ``fused_conv: false``) are set as a user sets
    them, and both packages' ``ModelConfig`` read them alike."""
    model_type, _, option = model_type.partition("-")

    def make(mod):
        cfg = stack_config(mod, model_type, edge_features=option == "edge")
        if option in ("conv", "mlp_per_node"):
            cfg["NeuralNetwork"]["Architecture"]["output_heads"]["node"]["type"] = option
        cfg["NeuralNetwork"]["Architecture"].update(KNOBS.get(option, {}))
        return cfg

    # mlp_per_node needs graphs of one size: 2 unit cells a side
    unit = dict.fromkeys(UNIT, (2, 3)) if option == "mlp_per_node" else UNIT
    done = []
    for data, prep, update, mod in ((deterministic_graph_data, prepare_dataset, update_config, flagship_config),
                                    (jax_data, jax_prepare_dataset, jax_update_config, jax_flagship_config)):
        cfg = make(mod)
        tr, va, te, _, _ = prep(data(number_configurations=16, seed=2, **unit), cfg)
        done.append(update(cfg, tr, va, te))
    cfg, jcfg = done

    def strip(d):
        if isinstance(d, dict):
            return {k: strip(v) for k, v in d.items() if k not in JAX_ONLY_KEYS}
        return d

    assert cfg["NeuralNetwork"]["Architecture"]["fused_conv"] is (option != "composed")
    assert strip(copy.deepcopy(cfg)) == strip(copy.deepcopy(jcfg))
    if option == "edge":
        assert cfg["NeuralNetwork"]["Architecture"]["edge_dim"] == 1
    ours, ref = model_config_from_dict(cfg["NeuralNetwork"]), jax_model_config(jcfg["NeuralNetwork"])
    for f in dataclasses.fields(ours):
        assert getattr(ours, f.name) == getattr(ref, f.name), f.name


def test_gaussian_smearing_on_one_thread_matches_float64(one_thread):
    """SchNet's smearing at the parity tests' size on one intra-op thread
    (module docstring): every entry within 1e-6 of the float64 value."""
    d = torch.rand(6000, generator=torch.Generator().manual_seed(0)) * 2.5
    out = C.gaussian_smearing(d, 0.0, 2.0, 50)
    offs = np.linspace(0.0, 2.0, 50)
    coeff = -0.5 / (2.0 / 49) ** 2
    ref = np.exp(coeff * (d.numpy().astype(np.float64)[:, None] - offs[None, :]) ** 2)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("model_type", STACKS)
def test_init_distributions_match_jax(model_type):
    """The port's seeded init draws every parameter from the JAX
    package's distribution (the generators differ, so the values do
    not): zeros stay zeros, GIN's eps is 100, and each tensor of 256
    entries or more has a std within 25% and a largest magnitude within
    10% of the JAX init's (lecun-normal, the torch-style uniforms,
    xavier)."""
    cfg, jcfg, loader, jloader = _both(model_type, n=16, inputs=(0, 1, 2), hidden=32)
    _, variables = _jax_model(jcfg, next(iter(jloader)))
    want = variables_from_flax(jax.tree_util.tree_map(np.asarray, variables))
    model = create_model_config(cfg["NeuralNetwork"], seed=3, device="cpu")
    for name, t in model.state_dict().items():
        ref = want[name]
        assert t.shape == ref.shape, name
        if not ref.any() or ref.numel() == 1:
            assert torch.equal(t, ref), name
        elif ref.numel() >= 256:
            assert 0.8 < float(t.std() / ref.std()) < 1.25, name
            assert 0.9 < float(t.abs().max() / ref.abs().max()) < 1.1, name


@pytest.mark.parametrize("model_type,edge_features", [(m, False) for m in STACKS] + [("CGCNN", True), ("SchNet", True)])
def test_stack_forward_losses_and_grads_match_jax(model_type, edge_features, one_thread):
    cfg, jcfg, loader, jloader = _both(model_type, edge_features)
    batch, jbatch = next(iter(loader)), next(iter(jloader))
    assert batch.run_align == 8
    jmodel, variables = _jax_model(jcfg, jbatch)
    (jloss, (jtasks, jouts, jstats)), jgrads = _jax_grad_fn(jmodel)(
        variables["params"], variables["batch_stats"], jbatch
    )
    model = create_model_config(cfg["NeuralNetwork"], device="cpu")
    sd = variables_from_flax(jax.tree_util.tree_map(np.asarray, variables))
    assert len(sd) == len(jax.tree_util.tree_leaves(variables)) == len(model.state_dict())
    model.load_state_dict(sd, strict=True)
    outs = model(batch, train=True)
    loss, tasks = model_loss(model.cfg, outs, batch)
    loss.backward()
    for o, r in zip(outs, jouts):
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(r), **TOL)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-4)
    np.testing.assert_allclose(torch.stack(tasks).detach().numpy(), np.asarray(jtasks), rtol=1e-4)
    want = variables_from_flax({"params": jax.tree_util.tree_map(np.asarray, jgrads)})
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), err_msg=name, **TOL)
    stats = variables_from_flax({"batch_stats": jax.tree_util.tree_map(np.asarray, jstats)})
    for name, v in stats.items():
        np.testing.assert_allclose(model.state_dict()[name].numpy(), v.numpy(), err_msg=name, **TOL)


@pytest.mark.parametrize("model_type", ["GIN", "SchNet", "CGCNN"])
def test_three_step_training_trajectory_matches_jax(model_type, one_thread):
    """Two input features: with one, GIN's conv_0 feeds its BatchNorm an
    affine function of a single scalar per node, which the BatchNorm
    normalizes away, and Adam turns the rounding-level gradients of
    those weights into lr-sized steps that differ between the two
    frameworks (the forward and gradient test above covers one input)."""
    cfg, jcfg, loader, jloader = _both(model_type, n=30, inputs=(0, 1))
    batches, jbatches = list(loader), list(jloader)
    assert len(batches) == 3
    jmodel, variables = _jax_model(jcfg, jbatches[0])
    tx = jax_select_optimizer(jcfg["NeuralNetwork"]["Training"])
    grad_fn = _jax_grad_fn(jmodel)
    model = create_model_config(cfg["NeuralNetwork"], device="cpu")
    model.load_state_dict(variables_from_flax(variables), strict=True)
    optimizer = select_optimizer(model, cfg["NeuralNetwork"]["Training"])
    params, stats, opt_state = variables["params"], variables["batch_stats"], tx.init(variables["params"])
    bn_fed = BN_FED_BIASES.get(model_type, ())
    for step, (batch, jbatch) in enumerate(zip(batches, jbatches)):
        (jloss, (jtasks, _, stats)), jgrads = grad_fn(params, stats, jbatch)
        updates, opt_state = tx.update(jgrads, opt_state, params)
        params = optax.apply_updates(params, updates)
        optimizer.zero_grad()
        loss, tasks = model_loss(model.cfg, model(batch, train=True), batch)
        loss.backward()
        np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-4, err_msg=f"step {step}")
        np.testing.assert_allclose(torch.stack(tasks).detach().numpy(), np.asarray(jtasks), rtol=1e-4, err_msg=f"step {step} tasks")
        want = variables_from_flax({"params": jax.tree_util.tree_map(np.asarray, jgrads)})
        zero_grad = {}  # entries whose gradient is 0 up to rounding
        for name, p in model.named_parameters():
            np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), err_msg=f"step {step} {name}", **TOL)
            # below the gradients' atol their signs cannot be told apart
            zero_grad[name] = want[name].abs() < TOL["atol"]
            if name.startswith("convs.") and name.endswith(bn_fed):
                zero_grad[name] = torch.ones_like(want[name], dtype=torch.bool)
        optimizer.step()
        now = variables_from_flax({"params": params, "batch_stats": stats})
        sd = model.state_dict()
        for name in now:
            if name in zero_grad:
                # Adam turns a gradient that is 0 up to rounding into a
                # step of up to lr either way: held to that, then carried
                # across so that the next steps stay comparable
                z = zero_grad[name]
                moved = torch.where(z, (sd[name] - now[name]).abs(), torch.zeros(()))
                assert float(moved.max()) <= 2e-3 * (step + 1), name
                with torch.no_grad():
                    sd[name].copy_(torch.where(z, now[name], sd[name]))
            tol = TOL if "running" in name else dict(rtol=1e-4, atol=2e-5)
            np.testing.assert_allclose(sd[name].numpy(), now[name].numpy(), err_msg=f"step {step} {name}", **tol)


def _molecular(mod_data, mod_prep, mod_update, model_type, n=40):
    """The ``tests/test_train_e2e.py`` data (default unit cells, seed 0,
    stratified split) under the flagship chassis at hidden 8: tight
    degrees, so the loaders pick the dense slot map."""
    cfg = stack_config(jax_flagship_config if mod_data is jax_data else flagship_config, model_type, batch=16)
    cfg["Dataset"]["compositional_stratified_splitting"] = True
    cfg["NeuralNetwork"]["Training"]["perc_train"] = 0.7
    samples = mod_data(number_configurations=n, seed=0)
    tr, va, te, _, _ = mod_prep(samples, cfg)
    return tr, mod_update(cfg, tr, va, te)


def test_dense_slot_map_equals_jax_and_gin_runs_on_it():
    tr, cfg = _molecular(deterministic_graph_data, prepare_dataset, update_config, "GIN")
    jtr, jcfg = _molecular(jax_data, jax_prepare_dataset, jax_update_config, "GIN")
    loader, jloader = GraphLoader(tr, 16), JaxGraphLoader(jtr, 16, prefetch=0)
    assert loader.dense_slots == jloader.dense_slots and loader.dense_slots > 0
    assert loader.run_align == jloader.run_align == 0
    batches, jbatches = list(loader), list(jloader)
    assert len(batches) == len(jbatches) == 2
    for ours, ref in zip(batches, jbatches):
        for f in dataclasses.fields(ours):
            a, b = getattr(ours, f.name), getattr(ref, f.name)
            if isinstance(a, torch.Tensor):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f.name)
                assert a.numpy().dtype == np.asarray(b).dtype, f.name
            elif not isinstance(a, dict):
                assert a == b, f.name
        assert ours.dense_senders is not None and ours.sender_win is not None
    jmodel, variables = _jax_model(jcfg, jbatches[0])
    model = create_model_config(cfg["NeuralNetwork"], device="cpu")
    model.load_state_dict(variables_from_flax(variables), strict=True)
    ref = jmodel.apply(variables, jbatches[0], train=False)
    with torch.no_grad():
        outs = model(batches[0], train=False)
    for o, r in zip(outs, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **TOL)


@pytest.mark.parametrize("key,value", [
    ("freeze_conv_layers", True),
    ("model_type", "GAT"),
    ("radius_graph_in_forward", True),
    ("conv_bf16", True),
    ("fused_conv", False),
])
def test_formerly_unported_options_build_and_run(key, value):
    """``freeze_conv_layers`` (the optimizer's mask, held to optax in
    test_torch_optimizers.py), GAT, the in-forward radius graph (on
    SchNet), ``conv_bf16`` and ``fused_conv: false`` build and run a
    finite forward."""
    model_type = "SchNet" if key == "radius_graph_in_forward" else "GIN"
    tr, cfg = _splits(deterministic_graph_data, prepare_dataset, update_config,
                      stack_config(flagship_config, model_type), 12)
    cfg["NeuralNetwork"]["Architecture"][key] = value
    model = create_model_config(cfg["NeuralNetwork"], device="cpu")
    with torch.no_grad():
        outs = model(next(iter(GraphLoader(tr, 8))), train=False)
    assert all(torch.isfinite(o).all() for o in outs)


@pytest.mark.parametrize("model_type", STACKS)
def test_run_training_then_prediction_roundtrip_cpu(model_type, tmp_path):
    def cfg():
        return stack_config(flagship_config, model_type, batch=16, epochs=2)

    def raw():
        return deterministic_graph_data(number_configurations=40, seed=0, **UNIT)

    model, _, history, done = hg.run_training(cfg(), raw(), log_dir=str(tmp_path), device="cpu")
    assert len(history["train_loss"]) == 2 and np.isfinite(history["train_loss"]).all()
    assert model.cfg.model_type == model_type
    _, _, test_loader, _ = hg.api.prepare_loaders_and_config(cfg(), raw())
    in_memory = t_loop.test_epoch(test_loader, model)
    err, tasks, trues, preds = hg.run_prediction(cfg(), raw(), log_dir=str(tmp_path), device="cpu")
    assert err == in_memory[0]
    np.testing.assert_array_equal(tasks, in_memory[1])
    for a, b in zip(preds + trues, in_memory[3] + in_memory[2]):
        np.testing.assert_array_equal(a, b)
