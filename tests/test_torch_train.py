"""The training slice against the JAX package: ``PNAConv``'s run-aligned
branch (forward and gradients), the BatchNorm running-statistics update,
the loss, the optimizer and the plateau/early-stop controllers, a
3-step ``HydraModel`` training trajectory from one init carried across
by ``convert.py``, and a ``run_training`` -> ``run_prediction`` round
trip on the CPU.

Tolerances and why:
  - model forward and gradients ``rtol=1e-4, atol=1e-5`` (matrix products
    and sums accumulate in another order in the two frameworks);
  - trajectory losses ``rtol=1e-4``; gradients and BatchNorm statistics
    along it ``rtol=1e-4, atol=1e-5``; parameters after each AdamW step
    ``rtol=1e-4, atol=2e-5`` = 2% of the learning rate (Adam divides each
    gradient by its own magnitude, so an entry whose gradient is near 0
    turns the gradients' atol-level differences into parameter
    differences of a few percent of lr; 5.9e-6 seen). The conv biases
    that feed a BatchNorm have a gradient that is 0 up to rounding, so
    they are held only to move by at most lr per step in both, and then
    carried across from the JAX side before the next step;
  - the optimizer alone ``rtol=1e-5, atol=1e-9`` (optax's and PyTorch's
    AdamW round their bias corrections differently: 1.3e-6 seen);
  - CPU round trip: exact (the same computation twice).
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
from hydragnn_tpu.models import convs as jax_convs
from hydragnn_tpu.models.base import HydraModel as JaxHydraModel
from hydragnn_tpu.models.base import model_loss as jax_model_loss
from hydragnn_tpu.models.create import model_config_from_dict as jax_model_config
from hydragnn_tpu.models.layers import MaskedBatchNorm as JaxBatchNorm
from hydragnn_tpu.postprocess.postprocess import output_denormalize as jax_output_denormalize
from hydragnn_tpu.train import loop as jax_loop
from hydragnn_tpu.train.optimizer import select_optimizer as jax_select_optimizer
from hydragnn_tpu.train.state import create_train_state
from hydragnn_tpu.utils.config import update_config as jax_update_config

import hydragnn_tpu_torch as hg
from hydragnn_tpu_torch.convert import variables_from_flax
from hydragnn_tpu_torch.data.ingest import prepare_dataset
from hydragnn_tpu_torch.data.loader import GraphLoader
from hydragnn_tpu_torch.data.synthetic import deterministic_graph_data
from hydragnn_tpu_torch.flagship import flagship_config
from hydragnn_tpu_torch.models.base import model_loss
from hydragnn_tpu_torch.models.convs import EdgeContext, PNAConv, avg_degree_stats
from hydragnn_tpu_torch.models.create import create_model_config
from hydragnn_tpu_torch.models.layers import MaskedBatchNorm
from hydragnn_tpu_torch.train import loop as t_loop
from hydragnn_tpu_torch.train.optimizer import select_optimizer
from hydragnn_tpu_torch.utils.config import update_config

TOL = dict(rtol=1e-4, atol=1e-5)
UNIT = dict(unit_cell_x_range=(2, 4), unit_cell_y_range=(2, 4), unit_cell_z_range=(2, 4))


@pytest.fixture(autouse=True, scope="module")
def _diagnostics_off():
    """The training loop's per-head diagnostics and hardware ledger off in
    this file (``test_torch_{introspect,train_obs}.py`` test them): they
    add a forward and H + 1 backward pulls an epoch, and a counted
    forward and backward a run, to every run here."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HGTORCH_DIAGNOSTICS", "0")
        yield


def _splits(mod_data, mod_prep, mod_update, cfg, n, seed=2):
    samples = mod_data(number_configurations=n, seed=seed, **UNIT)
    tr, va, te, _, _ = mod_prep(samples, cfg)
    return tr, mod_update(cfg, tr, va, te)


@pytest.fixture(scope="module")
def flagship_small():
    """24 BCC graphs prepared by both packages, hidden 24, 2 layers,
    batch 8, and both packages' shuffled run-aligned train loaders."""
    tr, cfg = _splits(deterministic_graph_data, prepare_dataset, update_config, flagship_config(24, 2, 8), 24)
    jtr, jcfg = _splits(jax_data, jax_prepare_dataset, jax_update_config, jax_flagship_config(24, 2, 8), 24)
    return cfg, jcfg, GraphLoader(tr, 8, shuffle=True), JaxGraphLoader(jtr, 8, shuffle=True, prefetch=0)


@pytest.mark.parametrize("fin", [1, 24])
def test_pnaconv_run_aligned_matches_jax(flagship_small, fin):
    cfg, _, loader, jloader = flagship_small
    batch, jbatch = next(iter(loader)), next(iter(jloader))
    assert batch.run_align == 8
    lin, log = avg_degree_stats(cfg["NeuralNetwork"]["Architecture"]["pna_deg"])
    rng = np.random.default_rng(fin)
    x = rng.normal(size=(batch.num_nodes, fin)).astype(np.float32)
    # flax's own init and a cotangent of this size keep the gradients
    # O(1), where atol 1e-5 is about f32 accumulation-order noise
    g = (rng.normal(size=(batch.num_nodes, 32)) / batch.num_nodes).astype(np.float32)
    jconv = jax_convs.PNAConv(32, avg_deg_lin=lin, avg_deg_log=log)

    def jctx():
        return jax_convs.EdgeContext(
            senders=jbatch.senders, receivers=jbatch.receivers, edge_mask=jbatch.edge_mask,
            node_mask=jbatch.node_mask, sender_perm=jbatch.sender_perm, in_degree=jbatch.in_degree,
            sender_win=jbatch.sender_win, run_align=jbatch.run_align,
        )

    params = jconv.init(jax.random.PRNGKey(fin), jnp.asarray(x), jctx())
    params["params"]["pre_bias"] = jnp.asarray(rng.normal(scale=0.3, size=fin).astype(np.float32))

    @jax.jit
    def fwd_bwd(p, x_, g_):
        out, vjp = jax.vjp(lambda p_, xx: jconv.apply(p_, xx, jctx()), p, x_)
        return out, vjp(g_)

    ref, (jgp, jgx) = fwd_bwd(params, jnp.asarray(x), jnp.asarray(g))

    conv = PNAConv(fin, 32, lin, log)
    sd = variables_from_flax({"params": {"conv_0": params["params"]}})
    conv.load_state_dict({k[len("convs.0."):]: v for k, v in sd.items()}, strict=True)
    ctx = EdgeContext(
        senders=batch.senders, receivers=batch.receivers, edge_mask=batch.edge_mask,
        node_mask=batch.node_mask, in_degree=batch.in_degree, sender_win=batch.sender_win,
        run_align=batch.run_align,
    )
    xt = torch.from_numpy(x).requires_grad_(True)
    out = conv(xt, ctx)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), **TOL)
    gsd = variables_from_flax({"params": {"conv_0": jgp["params"]}})
    for name, p in conv.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), gsd["convs.0." + name].numpy(), err_msg=name, **TOL)


def test_masked_batchnorm_running_stats_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(loc=1.5, size=(40, 6)).astype(np.float32)
    mask = rng.random(40) > 0.3
    jbn = JaxBatchNorm(6)
    variables = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask), train=False)
    ref, mutated = jbn.apply(variables, jnp.asarray(x), jnp.asarray(mask), train=True, mutable=["batch_stats"])
    bn = MaskedBatchNorm(6)
    out = bn(torch.from_numpy(x), torch.from_numpy(mask), train=True)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(mutated["batch_stats"]["mean"]), rtol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(mutated["batch_stats"]["var"]), rtol=1e-6)
    before = bn.running_mean.clone()
    bn(torch.from_numpy(x), torch.from_numpy(mask), train=False)
    assert torch.equal(bn.running_mean, before)  # eval never updates


def _jax_model(jcfg, jbatch):
    jmodel = JaxHydraModel(jax_model_config(jcfg["NeuralNetwork"]))
    return jmodel, jax.jit(lambda b: jmodel.init(jax.random.PRNGKey(0), b, train=False))(jbatch)


def _torch_grads(model):
    return {k: p.grad.clone() for k, p in model.named_parameters()}


def test_three_step_training_trajectory_matches_jax(flagship_small):
    """Three AdamW steps of the whole model from one init on the same
    run-aligned batches: loss and per-head losses, every parameter's
    gradient, the BatchNorm running statistics, and the parameters."""
    cfg, jcfg, loader, jloader = flagship_small
    jbatches = list(jloader)
    batches = list(loader)
    assert len(batches) == 3
    jmodel, variables = _jax_model(jcfg, jbatches[0])
    training = jcfg["NeuralNetwork"]["Training"]
    tx = jax_select_optimizer(training)

    @jax.jit
    def jstep(params, stats, opt_state, batch):
        def loss_fn(p):
            outs, mut = jmodel.apply({"params": p, "batch_stats": stats}, batch, train=True, mutable=["batch_stats"])
            total, tasks = jax_model_loss(jmodel.cfg, [o.astype(jnp.float32) for o in outs], batch)
            return total, (jnp.stack(tasks), mut["batch_stats"])

        (loss, (tasks, new_stats)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), new_stats, opt_state, loss, tasks, grads

    model = create_model_config(cfg["NeuralNetwork"], device="cpu")
    model.load_state_dict(variables_from_flax(variables), strict=True)
    optimizer = select_optimizer(model, cfg["NeuralNetwork"]["Training"])
    params, stats, opt_state = variables["params"], variables["batch_stats"], tx.init(variables["params"])
    for step, (batch, jbatch) in enumerate(zip(batches, jbatches)):
        params, stats, opt_state, jloss, jtasks, jgrads = jstep(params, stats, opt_state, jbatch)
        optimizer.zero_grad()
        loss, tasks = model_loss(model.cfg, model(batch, train=True), batch)
        loss.backward()
        np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-4, err_msg=f"step {step}")
        np.testing.assert_allclose(torch.stack(tasks).detach().numpy(), np.asarray(jtasks), rtol=1e-4)
        want = variables_from_flax({"params": jax.tree_util.tree_map(np.asarray, jgrads)})
        for name, grad in _torch_grads(model).items():
            np.testing.assert_allclose(grad.numpy(), want[name].numpy(), err_msg=f"step {step} {name}", **TOL)
        optimizer.step()
        now = variables_from_flax({"params": params, "batch_stats": stats})
        sd = model.state_dict()
        for name in now:
            if name.startswith("convs.") and name.endswith("post.bias"):
                # feeds a BatchNorm, which removes any shift: its gradient
                # is 0 up to rounding, and Adam turns the two frameworks'
                # different roundings into different steps of up to lr
                # held to that, then carried across so that the BatchNorm
                # running means (which see the bias) stay comparable
                assert float((sd[name] - now[name]).abs().max()) <= 2e-3 * (step + 1), name
                with torch.no_grad():
                    sd[name].copy_(now[name])
                continue
            tol = TOL if "running" in name else dict(rtol=1e-4, atol=2e-5)
            np.testing.assert_allclose(sd[name].numpy(), now[name].numpy(), err_msg=f"step {step} {name}", **tol)


def test_adamw_matches_optax():
    rng = np.random.default_rng(0)
    w0 = rng.normal(size=(5, 3)).astype(np.float32)
    grads = [rng.normal(size=(5, 3)).astype(np.float32) for _ in range(4)]
    training = {"Optimizer": {"type": "AdamW", "learning_rate": 1e-2}}
    tx = jax_select_optimizer(training)
    p, s = {"w": jnp.asarray(w0)}, None
    s = tx.init(p)
    w = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = select_optimizer(torch.nn.ParameterList([w]), training)
    for g in grads:
        upd, s = tx.update({"w": jnp.asarray(g)}, s, p)
        p = optax.apply_updates(p, upd)
        w.grad = torch.from_numpy(g)
        opt.step()
        np.testing.assert_allclose(w.detach().numpy(), np.asarray(p["w"]), rtol=1e-5, atol=1e-9)
    # every optax optimizer of the JAX package is ported (each held to optax
    # in test_torch_optimizers.py); an unknown name raises as optax's does
    assert select_optimizer(torch.nn.ParameterList([w]), {"Optimizer": {"type": "SGD"}}).kind == "SGD"
    with pytest.raises(NameError, match="not recognized"):
        select_optimizer(torch.nn.ParameterList([w]), {"Optimizer": {"type": "Lion", "learning_rate": 1e-2}})


def test_plateau_and_early_stop_follow_jax():
    losses = [1.0, 0.9, 0.95, 0.9, 0.91, 0.92, 0.93, 0.94, 0.95, 0.96, 0.97, 0.98, 0.99, 1.0, 1.1, 1.2, 1.3]
    training = {"Optimizer": {"type": "AdamW", "learning_rate": 1e-3}}
    tx = jax_select_optimizer(training)
    state = create_train_state({"params": {"w": jnp.zeros(3)}}, tx)
    jsched, jstop = jax_loop.ReduceLROnPlateau(), jax_loop.EarlyStopping(patience=4)
    w = torch.nn.Parameter(torch.zeros(3))
    opt = select_optimizer(torch.nn.ParameterList([w]), training)
    sched, stop = t_loop.ReduceLROnPlateau(), t_loop.EarlyStopping(patience=4)
    for val in losses:
        state = jsched.step(state, val)
        sched.step(opt, val)
        assert opt.param_groups[0]["lr"] == pytest.approx(float(state.opt_state.hyperparams["learning_rate"]))
        assert stop(val) == jstop(val)
    assert opt.param_groups[0]["lr"] < 1e-3  # the plateau was reached


def test_build_flagship_trains_on_run_aligned_batches():
    config, model, loader = hg.flagship.build_flagship(
        n_samples=24, hidden_dim=8, num_conv_layers=2, batch_size=6, device="cpu"
    )
    assert loader.drop_last and loader.shuffle and len(loader) == len(loader.samples) // 6
    batch = next(iter(loader))
    assert batch.run_align == 8 and batch.num_edges % 8 == 0
    assert config["NeuralNetwork"]["Architecture"]["hidden_dim"] == 8
    loss, _ = model_loss(model.cfg, model(batch, train=True), batch)
    loss.backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in model.parameters())


def test_run_training_then_prediction_roundtrip_cpu(tmp_path):
    cfg = flagship_config(hidden_dim=16, num_conv_layers=2, batch_size=16, num_epoch=2)
    raw = deterministic_graph_data(number_configurations=40, seed=0, **UNIT)
    model, optimizer, history, done = hg.run_training(cfg, raw, log_dir=str(tmp_path), device="cpu")
    assert len(history["train_loss"]) == 2 and np.isfinite(history["train_loss"]).all()
    assert next(model.parameters()).device.type == "cpu"

    _, _, test_loader, _ = hg.api.prepare_loaders_and_config(
        flagship_config(16, 2, 16, 2), deterministic_graph_data(number_configurations=40, seed=0, **UNIT)
    )
    in_memory = t_loop.test_epoch(test_loader, model)
    err, tasks, trues, preds = hg.run_prediction(
        flagship_config(16, 2, 16, 2), deterministic_graph_data(number_configurations=40, seed=0, **UNIT),
        log_dir=str(tmp_path), device="cpu",
    )
    assert err == in_memory[0]
    np.testing.assert_array_equal(tasks, in_memory[1])
    for a, b in zip(preds + trues, in_memory[3] + in_memory[2]):
        np.testing.assert_array_equal(a, b)

    # denormalized as the JAX package denormalizes
    dcfg = flagship_config(16, 2, 16, 2)
    dcfg["NeuralNetwork"]["Variables_of_interest"]["denormalize_output"] = True
    _, _, dtrues, dpreds = hg.run_prediction(
        dcfg, deterministic_graph_data(number_configurations=40, seed=0, **UNIT),
        log_dir=str(tmp_path), device="cpu",
    )
    y_minmax = dcfg["NeuralNetwork"]["Variables_of_interest"]["y_minmax"]
    rtrues, rpreds = jax_output_denormalize(y_minmax, trues, preds)
    for a, b in zip(dtrues + dpreds, rtrues + rpreds):
        np.testing.assert_array_equal(a, b)
