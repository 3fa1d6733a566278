"""The port's optimizers (``hydragnn_tpu_torch/train/optimizer.py``)
against optax as the JAX package builds it (``select_optimizer``):
every one of the eight, ``freeze_conv_layers`` and ``grad_accum_steps``.

Each test feeds both sides the same gradients (the JAX model's, at the
JAX parameters, on the flagship's run-aligned batches at hidden 16 and 2
layers, carried across by ``convert.py``), so what is compared is the
optimizer alone, over its trajectory.

Tolerances: parameters ``rtol=1e-5, atol=1e-7`` after each step (optax's
float32 operations, in torch's order for the five rules that take
torch's class; a division or square root may round its last bit
differently, and Adam-like rules turn such a bit of an entry whose
gradient is near 0 into at most a bit of the step);
where a parameter must not move at all (a frozen conv, an accumulation's
micro-step), bit-equality. Adam and AdamW (``torch.optim``'s, which takes
its bias corrections in float64) add ``2e-5·lr`` for each update taken
(``_tol``): optax takes ``1 - 0.999^t`` in float32, 1.3e-5 off relative
because 0.999 itself rounds, which is 6.4e-6 of the update after the
square root, and ``|m̂/√v̂|`` stays below 3.2 at b1 0.9, b2 0.999. Against
the same rule in float64, torch's AdamW lies 1.6e-7 off after two steps
at lr 1e-2 and optax's 2.3e-7.
"""

import numpy as np
import pytest
import torch

import jax
import optax

from hydragnn_tpu.data.ingest import prepare_dataset as jax_prepare_dataset
from hydragnn_tpu.data.loader import GraphLoader as JaxGraphLoader
from hydragnn_tpu.data.synthetic import deterministic_graph_data as jax_data
from hydragnn_tpu.flagship import flagship_config as jax_flagship_config
from hydragnn_tpu.models.base import HydraModel as JaxHydraModel
from hydragnn_tpu.models.base import model_loss as jax_model_loss
from hydragnn_tpu.models.create import model_config_from_dict as jax_model_config
from hydragnn_tpu.train.optimizer import OPTIMIZERS as JAX_OPTIMIZERS
from hydragnn_tpu.train.optimizer import current_learning_rate as jax_current_lr
from hydragnn_tpu.train.optimizer import select_optimizer as jax_select_optimizer
from hydragnn_tpu.train.optimizer import set_learning_rate as jax_set_lr
from hydragnn_tpu.utils.config import update_config as jax_update_config

from hydragnn_tpu_torch.convert import variables_from_flax
from hydragnn_tpu_torch.models.create import create_model_config
from hydragnn_tpu_torch.train.optimizer import (
    OPTIMIZERS,
    SLOTS,
    current_learning_rate,
    select_optimizer,
    set_learning_rate,
)

TOL = dict(rtol=1e-5, atol=1e-7)
UNIT = dict(unit_cell_x_range=(2, 4), unit_cell_y_range=(2, 4), unit_cell_z_range=(2, 4))


@pytest.fixture(scope="module")
def problem():
    """The JAX flagship at hidden 16, 2 layers: its model, variables, the
    gradients of three run-aligned batches at fixed parameters (each
    step's gradient is taken at the JAX side's current parameters), and
    the completed config."""
    cfg = jax_flagship_config(16, 2, 8)
    samples = jax_data(number_configurations=40, seed=2, **UNIT)
    tr, va, te, _, _ = jax_prepare_dataset(samples, cfg)
    cfg = jax_update_config(cfg, tr, va, te)
    batches = list(JaxGraphLoader(tr, 8, shuffle=True, prefetch=0))[:3]
    jmodel = JaxHydraModel(jax_model_config(cfg["NeuralNetwork"]))
    variables = jax.jit(lambda b: jmodel.init(jax.random.PRNGKey(0), b, train=False))(batches[0])

    @jax.jit
    def grads(params, batch):
        def loss_fn(p):
            outs, _ = jmodel.apply({"params": p, "batch_stats": variables["batch_stats"]}, batch, train=True,
                                   mutable=["batch_stats"])
            return jax_model_loss(jmodel.cfg, outs, batch)[0]

        return jax.grad(loss_fn)(params)

    return cfg, variables, batches, grads


def _port(cfg, variables, training, freeze=False):
    model = create_model_config(cfg["NeuralNetwork"], device="cpu")
    model.load_state_dict(variables_from_flax(variables), strict=True)
    return model, select_optimizer(model, training, freeze_conv=freeze)


def _step_both(tx, state, params, model, optimizer, grads_fn, batch):
    g = grads_fn(params, batch)
    updates, state = tx.update(g, state, params)
    params = optax.apply_updates(params, updates)
    named = dict(model.named_parameters())
    for name, t in variables_from_flax({"params": jax.tree_util.tree_map(np.asarray, g)}).items():
        named[name].grad = t
    optimizer.step()
    return state, params


def _tol(opt_type, updates, lr):
    """The parameter tolerance after ``updates`` updates at ``lr``."""
    if opt_type not in ("Adam", "AdamW"):
        return TOL
    return dict(rtol=TOL["rtol"], atol=TOL["atol"] + 2e-5 * lr * updates)


def _assert_params(model, params, label, **tol):
    want = variables_from_flax({"params": jax.tree_util.tree_map(np.asarray, params)})
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), err_msg=f"{label} {name}", **(tol or TOL))


def test_optimizer_names_match_jax():
    assert OPTIMIZERS == JAX_OPTIMIZERS


@pytest.mark.parametrize("opt_type", OPTIMIZERS)
def test_three_step_trajectory_matches_optax(problem, opt_type):
    cfg, variables, batches, grads_fn = problem
    training = {"Optimizer": {"type": opt_type, "learning_rate": 1e-2}}
    tx = jax_select_optimizer(training)
    params = variables["params"]
    state = tx.init(params)
    model, optimizer = _port(cfg, variables, training)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    for step, batch in enumerate(batches):
        state, params = _step_both(tx, state, params, model, optimizer, grads_fn, batch)
        _assert_params(model, params, f"{opt_type} step {step}", **_tol(opt_type, step + 1, 1e-2))
    assert any(not torch.equal(before[k], p) for k, p in model.named_parameters())
    count = optimizer.count()
    assert count is None or int(count) == 3


@pytest.mark.parametrize("opt_type", ["SGD", "AdamW"])
def test_freeze_conv_masks_updates_as_optax(problem, opt_type):
    """Frozen encoder convs keep their values bit for bit while their
    moments follow their gradients (optax masks the final update only);
    BatchNorm and heads train, all as optax's masked chain."""
    cfg, variables, batches, grads_fn = problem
    training = {"Optimizer": {"type": opt_type, "learning_rate": 0.05}}
    tx = jax_select_optimizer(training, freeze_conv=True)
    params = variables["params"]
    state = tx.init(params)
    model, optimizer = _port(cfg, variables, training, freeze=True)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    for batch in batches:
        state, params = _step_both(tx, state, params, model, optimizer, grads_fn, batch)
    _assert_params(model, params, f"freeze {opt_type}", **_tol(opt_type, len(batches), 0.05))
    for name, p in model.named_parameters():
        if name.startswith("convs."):
            assert torch.equal(p, before[name]), name
        elif not name.startswith("norms."):
            assert not torch.equal(p, before[name]), name
    if opt_type == "AdamW":  # the frozen convs' first moments, against optax's
        mu = variables_from_flax({"params": jax.tree_util.tree_map(np.asarray, state.inner_state[0][0].mu)})
        key = SLOTS["AdamW"]["mu"]
        for name, p in model.named_parameters():
            np.testing.assert_allclose(optimizer.state[p][key].numpy(), mu[name].numpy(), err_msg=name, **TOL)
        assert any(float(optimizer.state[p][key].abs().max()) > 0
                   for name, p in model.named_parameters() if name.startswith("convs."))


@pytest.mark.parametrize("opt_type", ["SGD", "AdamW"])
def test_grad_accum_matches_multisteps(problem, opt_type):
    """grad_accum_steps = 3 as optax.MultiSteps: the parameters hold for
    two micro-steps (bit for bit), the third applies the rule to the
    mean gradient; six steps, two updates."""
    cfg, variables, batches, grads_fn = problem
    training = {"Optimizer": {"type": opt_type, "learning_rate": 0.05}, "grad_accum_steps": 3}
    tx = jax_select_optimizer(training)
    params = variables["params"]
    state = tx.init(params)
    model, optimizer = _port(cfg, variables, training)
    for step in range(6):
        before = {k: p.detach().clone() for k, p in model.named_parameters()}
        state, params = _step_both(tx, state, params, model, optimizer, grads_fn, batches[step % 3])
        _assert_params(model, params, f"accum {opt_type} step {step}", **_tol(opt_type, (step + 1) // 3, 0.05))
        moved = any(not torch.equal(before[k], p) for k, p in model.named_parameters())
        assert moved == (step % 3 == 2), step
    assert int(optimizer.shared["gradient_step"]) == int(state.gradient_step) == 2
    assert int(optimizer.shared["mini_step"]) == int(state.mini_step) == 0


def test_learning_rate_read_and_set_through_accumulation(problem):
    """The plateau scheduler's handle: the learning rate read and set
    through the accumulation wrapper (the port holds the Python float,
    optax its float32 rounding), and the next update uses it on both
    sides."""
    cfg, variables, batches, grads_fn = problem
    training = {"Optimizer": {"type": "Adam", "learning_rate": 0.05}, "grad_accum_steps": 2}
    tx = jax_select_optimizer(training)
    params = variables["params"]
    state = tx.init(params)
    model, optimizer = _port(cfg, variables, training)
    assert current_learning_rate(optimizer) == 0.05 and np.float32(0.05) == jax_current_lr(state)
    for step in range(4):
        if step == 2:
            state = jax_set_lr(state, 0.0123)
            set_learning_rate(optimizer, 0.0123)
            assert np.float32(current_learning_rate(optimizer)) == jax_current_lr(state)
        state, params = _step_both(tx, state, params, model, optimizer, grads_fn, batches[step % 3])
        _assert_params(model, params, f"lr step {step}", **_tol("Adam", (step + 1) // 2, 0.05))


@pytest.mark.parametrize("opt_type", ["AdamW", "Adagrad"])
def test_state_dict_resumes_mid_accumulation_bit_equal(problem, opt_type):
    """An optimizer restored from ``state_dict`` between micro-steps
    continues exactly as the one that was not interrupted."""
    cfg, variables, batches, grads_fn = problem
    training = {"Optimizer": {"type": opt_type, "learning_rate": 0.05}, "grad_accum_steps": 2}
    runs = []
    for interrupt in (False, True):
        params, state = variables["params"], None
        tx = jax_select_optimizer(training)
        state = tx.init(params)
        model, optimizer = _port(cfg, variables, training)
        for step in range(5):
            if interrupt and step == 3:
                saved = optimizer.state_dict()
                model2, optimizer = _port(cfg, variables, training)
                model2.load_state_dict(model.state_dict())
                optimizer.load_state_dict(saved)
                model = model2
            state, params = _step_both(tx, state, params, model, optimizer, grads_fn, batches[step % 3])
        runs.append((model, optimizer))
    (m0, o0), (m1, o1) = runs
    for (name, a), b in zip(m0.named_parameters(), m1.parameters()):
        assert torch.equal(a, b), name
    for a, b in zip(o0.state_tensors(), o1.state_tensors()):
        assert torch.equal(a, b)
