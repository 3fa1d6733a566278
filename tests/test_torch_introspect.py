"""The port's model-level introspection (``hydragnn_tpu_torch/obs/introspect.py``,
``obs/drift.py``) against the JAX package's (``hydragnn_tpu/obs/``).

Both sides run the flagship at hidden 8, 2 conv layers (1 graph head, 3
node heads) on 20 BCC graphs, batch 5, prepared by each package from the
same seed, with the JAX initial weights carried across by ``convert.py``.

Tolerances:
  - per-head gradient norms, the weighted total's norm and the parameter
    norm: ``rtol=1e-4`` (the train step's CPU gradient tier,
    ``tests/test_torch_train.py``); the cosine matrix ``atol=1e-4``;
  - the update norm and update ratio: the same, plus Adam's bias-correction
    allowance of ``tests/test_torch_optimizers.py:_tol`` (``2e-5 * lr`` an
    entry for the one update, over the update's entries) and, for the
    BatchNorm-fed conv biases whose gradient is 0 up to rounding and whose
    Adam update is then any value up to ``lr`` on either side, ``lr`` an
    entry (the same tier ``test_torch_train.py`` gives those biases);
  - ``Optimizer.dry_update`` against a real step's change, in float64:
    ``1e-12`` of the step's largest entry (the same formula, float64
    rounding) plus 4 float64 ulps of the parameter (the subtraction that
    measures the real change);
  - the copied numpy helpers and ``RULE_KINDS``: equal;
  - the ledger's FLOPs: equal to the analytic count of the dense products.
"""

import copy

import numpy as np
import pytest
import torch

import jax

from hydragnn_tpu.data.ingest import prepare_dataset as jax_prepare_dataset
from hydragnn_tpu.data.loader import GraphLoader as JaxGraphLoader
from hydragnn_tpu.data.synthetic import deterministic_graph_data as jax_data
from hydragnn_tpu.flagship import flagship_config as jax_flagship_config
from hydragnn_tpu.models.base import HydraModel as JaxHydraModel
from hydragnn_tpu.models.create import model_config_from_dict as jax_model_config
from hydragnn_tpu.obs import drift as jax_drift
from hydragnn_tpu.obs import introspect as jax_introspect
from hydragnn_tpu.train.optimizer import select_optimizer as jax_select_optimizer
from hydragnn_tpu.train.state import create_train_state
from hydragnn_tpu.utils.config import update_config as jax_update_config

from hydragnn_tpu_torch.convert import variables_from_flax
from hydragnn_tpu_torch.data.ingest import prepare_dataset
from hydragnn_tpu_torch.data.loader import GraphLoader
from hydragnn_tpu_torch.data.synthetic import deterministic_graph_data
from hydragnn_tpu_torch.flagship import flagship_config
from hydragnn_tpu_torch.models.create import create_model_config
from hydragnn_tpu_torch.obs import drift, introspect
from hydragnn_tpu_torch.obs.introspect import HeadDiagnostics, make_diagnostics_step
from hydragnn_tpu_torch.train.optimizer import OPTIMIZERS, Optimizer, select_optimizer
from hydragnn_tpu_torch.train.state import make_train_step
from hydragnn_tpu_torch.utils.config import update_config

UNIT = dict(unit_cell_x_range=(2, 3), unit_cell_y_range=(2, 3), unit_cell_z_range=(2, 3))
NORM_RTOL = 1e-4
COS_ATOL = 1e-4
ADAM_ENTRY = 2e-5  # times lr, an entry, for the one update (tests/test_torch_optimizers.py:_tol)


def _splits(mod_data, mod_prep, mod_update, cfg, n=20, seed=0):
    samples = mod_data(number_configurations=n, seed=seed, **UNIT)
    tr, va, te, _, _ = mod_prep(samples, cfg)
    return tr, mod_update(cfg, tr, va, te)


@pytest.fixture(scope="module")
def small():
    """Both packages' flagship at hidden 8, 2 layers, batch 5: the port's
    config and train samples, the JAX config and samples, the first
    batch of each, the JAX model and its initial variables."""
    tr, cfg = _splits(deterministic_graph_data, prepare_dataset, update_config, flagship_config(8, 2, 5))
    jtr, jcfg = _splits(jax_data, jax_prepare_dataset, jax_update_config, jax_flagship_config(8, 2, 5))
    batch = next(iter(GraphLoader(tr, 5, prefetch=0)))
    jbatch = next(iter(JaxGraphLoader(jtr, 5, prefetch=0)))
    jmodel = JaxHydraModel(jax_model_config(jcfg["NeuralNetwork"]))
    variables = jax.jit(lambda b: jmodel.init(jax.random.PRNGKey(0), b, train=False))(jbatch)
    return cfg, tr, jcfg, jtr, batch, jbatch, jmodel, variables


def _port_model(cfg, variables, device="cpu"):
    model = create_model_config(cfg["NeuralNetwork"], device=device)
    model.load_state_dict(variables_from_flax(variables), strict=True)
    return model, select_optimizer(model, cfg["NeuralNetwork"]["Training"])


def _bn_fed_bias_entries(model) -> int:
    return sum(p.numel() for k, p in model.named_parameters() if k.startswith("convs.") and k.endswith("post.bias"))


def test_diagnostics_match_jax(small):
    """One diagnostics sample at the initial state, AdamW, no dropout:
    every field against ``hydragnn_tpu.obs.introspect.make_diagnostics_step``."""
    cfg, _, jcfg, _, batch, jbatch, jmodel, variables = small
    tx = jax_select_optimizer(jcfg["NeuralNetwork"]["Training"])
    want = jax.device_get(jax_introspect.make_diagnostics_step(jmodel, tx)(create_train_state(variables, tx), jbatch))
    model, optimizer = _port_model(cfg, variables)
    got = {k: v.numpy() for k, v in make_diagnostics_step(model, optimizer)(batch).items()}

    np.testing.assert_allclose(got["tasks_loss"], want["tasks_loss"], rtol=NORM_RTOL)
    for key in ("grad_norms", "grad_norm_total", "param_norm"):
        np.testing.assert_allclose(got[key], want[key], rtol=NORM_RTOL, err_msg=key)
    np.testing.assert_allclose(got["cosine"], want["cosine"], atol=COS_ATOL)
    np.testing.assert_allclose(np.diagonal(got["cosine"]), 1.0, atol=1e-6)
    lr = float(optimizer.param_groups[0]["lr"])
    n = sum(p.numel() for p in model.parameters())
    allowance = np.sqrt(n) * ADAM_ENTRY * lr + np.sqrt(_bn_fed_bias_entries(model)) * lr
    assert abs(float(got["update_norm"]) - float(want["update_norm"])) <= (
        NORM_RTOL * float(want["update_norm"]) + allowance)
    assert abs(float(got["update_ratio"]) - float(want["update_ratio"])) <= (
        NORM_RTOL * float(want["update_ratio"]) + allowance / float(want["param_norm"]))


def test_diagnostics_match_jax_after_training_steps_under_sgd(small):
    """Under SGD the update is ``-lr * g``, so the update norm takes the
    gradient tier alone; the sample is taken after two steps, on the
    moved parameters and BatchNorm statistics."""
    cfg, _, jcfg, jtr, batch, jbatch, jmodel, variables = small
    jcfg = copy.deepcopy(jcfg)
    jcfg["NeuralNetwork"]["Training"]["Optimizer"] = {"type": "SGD", "learning_rate": 1e-2}
    tx = jax_select_optimizer(jcfg["NeuralNetwork"]["Training"])
    from hydragnn_tpu.train.state import make_train_step as jax_make_train_step

    state = create_train_state(variables, tx)
    jstep = jax_make_train_step(jmodel, tx)
    for _ in range(2):
        state, _, _ = jstep(state, jbatch)
    want = jax.device_get(jax_introspect.make_diagnostics_step(jmodel, tx)(state, jbatch))

    pcfg = copy.deepcopy(cfg)
    pcfg["NeuralNetwork"]["Training"]["Optimizer"] = {"type": "SGD", "learning_rate": 1e-2}
    model, optimizer = _port_model(pcfg, variables)
    step = make_train_step(model, optimizer)
    for _ in range(2):
        step(batch)
    got = {k: v.numpy() for k, v in make_diagnostics_step(model, optimizer)(batch).items()}
    for key in ("grad_norms", "grad_norm_total", "param_norm", "update_norm", "update_ratio"):
        np.testing.assert_allclose(got[key], want[key], rtol=NORM_RTOL, err_msg=key)
    np.testing.assert_allclose(got["cosine"], want["cosine"], atol=COS_ATOL)


def _state(model, optimizer):
    return ([t.detach().clone() for t in model.state_dict().values()]
            + [t.detach().clone() for t in optimizer.state_tensors()] + [optimizer.steps.clone()])


def _same(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("case", ["flagship_adamw", "flagship_bf16", "gat_dropout", "grad_accum"])
def test_diagnostics_leave_the_training_state_untouched(small, case):
    """Parameters, BatchNorm statistics, the dropout generator, every
    optimizer tensor and its step are bit-unchanged by a sample, no
    ``.grad`` is written, and the next train step is bit-equal to the
    same step without the sample."""
    cfg, _, _, _, batch, _, _, variables = small
    cfg = copy.deepcopy(cfg)
    training = cfg["NeuralNetwork"]["Training"]
    arch = cfg["NeuralNetwork"]["Architecture"]
    dtype = torch.bfloat16 if case == "flagship_bf16" else None
    if case == "gat_dropout":
        arch.update(model_type="GAT", heads=2, dropout=0.25)
    if case == "grad_accum":
        training["grad_accum_steps"] = 2

    def fresh():
        m = create_model_config(cfg["NeuralNetwork"], seed=3, device="cpu")
        return m, select_optimizer(m, training)

    results = []
    for sample in (True, False):
        model, optimizer = fresh()
        step = make_train_step(model, optimizer, compute_dtype=dtype)
        step(batch)  # a step first, so the optimizer state and counts are not the initial ones
        if sample:
            assert model.uses_dropout == (case == "gat_dropout")
            gen = model.dropout_generator(torch.device("cpu")) if model.uses_dropout else None
            gen_before = None if gen is None else gen.get_state().clone()
            before = _state(model, optimizer)
            optimizer.zero_grad(set_to_none=True)
            make_diagnostics_step(model, optimizer, compute_dtype=dtype)(batch)
            assert _same(before, _state(model, optimizer))
            assert all(p.grad is None for p in model.parameters())
            if gen is not None:
                assert torch.equal(gen.get_state(), gen_before)
        loss, tasks = step(batch)
        results.append([loss, tasks] + _state(model, optimizer))
    assert _same(results[0], results[1])


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("kind", OPTIMIZERS)
def test_dry_update_is_the_change_a_step_makes_and_writes_nothing(kind, accum):
    """For every rule, with the accumulation and a frozen parameter, the
    dry update equals the change the real step then makes (any parameter
    order) and leaves every state tensor bit-unchanged."""
    gen = torch.Generator().manual_seed(0)
    params = [torch.randn(shape, generator=gen, dtype=torch.float64, requires_grad=True)
              for shape in ((5, 3), (4,), (2, 2))]
    optimizer = Optimizer(params, kind, 0.01, frozen=[False, True, False], accum=accum)
    order = [2, 0, 1]
    for _ in range(4):
        grads = [torch.randn(p.shape, generator=gen, dtype=torch.float64) for p in params]
        before = [t.clone() for t in optimizer.state_tensors()]
        dry = optimizer.dry_update([params[i] for i in order], [grads[i] for i in order])
        assert _same(before, optimizer.state_tensors())
        old = [p.detach().clone() for p in params]
        for p, g in zip(params, grads):
            p.grad = g.clone()
        optimizer.step()
        for d, i in zip(dry, order):
            real = params[i].detach() - old[i]
            ulps = 4 * torch.finfo(torch.float64).eps * float(old[i].abs().max())
            assert torch.allclose(d, real, rtol=0, atol=1e-12 * float(real.abs().max()) + ulps)


def test_one_retained_graph_gives_each_pull_what_a_fresh_graph_gives(small):
    """The autograd Functions on the path (``graph/segment.py``,
    ``ops/gather_stats.py``, ``ops/pna_aggregate.py``) give each pull
    through the retained graph the gradient a fresh backward gives."""
    cfg, _, _, _, batch, _, _, variables = small
    from hydragnn_tpu_torch.train.state import _loss

    model, _ = _port_model(cfg, variables)
    params = list(model.parameters())
    with introspect.preserved_training_state(model):
        _, tasks = _loss(model, batch, None)
        retained = [torch.autograd.grad(tasks[i], params, retain_graph=True, allow_unused=True)
                    for i in range(len(tasks))]
    for i in range(len(tasks)):
        with introspect.preserved_training_state(model):
            _, fresh = _loss(model, batch, None)
            once = torch.autograd.grad(fresh[i], params, allow_unused=True)
        for a, b in zip(retained[i], once):
            assert (a is None) == (b is None)
            if a is not None:
                assert torch.equal(a, b)


def test_head_diagnostics_samples_every_k_steps_and_reads_once():
    calls = []

    def fn(batch):
        calls.append(batch)
        return {"tasks_loss": torch.tensor([1.0, 2.0]), "grad_norms": torch.tensor([3.0, 4.0]),
                "cosine": torch.eye(2), "grad_norm_total": torch.tensor(5.0), "param_norm": torch.tensor(6.0),
                "update_norm": torch.tensor(0.5), "update_ratio": torch.tensor(0.5 / 6.0)}

    diag = HeadDiagnostics(fn, ["a", "b"], every=3)
    for step in range(7):
        diag.maybe_sample(step)
    assert calls == [0, 3, 6]
    snap = diag.epoch_snapshot()
    assert snap["sampled_step"] == 6 and snap["grad_norm"] == {"a": 3.0, "b": 4.0}
    assert snap["cosine"] == [[1.0, 0.0], [0.0, 1.0]]
    assert diag.epoch_snapshot() is None


def test_numpy_helpers_are_bit_equal_to_jax(small):
    """``per_head_error_metrics``, ``conv_traffic_model``,
    ``collect_head_series``, ``flag_anomalies``, ``pad_waste_from_batch``
    and drift's ``build_reference`` give what the JAX package's give."""
    cfg, tr, _, jtr, batch, jbatch, _, _ = small
    rng = np.random.default_rng(0)
    names = ["e", "f", "g"]
    trues = [rng.normal(size=(n, 1)).astype(np.float32) for n in (7, 30, 0)]
    preds = [t + rng.normal(size=t.shape).astype(np.float32) * 0.1 for t in trues]
    assert introspect.per_head_error_metrics(trues, preds, names) == jax_introspect.per_head_error_metrics(
        trues, preds, names)
    for args in ((96, 1104, 8, 2, None), (96, 1104, 8, 2, 1100.0), (32752, 810888, 128, 6, 700000.0)):
        assert introspect.conv_traffic_model(*args) == jax_introspect.conv_traffic_model(*args)
    events = []
    for ep in range(8):
        spike = 10.0 if ep == 5 else 1.0
        cos = [[1.0, -0.3, 0.1], [-0.3, 1.0, 0.0], [0.1, 0.0, 1.0]] if ep % 2 else None
        heads = {"names": names, "grad_norm": {"e": 50.0, "f": 1.0 + ep, "g": 2.0}, "cosine": cos,
                 "mae": {n: 0.1 * ep for n in names}, "update_ratio": 1e-3}
        events.append({"kind": "epoch", "epoch": ep, "train_tasks": {n: spike / (1 + ep) for n in names},
                       "heads": heads})
    events.append({"kind": "epoch", "epoch": 8, "train_tasks": [1.0, 2.0, 3.0]})
    series = introspect.collect_head_series(events)
    assert series == jax_introspect.collect_head_series(events)
    assert introspect.flag_anomalies(series) == jax_introspect.flag_anomalies(series)
    assert introspect.flag_anomalies(series)  # the spike, the conflict and the imbalance all flag
    assert introspect.pad_waste_from_batch(batch) == jax_introspect.pad_waste_from_batch(jbatch)
    assert drift.QUANTILE_PROBES == jax_drift.QUANTILE_PROBES and drift.REFERENCE_SCHEMA == jax_drift.REFERENCE_SCHEMA
    heads = ["sum_x_x2_x3", "x", "x2", "x3"]
    assert drift.build_reference(tr, head_names=heads) == jax_drift.build_reference(jtr, head_names=heads)
    assert drift.build_reference(tr[:3], bins=4) == jax_drift.build_reference(jtr[:3], bins=4)


def _dense_flops(model, batch) -> int:
    """The analytic FLOPs of the flagship's dense products in one forward
    and backward: 2·M·a·b a product of [M, a] and [a, b], once forward,
    once for the weight's gradient and once more for the input's where
    it needs one. The PNA layers' two pre-products (receiver and sender
    parts, [N, fin] x [fin, fin]) are counted from the layer's widths;
    every ``Dense`` from the rows its forward hook sees."""
    from hydragnn_tpu_torch.models.convs import PNAConv
    from hydragnn_tpu_torch.models.layers import Dense

    rows = []
    hooks = [m.register_forward_hook(lambda mod, inp, out: rows.append(
        (inp[0].shape[0], mod.in_features, mod.out_features, inp[0].requires_grad)))
        for m in model.modules() if isinstance(m, Dense)]
    try:
        model(batch, train=True)
    finally:
        for h in hooks:
            h.remove()
    total = sum(2 * m * a * b * (3 if grad_in else 2) for m, a, b, grad_in in rows)
    n = batch.nodes.shape[0]
    for li, conv in enumerate(c for c in model.convs if isinstance(c, PNAConv)):
        fin = conv.in_dim
        total += 2 * (2 * n * fin * fin) * (2 if li == 0 else 3)  # layer 0's input is the batch's nodes
    return total


def test_flops_per_step_is_the_analytic_count_of_the_dense_products(small):
    cfg, _, _, _, batch, _, _, variables = small
    model, _ = _port_model(cfg, variables)
    before = [t.clone() for t in model.state_dict().values()]
    flops = introspect.step_flops(model, batch)
    assert _same(before, list(model.state_dict().values()))  # the BatchNorm statistics put back
    assert all(p.grad is None for p in model.parameters())
    assert flops == _dense_flops(model, batch) > 0
    ledger = introspect.HardwareLedger.from_model(model, batch)
    man = ledger.manifest()
    assert man["flops_per_step"] == flops and man["flops_source"] == "torch.utils.flop_counter"
    assert man["peak_dtype"] == "bf16" and man["peak_bf16_tflops"] is None
    rec = ledger.epoch_record(steps=4, wall_s=2.0)
    assert rec["achieved_tflops"] == round(flops * 4 / 2.0 / 1e12, 9) and rec["mfu"] is None
    assert rec["memory"] == {"available": False}
    assert ledger.run_summary() == {"available": True}


def test_peak_tables_give_none_on_the_cpu():
    cpu = torch.device("cpu")
    assert introspect.peak_flops(cpu) is None and introspect.peak_hbm_bw(cpu) is None
    assert introspect.device_memory_stats(cpu) == {"available": False}
    assert introspect.PEAK_BF16_TFLOPS == (("h100 80gb hbm3", 989.0),)
    assert introspect.PEAK_HBM_GBPS == (("h100 80gb hbm3", 3350.0),)
