"""The port's data-parallel steps (``hydragnn_tpu_torch/parallel/sharded.py``)
against the JAX package's (``hydragnn_tpu/parallel/sharded.py``), the
counterparts of ``tests/test_parallel.py``.

The JAX reference runs here on the conftest's forced CPU devices (a
``Partitioner(data=2)`` mesh over two of them, its loader stacking two
sub-batches); the port runs in ONE group of two gloo processes
(``test_torch_parallel_cases.spawn_group``, module-scoped), rank r
training on the JAX package's sub-batch r. Tolerances:

  - SGD: per-step losses and final parameters ``rtol 1e-4`` (the
    port's CPU bar against the JAX package, ``LOSS_RTOL``; the JAX
    ``pmean`` and gloo's ring add the two ranks' gradients in different
    orders);
  - AdamW: the first step's loss ``LOSS_RTOL``, later ones
    ``ADAM_LATER_RTOL`` (ROADMAP's Adam limits: Adam's first update
    turns every gradient's rounding into a sign);
  - ZeRO-1, FSDP, remat and the guard against the port's own replicated
    data-parallel run: ``rtol 1e-5``; the elementwise rule runs on the
    slices of the same reduced gradient, so they agree to the bit here,
    which the tolerance does not require.
"""

import json

import numpy as np
import pytest

import jax

from hydragnn_tpu.data.loader import GraphLoader as JaxGraphLoader
from hydragnn_tpu.models.create import create_model_config as jax_create_model_config
from hydragnn_tpu.parallel import Partitioner as JaxPartitioner
from hydragnn_tpu.train import create_train_state
from hydragnn_tpu.train import select_optimizer as jax_select_optimizer

from hydragnn_tpu_torch.convert import variables_from_flax
from hydragnn_tpu_torch.data.loader import GraphLoader
from hydragnn_tpu_torch.models.create import create_model_config
from hydragnn_tpu_torch.train.optimizer import select_optimizer
from hydragnn_tpu_torch.train.state import make_train_step

from test_torch_parallel_cases import batch_arrays, shared_group
from test_torch_train_loop import ADAM_LATER_RTOL, LOSS_RTOL, _both_flagship

BS = 8  # global batch: two sub-batches of 4
STEPS = 3
SGD = {"type": "SGD", "learning_rate": 0.05}
ADAMW = {"type": "AdamW", "learning_rate": 0.01}
LAMB = {"type": "FusedLAMB", "learning_rate": 0.01}


def _jax_run(jax_side, opt, steps=STEPS, sync_bn=False):
    """JAX's Partitioner(data=2) run: losses, per-head losses, the state."""
    jtr, _, _, jcfg = jax_side
    jcfg["NeuralNetwork"]["Training"]["Optimizer"] = dict(opt)
    loader = JaxGraphLoader(jtr, BS, device_stack=2, drop_last=True)
    batches = list(loader)[:steps]
    part = JaxPartitioner(data=2)
    example = jax.tree_util.tree_map(lambda x: x[0], batches[0])
    nn = jcfg["NeuralNetwork"]
    nn["Architecture"]["SyncBatchNorm"] = sync_bn
    model, variables = jax_create_model_config(nn, example, bn_axis_name=part.bn_axis_name)
    tx = jax_select_optimizer(nn["Training"])
    state = part.shard_init(create_train_state(variables, tx, seed=0))
    step = part.shard_train_step(model, tx)
    losses, tasks = [], []
    for b in batches:
        state, loss, t = step(state, b)
        losses.append(float(loss))
        tasks.append(np.asarray(t))
    return model, variables, state, losses, tasks, part, batches


def _state_dict(variables):
    return {k: v.clone() for k, v in variables_from_flax(jax.device_get(variables)).items()}


@pytest.fixture(scope="module")
def problem():
    jax_side, port_side = _both_flagship(n=64, batch=BS, epochs=1)
    return jax_side, port_side


class _JaxRuns(dict):
    """JAX's runs by name, each made at its first read: a worker that
    runs only tests of the port's own layouts makes none."""

    RUNS = {"sgd": (SGD, False), "adamw": (ADAMW, False), "syncbn": (SGD, True)}

    def __init__(self, jax_side):
        super().__init__()
        self.jax_side = jax_side

    def __missing__(self, key):
        opt, sync_bn = self.RUNS[key]
        self[key] = _jax_run(self.jax_side, opt, sync_bn=sync_bn)
        return self[key]


@pytest.fixture(scope="module")
def jax_runs(problem):
    return _JaxRuns(problem[0])


def _jax_init(jax_side):
    """The JAX model's initial variables, those ``_jax_run`` starts from."""
    jtr, _, _, jcfg = jax_side
    batch = next(iter(JaxGraphLoader(jtr, BS, device_stack=2, drop_last=True)))
    nn = dict(jcfg["NeuralNetwork"], Architecture=dict(jcfg["NeuralNetwork"]["Architecture"], SyncBatchNorm=False))
    return jax_create_model_config(nn, jax.tree_util.tree_map(lambda x: x[0], batch),
                                   bn_axis_name=JaxPartitioner(data=2).bn_axis_name)[1]


@pytest.fixture(scope="module")
def group(problem, tmp_path_factory):
    """Every port case, in one group of two processes (from the JAX
    model's initial variables alone: the group does not wait for JAX's
    runs)."""
    _, (tr, va, te, cfg) = problem
    sd = _state_dict(_jax_init(problem[0]))
    nn = cfg["NeuralNetwork"]

    def nn_with(opt, sync_bn=False):
        out = {**nn, "Training": {**nn["Training"], "Optimizer": dict(opt)},
               "Architecture": {**nn["Architecture"], "SyncBatchNorm": sync_bn}}
        return out

    base = dict(samples=tr, state_dict=sd, batch_size=BS, steps=STEPS)
    cases = [
        ("dp_sgd", "dp_steps", dict(base, nn_config=nn_with(SGD), layout={"data": 2}, eval_outputs=True,
                                    stats=True)),
        ("dp_adamw", "dp_steps", dict(base, nn_config=nn_with(ADAMW), layout={"data": 2})),
        ("syncbn", "dp_steps", dict(base, nn_config=nn_with(SGD, sync_bn=True), layout={"data": 2})),
        ("zero1", "dp_steps", dict(base, nn_config=nn_with(ADAMW), layout={"data": 2, "zero1": True})),
        ("fsdp", "dp_steps", dict(base, nn_config=nn_with(ADAMW), layout={"fsdp": 2})),
        ("remat", "dp_steps", dict(base, nn_config=nn_with(ADAMW), layout={"data": 2}, remat=True)),
        ("guard", "dp_steps", dict(base, nn_config=nn_with(ADAMW), layout={"data": 2}, guard=True)),
        ("one_step", "dp_steps", dict(base, nn_config=nn_with(SGD), layout={"data": 2}, steps=1)),
        ("dp_lamb", "dp_steps", dict(base, nn_config=nn_with(LAMB), layout={"data": 2})),
        ("fsdp_lamb", "dp_steps", dict(base, nn_config=nn_with(LAMB), layout={"fsdp": 2})),
        ("fsdp_remat_guard", "dp_steps", dict(base, nn_config=nn_with(ADAMW), layout={"fsdp": 2}, remat=True,
                                              guard=True)),
        ("dp_bf16", "dp_steps", dict(base, nn_config=nn_with(ADAMW), layout={"data": 2}, bf16=True, diag=True)),
        ("fsdp_bf16", "dp_steps", dict(base, nn_config=nn_with(ADAMW), layout={"fsdp": 2}, bf16=True, diag=True)),
    ]
    for name, layout in (("fsdp", {"Parallel": {"fsdp": 2}}), ("zero1", {"use_zero_redundancy": True})):
        run_cfg = json.loads(json.dumps(cfg))
        run_cfg["NeuralNetwork"]["Training"]["Optimizer"] = dict(ADAMW, **{k: v for k, v in layout.items()
                                                                           if k == "use_zero_redundancy"})
        run_cfg["NeuralNetwork"]["Parallel"] = layout.get("Parallel", {})
        # the meta a resume reads its epoch from; no end-of-run BatchNorm
        # recalibration, which the first run's last checkpoint would carry
        # (as the single-process exact resume, tests/test_torch_checkpoint.py)
        run_cfg["NeuralNetwork"]["Training"].update(checkpoint_every=1, bn_recalibration=False)
        cases.append((f"resume_{name}", "train_resume",
                      dict(config=run_cfg, samples=(tr, va, te), epochs=2, split=1,
                           log_dir=str(tmp_path_factory.mktemp(f"resume_{name}")))))
    return shared_group(2, cases, tmp_path_factory, "parallel_group")


def _assert_params(port_params, jax_state, rtol, atol=1e-6):
    ref = variables_from_flax(jax.device_get({"params": jax_state.params, "batch_stats": jax_state.batch_stats}))
    for name, val in port_params.items():
        np.testing.assert_allclose(val, ref[name].numpy(), rtol=rtol, atol=atol, err_msg=name)


def test_data2_matches_jax_device_stack2_under_sgd(group, jax_runs):
    """Per-step losses, per-head losses and final parameters of the small
    flagship at data = 2 equal JAX's two-sub-batch mesh step; both ranks
    hold the same parameters and running statistics."""
    _, _, jstate, jlosses, jtasks, _, _ = jax_runs["sgd"]
    r0, r1 = group["dp_sgd"]
    np.testing.assert_allclose(r0["losses"], jlosses, rtol=LOSS_RTOL)
    np.testing.assert_allclose(np.stack(r0["tasks"]), np.stack(jtasks), rtol=LOSS_RTOL, atol=1e-7)
    _assert_params(r0["params"], jstate, rtol=1e-4)
    ref = variables_from_flax(jax.device_get({"params": jstate.params, "batch_stats": jstate.batch_stats}))
    for name, val in r0["buffers"].items():
        np.testing.assert_allclose(val, ref[name].numpy(), rtol=1e-4, atol=1e-6, err_msg=name)
    for k in r0["params"]:
        np.testing.assert_array_equal(r0["params"][k], r1["params"][k])
    for k in r0["buffers"]:
        np.testing.assert_array_equal(r0["buffers"][k], r1["buffers"][k])
    assert r0["losses"] == r1["losses"] and r0["steps"] == STEPS


def test_data2_matches_jax_device_stack2_under_adamw(group, jax_runs):
    jlosses = jax_runs["adamw"][3]
    losses = group["dp_adamw"][0]["losses"]
    np.testing.assert_allclose(losses[0], jlosses[0], rtol=LOSS_RTOL)
    np.testing.assert_allclose(losses[1:], jlosses[1:], rtol=ADAM_LATER_RTOL)


def test_syncbn_matches_jax_axis_name(group, jax_runs):
    """``Architecture.SyncBatchNorm`` with the partitioner's group: the
    BatchNorm statistics are the two sub-batches' together, as JAX's
    ``psum`` over the mesh axis makes them."""
    _, _, jstate, jlosses, _, _, _ = jax_runs["syncbn"]
    r0 = group["syncbn"][0]
    np.testing.assert_allclose(r0["losses"], jlosses, rtol=LOSS_RTOL)
    _assert_params(r0["params"], jstate, rtol=1e-4)
    assert not np.allclose(r0["losses"][1:], group["dp_sgd"][0]["losses"][1:], rtol=1e-6)


def test_sharded_matches_single_device(problem, group, jax_runs):
    """With equal-sized sub-batches, one data = 2 SGD step equals the mean
    of the single-process steps on each sub-batch (the port against
    itself)."""
    _, (tr, _, _, cfg) = problem
    nn = cfg["NeuralNetwork"]
    nn["Training"]["Optimizer"] = dict(SGD)
    sd = _state_dict(jax_runs["sgd"][1])
    singles = []
    for r in range(2):
        batch = next(iter(GraphLoader(tr, BS, device_stack=2, stack_rank=r, drop_last=True)))
        model = create_model_config(nn, device="cpu")
        model.load_state_dict(sd)
        make_train_step(model, select_optimizer(model, nn["Training"]))(batch)
        singles.append({n: p.detach().numpy() for n, p in model.named_parameters()})
    port = group["one_step"][0]["params"]
    for name, val in port.items():
        np.testing.assert_allclose(val, (singles[0][name] + singles[1][name]) / 2, rtol=2e-4, atol=2e-5,
                                   err_msg=name)


def test_zero1_opt_state_is_sharded(group):
    """ZeRO-1: each rank holds about half of the optimizer state (the
    moments whose first axis the data width divides) and trains what the
    replicated layout trains."""
    z0, z1 = group["zero1"]
    ref = group["dp_adamw"][0]
    np.testing.assert_allclose(z0["losses"], ref["losses"], rtol=1e-5)
    for k in ref["params"]:
        np.testing.assert_allclose(z0["params"][k], ref["params"][k], rtol=1e-5, atol=1e-7, err_msg=k)
        np.testing.assert_array_equal(z0["params"][k], z1["params"][k])
    man = z0["manifest"]
    assert man["zero1"] and man["opt"]["sharded"] > 0 and man["params"]["sharded"] == 0
    assert man["replicated_leaves"] and all(p.startswith("opt_state") for p in man["replicated_leaves"])
    assert z0["opt_bytes"] < 0.6 * ref["opt_bytes"], (z0["opt_bytes"], ref["opt_bytes"])
    # the gathered optimizer state is the replicated run's, whole
    for k, v in ref["opt_state"].items():
        np.testing.assert_allclose(z0["opt_state"][k], v, rtol=1e-5, atol=1e-9, err_msg=k)


def test_fsdp2_matches_data2_and_halves_the_state(group):
    f0 = group["fsdp"][0]
    ref = group["dp_adamw"][0]
    np.testing.assert_allclose(f0["losses"], ref["losses"], rtol=1e-5)
    for k in ref["params"]:
        np.testing.assert_allclose(f0["params"][k], ref["params"][k], rtol=1e-5, atol=1e-7, err_msg=k)
    man = f0["manifest"]
    assert man["fsdp"] == 2 and man["params"]["sharded"] > 0 and man["opt"]["sharded"] > 0
    # what a rank holds after a step: half the state and half the parameters
    assert f0["opt_bytes"] < 0.6 * ref["opt_bytes"] and f0["param_bytes"] < 0.6 * ref["param_bytes"]
    assert f0["param_bytes"] == man["params"]["bytes_per_device"]


def test_sharded_eval_with_outputs(group, jax_runs):
    """The partitioned eval step: the loss and per-head losses over both
    ranks' real graphs equal JAX's sharded eval; each rank's outputs are
    its own sub-batch's rows (the JAX package's ``local_view``)."""
    jmodel, _, jstate, _, _, jpart, jbatches = jax_runs["sgd"]
    jloss, jtasks = jpart.shard_eval_step(jmodel)(jstate, jbatches[0])
    r0, r1 = group["dp_sgd"]
    np.testing.assert_allclose(r0["eval"]["loss"], float(jloss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(r0["eval"]["tasks"], np.asarray(jtasks), rtol=LOSS_RTOL, atol=1e-7)
    assert r0["eval"]["loss"] == r1["eval"]["loss"]
    assert r0["eval"]["count"] == float(np.asarray(jbatches[0].graph_mask).sum())
    assert r0["eval"]["rows"][0] == jbatches[0].graph_mask.shape[1]
    # the statistics step leaves equal, finite running statistics on both ranks
    for k, v in r0["stats_buffers"].items():
        assert np.isfinite(v).all()
        np.testing.assert_array_equal(v, r1["stats_buffers"][k])


def test_sharded_remat_matches_plain(group):
    a, b = group["dp_adamw"][0], group["remat"][0]
    np.testing.assert_allclose(b["losses"], a["losses"], rtol=1e-6)
    for k in a["params"]:
        np.testing.assert_allclose(b["params"][k], a["params"][k], rtol=1e-6, atol=1e-7, err_msg=k)


def test_fsdp_gathers_for_remat_guard_bf16_and_diagnostics(group):
    """FSDP frees the whole parameters after each step and gathers them
    for the next forward: under remat with the guard it trains what the
    replicated layout trains (rtol 1e-6, as remat and the guard alone);
    its bf16 step (the cast reads the gathered parameters) and the
    per-head diagnostics after it (the weighted pull averaged over the
    ranks before the sharded dry update) equal the replicated layout's
    bf16 run (rtol 1e-5, the layouts' bar)."""
    a, b = group["dp_adamw"][0], group["fsdp_remat_guard"][0]
    np.testing.assert_allclose(b["losses"], a["losses"], rtol=1e-6)
    for k in a["params"]:
        np.testing.assert_allclose(b["params"][k], a["params"][k], rtol=1e-6, atol=1e-7, err_msg=k)
    assert b["steps"] == STEPS and b["param_bytes"] < 0.6 * a["param_bytes"]
    d, f = group["dp_bf16"][0], group["fsdp_bf16"][0]
    np.testing.assert_allclose(f["losses"], d["losses"], rtol=1e-5)
    for k in d["params"]:
        np.testing.assert_allclose(f["params"][k], d["params"][k], rtol=1e-5, atol=1e-7, err_msg=k)
    for k, v in d["diag"].items():
        assert np.isfinite(v).all(), k
        np.testing.assert_allclose(f["diag"][k], v, rtol=1e-5, atol=1e-9, err_msg=k)


@pytest.mark.parametrize("layout", ["fsdp", "zero1"])
def test_resume_is_exact_under_the_sharded_layouts(group, layout):
    """Through ``train_with_loaders`` in the group: 1 epoch, then a
    ``continue`` run to 2 from the checkpoint rank 0 wrote, equal to the
    bit to 2 epochs straight (the histories, the parameters, the running
    statistics and the whole optimizer state; PR 10's exact resume), on
    both ranks. The checkpoint holds the whole state, gathered from the
    shards, and the load puts it back into the layout."""
    for r in group[f"resume_{layout}"]:
        s, c = r["straight"], r["continued"]
        assert c["history"] == s["history"] and len(s["history"]["train_loss"]) == 2
        for part in ("params", "buffers", "opt_state"):
            assert set(c[part]) == set(s[part]) and s[part]
            for k, v in s[part].items():
                np.testing.assert_array_equal(c[part][k], v, err_msg=(layout, part, k))
    files = group[f"resume_{layout}"][0]["straight"]["files"]
    assert any(f.endswith(".pt") for f in files) and any(f.endswith(".meta.json") for f in files)


def test_guard_agrees_with_the_plain_step(group):
    """The non-finite guard decides on the reduced loss and gradient: on
    finite data it takes every step the plain step takes."""
    a, b = group["dp_adamw"][0], group["guard"][0]
    np.testing.assert_allclose(b["losses"], a["losses"], rtol=1e-6)
    assert b["steps"] == a["steps"] == STEPS


@pytest.mark.parametrize("rank", [0, 1])
def test_rank_batches_bit_equal_to_jax_sub_batch(problem, rank):
    """Rank r's loader (``device_stack=2``, ``stack_rank=r``) yields JAX's
    sub-batch r of every step, bit for bit, the all-padding filler of a
    short last batch included."""
    (jtr, _, _, _), (tr, _, _, _) = problem
    n = 18  # the last batch holds 2 graphs: sub-batch 1 is a filler
    jl = JaxGraphLoader(jtr[:n], BS, shuffle=True, device_stack=2)
    tl = GraphLoader(tr[:n], BS, shuffle=True, device_stack=2, stack_rank=rank)
    jl.set_epoch(1)
    tl.set_epoch(1)
    jb, tb = list(jl), list(tl)
    assert len(jb) == len(tb) == 3
    for j, t in zip(jb, tb):
        ours = batch_arrays(t)
        for key, val in ours.items():
            field, _, sub = key.partition(".")
            ref = getattr(j, field)
            ref = ref[sub] if sub else ref
            np.testing.assert_array_equal(val, np.asarray(ref)[rank], err_msg=key)
    if rank == 1:
        assert not batch_arrays(tb[-1])["graph_mask"].any()


def test_fsdp_lamb_trust_ratio_uses_whole_tensor_norms(group):
    """LAMB's trust ratio divides per-tensor norms: under FSDP each
    rank's slice reduces its squares over the shard group, so the run
    is the replicated one's: the losses rtol 1e-5, the parameters atol
    1e-5. The norms add the squares in another order (1e-7 relative on
    the weights); the conv post-layer biases feed a BatchNorm, their
    gradient is rounding noise, and Adam's normalization makes their
    steps differ by up to 2.5e-6 after three steps."""
    a, b = group["dp_lamb"][0], group["fsdp_lamb"][0]
    np.testing.assert_allclose(b["losses"], a["losses"], rtol=1e-5)
    for k in a["params"]:
        np.testing.assert_allclose(b["params"][k], a["params"][k], rtol=1e-5, atol=1e-5, err_msg=k)
    assert b["manifest"]["params"]["sharded"] > 0
