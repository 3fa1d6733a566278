"""The port's ``Partitioner`` (``hydragnn_tpu_torch/parallel/partitioner.py``)
against the JAX package's, the counterparts of ``tests/test_partitioner.py``,
and data × edge composed against JAX's data-parallel step (the counterpart
of ``tests/test_edge_sharded.py:pytest_dp_edge_composed_matches_data_parallel``).

The JAX reference runs here on the conftest's forced CPU devices; the port
runs its layouts in ONE group of four gloo processes (module-scoped). The
port at data = 4, fsdp = 4, data 2 × fsdp 2 and ZeRO-1 trains what JAX's
``Partitioner(data=4)`` trains: losses ``LOSS_RTOL`` and parameters
``rtol 1e-4, atol 1e-6`` under SGD; the layouts among themselves
``rtol 2e-5`` (JAX's own bar; here they agree to the bit, the rule running
on slices of one reduced gradient). Data × edge composed: losses
``rtol 1e-5`` and parameters ``rtol 1e-4`` with ``DP_EDGE_ATOL``.
The layout reports (leaf counts, bytes, the replicated leaves, mapped
through ``convert.py``'s names) equal JAX's manifest exactly.
"""

import re

import numpy as np
import pytest

import jax

from hydragnn_tpu.data.ingest import prepare_dataset as jax_prepare_dataset
from hydragnn_tpu.data.loader import GraphLoader as JaxGraphLoader
from hydragnn_tpu.data.synthetic import deterministic_graph_data as jax_data
from hydragnn_tpu.models.create import create_model_config as jax_create_model_config
from hydragnn_tpu.parallel import Partitioner as JaxPartitioner
from hydragnn_tpu.parallel import make_mesh as jax_make_mesh
from hydragnn_tpu.parallel import make_sharded_train_step as jax_make_sharded_train_step
from hydragnn_tpu.parallel import place_state as jax_place_state
from hydragnn_tpu.train import create_train_state
from hydragnn_tpu.train import select_optimizer as jax_select_optimizer
from hydragnn_tpu.utils.config import update_config as jax_update_config

from hydragnn_tpu_torch.convert import _flatten, _module_map, _torch_name, variables_from_flax
from hydragnn_tpu_torch.data.ingest import prepare_dataset
from hydragnn_tpu_torch.data.loader import GraphLoader
from hydragnn_tpu_torch.data.synthetic import deterministic_graph_data
from hydragnn_tpu_torch.models.create import create_model_config
from hydragnn_tpu_torch.parallel import ParallelConfig, Partitioner
from hydragnn_tpu_torch.train.loop import _fixed_auto_eligible
from hydragnn_tpu_torch.train.optimizer import select_optimizer
from hydragnn_tpu_torch.utils.config import update_config

from test_data_pipeline import base_config
from test_torch_parallel_cases import shared_group
from test_torch_train_loop import LOSS_RTOL

D = 4  # ranks of the group, and JAX devices of the reference
# data 2 × edge 2 against JAX's data = 2 after every batch of SGD: the
# first conv's bias takes 1.7e-5 more or less where a node's neighbour sum
# cancels to ~0 and the ReLU after it flips with the order of the sum
# (two halves, then their sum); every other parameter agrees to 1e-6
DP_EDGE_ATOL = 2e-5
BS = 16
ADAMW = {"type": "AdamW", "learning_rate": 0.01}
SGD = {"type": "SGD", "learning_rate": 0.05}


def _gin_config():
    cfg = base_config(multihead=True)
    arch = cfg["NeuralNetwork"]["Architecture"]
    arch["model_type"] = "GIN"
    arch["hidden_dim"] = 16
    arch["output_heads"]["graph"]["dim_sharedlayers"] = 8
    arch["output_heads"]["graph"]["dim_headlayers"] = [16, 16]
    arch["output_heads"]["node"]["dim_headlayers"] = [8, 8]
    cfg["NeuralNetwork"]["Training"]["batch_size"] = BS
    return cfg


def _both(n, seed, cfg_fn=_gin_config):
    out = []
    for data, prep, upd in ((jax_data, jax_prepare_dataset, jax_update_config),
                            (deterministic_graph_data, prepare_dataset, update_config)):
        cfg = cfg_fn()
        train, val, test, _, _ = prep(data(number_configurations=n, seed=seed), cfg)
        out.append((train, upd(cfg, train, val, test)))
    return out


@pytest.fixture(scope="module")
def problem():
    (jtr, jcfg), (tr, cfg) = _both(64, 7)
    loader = JaxGraphLoader(jtr, BS, device_stack=D, drop_last=True)
    example = jax.tree_util.tree_map(lambda x: x[0], next(iter(loader)))
    model, variables = jax_create_model_config(jcfg["NeuralNetwork"], example)
    return jcfg, model, variables, loader, tr, cfg


@pytest.fixture(scope="module")
def edge_problem():
    """GIN single-head at batch 8: data 2 × edge 2 against JAX's data = 2."""

    def cfg_fn():
        cfg = base_config(multihead=False)
        cfg["NeuralNetwork"]["Architecture"]["model_type"] = "GIN"
        cfg["NeuralNetwork"]["Training"]["batch_size"] = 8
        return cfg

    (jtr, jcfg), (tr, cfg) = _both(32, 5, cfg_fn)
    loader = JaxGraphLoader(jtr, 8, shuffle=False, device_stack=2, edge_multiple=4)
    example = jax.tree_util.tree_map(lambda x: x[0], next(iter(loader)))
    model, variables = jax_create_model_config(jcfg["NeuralNetwork"], example)
    return jcfg, model, variables, loader, tr, cfg


def _nn(cfg, opt):
    nn = cfg["NeuralNetwork"]
    return {**nn, "Training": {**nn["Training"], "Optimizer": dict(opt)}}


@pytest.fixture(scope="module")
def group(problem, edge_problem, tmp_path_factory):
    _, _, variables, _, tr, cfg = problem
    sd = variables_from_flax(jax.device_get(variables))
    base = dict(samples=tr, state_dict=sd, batch_size=BS, steps=3)
    _, _, evars, eloader, etr, ecfg = edge_problem
    cases = [("mesh", "mesh_checks", dict(world=D)),
             ("warn", "replicated_warning", dict(world=D))]
    for opt_name, opt in (("sgd", SGD), ("adamw", ADAMW)):
        cases += [
            (f"data4_{opt_name}", "dp_steps", dict(base, nn_config=_nn(cfg, opt), layout={"data": 4},
                                                   eval_outputs=True, stats=True)),
            (f"fsdp4_{opt_name}", "dp_steps", dict(base, nn_config=_nn(cfg, opt), layout={"fsdp": 4},
                                                   eval_outputs=True, stats=True)),
            (f"d2f2_{opt_name}", "dp_steps", dict(base, nn_config=_nn(cfg, opt), layout={"data": 2, "fsdp": 2})),
        ]
    cases += [
        ("zero1", "dp_steps", dict(base, nn_config=_nn(cfg, ADAMW), layout={"data": 4, "zero1": True})),
        ("d2e2", "dp_steps", dict(samples=etr, state_dict=variables_from_flax(jax.device_get(evars)),
                                  batch_size=8, steps=len(eloader), nn_config=_nn(ecfg, SGD), drop_last=False,
                                  layout={"data": 2, "edge": 2, "edge_multiple": 4}, sub_batches=2)),
    ]
    return shared_group(D, cases, tmp_path_factory, "partitioner_group")


def _jax_steps(problem, opt, steps=3, **layout):
    jcfg, model, variables, loader, _, _ = problem
    tx = jax_select_optimizer({"Optimizer": dict(opt)})
    part = JaxPartitioner(**layout)
    state = part.shard_init(create_train_state(variables, tx, seed=0))
    step = part.shard_train_step(model, tx)
    losses = []
    for b in list(loader)[:steps]:
        state, loss, _ = step(state, b)
        losses.append(float(loss))
    return state, losses, part


def _port_names(state):
    return variables_from_flax(jax.device_get({"params": state.params, "batch_stats": state.batch_stats}))


# ---------------------------------------------------------------------------
# mesh composition
# ---------------------------------------------------------------------------


def test_mesh_composition_and_auto_collapse(group):
    p = Partitioner(data=8)
    assert p.axis_names == ("data",) and p.mesh_shape == {"data": 8}
    assert not p.single_device and p.device_stack == 1 and p.num_devices == 8
    p = Partitioner(data=2, fsdp=4)
    assert p.axis_names == ("data", "fsdp") and p.lead_spec == ("data", "fsdp") and p.fsdp_factor == 4
    p = Partitioner(fsdp=8)
    assert p.axis_names == ("fsdp",) and p.lead_spec == "fsdp"
    assert Partitioner(data=2, fsdp=2, edge=2).axis_names == ("data", "fsdp", "edge")
    p = Partitioner()
    assert p.single_device and p.mesh is None and p.axis_names == () and p.lead_group is None
    with pytest.raises(ValueError, match="positive integer"):
        ParallelConfig(data=0)
    with pytest.raises(ValueError, match="needs 16 devices, have 8"):
        Partitioner(data=16, devices=8)
    # in a group of four: one DeviceMesh over the named axes, rank r at
    # row-major position r, and a layout the group does not fit refused
    mesh = group["mesh"]
    for rank, m in enumerate(mesh):
        assert m["data"]["axis_names"] == m["data"]["mesh_dims"] == ("data",) and m["data"]["sizes"] == {"data": 4}
        assert m["fsdp"]["axis_names"] == ("fsdp",)
        assert m["data_fsdp"]["mesh_dims"] == ("data", "fsdp") and m["data_fsdp"]["coords"] == (rank // 2, rank % 2, 0)
        assert m["data_fsdp"]["sizes"] == {"data": 2, "fsdp": 2}
        assert m["data_edge"]["coords"] == (rank // 2, 0, rank % 2) and m["data_edge"]["lead_rank"] == rank // 2
        assert "needs 8 devices, have 4" in m["errors"][0] and "uses 2 of the group's 4" in m["errors"][1]


def test_from_config_knobs():
    nn = {"Parallel": {"fsdp": 2}, "Training": {"Optimizer": {}}}
    p = Partitioner.from_config(nn, device_stack=8)
    assert p.config.data == 4 and p.config.fsdp == 2
    bad = {"Parallel": {"fsdp": 3}, "Training": {}}
    with pytest.raises(ValueError) as ours:
        Partitioner.from_config(bad, device_stack=8)
    with pytest.raises(ValueError) as theirs:
        JaxPartitioner.from_config(bad, device_stack=8)
    assert str(ours.value) == str(theirs.value)
    nn = {"Parallel": {"fsdp": 2}, "Training": {"Optimizer": {"use_zero_redundancy": True}}}
    assert Partitioner.from_config(nn, device_stack=8).config.zero1 is False
    nn = {"Training": {"Optimizer": {"use_zero_redundancy": True}}}
    assert Partitioner.from_config(nn, device_stack=8).config.zero1 is True
    with pytest.raises(ValueError) as ours:
        ParallelConfig(edge=-1)
    with pytest.raises(ValueError) as theirs:
        jax_parallel_config(edge=-1)
    assert str(ours.value) == str(theirs.value)


def jax_parallel_config(**kw):
    from hydragnn_tpu.parallel import ParallelConfig as JaxParallelConfig

    return JaxParallelConfig(**kw)


# ---------------------------------------------------------------------------
# FSDP training: parity with replicated DP and with JAX
# ---------------------------------------------------------------------------


def test_fsdp_train_matches_replicated_dp(problem, group):
    """fsdp = 4 and data 2 × fsdp 2 train what data = 4 trains, and data = 4
    what JAX's ``Partitioner(data=4)`` trains; every leaf a width divides
    is sharded, the rest reported."""
    jstate, jlosses, _ = _jax_steps(problem, SGD, data=D)
    ref = _port_names(jstate)
    dp = group["data4_sgd"][0]
    np.testing.assert_allclose(dp["losses"], jlosses, rtol=LOSS_RTOL)
    for k, v in dp["params"].items():
        np.testing.assert_allclose(v, ref[k].numpy(), rtol=1e-4, atol=1e-6, err_msg=k)
    for opt_name in ("sgd", "adamw"):
        base = group[f"data4_{opt_name}"][0]
        for name in (f"fsdp4_{opt_name}", f"d2f2_{opt_name}"):
            for r in group[name]:
                np.testing.assert_allclose(r["losses"], base["losses"], rtol=2e-5)
                for k, v in base["params"].items():
                    np.testing.assert_allclose(r["params"][k], v, rtol=2e-4, atol=2e-5, err_msg=(name, k))
    for name, fsdp in (("fsdp4_adamw", 4), ("d2f2_adamw", 2)):
        man = group[name][0]["manifest"]
        jman = JaxPartitioner(**({"fsdp": 4} if fsdp == 4 else {"data": 2, "fsdp": 2})).manifest(
            state=create_train_state(problem[2], jax_select_optimizer({"Optimizer": ADAMW})))
        assert man["params"]["sharded"] > 0 and man["opt"]["sharded"] > 0
        for key in ("sharded", "bytes_global", "bytes_per_device"):
            assert man["params"][key] == jman["params"][key], (name, key)
        assert man["replicated_leaves"] == jman["replicated_leaves"] == []


def test_fsdp_memory_drop_at_least_3x(problem, group):
    """fsdp = 4 drops the parameter + optimizer-state bytes a rank holds
    after a step at least 3x against the replicated layout (data = 4,
    AdamW), and the manifest reports what the rank holds."""
    _, _, variables, _, _, cfg = problem
    model = create_model_config(cfg["NeuralNetwork"], device="cpu")
    opt = select_optimizer(model, {"Optimizer": ADAMW})
    rep = Partitioner(data=D).manifest(model, opt)
    rep_dev = rep["params"]["bytes_per_device"] + rep["opt"]["bytes_per_device"]
    assert rep_dev == rep["params"]["bytes_global"] + rep["opt"]["bytes_global"]
    for r_rep, r_f in zip(group["data4_adamw"], group["fsdp4_adamw"]):
        held_rep = r_rep["param_bytes"] + r_rep["opt_bytes"]
        held_f = r_f["param_bytes"] + r_f["opt_bytes"]
        assert held_f * 3 <= held_rep, (held_f, held_rep)
        man = r_f["manifest"]
        assert man["params"]["sharded"] > 0 and man["opt"]["sharded"] > 0
        assert r_f["param_bytes"] == man["params"]["bytes_per_device"]
        assert r_rep["param_bytes"] == rep["params"]["bytes_per_device"]


def test_fsdp_eval_and_stats_parity(problem, group):
    jcfg, model, variables, loader, _, _ = problem
    tx = jax_select_optimizer({"Optimizer": SGD})
    jstate, _, part = _jax_steps(problem, SGD, data=D)
    jloss, jtasks = part.shard_eval_step(model)(jstate, next(iter(loader)))
    for name in ("data4_sgd", "fsdp4_sgd"):
        r0 = group[name][0]
        np.testing.assert_allclose(r0["eval"]["loss"], float(jloss), rtol=LOSS_RTOL)
        np.testing.assert_allclose(r0["eval"]["tasks"], np.asarray(jtasks), rtol=LOSS_RTOL, atol=1e-7)
        assert r0["eval"]["rows"][0] == loader.pad_graphs
    for a, b in zip(group["data4_sgd"], group["fsdp4_sgd"]):
        for k, v in a["stats_buffers"].items():
            assert np.isfinite(b["stats_buffers"][k]).all()
            np.testing.assert_allclose(b["stats_buffers"][k], v, rtol=2e-5, atol=1e-7, err_msg=k)


# ---------------------------------------------------------------------------
# replicated-leaf loudness
# ---------------------------------------------------------------------------


def test_replicated_leaves_warn_with_paths(group):
    """A leaf no fsdp width divides stays whole on every rank, loudly: one
    rank-0 warning naming it (JAX's words), once per partitioner, and
    ``replicated_leaves`` in the manifest."""
    for rank, r in enumerate(group["warn"]):
        first, second = r["warnings"]
        assert second == []
        if rank == 0:
            assert len(first) == 1 and "REPLICATED" in first[0] and "['odd']" in first[0]
            # the leaf, and its two AdamW moments
            assert first[0].startswith("Partitioner: 3 state leaf(ves) have no dimension divisible by the 'fsdp'")
        else:
            assert first == []
        man = r["manifest"]
        assert "params['odd']" in man["replicated_leaves"] and "opt_state.mu['odd']" in man["replicated_leaves"]
        assert r["shards"] == [(0, 4), None]


def _jax_path_to_port(path, flat, cfg):
    """``opt_state.inner_state[0].mu['conv_0']['Dense_0']['kernel']`` ->
    ``opt_state.mu['convs.0.dense_0.weight']`` (``convert.py``'s names)."""
    keys = re.findall(r"\['([^']+)'\]", path)
    norms, convs = _module_map(flat, cfg)
    name = _torch_name("/".join(["params"] + keys), norms, convs)
    if path.startswith("params"):
        return f"params['{name}']"
    slot = re.search(r"\.(mu|nu)\[", path).group(1)
    return f"opt_state.{slot}['{name}']"


def test_zero1_replication_warns_with_paths(problem, group):
    """ZeRO-1: the optimizer leaves whose first axis (in the JAX package's
    layout) the data width does not divide stay whole, named as JAX names
    them, and the rank-0 warning says so."""
    jcfg, model, variables, _, _, _ = problem
    tx = jax_select_optimizer({"Optimizer": ADAMW})
    jman = JaxPartitioner(data=D, zero1=True).manifest(state=create_train_state(variables, tx))
    flat = _flatten(jax.device_get(dict(variables)))
    want = sorted(_jax_path_to_port(p, flat, model.cfg) for p in jman["replicated_leaves"])
    r0 = group["zero1"][0]
    assert sorted(r0["manifest"]["replicated_leaves"]) == want
    assert r0["manifest"]["opt"]["sharded"] > 0
    assert len(r0["warnings"]) == 1 and "REPLICATED" in r0["warnings"][0]
    assert group["zero1"][1]["warnings"] == []
    np.testing.assert_allclose(r0["losses"], group["data4_adamw"][0]["losses"], rtol=1e-5)
    assert r0["opt_bytes"] < 0.5 * group["data4_adamw"][0]["opt_bytes"]


# ---------------------------------------------------------------------------
# data x edge composed, and the scan eligibility
# ---------------------------------------------------------------------------


def test_dp_edge_composed_matches_data_parallel(edge_problem, group):
    """data 2 × edge 2 (each sub-batch's edges split over two ranks) trains
    what JAX's data = 2 mesh step trains, over every batch (the last one
    partial: unequal real-graph counts per sub-batch); each rank holds
    half of its sub-batch's padded edge rows."""
    jcfg, model, variables, loader, _, _ = edge_problem
    tx = jax_select_optimizer({"Optimizer": SGD})
    mesh = jax_make_mesh(2)
    state = jax_place_state(mesh, create_train_state(variables, tx, seed=0))
    step = jax_make_sharded_train_step(model, tx, mesh)
    losses = []
    for batch in loader:
        state, loss, _ = step(state, batch)
        losses.append(float(loss))
    ref = _port_names(state)
    edge_pad = next(iter(loader)).senders.shape[1]
    for r in group["d2e2"]:
        np.testing.assert_allclose(r["losses"], losses, rtol=1e-5)
        for k, v in r["params"].items():
            np.testing.assert_allclose(v, ref[k].numpy(), rtol=1e-4, atol=DP_EDGE_ATOL, err_msg=k)
        assert r["edge_rows"] * 2 >= edge_pad and r["edge_rows"] % 8 == 0
        assert r["manifest"]["mesh"]["shape"] == {"data": 2, "edge": 2}


def test_scan_eligibility_uses_partitioner(problem):
    _, _, _, _, tr, _ = problem
    loader = GraphLoader(tr[:8], 4)
    ok, reason = _fixed_auto_eligible(loader, partitioner=Partitioner())
    assert ok, reason
    ok, reason = _fixed_auto_eligible(loader, partitioner=Partitioner(data=2, fsdp=4))
    assert not ok and "partitioner" in reason
