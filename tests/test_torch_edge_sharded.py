"""The port's edge sharding (``hydragnn_tpu_torch/parallel/edge_sharded.py``)
against the JAX package's, the counterparts of ``tests/test_edge_sharded.py``.

The JAX reference runs here (its mesh functions on two of the conftest's
forced CPU devices, its plain step for the unsharded giant graph); the
port runs every case in ONE group of two gloo processes, each rank
holding half of the edges. Tolerances: the aggregates ``rtol/atol 1e-5``
(``1e-4`` with edge data), as JAX holds its own; the PNA giant-graph step
loss ``rtol 1e-5`` and parameters ``rtol 1e-4, atol 1e-6`` on both batch
layouts; the planted cross-shard tie's gradient ``rtol 1e-6``; the giant
driver's losses against its one-process run ``rtol 1e-4``.
(``pytest_dp_edge_composed_matches_data_parallel``'s counterpart, data 2 ×
edge 2, is in ``test_torch_partitioner.py``, whose group has four ranks.)
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from hydragnn_tpu.graph import batch_graphs as jax_batch_graphs
from hydragnn_tpu.models import ModelConfig as JaxModelConfig
from hydragnn_tpu.models import create_model as jax_create_model
from hydragnn_tpu.parallel import make_mesh as jax_make_mesh
from hydragnn_tpu.parallel.edge_sharded import edge_sharded_aggregate as jax_edge_sharded_aggregate
from hydragnn_tpu.parallel.edge_sharded import edge_sharded_gin_layer as jax_edge_sharded_gin_layer
from hydragnn_tpu.parallel.edge_sharded import place_edge_shards as jax_place_edge_shards
from hydragnn_tpu.parallel.edge_sharded import shard_edges as jax_shard_edges
from hydragnn_tpu.train import create_train_state, make_train_step
from hydragnn_tpu.train import select_optimizer as jax_select_optimizer

from hydragnn_tpu_torch.convert import variables_from_flax
from hydragnn_tpu_torch.examples.giant_graph.train_giant import train_giant
from hydragnn_tpu_torch.models.base import ModelConfig

from test_torch_parallel_cases import prepared_flagship, shared_group

W = 2  # edge ranks
LATTICE = (10, 10, 8)  # the giant driver's lattice, cut to 800 nodes for the CPU


def _graph():
    rng = np.random.default_rng(0)
    n, e, h = 300, 5000, 16
    return (rng.normal(size=(n, h)).astype(np.float32), rng.integers(0, n, e).astype(np.int32),
            rng.integers(0, n, e).astype(np.int32))


def _gin_weights(h):
    rng = np.random.default_rng(2)
    return (rng.normal(size=(h, h)).astype(np.float32) * 0.1, np.zeros(h, np.float32),
            rng.normal(size=(h, h)).astype(np.float32) * 0.1, np.zeros(h, np.float32))


def _pna_graph():
    rng = np.random.default_rng(3)
    n, e = 96, 2048
    return {"x": rng.normal(size=(n, 8)).astype(np.float32), "senders": rng.integers(0, n, e).astype(np.int32),
            "receivers": np.sort(rng.integers(0, n, e)).astype(np.int32),
            "graph_targets": {"energy": np.asarray([0.7], np.float32)}}


PNA_CFG = dict(model_type="PNA", input_dim=8, hidden_dim=128, output_dim=(1,), output_type=("graph",),
               output_names=("energy",), task_weights=(1.0,), num_conv_layers=2, graph_num_sharedlayers=1,
               graph_dim_sharedlayers=8, graph_num_headlayers=1, graph_dim_headlayers=(8,), pna_avg_deg_lin=20.0,
               pna_avg_deg_log=3.0)


def _pna_pads(g):
    e = g["senders"].shape[0]
    deg = np.bincount(g["receivers"], minlength=g["x"].shape[0])
    aligned = int((((deg + 7) // 8) * 8).sum())
    # unaligned: the JAX test's pad; run-aligned: a multiple of 2 · K
    return {0: e + 2 * 8, 8: ((aligned + 1 + 15) // 16) * 16}


def _tie_case(run_align):
    """Receivers sorted, one node's run straddling the two halves, and a
    maximum (of v and of -v) planted on both sides of the boundary."""
    rng = np.random.default_rng(4)
    h = 3
    if run_align:
        counts = np.full(11, 8)
        counts[5] = 16  # 96 slots; node 5's two K-groups (slots 40..55): one on each rank
    else:
        counts = np.asarray([5, 7, 6, 4, 8, 6, 4, 8])  # 48 edges; node 4 holds slots 22..29
    receivers = np.repeat(np.arange(len(counts)), counts).astype(np.int32)
    e = receivers.shape[0]
    v = rng.normal(size=(e, h)).astype(np.float32)
    mid = e // 2
    left, right = mid - 1, mid
    assert receivers[left] == receivers[right]
    v[[left, right], 0] = 5.0
    v[[left, right], 1] = -5.0
    return v, receivers, len(counts)


@pytest.fixture(scope="module")
def pna_problem():
    """The JAX model and its unsharded SGD step on each layout."""
    g = _pna_graph()
    out = {}
    for k, pad in _pna_pads(g).items():
        kw = dict(run_align=k) if k else {}
        batch = jax_batch_graphs([g], n_node_pad=g["x"].shape[0] + 8, n_edge_pad=pad, n_graph_pad=2, **kw)
        model, variables = jax_create_model(JaxModelConfig(**PNA_CFG), batch)
        tx = jax_select_optimizer({"Optimizer": {"type": "SGD", "learning_rate": 0.05}})
        state, loss, _ = make_train_step(model, tx)(create_train_state(variables, tx, seed=0), batch)
        out[k] = (variables, float(loss), state, pad)
    return g, out


@pytest.fixture(scope="module")
def group(pna_problem, tmp_path_factory):
    nodes, senders, receivers = _graph()
    weights = np.random.default_rng(1).normal(size=(len(senders), 1)).astype(np.float32)
    g, pna = pna_problem
    cfg = ModelConfig(**PNA_CFG)
    cases = [("agg", "edge_aggregate", dict(nodes=nodes, senders=senders, receivers=receivers, weights=weights,
                                            h_w=_gin_weights(nodes.shape[1])))]
    for k, (variables, _, _, pad) in pna.items():
        cases.append((f"pna{k}", "giant_step", dict(cfg=cfg, graph=g, state_dict=variables_from_flax(
            jax.device_get(variables)), n_edge_pad=pad, run_align=k, lr=0.05)))
    for k in (0, 8):
        v, r, n = _tie_case(k)
        cases.append((f"tie{k}", "tie_grad", dict(v=v, receivers=r, n=n, run_align=k)))
    _, tr, _, _ = prepared_flagship(24)
    cases += [("place", "placement_by_name", dict(samples=tr, batch_size=8)),
              ("driver", "giant_driver", dict(nx=LATTICE[0], ny=LATTICE[1], nz=LATTICE[2], hidden=32, steps=4))]
    return shared_group(W, cases, tmp_path_factory, "edge_group")


def _jax_mesh_edges(senders, receivers, weights):
    mesh = jax_make_mesh(W)
    snd, rcv, w, mask = jax_shard_edges(senders, receivers, weights, W)
    return mesh, jax_place_edge_shards(mesh, snd, rcv, w, mask)


def test_edge_sharded_sum_matches_reference(group):
    nodes, senders, receivers = _graph()
    mesh, (snd, rcv, _, mask) = _jax_mesh_edges(senders, receivers, None)
    jagg = jax_edge_sharded_aggregate(mesh, lambda xi, xj: xj, jnp.asarray(nodes), snd, rcv, mask)
    ref = jax.ops.segment_sum(nodes[senders], jnp.asarray(receivers), nodes.shape[0])
    for r in group["agg"]:
        np.testing.assert_allclose(r["sum"], np.asarray(ref), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r["sum"], np.asarray(jagg), rtol=1e-5, atol=1e-5)
        assert r["rows"] * W == r["global_rows"]


def test_edge_sharded_with_edge_data(group):
    nodes, senders, receivers = _graph()
    weights = np.random.default_rng(1).normal(size=(len(senders), 1)).astype(np.float32)
    mesh, (snd, rcv, w, mask) = _jax_mesh_edges(senders, receivers, weights)
    jagg = jax_edge_sharded_aggregate(mesh, lambda xi, xj, ew: xj * ew, jnp.asarray(nodes), snd, rcv, mask,
                                      edge_data=w)
    for r in group["agg"]:
        np.testing.assert_allclose(r["weighted"], np.asarray(jagg), rtol=1e-4, atol=1e-4)


def test_edge_sharded_gin_layer(group):
    nodes, senders, receivers = _graph()
    w1, b1, w2, b2 = _gin_weights(nodes.shape[1])
    mesh, (snd, rcv, _, mask) = _jax_mesh_edges(senders, receivers, None)
    jout = jax_edge_sharded_gin_layer(mesh, jnp.asarray(nodes), snd, rcv, mask, w1, b1, w2, b2)
    for r in group["agg"]:
        assert r["gin"].shape == nodes.shape and np.isfinite(r["gin"]).all()
        np.testing.assert_allclose(r["gin"], np.asarray(jout), rtol=1e-4, atol=1e-4)
    iso = np.setdiff1d(np.arange(nodes.shape[0]), np.unique(receivers))
    if len(iso):
        i = int(iso[0])
        ref = np.maximum((101.0 * nodes[i]) @ w1 + b1, 0.0) @ w2 + b2
        np.testing.assert_allclose(group["agg"][0]["gin"][i], ref, rtol=1e-4)


@pytest.mark.parametrize("run_align", [0, 8])
def test_giant_graph_pna_with_kernel_path(pna_problem, group, run_align):
    """The hidden-128 PNA step over a graph whose edges are split over two
    ranks equals JAX's unsharded step, on the unaligned layout (B5, then
    B6 and B7 with the group's tie counts) and the run-aligned one (the
    sender gather and the K-group statistics, B2, the group's maxima),
    the window plans dropped."""
    _, pna = pna_problem
    _, jloss, jstate, pad = pna[run_align]
    ref = variables_from_flax(jax.device_get({"params": jstate.params, "batch_stats": jstate.batch_stats}))
    for r in group[f"pna{run_align}"]:
        np.testing.assert_allclose(r["loss"], jloss, rtol=1e-5)
        for k, v in r["params"].items():
            np.testing.assert_allclose(v, ref[k].numpy(), rtol=1e-4, atol=1e-6, err_msg=k)
        assert r["rows"] * W == r["global_rows"] == pad and r["win"]


@pytest.mark.parametrize("run_align", [0, 8])
def test_cross_shard_tie_gets_the_unsharded_gradient(group, run_align):
    """A maximum tied by one edge on each side of the shard boundary: the
    gradient splits evenly between the two edges, as without sharding
    (each rank's share of the group's summed cotangent over the group's
    tie count)."""
    v, _, _ = _tie_case(run_align)
    for r in group[f"tie{run_align}"]:
        ref = r["ref"][r["lo"]:r["hi"]]
        np.testing.assert_allclose(r["shard"], ref, rtol=1e-6, atol=1e-7)
    mid = v.shape[0] // 2
    full = group[f"tie{run_align}"][0]["ref"]
    assert full[mid - 1, 0] == full[mid, 0] != 0.0 and full[mid - 1, 1] == full[mid, 1] != 0.0


def test_dp_edge_placement_by_field_name(group):
    """The edge fields are sliced by name; graph-axis fields whose pad
    equals the edge pad stay whole; the window plans are dropped."""
    for r in group["place"]:
        assert r["senders"] * W == r["e_pad"] and r["edge_mask"] * W == r["e_pad"]
        assert r["graph_mask"] == r["e_pad"] and all(t == r["e_pad"] for t in r["targets"])
        assert r["win"]


def test_giant_driver_loss_falls_and_equals_one_process(group):
    """The giant driver on two edge ranks: each holds half of the padded
    edge rows, and its losses are the one-process run's."""
    one = train_giant(*LATTICE, hidden=32, steps=4, device="cpu", verbose=False)
    for r in group["driver"]:
        assert r["losses"][-1] < r["losses"][0]
        np.testing.assert_allclose(r["losses"], one["losses"], rtol=1e-4)
        acct = r["residency"]["senders"]
        assert acct["rows_per_device"] * W == acct["global_rows"] and acct["bytes_per_device"] == 4 * acct["rows_per_device"]
