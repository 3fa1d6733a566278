"""The port's ``PNAConv`` and ``HydraModel`` forward against the JAX
package's, with the weights carried across by ``convert.py``.

Tolerance: ``rtol=1e-4, atol=1e-5`` in float32 (matrix products and
sums accumulate in another order in the two frameworks). Every leaf of
the JAX variables (randomized, so biases and BatchNorm statistics are
not their trivial init) must map onto exactly one port parameter.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hydragnn_tpu.data.ingest import prepare_dataset as jax_prepare_dataset
from hydragnn_tpu.data.synthetic import deterministic_graph_data as jax_data
from hydragnn_tpu.flagship import flagship_config as jax_flagship_config
from hydragnn_tpu.graph.batch import batch_graphs as jax_batch_graphs
from hydragnn_tpu.models import convs as jax_convs
from hydragnn_tpu.models.base import HydraModel as JaxHydraModel
from hydragnn_tpu.models.create import model_config_from_dict as jax_model_config
from hydragnn_tpu.utils.config import update_config as jax_update_config

from hydragnn_tpu_torch.convert import variables_from_flax
from hydragnn_tpu_torch.data.ingest import prepare_dataset
from hydragnn_tpu_torch.data.synthetic import deterministic_graph_data
from hydragnn_tpu_torch.flagship import flagship_config
from hydragnn_tpu_torch.graph.batch import batch_graphs
from hydragnn_tpu_torch.models.convs import EdgeContext, PNAConv, avg_degree_stats
from hydragnn_tpu_torch.models.create import create_model_config
from hydragnn_tpu_torch.serve.server import request_to_dict
from hydragnn_tpu_torch.utils.config import update_config

TOL = dict(rtol=1e-4, atol=1e-5)


def _prepared(mod_data, mod_prep, mod_update, cfg, n=16):
    samples = mod_data(
        number_configurations=n,
        unit_cell_x_range=(2, 4),
        unit_cell_y_range=(2, 4),
        unit_cell_z_range=(2, 4),
        seed=2,
    )
    tr, va, te, _, _ = mod_prep(samples, cfg)
    cfg = mod_update(cfg, tr, va, te)
    return list(tr) + list(va) + list(te), cfg


@pytest.fixture(scope="module")
def setup():
    hidden, layers = 24, 3
    samples, cfg = _prepared(
        deterministic_graph_data, prepare_dataset, update_config, flagship_config(hidden, layers)
    )
    jsamples, jcfg = _prepared(
        jax_data, jax_prepare_dataset, jax_update_config, jax_flagship_config(hidden, layers)
    )
    graphs = [request_to_dict(s) for s in samples[:6]]
    jgraphs = [request_to_dict(s) for s in jsamples[:6]]
    return cfg, jcfg, graphs, jgraphs


def _jax_model(nn_config, jbatch):
    """The JAX model and its (jit-traced) initial variables."""
    jmodel = JaxHydraModel(jax_model_config(nn_config))
    init = jax.jit(lambda b: jmodel.init(jax.random.PRNGKey(0), b, train=False))
    return jmodel, init(jbatch)


def _randomized(variables, seed):
    """Every leaf replaced by numpy-seeded values (variances positive)."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        x = np.asarray(x)
        name = jax.tree_util.keystr(path)
        vals = rng.normal(scale=0.3, size=x.shape).astype(np.float32)
        if name.endswith("['var']"):
            vals = np.abs(vals) + 0.5
        return vals

    return jax.tree_util.tree_map_with_path(leaf, variables)


def test_pnaconv_matches_jax(setup):
    cfg, jcfg, graphs, jgraphs = setup
    batch = batch_graphs(graphs, n_node_pad=240, n_edge_pad=4400, n_graph_pad=8)
    jbatch = jax_batch_graphs(jgraphs, n_node_pad=240, n_edge_pad=4400, n_graph_pad=8)
    lin, log = avg_degree_stats(cfg["NeuralNetwork"]["Architecture"]["pna_deg"])
    rng = np.random.default_rng(0)
    for fin in (1, 24):
        x = rng.normal(size=(batch.num_nodes, fin)).astype(np.float32)
        jconv = jax_convs.PNAConv(32, avg_deg_lin=lin, avg_deg_log=log)
        jctx = jax_convs.EdgeContext(
            senders=jbatch.senders,
            receivers=jbatch.receivers,
            edge_mask=jbatch.edge_mask,
            node_mask=jbatch.node_mask,
            sender_perm=jbatch.sender_perm,
            in_degree=jbatch.in_degree,
        )
        jvars = _randomized(
            jax.jit(lambda x_: jconv.init(jax.random.PRNGKey(0), x_, jctx))(jnp.asarray(x)),
            seed=fin,
        )
        ref = np.asarray(jax.jit(lambda v_, x_: jconv.apply(v_, x_, jctx))(jvars, jnp.asarray(x)))

        sd = variables_from_flax({"params": {"conv_0": jvars["params"]}})
        conv = PNAConv(fin, 32, lin, log)
        conv.load_state_dict({k[len("convs.0."):]: v for k, v in sd.items()}, strict=True)
        ctx = EdgeContext(
            senders=batch.senders,
            receivers=batch.receivers,
            edge_mask=batch.edge_mask,
            node_mask=batch.node_mask,
            in_degree=batch.in_degree,
        )
        with torch.no_grad():
            out = conv(torch.from_numpy(x), ctx).numpy()
        np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("train", [False, True])
def test_hydra_model_forward_matches_jax(setup, train):
    cfg, jcfg, graphs, jgraphs = setup
    batch = batch_graphs(graphs)
    jbatch = jax_batch_graphs(jgraphs)
    jmodel, jvars = _jax_model(jcfg["NeuralNetwork"], jbatch)
    jvars = _randomized(jvars, seed=11)
    ref = jax.jit(
        lambda v, b: jmodel.apply(v, b, train=train, mutable=["batch_stats"])[0]
    )(jvars, jbatch)

    model = create_model_config(cfg["NeuralNetwork"], seed=0, device="cpu")
    sd = variables_from_flax(jvars)
    assert set(sd) == set(model.state_dict())  # every leaf, exactly once
    model.load_state_dict(sd, strict=True)
    with torch.no_grad():
        outs = model(batch, train=train)
    assert len(outs) == len(ref) == 4
    for o, r in zip(outs, ref):
        assert o.shape == r.shape
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **TOL)


def test_converter_consumes_every_leaf_once(setup):
    cfg, jcfg, _, jgraphs = setup
    _, jvars = _jax_model(jcfg["NeuralNetwork"], jax_batch_graphs(jgraphs))
    n_leaves = len(jax.tree_util.tree_leaves(jvars))
    sd = variables_from_flax(jax.tree_util.tree_map(np.asarray, jvars))
    assert len(sd) == n_leaves
    model = create_model_config(cfg["NeuralNetwork"], seed=0, device="cpu")
    assert len(model.state_dict()) == n_leaves
    extra = {"params": {"mystery": {"Dense_0": {"kernel": np.zeros((1, 1))}}}}
    with pytest.raises(KeyError):
        variables_from_flax(extra)


def test_seeded_init_follows_flax_initializers(setup):
    cfg = setup[0]
    a = create_model_config(cfg["NeuralNetwork"], seed=5, device="cpu").state_dict()
    b = create_model_config(cfg["NeuralNetwork"], seed=5, device="cpu").state_dict()
    for k in a:
        assert torch.equal(a[k], b[k]), k  # same seed, same weights
    w = a["convs.1.post.weight"]  # fan_in = 17 * hidden
    std = 1.0 / np.sqrt(w.shape[1])
    assert abs(float(w.std()) - std) < 0.1 * std
    assert float(w.abs().max()) <= 2.0 * std / 0.87962566103423978 + 1e-6
    assert not a["convs.0.post.bias"].any()
    assert torch.equal(a["norms.0.running_var"], torch.ones_like(a["norms.0.running_var"]))
