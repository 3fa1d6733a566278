"""Parity of the port's host data path with the JAX package's.

Synthetic data, radius edges, the splits and the normalized, packed
features of ``prepare_dataset`` must be BIT-equal from the same seed
(both are the same numpy arithmetic); ``update_config`` must resolve the
same config, including the PNA degree histogram and its average-degree
statistics.
"""

import copy
import importlib

import numpy as np
import pytest

from hydragnn_tpu.data import ingest as jax_ingest
from hydragnn_tpu.data.radius_graph import edge_lengths as jax_edge_lengths
from hydragnn_tpu.data.radius_graph import radius_graph as jax_radius_graph
from hydragnn_tpu.data import splitting as jax_splitting
from hydragnn_tpu.data import synthetic as jax_synthetic
from hydragnn_tpu.flagship import flagship_config as jax_flagship_config
from hydragnn_tpu.models.convs import avg_degree_stats as jax_avg_degree_stats
from hydragnn_tpu.utils import config as jax_config

from hydragnn_tpu_torch.data import ingest as t_ingest
from hydragnn_tpu_torch.data import splitting as t_splitting
from hydragnn_tpu_torch.data import synthetic as t_synthetic
from hydragnn_tpu_torch.flagship import flagship_config as t_flagship_config
from hydragnn_tpu_torch.models.convs import avg_degree_stats as t_avg_degree_stats
from hydragnn_tpu_torch.utils import config as t_config

# the package exports the function under the module's name
t_radius = importlib.import_module("hydragnn_tpu_torch.data.radius_graph")

# the runtime knobs of the JAX package that the port does not resolve
_JAX_ONLY_KEYS = {"diagnostics", "diag_every", "Parallel"}


def _samples(mod, n=24, seed=3):
    return mod.deterministic_graph_data(
        number_configurations=n,
        unit_cell_x_range=(2, 4),
        unit_cell_y_range=(2, 4),
        unit_cell_z_range=(2, 4),
        seed=seed,
    )


def _assert_samples_equal(a, b):
    assert len(a) == len(b)
    for sa, sb in zip(a, b):
        np.testing.assert_array_equal(sa.x, sb.x)
        assert sa.x.dtype == sb.x.dtype
        for field in ("pos", "edge_index", "edge_attr", "graph_y"):
            va, vb = getattr(sa, field), getattr(sb, field)
            assert (va is None) == (vb is None), field
            if va is not None:
                np.testing.assert_array_equal(va, vb, err_msg=field)
                assert va.dtype == vb.dtype, field
        for tgt in ("graph_targets", "node_targets"):
            ta, tb = getattr(sa, tgt), getattr(sb, tgt)
            assert sorted(ta) == sorted(tb)
            for k in ta:
                np.testing.assert_array_equal(ta[k], tb[k])


def test_deterministic_graph_data_bit_equal():
    _assert_samples_equal(_samples(t_synthetic, seed=11), _samples(jax_synthetic, seed=11))


@pytest.mark.parametrize("cap", [None, 5])
@pytest.mark.parametrize("n_points", [40, 300])
def test_radius_graph_matches(cap, n_points):
    """Brute-force (40 points) and cell-list (300 points) candidate
    paths; random positions have no distance ties, so the
    receiver-major order is unique."""
    pos = np.random.default_rng(n_points).random((n_points, 3)) * 2.0
    ours = t_radius.radius_graph(pos, 0.45, max_num_neighbors=cap)
    ref = jax_radius_graph(pos, 0.45, max_num_neighbors=cap)
    np.testing.assert_array_equal(ours, ref)
    assert ours.dtype == ref.dtype
    np.testing.assert_array_equal(t_radius.edge_lengths(pos, ours), jax_edge_lengths(pos, ref))


@pytest.mark.parametrize("cap", [None, 10])
@pytest.mark.parametrize("cells", [3, 5])
def test_radius_graph_matches_on_tied_lattice(cap, cells):
    """BCC lattices are full of equal distances, so the order of tied
    candidates decides which neighbours a cap keeps: brute force
    (54 atoms) and cell list (250 atoms) must tie-break like the JAX
    package."""
    g = np.stack(np.meshgrid(*[np.arange(cells)] * 3, indexing="ij"), -1).reshape(-1, 3)
    pos = np.concatenate([g, g + 0.5]).astype(np.float32)
    np.testing.assert_array_equal(
        t_radius.radius_graph(pos, 2.0, max_num_neighbors=cap),
        jax_radius_graph(pos, 2.0, max_num_neighbors=cap),
    )


@pytest.mark.parametrize("stratified", [False, True])
def test_prepare_dataset_bit_equal(stratified):
    cfg_t = t_flagship_config(hidden_dim=16, num_conv_layers=2)
    cfg_j = jax_flagship_config(hidden_dim=16, num_conv_layers=2)
    cfg_t["Dataset"]["compositional_stratified_splitting"] = stratified
    cfg_j["Dataset"]["compositional_stratified_splitting"] = stratified
    assert cfg_t == cfg_j
    out_t = t_ingest.prepare_dataset(_samples(t_synthetic), cfg_t)
    out_j = jax_ingest.prepare_dataset(_samples(jax_synthetic), cfg_j)
    for split_t, split_j in zip(out_t[:3], out_j[:3]):
        _assert_samples_equal(split_t, split_j)
    np.testing.assert_array_equal(out_t[3], out_j[3])
    np.testing.assert_array_equal(out_t[4], out_j[4])


def test_stratified_split_matches():
    a = _samples(t_synthetic, n=30, seed=5)
    b = _samples(jax_synthetic, n=30, seed=5)
    assert t_splitting.composition_categories(a) == jax_splitting.composition_categories(b)
    for sa, sb in zip(
        t_splitting.compositional_stratified_splitting(a, 0.7, seed=2),
        jax_splitting.compositional_stratified_splitting(b, 0.7, seed=2),
    ):
        _assert_samples_equal(sa, sb)


def test_update_config_resolves_the_same_config():
    cfg_t = t_flagship_config(hidden_dim=16, num_conv_layers=2)
    cfg_j = jax_flagship_config(hidden_dim=16, num_conv_layers=2)
    tr, va, te, _, _ = t_ingest.prepare_dataset(_samples(t_synthetic, n=40), cfg_t)
    cfg_t = t_config.update_config(cfg_t, tr, va, te)
    tr, va, te, _, _ = jax_ingest.prepare_dataset(_samples(jax_synthetic, n=40), cfg_j)
    cfg_j = jax_config.update_config(cfg_j, tr, va, te)

    def strip(d):
        if isinstance(d, dict):
            return {k: strip(v) for k, v in d.items() if k not in _JAX_ONLY_KEYS}
        return d

    assert strip(copy.deepcopy(cfg_t)) == strip(copy.deepcopy(cfg_j))
    deg = cfg_t["NeuralNetwork"]["Architecture"]["pna_deg"]
    assert sum(deg) > 0
    assert t_avg_degree_stats(deg) == jax_avg_degree_stats(deg)

