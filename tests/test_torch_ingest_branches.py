"""Parity of the port's ingest branches and radius graphs with the JAX
package's (the case list of ``tests/test_data_pipeline.py:84-394`` and
``tests/test_native_radius.py``).

Both packages run the same numpy (and the same ``native/radius.cpp``),
so radius graphs (native, numpy and periodic), rotation, descriptors,
subsample indices and presplit outputs must be BIT-equal on the same
numpy-seeded inputs. Two behaviours of the JAX package that look wrong
against the original HydraGNN are pinned here as they are (ROADMAP C,
"the reference's own"): PBC edge lengths from the unshifted positions,
and rotation normalization that leaves ``meta["cell"]`` unrotated.
"""

import copy
import importlib
from collections import Counter

import numpy as np
import pytest

from hydragnn_tpu.data import ingest as j_ingest
from hydragnn_tpu.data import splitting as j_splitting
from hydragnn_tpu.data.dataset import GraphSample as JSample
from hydragnn_tpu.data.synthetic import deterministic_graph_data as j_data
from hydragnn_tpu.utils.config import update_config as j_update_config

from hydragnn_tpu_torch import native as t_native
from hydragnn_tpu_torch.data import ingest as t_ingest
from hydragnn_tpu_torch.data import splitting as t_splitting
from hydragnn_tpu_torch.data.dataset import GraphSample as TSample
from hydragnn_tpu_torch.data.synthetic import deterministic_graph_data as t_data
from hydragnn_tpu_torch.utils.config import update_config as t_update_config

from test_data_pipeline import base_config
from test_torch_data import _assert_samples_equal

j_rg = importlib.import_module("hydragnn_tpu.data.radius_graph")
t_rg = importlib.import_module("hydragnn_tpu_torch.data.radius_graph")
j_native = importlib.import_module("hydragnn_tpu.native")


def _both(fn):
    """``fn(radius_graph_module)`` on the port and on the JAX package."""
    return fn(t_rg), fn(j_rg)


def _equal(a, b):
    np.testing.assert_array_equal(a, b)
    assert a.dtype == b.dtype


def _bcc(a, reps):
    """A cubic BCC supercell: positions and the cell."""
    reps = (reps,) * 3 if np.isscalar(reps) else reps
    basis = np.array([[0.0, 0.0, 0.0], [a / 2, a / 2, a / 2]])
    shifts = np.array(
        [[i, j, k] for i in range(reps[0]) for j in range(reps[1]) for k in range(reps[2])]
    ) * a
    return (basis[None] + shifts[:, None]).reshape(-1, 3), np.diag(np.asarray(reps, float) * a)


# ---------------------------------------------------------------- radius graphs


@pytest.mark.parametrize(
    "pos,r,cap",
    [
        (np.array([[0.0, 0, 0], [1.0, 0, 0], [2.0, 0, 0]]), 1.5, None),
        (np.array([[0.0, 0, 0], [1.0, 0, 0], [0, 1.1, 0], [0, 0, 1.2], [1.3, 0, 0]]), 2.0, 2),
    ],
    ids=["line", "hub_cap"],
)
def test_small_radius_graphs_match(pos, r, cap):
    ours, ref = _both(lambda m: m.radius_graph(pos, r, max_num_neighbors=cap))
    _equal(ours, ref)
    _equal(t_rg.edge_lengths(pos, ours), j_rg.edge_lengths(pos, ref))


def test_cell_list_matches_jax_and_brute_force():
    pos = np.random.default_rng(0).uniform(0, 10, size=(300, 3))
    ours, ref = _both(lambda m: m.radius_graph(pos, 1.2))
    _equal(ours, ref)
    diff = pos[:, None] - pos[None, :]
    dist = np.sqrt((diff**2).sum(-1))
    want = {(j, i) for j in range(300) for i in range(300) if j != i and dist[j, i] <= 1.2}
    assert set(map(tuple, ours.T.tolist())) == want


@pytest.mark.parametrize("loop", [False, True])
def test_pbc_counts_match(loop):
    one, one_j = _both(lambda m: m.radius_graph_pbc(np.zeros((1, 3)), 1.0, np.eye(3), loop=loop))
    _equal(one, one_j)
    assert one.shape[1] == 6 + (1 if loop else 0)
    pos2 = np.array([[0.0, 0, 0], [0.5, 0, 0]])
    two, two_j = _both(lambda m: m.radius_graph_pbc(pos2, 0.6, np.eye(3), loop=loop))
    _equal(two, two_j)
    pairs = [tuple(e) for e in two.T.tolist()]
    assert pairs.count((0, 1)) == 2 and pairs.count((1, 0)) == 2


@pytest.mark.parametrize("loop,per_atom", [(False, 14), (True, 15)])
def test_periodic_bcc_supercell_matches(loop, per_atom):
    """The 5x5x5 BCC Cr supercell (a = 3.6, radius 5.0): 8 first-shell
    and 6 second-shell periodic neighbours an atom, 15 with the self
    loop; the same edges in the same order as the JAX package."""
    pos, cell = _bcc(3.6, 5)
    ours, ref = _both(lambda m: m.radius_graph_pbc(pos, 5.0, cell, loop=loop))
    _equal(ours, ref)
    assert ours.shape[1] == per_atom * pos.shape[0]


def test_pbc_partial_periodicity_and_cap_match():
    pos = np.random.default_rng(4).uniform(0, 6.0, (90, 3))
    cell = np.array([[6.0, 0.0, 0.0], [1.0, 6.0, 0.0], [0.5, 0.3, 6.0]])
    for pbc in ((True, True, True), (True, False, True)):
        for cap in (None, 5):
            ours, ref = _both(
                lambda m: m.radius_graph_pbc(pos, 2.2, cell, pbc=pbc, max_num_neighbors=cap)
            )
            _equal(ours, ref)


# ---------------------------------------------------------------- native core


@pytest.fixture
def big_cloud():
    return np.random.default_rng(3).uniform(0, 12.0, (400, 3)).astype(np.float64)


def test_native_library_builds_in_the_port():
    t_native._load()
    assert t_native.HAVE_NATIVE, "libhgc.so failed to build from native/*.cpp; check g++"
    assert t_native._BUILD_DIR.endswith("hydragnn_tpu_torch/native/build")
    assert t_native.native_radius_pairs(np.zeros((5, 3)), np.zeros((5, 3)), 0.1) is not None


def test_native_pairs_equal_jax_native_pairs(big_cloud):
    ours = t_native.native_radius_pairs(big_cloud, big_cloud, 1.7)
    ref = j_native.native_radius_pairs(big_cloud, big_cloud, 1.7)
    for a, b in zip(ours, ref):
        _equal(a, b)


@pytest.mark.parametrize("periodic", [False, True])
def test_native_matches_numpy_fallback(big_cloud, monkeypatch, periodic):
    def build():
        if periodic:
            return t_rg.radius_graph_pbc(big_cloud, 1.7, np.eye(3) * 12.0)
        return t_rg.radius_graph(big_cloud, 1.7)

    native_ei = build()
    _equal(native_ei, (j_rg.radius_graph_pbc(big_cloud, 1.7, np.eye(3) * 12.0) if periodic
                       else j_rg.radius_graph(big_cloud, 1.7)))
    monkeypatch.setattr("hydragnn_tpu_torch.native.native_radius_pairs", lambda *a: None)
    numpy_ei = build()
    assert set(map(tuple, native_ei.T.tolist())) == set(map(tuple, numpy_ei.T.tolist()))
    assert native_ei.shape == numpy_ei.shape


def test_native_matches_brute_force():
    pos = np.random.default_rng(11).uniform(0, 8.0, (300, 3))
    diff = pos[:, None] - pos[None, :]
    dist = np.sqrt((diff**2).sum(-1))
    want = {(s, t) for s, t in zip(*np.nonzero(dist <= 1.4)) if s != t}
    s, t, d = t_native.native_radius_pairs(pos, pos, 1.4)
    assert {(int(a), int(b)) for a, b in zip(s, t) if a != b} == want
    np.testing.assert_allclose(d, np.linalg.norm(pos[s] - pos[t], axis=1), rtol=1e-12)


def test_neighbour_cap(big_cloud):
    ours, ref = _both(lambda m: m.radius_graph(big_cloud, 2.5, max_num_neighbors=4))
    _equal(ours, ref)
    assert np.unique(ours[1], return_counts=True)[1].max() <= 4


def test_native_outlier_falls_back():
    """A far outlier makes the dense grid unsuitable: the native call
    returns None and the numpy grid answers, as in the JAX package."""
    pos = np.random.default_rng(2).uniform(0, 12.0, (400, 3))
    pos[0] = [2e5, 2e5, 2e5]
    assert t_native.native_radius_pairs(pos, pos, 1.7) is None
    ours, ref = _both(lambda m: m.radius_graph(pos, 1.7))
    _equal(ours, ref)
    assert ours.shape[0] == 2 and (ours[0] != 0).all()


# ---------------------------------------------------------------- rotation


def _rotated_pair(rng, n, dtype):
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    pos = rng.rand(n, 3).astype(dtype)
    rot = (q @ pos.astype(np.float64).T).T + rng.normal(size=3)
    return pos, rot.astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_rotation_matches_and_aligns(dtype):
    rng = np.random.RandomState(13)
    pos, rot = _rotated_pair(rng, 24, dtype)
    out = {}
    for name, mod, cls in (("t", t_ingest, TSample), ("j", j_ingest, JSample)):
        a = cls(x=np.zeros((24, 1), np.float32), pos=pos.copy())
        b = cls(x=np.zeros((24, 1), np.float32), pos=rot.copy())
        mod.normalize_rotation([a, b])
        out[name] = (a.pos, b.pos)
    for ours, ref in zip(out["t"], out["j"]):
        _equal(ours, ref)
    pa, pb = (p.astype(np.float64) for p in out["t"])
    tol = 1e-4 if dtype == np.float32 else 1e-14
    for axis in range(3):  # the same canonical frame up to SVD's signs
        err = min(np.abs(pa[:, axis] - pb[:, axis]).max(), np.abs(pa[:, axis] + pb[:, axis]).max())
        assert err < 100 * tol


@pytest.mark.parametrize("n", [1, 2])
def test_rotation_keeps_dimensions_for_tiny_graphs(n):
    pos = np.arange(3 * n, dtype=np.float32).reshape(n, 3)
    a, b = TSample(x=np.zeros((n, 1), np.float32), pos=pos.copy()), JSample(
        x=np.zeros((n, 1), np.float32), pos=pos.copy())
    t_ingest.normalize_rotation([a])
    j_ingest.normalize_rotation([b])
    assert a.pos.shape == (n, 3) and np.isfinite(a.pos).all()
    _equal(a.pos, b.pos)


def test_rotation_of_integer_positions_matches():
    pos = np.array([[0, 0, 0], [1, 0, 0], [0, 2, 0], [0, 0, 3]], dtype=np.int64)
    a, b = TSample(x=np.zeros((4, 1)), pos=pos.copy()), JSample(x=np.zeros((4, 1)), pos=pos.copy())
    t_ingest.normalize_rotation([a])
    j_ingest.normalize_rotation([b])
    _equal(a.pos, b.pos)
    assert a.pos.dtype == np.float32


# ---------------------------------------------------------------- the reference's own


def _supercell_samples(cls):
    """A 2x3x2 BCC supercell (a = 3.3, an off-centre atom so that the
    principal axes are not the lattice axes) with a cell."""
    pos, cell = _bcc(3.3, (2, 3, 2))
    pos = pos.copy()
    pos[0] += [0.31, 0.17, 0.05]
    rng = np.random.default_rng(5)
    return [cls(x=rng.random((pos.shape[0], 1)), pos=pos.astype(np.float32), meta={"cell": cell.copy()})]


def test_pbc_lengths_use_the_unshifted_positions_as_jax_does():
    """Under PBC the JAX package measures every edge on the unshifted
    positions (``hydragnn_tpu/data/ingest.py:92``), so an edge through a
    periodic image gets the in-cell distance, not the image's. The port
    copies it; the test shows the two differ on this supercell."""
    ours, ref = _supercell_samples(TSample), _supercell_samples(JSample)
    mx_t = t_ingest.build_edges(ours, 3.0, None, periodic_boundary_conditions=True)
    mx_j = j_ingest.build_edges(ref, 3.0, None, periodic_boundary_conditions=True)
    assert mx_t == mx_j
    _equal(ours[0].edge_index, ref[0].edge_index)
    _equal(ours[0].edge_attr, ref[0].edge_attr)
    s, cell = ours[0], ours[0].meta["cell"]
    pos = s.pos.astype(np.float64)
    d = pos[s.edge_index[1]] - pos[s.edge_index[0]]
    frac = d @ np.linalg.inv(cell)
    image = np.linalg.norm((frac - np.round(frac)) @ cell, axis=1)
    assert image.max() <= 3.0 + 1e-5  # every edge is within r of some image
    assert np.linalg.norm(d, axis=1).max() > 3.0  # but the lengths are in-cell
    np.testing.assert_allclose(s.edge_attr[:, 0] * mx_t, np.linalg.norm(d, axis=1), rtol=1e-6)


def test_rotation_leaves_the_cell_unrotated_as_jax_does():
    """``normalize_rotation`` rotates ``pos`` and not ``meta["cell"]``,
    which the PBC branch then uses (``hydragnn_tpu/data/ingest.py:79``,
    ``:83``). The rotation here is not the identity; the port equals
    the JAX package edge for edge."""
    ours, ref = _supercell_samples(TSample), _supercell_samples(JSample)
    before = ours[0].pos.copy()
    kw = dict(periodic_boundary_conditions=True, rotational_invariance=True)
    t_ingest.build_edges(ours, 3.0, 100000, **kw)
    j_ingest.build_edges(ref, 3.0, 100000, **kw)
    centred = before.astype(np.float64) - before.astype(np.float64).mean(0)
    assert np.abs(np.abs(ours[0].pos) - np.abs(centred)).max() > 0.1  # rotated
    np.testing.assert_array_equal(ours[0].meta["cell"], _supercell_samples(TSample)[0].meta["cell"])
    for f in ("pos", "edge_index", "edge_attr"):
        _equal(getattr(ours[0], f), getattr(ref[0], f))


def test_rotation_with_pbc_changes_the_lattice_degree_as_jax_does(tmp_path):
    """The effect of the unrotated cell on the EAM example's data: BCC
    NiNb supercells (a = 3.30, radius 3.0) give every atom its 8 first
    neighbours under PBC alone; with the rotation as well the images
    shift along the unrotated lattice and the in-degrees spread, in the
    port exactly as in the JAX package."""
    from hydragnn_tpu.data.formats import read_cfg_dir as j_read_cfg_dir

    from hydragnn_tpu_torch.data.formats import read_cfg_dir as t_read_cfg_dir

    from test_torch_cuda_kernels import eam_config, write_cfg_dir

    write_cfg_dir(str(tmp_path), 6, seed=0)
    ds = eam_config(str(tmp_path))["Dataset"]
    for rot in (False, True):
        ours, ref = t_read_cfg_dir(str(tmp_path), ds), j_read_cfg_dir(str(tmp_path), ds)
        kw = dict(periodic_boundary_conditions=True, rotational_invariance=rot)
        t_ingest.build_edges(ours, 3.0, 100000, **kw)
        j_ingest.build_edges(ref, 3.0, 100000, **kw)
        _assert_samples_equal(ours, ref)
        degrees = np.concatenate([np.bincount(s.edge_index[1], minlength=s.num_nodes) for s in ours])
        if rot:
            assert degrees.min() < 8 < degrees.max()
        else:
            assert (degrees == 8).all()


# ---------------------------------------------------------------- descriptors


def _with_normals(samples):
    for s in samples:
        n = np.random.default_rng(s.num_nodes).normal(size=(s.num_nodes, 3))
        s.meta["norm"] = n / np.linalg.norm(n, axis=1, keepdims=True)
    return samples


@pytest.mark.parametrize("spherical,point_pair", [(True, False), (False, True), (True, True)])
def test_descriptors_match(spherical, point_pair):
    ours, ref = _with_normals(t_data(number_configurations=6, seed=3)), _with_normals(
        j_data(number_configurations=6, seed=3))
    kw = dict(spherical_coordinates=spherical, point_pair_features=point_pair)
    assert t_ingest.build_edges(ours, 2.0, 100, **kw) == j_ingest.build_edges(ref, 2.0, 100, **kw)
    _assert_samples_equal(ours, ref)
    width = 1 + (2 if spherical else 0) + (4 if point_pair else 0)
    for s in ours:
        assert s.edge_attr.shape[1] == width
        if point_pair:
            ppf = s.edge_attr[:, -4:]
            assert (ppf[:, 0] >= 0).all() and (ppf[:, 0] <= 1.0 + 1e-6).all()
            assert (ppf[:, 1:] >= 0).all() and (ppf[:, 1:] <= np.pi + 1e-6).all()


def test_point_pair_needs_normals():
    with pytest.raises(ValueError, match="norm"):
        t_ingest.build_edges(t_data(number_configurations=2, seed=3), 2.0, 100, point_pair_features=True)


def test_descriptors_grow_edge_dim_and_feed_the_model():
    import torch

    from hydragnn_tpu_torch.data.loader import GraphLoader
    from hydragnn_tpu_torch.models.create import create_model_config

    cfgs = []
    for mod, data, upd in ((t_ingest, t_data, t_update_config), (j_ingest, j_data, j_update_config)):
        cfg = base_config()
        cfg["NeuralNetwork"]["Architecture"]["edge_features"] = ["lengths"]
        cfg["Dataset"]["Descriptors"] = {"SphericalCoordinates": True, "PointPairFeatures": True}
        samples = data(number_configurations=30, seed=5)
        for s in samples:
            s.meta["norm"] = np.ones((s.num_nodes, 3), dtype=np.float32) / np.sqrt(3.0)
        splits = mod.prepare_dataset(samples, cfg)
        cfgs.append((upd(cfg, *splits[:3]), splits))
    (cfg_t, out_t), (cfg_j, out_j) = cfgs
    for a, b in zip(out_t[:3], out_j[:3]):
        _assert_samples_equal(a, b)
    assert cfg_t["NeuralNetwork"]["Architecture"]["edge_dim"] == 7
    assert cfg_j["NeuralNetwork"]["Architecture"]["edge_dim"] == 7
    model = create_model_config(cfg_t["NeuralNetwork"], device="cpu")
    with torch.no_grad():
        outs = model(next(iter(GraphLoader(out_t[0], 8))), train=False)
    assert all(torch.isfinite(o).all() for o in outs)

    cfg2 = base_config()
    cfg2["Dataset"]["Descriptors"] = {"SphericalCoordinates": True}
    tr, va, te, _, _ = t_ingest.prepare_dataset(t_data(number_configurations=30, seed=5), cfg2)
    with pytest.raises(ValueError, match="edge_features"):
        t_update_config(cfg2, tr, va, te)


# ---------------------------------------------------------------- subsampling


@pytest.mark.parametrize("frac", [0.3, 0.5, 1.0])
def test_stratified_subsample_matches(frac):
    ours = t_splitting.stratified_subsample(t_data(number_configurations=200, seed=2), frac)
    ref = j_splitting.stratified_subsample(j_data(number_configurations=200, seed=2), frac)
    _assert_samples_equal(ours, ref)
    samples = t_data(number_configurations=200, seed=2)
    assert t_splitting.subsample_categories(samples) == j_splitting.subsample_categories(
        j_data(number_configurations=200, seed=2))
    assert len(ours) == int(round(frac * 200))  # the largest-remainder total
    cats_sub = set(t_splitting.subsample_categories(ours))
    for c, n in Counter(t_splitting.subsample_categories(samples)).items():
        if frac * n >= 1:
            assert c in cats_sub


def test_stratified_subsample_rejects_out_of_range():
    with pytest.raises(ValueError):
        t_splitting.stratified_subsample(t_data(number_configurations=10, seed=2), 0.0)


def test_subsample_through_prepare_dataset_matches():
    outs = []
    for mod, data in ((t_ingest, t_data), (j_ingest, j_data)):
        cfg = base_config()
        cfg["NeuralNetwork"]["Variables_of_interest"]["subsample_percentage"] = 0.5
        cfg["Dataset"]["compositional_stratified_splitting"] = False
        outs.append(mod.prepare_dataset(data(number_configurations=100, seed=5), cfg))
    assert sum(len(s) for s in outs[0][:3]) == 50
    for a, b in zip(outs[0][:3], outs[1][:3]):
        _assert_samples_equal(a, b)


@pytest.mark.parametrize("subsample", [None, 0.5])
def test_presplit_preparation_matches(subsample):
    outs = []
    for mod, data in ((t_ingest, t_data), (j_ingest, j_data)):
        cfg = base_config()
        cfg["Dataset"]["rotational_invariance"] = True
        if subsample:
            cfg["NeuralNetwork"]["Variables_of_interest"]["subsample_percentage"] = subsample
        splits = [data(number_configurations=n, seed=seed) for n, seed in ((20, 1), (8, 2), (8, 3))]
        outs.append(mod.prepare_presplit_dataset(*splits, cfg))
    for a, b in zip(outs[0][:3], outs[1][:3]):
        _assert_samples_equal(a, b)
    for a, b in zip(outs[0][3:], outs[1][3:]):
        _equal(a, b)


def test_periodic_rotated_prepare_matches():
    """The EAM configs' branch pair (PBC and rotational invariance) with
    compositional stratified splitting, through ``prepare_dataset``."""
    outs = []
    for mod, cls in ((t_ingest, TSample), (j_ingest, JSample)):
        cfg = copy.deepcopy(base_config())
        cfg["Dataset"]["rotational_invariance"] = True
        arch = cfg["NeuralNetwork"]["Architecture"]
        arch["periodic_boundary_conditions"], arch["radius"], arch["max_neighbours"] = True, 3.0, 100000
        voi = cfg["NeuralNetwork"]["Variables_of_interest"]
        voi.update(output_names=["sum_x_x2_x3", "x"], output_index=[0, 0], type=["graph", "node"])
        rng = np.random.default_rng(9)
        samples = []
        for k in range(12):
            pos, cell = _bcc(3.3, (2, 2 + k % 2, 2))
            samples.append(cls(x=rng.integers(0, 2, (pos.shape[0], 3)).astype(np.float64),
                               pos=(pos + rng.normal(scale=0.05, size=pos.shape)).astype(np.float32),
                               graph_y=rng.random(1), meta={"cell": cell}))
        outs.append(mod.prepare_dataset(samples, cfg))
    for a, b in zip(outs[0][:3], outs[1][:3]):
        _assert_samples_equal(a, b)
