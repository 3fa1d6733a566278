"""Parity of the port's raw-format readers and of its entry points on
``Dataset.path`` with the JAX package's.

The case lists of ``tests/test_data_pipeline.py:84-96`` (the LSMS round
trip) and ``tests/test_formats.py`` (XYZ with and without a lattice,
the ``_energy.txt`` sidecar, CFG parse and packing), on files both
packages read: readers must be BIT-equal to the JAX package's, the LSMS
text round trip within rtol 1e-6 of the in-memory samples. Then the
entry points: ``prepare_loaders_and_config`` with ``samples=None``
resolves the same splits and completed config as
``hydragnn_tpu.api.prepare_loaders_and_config`` on the same files, for
every format and both ``Dataset.path`` layouts, and ``run_training``,
``run_prediction`` and ``serve_model`` run from the path on the CPU.
"""

import copy
import os

import numpy as np
import pytest

from hydragnn_tpu import api as j_api
from hydragnn_tpu.data import formats as j_formats
from hydragnn_tpu.data import ingest as j_ingest
from hydragnn_tpu.data.lsms import read_lsms_dir as j_read_lsms_dir
from hydragnn_tpu.data.synthetic import write_lsms_files as j_write_lsms_files
from hydragnn_tpu.postprocess import postprocess as j_post

import hydragnn_tpu_torch
from hydragnn_tpu_torch import api as t_api
from hydragnn_tpu_torch import postprocess as t_post
from hydragnn_tpu_torch.data import formats as t_formats
from hydragnn_tpu_torch.data import ingest as t_ingest
from hydragnn_tpu_torch.data.container import ContainerWriter
from hydragnn_tpu_torch.data.lsms import read_lsms_dir as t_read_lsms_dir
from hydragnn_tpu_torch.data.synthetic import deterministic_graph_data, write_lsms_files

from test_data_pipeline import base_config
from test_formats import _write_cfg, _write_xyz
from test_torch_cuda_kernels import eam_config, plain_gdb9_files, write_cfg_dir, write_xyz_dir, xyz_config
from test_torch_data import _JAX_ONLY_KEYS, _assert_samples_equal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GDB9 = os.path.join(REPO, "tests", "data", "gdb9_fixture")


@pytest.fixture(autouse=True, scope="module")
def _diagnostics_off():
    """The training loop's per-head diagnostics and hardware ledger off in
    this file (``test_torch_{introspect,train_obs}.py`` test them): they
    add a forward and H + 1 backward pulls an epoch, and a counted
    forward and backward a run, to every run here."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HGTORCH_DIAGNOSTICS", "0")
        yield


# ---------------------------------------------------------------- LSMS


def test_lsms_writer_is_byte_equal_and_round_trips(tmp_path):
    write_lsms_files(str(tmp_path / "t"), number_configurations=20, seed=11)
    j_write_lsms_files(str(tmp_path / "j"), number_configurations=20, seed=11)
    names = sorted(os.listdir(tmp_path / "t"))
    assert names == sorted(os.listdir(tmp_path / "j")) and len(names) == 20
    for n in names:
        assert (tmp_path / "t" / n).read_bytes() == (tmp_path / "j" / n).read_bytes()
    cfg = base_config()["Dataset"]
    disk = t_read_lsms_dir(str(tmp_path / "t"), cfg)
    _assert_samples_equal(disk, j_read_lsms_dir(str(tmp_path / "t"), cfg))
    mem = deterministic_graph_data(number_configurations=20, seed=11)
    order = sorted(range(20), key=lambda k: f"output{k}.txt")  # files sort lexically
    for file_pos, conf_id in enumerate(order):
        for f in ("x", "pos", "graph_y"):
            np.testing.assert_allclose(getattr(disk[file_pos], f), getattr(mem[conf_id], f), rtol=1e-6)


# ---------------------------------------------------------------- XYZ


@pytest.mark.parametrize("with_lattice", [True, False])
def test_xyz_matches(tmp_path, with_lattice):
    p = str(tmp_path / "s.xyz")
    _write_xyz(p, with_lattice=with_lattice)
    ours, ref = t_formats.read_xyz_file(p), j_formats.read_xyz_file(p)
    for a, b in zip(ours[:2], ref[:2]):
        np.testing.assert_array_equal(a, b)
    assert (ours[2] is None) == (not with_lattice) == (ref[2] is None)
    if with_lattice:
        np.testing.assert_array_equal(ours[2], ref[2])
        np.testing.assert_allclose(ours[2], np.diag([5.0, 6.0, 7.0]))
    s, r = t_formats.read_xyz_sample(p, [2], [1]), j_formats.read_xyz_sample(p, [2], [1])
    _assert_samples_equal([s], [r])
    np.testing.assert_allclose(s.graph_y, [0.5, 7.7])
    assert ("cell" in s.meta) == with_lattice


def test_gdb9_fixture_xyz_files_match():
    """Every fixture file reads alike, or fails alike (``*^`` floats)."""
    files = sorted(f for f in os.listdir(GDB9) if f.endswith(".xyz"))
    assert len(files) == 100
    plain = plain_gdb9_files()
    assert len(plain) >= 12
    for f in files:
        path = os.path.join(GDB9, f)
        if f not in plain:
            with pytest.raises(ValueError):
                t_formats.read_xyz_file(path)
            continue
        ours, ref = t_formats.read_xyz_file(path), j_formats.read_xyz_file(path)
        for a, b in zip(ours[:2], ref[:2]):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
        assert ours[2] is None and ref[2] is None


# ---------------------------------------------------------------- CFG


def test_cfg_parse_and_packing_match(tmp_path):
    p = str(tmp_path / "c.cfg")
    _write_cfg(p)
    ours, ref = t_formats.read_cfg_file(p), j_formats.read_cfg_file(p)
    assert sorted(ours) == sorted(ref)
    for k in ours:
        np.testing.assert_array_equal(ours[k], ref[k])
    np.testing.assert_allclose(ours["pos"][1], [2.0, 2.0, 2.0])
    s, r = t_formats.read_cfg_sample(p, [1], [0]), j_formats.read_cfg_sample(p, [1], [0])
    _assert_samples_equal([s], [r])
    np.testing.assert_allclose(s.x[2], [78, 195.084, 3.3, 0.7, 0.8, 0.9], rtol=1e-6)
    np.testing.assert_array_equal(s.meta["cell"], r.meta["cell"])


def test_synthetic_eam_cfg_files_read_alike(tmp_path):
    write_cfg_dir(str(tmp_path), 6, seed=1)
    cfg = eam_config(str(tmp_path))["Dataset"]
    ours, ref = t_formats.read_cfg_dir(str(tmp_path), cfg), j_formats.read_cfg_dir(str(tmp_path), cfg)
    _assert_samples_equal(ours, ref)
    for s in ours:
        assert s.x.shape[1] == 6 and set(np.unique(s.x[:, 0])) <= {28.0, 41.0}
        sides = np.diag(s.meta["cell"]) / 3.30
        np.testing.assert_allclose(sides, np.round(sides), atol=1e-9)


# ---------------------------------------------------------------- load_raw_samples and Dataset.path


def _dataset(tmp_path, fmt, layout):
    """(config, paths) for ``fmt`` under ``layout`` ("total" or "split")."""
    root = str(tmp_path / fmt)
    dirs = {"total": [os.path.join(root, "total")], "split": [os.path.join(root, k) for k in ("train", "validate", "test")]}[layout]
    for i, d in enumerate(dirs):
        n = 24 if len(dirs) == 1 else (14, 6, 6)[i]
        if fmt in ("unit_test", "LSMS"):
            write_lsms_files(d, number_configurations=n, seed=7 + i)
        elif fmt == "XYZ":
            write_xyz_dir(d, n)
        elif fmt == "CFG":
            write_cfg_dir(d, n, seed=3 + i)
        elif fmt == "HGC":
            w = ContainerWriter(d)
            w.add(deterministic_graph_data(number_configurations=n, seed=7 + i))
            w.save()
    path = {"total": dirs[0]} if layout == "total" else dict(zip(("train", "validate", "test"), dirs))
    if fmt == "XYZ":
        cfg = xyz_config(path, base_config(multihead=False))
    elif fmt == "CFG":
        cfg = eam_config(path["total"] if layout == "total" else None)
        cfg["Dataset"]["path"] = path
    else:
        cfg = base_config()
        cfg["Dataset"].update(format=fmt, path=path)
    cfg["NeuralNetwork"]["Training"]["num_epoch"] = 1
    return cfg


def _strip(d):
    if isinstance(d, dict):
        return {k: _strip(v) for k, v in d.items() if k not in _JAX_ONLY_KEYS}
    return d


@pytest.mark.parametrize("layout", ["total", "split"])
@pytest.mark.parametrize("fmt", ["unit_test", "LSMS", "XYZ", "CFG", "HGC"])
def test_prepare_from_dataset_path_matches_jax(tmp_path, fmt, layout):
    cfg = _dataset(tmp_path, fmt, layout)
    ours = t_api.prepare_loaders_and_config(copy.deepcopy(cfg))
    ref = j_api.prepare_loaders_and_config(copy.deepcopy(cfg))
    for lt, lj in zip(ours[:3], ref[:3]):
        _assert_samples_equal(lt.samples, lj.all_samples)
    assert _strip(ours[3]) == _strip(ref[3])
    raw_t = t_ingest.load_raw_samples(cfg, next(iter(cfg["Dataset"]["path"].values())))
    raw_j = j_ingest.load_raw_samples(cfg, next(iter(cfg["Dataset"]["path"].values())))
    _assert_samples_equal(raw_t, raw_j)


def test_unknown_format_and_missing_split_raise(tmp_path):
    cfg = _dataset(tmp_path, "LSMS", "split")
    bad = copy.deepcopy(cfg)
    bad["Dataset"]["format"] = "PDB"
    with pytest.raises(NameError, match="PDB"):
        t_api.prepare_loaders_and_config(bad)
    del cfg["Dataset"]["path"]["validate"]
    with pytest.raises(ValueError, match="missing 'validate'"):
        t_api.prepare_loaders_and_config(copy.deepcopy(cfg))
    with pytest.raises(ValueError, match="missing 'validate'"):
        j_api.prepare_loaders_and_config(copy.deepcopy(cfg))


@pytest.mark.parametrize("fmt,layout", [("unit_test", "total"), ("LSMS", "split"), ("CFG", "total")])
def test_run_training_prediction_and_serving_from_dataset_path(tmp_path, fmt, layout):
    """The three entry points with ``samples=None`` on the CPU: training
    from the files equals training on the same samples passed in memory
    (read by the port's own reader), prediction reads the run back, and
    the server holds the same prepared samples."""
    cfg = _dataset(tmp_path, fmt, layout)
    log_dir = str(tmp_path / "logs")
    _, _, hist, done = hydragnn_tpu_torch.run_training(copy.deepcopy(cfg), log_dir=log_dir, device="cpu")
    assert all(np.isfinite(hist[k]).all() for k in ("train_loss", "val_loss", "test_loss"))
    if layout == "total":
        raw = t_ingest.load_raw_samples(cfg, cfg["Dataset"]["path"]["total"])
        _, _, hist_mem, _ = hydragnn_tpu_torch.run_training(copy.deepcopy(cfg), raw, log_dir=str(tmp_path / "mem"),
                                                            device="cpu")
        assert hist_mem["train_loss"] == hist["train_loss"]
    err, _, trues, preds = hydragnn_tpu_torch.run_prediction(copy.deepcopy(cfg), log_dir=log_dir, device="cpu")
    assert np.isfinite(err) and len(trues) == len(preds) == len(done["NeuralNetwork"]["Variables_of_interest"]["type"])
    tr, va, te, _ = t_api.prepare_config_and_samples(copy.deepcopy(cfg))
    server = hydragnn_tpu_torch.serve_model(copy.deepcopy(cfg), device="cpu", start=False)
    _assert_samples_equal(server.reference_samples, list(tr) + list(va) + list(te))


# ---------------------------------------------------------------- postprocess


@pytest.mark.parametrize("denormalize", [True, False])
def test_unscale_by_num_nodes_matches(denormalize):
    rng = np.random.default_rng(0)
    config = {"NeuralNetwork": {"Variables_of_interest": {
        "output_names": ["energy_scaled_num_nodes", "charge"], "denormalize_output": denormalize}}}

    def data():
        return [[[rng.random(3) for _ in range(4)], [rng.random(2) for _ in range(4)]] for _ in range(2)]

    nodes = [3, 5, 7, 9]
    state = rng.bit_generator.state
    ours_in = data()
    rng.bit_generator.state = state
    ref_in = data()
    if not denormalize:
        with pytest.raises(ValueError, match="denormalize_output"):
            t_post.unscale_features_by_num_nodes_config(config, ours_in, nodes)
        return
    ours = t_post.unscale_features_by_num_nodes_config(config, ours_in, nodes)
    ref = j_post.unscale_features_by_num_nodes_config(config, ref_in, nodes)
    for a, b in zip(ours, ref):
        for ha, hb in zip(a, b):
            for va, vb in zip(ha, hb):
                np.testing.assert_array_equal(va, vb)
    np.testing.assert_array_equal(
        t_post.unscale_features_by_num_nodes([[[np.ones(2)], [np.ones(2)]]], [1], [4])[0][1][0], [4.0, 4.0])
