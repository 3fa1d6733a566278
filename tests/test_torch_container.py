"""Parity of the port's HGC container and reference importer with the JAX
package's (the case lists of ``tests/test_container.py`` and
``tests/test_import_reference.py``).

The on-disk schema must be byte-compatible both ways: a container the
JAX package writes opens in the port and the reverse, and the port's
writer emits the same bytes. Reads are BIT-equal in every mode
(``mmap``, ``preload``, ``shm``), through ``get``, ``fetch_rows`` (the
native threaded gather) and ``fetch_samples``.
"""

import copy
import io
import os
import pickle
import sys

import numpy as np
import pytest
import torch

from hydragnn_tpu.data.container import ContainerDataset as JDataset
from hydragnn_tpu.data.container import ContainerWriter as JWriter
from hydragnn_tpu.data import import_reference as j_import
from hydragnn_tpu.data.ingest import prepare_dataset as j_prepare
from hydragnn_tpu.data.synthetic import deterministic_graph_data as j_data

from hydragnn_tpu_torch.data import container as t_container
from hydragnn_tpu_torch.data import import_reference as t_import
from hydragnn_tpu_torch.data.container import ContainerDataset as TDataset
from hydragnn_tpu_torch.data.container import ContainerWriter as TWriter
from hydragnn_tpu_torch.data.dataset import GraphSample
from hydragnn_tpu_torch.data.ingest import prepare_dataset as t_prepare
from hydragnn_tpu_torch.data.synthetic import deterministic_graph_data as t_data

from test_data_pipeline import base_config
from test_import_reference import _write_coincident_fixture, _write_fixture, _write_monolithic
from test_torch_data import _assert_samples_equal

MODES = ["mmap", "preload", "shm"]


@pytest.fixture(scope="module")
def built():
    """Prepared samples (edges, targets) from both packages, bit-equal."""
    cfg = base_config(multihead=True)
    tr_t, _, _, mm_g, mm_n = t_prepare(t_data(number_configurations=30, seed=7), copy.deepcopy(cfg))
    tr_j, _, _, _, _ = j_prepare(j_data(number_configurations=30, seed=7), copy.deepcopy(cfg))
    _assert_samples_equal(tr_t, tr_j)
    return tr_t, tr_j, mm_g, mm_n


def _write(writer_cls, path, samples, mm=None):
    w = writer_cls(path)
    w.add(samples)
    if mm is not None:
        w.add_global("minmax_graph_feature", mm[0])
        w.add_global("minmax_node_feature", mm[1])
    w.save()


def _open(cls, path, mode, tmp_path):
    return cls(path, mode=mode, shm_dir=str(tmp_path / f"shm_{mode}") if mode == "shm" else None)


def _assert_meta_equal(a, b):
    assert sorted(a.meta) == sorted(b.meta)
    for k in a.meta:
        np.testing.assert_array_equal(np.asarray(a.meta[k]), np.asarray(b.meta[k]))


def test_writer_emits_the_jax_packages_bytes(built, tmp_path):
    tr_t, tr_j, mm_g, mm_n = built
    _write(TWriter, str(tmp_path / "t"), tr_t, (mm_g, mm_n))
    _write(JWriter, str(tmp_path / "j"), tr_j, (mm_g, mm_n))
    names = sorted(os.listdir(tmp_path / "t"))
    assert names == sorted(os.listdir(tmp_path / "j"))
    assert "meta.json" in names and "edge_index.bin" in names and "x.cnt" in names
    for n in names:
        assert (tmp_path / "t" / n).read_bytes() == (tmp_path / "j" / n).read_bytes(), n


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("direction", ["jax_writes_port_reads", "port_writes_jax_reads"])
def test_round_trip_across_packages(built, tmp_path, mode, direction):
    tr_t, tr_j, mm_g, mm_n = built
    path = str(tmp_path / "c.hgc")
    if direction == "jax_writes_port_reads":
        _write(JWriter, path, tr_j, (mm_g, mm_n))
    else:
        _write(TWriter, path, tr_t, (mm_g, mm_n))
    ours, ref = _open(TDataset, path, mode, tmp_path), _open(JDataset, path, mode, tmp_path)
    assert len(ours) == len(ref) == len(tr_t)
    _assert_samples_equal(ours.samples(), ref.samples())
    for i in (0, len(tr_t) // 2, len(tr_t) - 1):
        got = ours.get(i)
        np.testing.assert_array_equal(got.x, tr_t[i].x.astype(np.float32))
        np.testing.assert_array_equal(got.edge_index, tr_t[i].edge_index)
        np.testing.assert_allclose(got.edge_attr, tr_t[i].edge_attr, rtol=1e-6)
    for a, b in zip(ours.minmax(), ref.minmax()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(ours.minmax()[0], mm_g)
    ours.close()
    ref.close()


@pytest.mark.parametrize("writer", [TWriter, JWriter])
def test_meta_round_trip(tmp_path, writer):
    """A PBC cell, a string and an empty meta survive; a zero-edge sample
    reads cleanly."""
    cls = GraphSample
    s = cls(x=np.ones((3, 2), dtype=np.float32), pos=np.zeros((3, 3), dtype=np.float32),
            edge_index=np.array([[0, 1], [1, 0]], dtype=np.int32),
            meta={"cell": np.eye(3) * 5.0, "composition": "FePt"})
    s2 = cls(x=np.ones((2, 2), dtype=np.float32), pos=np.zeros((2, 3), dtype=np.float32),
             edge_index=np.zeros((2, 0), dtype=np.int32), meta={})
    path = str(tmp_path / "m.hgc")
    _write(writer, path, [s, s2])
    ours, ref = TDataset(path), JDataset(path)
    got = ours.get(0)
    np.testing.assert_allclose(got.meta["cell"], np.eye(3) * 5.0)
    assert got.meta["composition"] == "FePt"
    assert ours.get(1).meta == {} and ours.get(1).edge_index.shape[1] == 0
    for a, b in zip(ours.samples(), ref.samples()):
        _assert_samples_equal([a], [b])
        _assert_meta_equal(a, b)
    ours.close()


def test_native_gather_matches_slicing(built, tmp_path):
    tr_t, _, _, _ = built
    path = str(tmp_path / "g.hgc")
    _write(TWriter, path, tr_t)
    ours, ref = TDataset(path, mode="mmap"), JDataset(path, mode="mmap")
    idx = [5, 0, 17, 3, 3]
    for field in ("x", "edge_index", "nt_x2"):
        packed, cnt = ours.fetch_rows(field, idx)
        packed_j, cnt_j = ref.fetch_rows(field, idx)
        np.testing.assert_array_equal(packed, packed_j)
        np.testing.assert_array_equal(cnt, cnt_j)
    packed, cnt = ours.fetch_rows("x", idx)
    np.testing.assert_array_equal(packed, np.concatenate([tr_t[i].x for i in idx]).astype(np.float32))
    np.testing.assert_array_equal(cnt, [tr_t[i].x.shape[0] for i in idx])
    ours.close()


def test_numpy_fallback_gather_matches_native(built, tmp_path, monkeypatch):
    """Without the native library the container reads through numpy
    memmaps and the same gather, value for value."""
    tr_t, _, _, _ = built
    path = str(tmp_path / "f.hgc")
    _write(TWriter, path, tr_t)
    native = TDataset(path).fetch_samples([4, 1, 4])
    monkeypatch.setattr("hydragnn_tpu_torch.native._load", lambda: None)
    fallback = TDataset(path).fetch_samples([4, 1, 4])
    _assert_samples_equal(native, fallback)


@pytest.mark.parametrize("mode", MODES)
def test_fetch_samples_bulk_matches_get(built, tmp_path, mode):
    tr_t, _, _, _ = built
    path = str(tmp_path / "bulk.hgc")
    _write(TWriter, path, tr_t[:12])
    ours, ref = _open(TDataset, path, mode, tmp_path), _open(JDataset, path, mode, tmp_path)
    idx = [7, 0, 3, 7, 11]
    bulk = ours.fetch_samples(idx)
    _assert_samples_equal(bulk, [ours.get(i) for i in idx])
    _assert_samples_equal(bulk, ref.fetch_samples(idx))
    with pytest.raises(IndexError):
        ours.fetch_samples([0, 99])
    with pytest.raises(IndexError):
        ours.get(12)
    ours.close()


def test_unknown_mode_and_empty_save_raise(tmp_path):
    with pytest.raises(ValueError, match="unknown mode"):
        TDataset(str(tmp_path), mode="fast")
    with pytest.raises(ValueError):
        TWriter(str(tmp_path / "e")).save()


def test_multi_process_save_waits_for_a5(built, tmp_path):
    """Writing from two torch.distributed processes (the JAX package's
    multi-process branch: gathered counts, each process its own byte
    range) gives the files, byte for byte, one process writes from both
    shards in order."""
    from test_torch_parallel_cases import spawn_group

    samples = built[0][:9]
    spawn_group(2, [("save", "container_save", dict(samples=samples, path=str(tmp_path / "two")))],
                str(tmp_path / "group"))
    one = TWriter(str(tmp_path / "one"))
    one.add(samples)
    one.add_global("note", "two processes")
    one.save()
    names = sorted(os.listdir(tmp_path / "one"))
    assert names == sorted(os.listdir(tmp_path / "two")) and "meta.json" in names
    for name in names:
        with open(tmp_path / "one" / name, "rb") as a, open(tmp_path / "two" / name, "rb") as b:
            assert a.read() == b.read(), name
    assert TDataset(str(tmp_path / "two")).ndata == 9


def test_container_feeds_training(built, tmp_path):
    """Container -> loader -> one train step on the CPU, equal to the
    same step on the samples passed in memory."""
    from hydragnn_tpu_torch.data.loader import GraphLoader
    from hydragnn_tpu_torch.models.base import model_loss
    from hydragnn_tpu_torch.models.create import create_model_config
    from hydragnn_tpu_torch.utils.config import update_config

    tr_t, _, _, _ = built
    path = str(tmp_path / "t.hgc")
    _write(TWriter, path, tr_t)
    samples = TDataset(path, mode="preload").samples()
    cfg = update_config(base_config(multihead=True), samples, samples, samples)
    losses = []
    for ss in (samples, [copy.deepcopy(s) for s in samples]):
        batch = next(iter(GraphLoader(ss, 8)))
        model = create_model_config(cfg["NeuralNetwork"], seed=0, device="cpu")
        loss, _ = model_loss(model.cfg, model(batch, train=True), batch)
        loss.backward()
        losses.append(float(loss.detach()))
    assert np.isfinite(losses[0]) and losses[0] == losses[1]


# ---------------------------------------------------------------- reference importer


def _drop_fake_pyg():
    for m in list(sys.modules):
        if m.startswith("torch_geometric"):
            del sys.modules[m]


@pytest.mark.parametrize("use_subdir", [False, True])
def test_pickle_reader_matches_jax(tmp_path, use_subdir):
    basedir = str(tmp_path / "pkl")
    truth = _write_fixture(basedir, "trainset", 5, use_subdir=use_subdir)
    _drop_fake_pyg()
    kw = dict(head_types=["graph", "node"], head_names=["energy", "charge"])
    ours = t_import.ReferencePickleReader(basedir, "trainset").samples(**kw)
    ref = j_import.ReferencePickleReader(basedir, "trainset").samples(**kw)
    _assert_samples_equal(ours, ref)
    for s, (x, pos, ei, g_y, n_y) in zip(ours, truth):
        np.testing.assert_array_equal(s.x, x)
        np.testing.assert_array_equal(s.edge_index, ei)
        np.testing.assert_array_equal(s.node_targets["charge"], n_y)


def test_pickle_import_writes_the_jax_packages_container(tmp_path):
    basedir = str(tmp_path / "pkl")
    _write_fixture(basedir, "total", 4)
    _drop_fake_pyg()
    kw = dict(head_types=["graph", "node"], head_names=["energy", "charge"])
    assert t_import.import_pickle_dataset(basedir, "total", str(tmp_path / "t.hgc"), **kw) == 4
    assert j_import.import_pickle_dataset(basedir, "total", str(tmp_path / "j.hgc"), **kw) == 4
    for n in sorted(os.listdir(tmp_path / "j.hgc")):
        assert (tmp_path / "t.hgc" / n).read_bytes() == (tmp_path / "j.hgc" / n).read_bytes(), n
    _assert_samples_equal(TDataset(str(tmp_path / "t.hgc")).samples(), JDataset(str(tmp_path / "j.hgc")).samples())


def test_monolithic_import_matches_jax(tmp_path):
    single = str(tmp_path / "unit-total.pkl")
    _write_monolithic(single, 4)
    _write_monolithic(str(tmp_path / "dist-total-0.pkl"), 2, rng_seed=1)
    _write_monolithic(str(tmp_path / "dist-total-1.pkl"), 3, rng_seed=2)
    _drop_fake_pyg()
    t_import.main([single, str(tmp_path / "t.hgc")])
    j_import.main([single, str(tmp_path / "j.hgc")])
    _assert_samples_equal(TDataset(str(tmp_path / "t.hgc")).samples(), JDataset(str(tmp_path / "j.hgc")).samples())
    ours = t_import.ReferenceMonolithicReader(str(tmp_path / "dist-total.pkl"))
    ref = j_import.ReferenceMonolithicReader(str(tmp_path / "dist-total.pkl"))
    assert len(ours) == len(ref) == 5
    _assert_samples_equal(ours.samples(), ref.samples())


def test_adios_input_is_refused(tmp_path):
    bp = tmp_path / "data.bp"
    bp.mkdir()
    (bp / "md.idx").write_bytes(b"")
    assert t_import.looks_like_adios(str(bp))
    assert not t_import.looks_like_adios(str(tmp_path / "missing.bp"))
    with pytest.raises(NotImplementedError, match="ADIOS2"):
        t_import.main([str(bp), "total", str(tmp_path / "o.hgc")])


def test_malicious_globals_are_stubbed(tmp_path):
    canary = str(tmp_path / "pwned")

    class Evil:
        def __reduce__(self):
            return (eval, (f"open({canary!r}, 'w').close()",))

    obj = t_import._TolerantUnpickler(io.BytesIO(pickle.dumps(Evil()))).load()
    assert isinstance(obj, t_import._Stub)
    assert not os.path.exists(canary)

    class EvilTorch:
        def __reduce__(self):
            import torch.serialization

            return (torch.serialization.load, (canary,))

    assert isinstance(t_import._TolerantUnpickler(io.BytesIO(pickle.dumps(EvilTorch()))).load(), t_import._Stub)


def test_head_type_ambiguity_raises_as_in_jax(tmp_path):
    basedir = str(tmp_path / "pkl")
    _write_fixture(basedir, "t", 2)
    _drop_fake_pyg()
    reader = t_import.ReferencePickleReader(basedir, "t")
    with pytest.raises(ValueError, match="head_types"):
        reader.read(0)
    s = reader.read(0, head_types=["graph", "node"])
    _assert_samples_equal([s], [j_import.ReferencePickleReader(basedir, "t").read(0, head_types=["graph", "node"])])


def test_coincident_sizes_need_explicit_types(tmp_path):
    basedir = str(tmp_path / "pkl")
    truth = _write_coincident_fixture(basedir, "total", 3, n_nodes=4)
    _drop_fake_pyg()
    with pytest.raises(ValueError, match="--head-type"):
        t_import.ReferencePickleReader(basedir, "total").samples()
    out = str(tmp_path / "coincident.hgc")
    kw = dict(head_types=["graph", "node"], head_names=["spectrum", "charge"])
    assert t_import.import_pickle_dataset(basedir, "total", out, **kw) == 3
    ds = TDataset(out)
    for i, (x, g_y, n_y) in enumerate(truth):
        s = ds.get(i)
        np.testing.assert_array_equal(np.ravel(s.graph_targets["spectrum"]), g_y)
        assert s.node_targets["charge"].shape == (4, 1)
        np.testing.assert_array_equal(s.node_targets["charge"], n_y)
    ds.close()
