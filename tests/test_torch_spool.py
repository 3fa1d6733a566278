"""The port's request spool (``hydragnn_tpu_torch/obs/spool.py``) held
to the JAX package's (``hydragnn_tpu/obs/spool.py``), and the recorder's
``on_close`` hook that releases an incident's pinned shards.

Parity: the same requests and results through both spools give shard
manifests equal but for the model fingerprint, and shard files bit-equal
(every field's ``.bin`` and ``.cnt``; the samples' meta equal but for
the fingerprint); each package reads the other's shards. Behaviour
(``tests/test_drift.py``'s cases): the round trip, a spooled shard
batching as the original requests did, sampling, rotation and the disk
bound, crash debris swept, per-tenant attribution, the manifest's
validator, and pins that outlive eviction until released.
"""

import json
import os
import time

import numpy as np
import pytest

from hydragnn_tpu.obs import spool as js

from hydragnn_tpu_torch.data.dataset import GraphSample
from hydragnn_tpu_torch.data.loader import GraphLoader
from hydragnn_tpu_torch.graph.batch import batch_graphs
from hydragnn_tpu_torch.obs import spool as ps
from hydragnn_tpu_torch.obs.triggers import IncidentRecorder, TriggerVerdict
from hydragnn_tpu_torch.serve import request_to_dict

HEAD_KINDS = {"energy": "graph", "forces": "node"}


def _toy_samples(n=12, nodes=6, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ei = np.stack([np.arange(nodes), (np.arange(nodes) + 1) % nodes]).astype(np.int32)
        out.append(GraphSample(x=rng.normal(size=(nodes, 2)).astype(np.float32),
                               pos=rng.normal(size=(nodes, 3)).astype(np.float32), edge_index=ei,
                               graph_targets={"energy": np.float32(rng.normal()).reshape(1)},
                               node_targets={"forces": rng.normal(size=(nodes, 1)).astype(np.float32)}))
    return out


def _request(sample):
    ei = np.asarray(sample.edge_index)
    return {"x": np.asarray(sample.x), "pos": np.asarray(sample.pos), "senders": ei[0], "receivers": ei[1]}


def _result(sample, seed=0):
    rng = np.random.default_rng(seed)
    return {"energy": rng.normal(size=(1,)).astype(np.float32),
            "forces": rng.normal(size=(sample.x.shape[0], 1)).astype(np.float32)}


def _offer_all(spool, samples, tenants=None):
    for i, s in enumerate(samples):
        spool.offer(_request(s), _result(s, i), trace=f"tr-{i}", tenant=(tenants or ["acme"] * len(samples))[i],
                    seq=i)


class _Clock:
    """A stand-in for ``time.time``: the same timestamps in both spools."""

    def __init__(self):
        self.t = 1.0e9

    def __call__(self):
        self.t += 0.25
        return self.t


FP = {"port": "fp-port", "jax": "fp-jax0"}  # of one length: the byte counts agree


def test_shards_and_manifests_equal_jax(tmp_path, monkeypatch):
    samples = _toy_samples(n=40, nodes=24)
    roots = {}
    for name, mod in (("port", ps), ("jax", js)):
        monkeypatch.setattr(time, "time", _Clock())
        spool = mod.RequestSpool(str(tmp_path / name), sample_every=3, max_mb=8.0, shard_mb=0.01,
                                 model_fingerprint=FP[name], head_kinds=HEAD_KINDS)
        _offer_all(spool, samples, tenants=["acme", "globex"] * 20)
        roots[name] = (spool.finalize(), spool.root)
    (p_sum, p_root), (j_sum, j_root) = roots["port"], roots["jax"]
    assert {k: v for k, v in p_sum.items() if k not in ("dir", "overhead_s")} == \
        {k: v for k, v in j_sum.items() if k not in ("dir", "overhead_s")}
    p_shards, j_shards = ps.list_shards(p_root), js.list_shards(j_root)
    assert [os.path.basename(s) for s in p_shards] == [os.path.basename(s) for s in j_shards]
    assert len(p_shards) >= 2
    for ps_dir, js_dir in zip(p_shards, j_shards):
        pm, jm = ps.read_shard_manifest(ps_dir), js.read_shard_manifest(js_dir)
        assert (pm.pop("model_fingerprint"), jm.pop("model_fingerprint")) == (FP["port"], FP["jax"])
        assert pm == jm
        assert sorted(os.listdir(ps_dir)) == sorted(os.listdir(js_dir))
        for f in os.listdir(ps_dir):
            if f.endswith((".bin", ".cnt")) and not f.startswith("meta."):
                with open(os.path.join(ps_dir, f), "rb") as a, open(os.path.join(js_dir, f), "rb") as b:
                    assert a.read() == b.read(), f
        with open(os.path.join(ps_dir, "meta.json")) as a, open(os.path.join(js_dir, "meta.json")) as b:
            pmeta, jmeta = json.load(a), json.load(b)
        assert pmeta["attrs"].pop("model_fingerprint") == FP["port"]
        jmeta["attrs"].pop("model_fingerprint")
        assert pmeta == jmeta
    # each package reads the other's shards; the samples agree but for the fingerprint
    p_back, j_back = js.read_spool(p_root), ps.read_spool(j_root)
    assert len(p_back) == len(j_back) == p_sum["spooled"] == 14
    for a, b in zip(p_back, j_back):
        for field in ("x", "pos", "edge_index"):
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
        np.testing.assert_array_equal(a.graph_targets["energy"], b.graph_targets["energy"])
        np.testing.assert_array_equal(a.node_targets["forces"], b.node_targets["forces"])
        ma, mb = dict(a.meta["spool"]), dict(b.meta["spool"])
        assert (ma.pop("model_fingerprint"), mb.pop("model_fingerprint")) == (FP["port"], FP["jax"])
        assert ma == mb
    assert ps.validate_spool_manifest(js.read_shard_manifest(js_dir)) == []


def test_roundtrip_bit_parity(tmp_path):
    samples = _toy_samples(n=6)
    spool = ps.RequestSpool(str(tmp_path / "spool"), sample_every=1, max_mb=8.0, model_fingerprint="fp-test",
                            head_kinds=HEAD_KINDS)
    _offer_all(spool, samples)
    spool.finalize()
    back = sorted(ps.read_spool(str(tmp_path / "spool")), key=lambda s: s.meta["spool"]["seq"])
    assert len(back) == len(samples)
    for i, (orig, got) in enumerate(zip(samples, back)):
        np.testing.assert_array_equal(got.x, orig.x)
        np.testing.assert_array_equal(got.pos, orig.pos)
        np.testing.assert_array_equal(got.edge_index, orig.edge_index)
        want = _result(orig, i)
        np.testing.assert_array_equal(got.graph_targets["energy"], want["energy"])
        np.testing.assert_array_equal(got.node_targets["forces"], want["forces"])
        assert got.meta["spool"]["trace"] == f"tr-{i}" and got.meta["spool"]["tenant"] == "acme"
        assert got.meta["spool"]["model_fingerprint"] == "fp-test"


@pytest.mark.parametrize("loader", [False, True])
def test_a_spooled_shard_batches_like_the_original(tmp_path, loader):
    """``batch_graphs`` of the requests, or a ``GraphLoader`` (run-aligned)
    over the samples, against the same over the spooled shard: every
    array bit-equal, the edge occupancy included."""
    samples = _toy_samples(n=8)
    spool = ps.RequestSpool(str(tmp_path / "spool"), sample_every=1, head_kinds=HEAD_KINDS)
    for i, s in enumerate(samples):
        spool.offer(_request(s), _result(s, i), seq=i)
    spool.finalize()
    back = sorted(ps.read_spool(str(tmp_path / "spool")), key=lambda s: s.meta["spool"]["seq"])
    if loader:
        want = next(iter(GraphLoader(samples, 8)))
        got = next(iter(GraphLoader(back, 8)))
    else:
        want = batch_graphs([request_to_dict(s) for s in samples])
        got = batch_graphs([request_to_dict(s) for s in back])
    fields = ("nodes", "pos", "senders", "receivers", "edge_mask", "node_mask", "graph_mask", "edge_occupancy")
    for f in fields:
        a, b = getattr(want, f), getattr(got, f)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=f)


def test_sampling_rotation_and_disk_bound(tmp_path):
    samples = _toy_samples(n=32, nodes=64)
    events = []

    class _Flight:
        def record(self, kind, **fields):
            events.append({"kind": kind, **fields})

    spool = ps.RequestSpool(str(tmp_path / "spool"), sample_every=2, max_mb=0.02, shard_mb=0.01,
                            head_kinds=HEAD_KINDS, flight=_Flight())
    for i, s in enumerate(samples):
        spool.offer(_request(s), _result(s, i), seq=i)
    summary = spool.finalize()
    assert summary["seen"] == 32 and summary["spooled"] == 16
    assert summary["rotations"] >= 2 and summary["evicted"] >= 1
    shards = ps.list_shards(str(tmp_path / "spool"))
    assert shards
    assert summary["bytes"] <= 0.02 * 1024 * 1024 or len(shards) == 1
    rot = [e for e in events if e["kind"] == "spool_rotate"]
    assert len(rot) == summary["rotations"] and all("total_bytes" in e and "shard" in e for e in rot)
    mans = [ps.read_shard_manifest(s) for s in shards]
    assert ps.validate_spool_manifest(mans[-1]) == []
    assert mans[-1]["seq_range"][1] == 30  # the newest shards survive


def test_crash_debris_is_swept_and_never_read(tmp_path):
    root = tmp_path / "spool"
    spool = ps.RequestSpool(str(root), sample_every=1, head_kinds=HEAD_KINDS)
    s = _toy_samples(n=1)[0]
    spool.offer(_request(s), _result(s), seq=0)
    spool.finalize()
    debris = root / ".shard-000099.tmp-12345"
    debris.mkdir()
    (debris / "junk").write_text("partial")
    assert all(".shard" not in p for p in ps.list_shards(str(root)))
    again = ps.RequestSpool(str(root), sample_every=1, head_kinds=HEAD_KINDS)
    assert not debris.exists()
    assert again._next_shard == 2  # numbering goes on after the existing shard


def test_per_tenant_attribution(tmp_path):
    samples = _toy_samples(n=4)
    spool = ps.RequestSpool(str(tmp_path / "spool"), sample_every=1, head_kinds=HEAD_KINDS)
    tenants = ["acme", "globex", "acme", "initech"]
    _offer_all(spool, samples, tenants)
    spool.finalize()
    (shard,) = ps.list_shards(str(tmp_path / "spool"))
    assert ps.read_shard_manifest(shard)["tenants"] == sorted(set(tenants))
    counts = {}
    for got in ps.read_spool(str(tmp_path / "spool")):
        counts[got.meta["spool"]["tenant"]] = counts.get(got.meta["spool"]["tenant"], 0) + 1
    assert counts == {"acme": 2, "globex": 1, "initech": 1}


def test_validate_spool_manifest_equals_jax():
    good = {"schema": 1, "shard": "s", "num_samples": 2, "model_fingerprint": "", "sample_every": 1,
            "tenants": [], "seq_range": [0, 1], "t_range": [0, 0]}
    assert ps.validate_spool_manifest(good) == js.validate_spool_manifest(good) == []
    for bad in ({"schema": 1}, dict(good, num_samples=0), dict(good, seq_range=[1]), dict(good, schema=2)):
        assert ps.validate_spool_manifest(bad) == js.validate_spool_manifest(bad) != []


def test_pinned_shards_outlive_eviction_until_unpinned(tmp_path):
    samples = _toy_samples(n=48, nodes=64)
    spool = ps.RequestSpool(str(tmp_path / "spool"), sample_every=1, max_mb=0.03, shard_mb=0.01,
                            head_kinds=HEAD_KINDS)
    for i, s in enumerate(samples[:6]):
        spool.offer(_request(s), _result(s, i), seq=i)
    spool.flush_pending()
    window = spool.window()
    assert window["shards"] and spool.pin(["nope"]) == []
    pinned = spool.pin(window["shards"])
    assert pinned == [os.path.basename(s) for s in window["shards"]]
    assert spool.pinned() == {n: 1 for n in pinned}
    for i, s in enumerate(samples[6:], start=6):
        spool.offer(_request(s), _result(s, i), seq=i)
    names = [os.path.basename(p) for p in ps.list_shards(spool.root)]
    assert set(pinned) <= set(names) and spool.finalize()["evicted"] >= 1
    spool.unpin(pinned)
    spool.unpin(pinned)  # over-unpinning is a no-op
    assert spool.pinned() == {}
    for i, s in enumerate(samples[:12]):  # over the bound again
        spool.offer(_request(s), _result(s, i), seq=100 + i)
    names = [os.path.basename(p) for p in ps.list_shards(spool.root)]
    assert not set(pinned) & set(names)  # released: the oldest go first


def _verdict(rule="r"):
    return TriggerVerdict(rule, "queue_depth", "serve.queue_depth", 9.0, 1.0, time.time())


def test_on_close_runs_once_per_close_and_releases_pins(tmp_path):
    """The recorder calls ``on_close(incident, status)`` once for every
    close, after the manifest is written; a raising hook does not break
    the close. The server's hook releases the incident's pins."""
    spool = ps.RequestSpool(str(tmp_path / "spool"), sample_every=1, max_mb=0.001, shard_mb=0.01,
                            head_kinds=HEAD_KINDS)
    s = _toy_samples(n=1)[0]
    spool.offer(_request(s), _result(s), seq=0)
    spool.flush_pending()
    pins, calls = {}, []

    def on_close(inc, status):
        calls.append((inc.id, status, os.path.exists(os.path.join(inc.dir, "incident_manifest.json"))))
        spool.unpin(pins.pop(inc.id, []))

    rec = IncidentRecorder(str(tmp_path / "inc"), profile_steps=2, overhead_frac=1e9, on_close=on_close)
    inc = rec.open_incident(_verdict())
    pins[inc.id] = spool.pin(spool.window()["shards"])
    assert spool.pinned()
    rec.tick()
    rec.tick()  # the second tick closes it
    assert calls == [(inc.id, "ok", True)] and spool.pinned() == {}
    rec.tick()
    rec.finalize()
    assert len(calls) == 1
    inc2 = rec.open_incident(_verdict("r2"))
    rec.finalize()
    assert calls[-1] == (inc2.id, "truncated", True) and len(calls) == 2

    def raising(inc, status):
        calls.append(inc.id)
        raise RuntimeError("hook fails")

    rec3 = IncidentRecorder(str(tmp_path / "inc3"), profile_steps=1, overhead_frac=1e9, on_close=raising)
    inc3 = rec3.open_incident(_verdict())
    rec3.tick()
    assert calls[-1] == inc3.id and rec3.open is None and rec3.closed_ids == [inc3.id]
    assert os.path.exists(os.path.join(inc3.dir, "incident_manifest.json"))
