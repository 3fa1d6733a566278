"""The port's live drift monitor (``hydragnn_tpu_torch/obs/drift.py``)
held to the JAX package's (``hydragnn_tpu/obs/drift.py``) on the same
seeded streams: ``RunningMoments``, ``P2Quantile``, ``hist_counts``,
``psi`` and the seven ``DriftMonitor`` gauges (also after ``reset()``
and ``observe_labeled``), its report and summary, and the validators.
Both are float64 numpy: every value agrees within 1e-12 (``EXACT``).
Also: the reference read from the port's own training flight record and
from the JAX package's, each by both ``load_reference``; the warm-up
guard, the channel check, prediction drift's own baseline and the error
track (``tests/test_drift.py``'s cases); and the port's
``tools/drift_report`` CLI (``--export-ref``, ``--validate``).
"""

import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from hydragnn_tpu.data.dataset import GraphSample as JaxGraphSample
from hydragnn_tpu.obs import drift as jd
from hydragnn_tpu.obs.flight import FlightRecorder as JaxFlightRecorder
from hydragnn_tpu.obs.registry import MetricsRegistry as JaxRegistry

from hydragnn_tpu_torch.data.dataset import GraphSample
from hydragnn_tpu_torch.obs import drift as pd
from hydragnn_tpu_torch.obs.registry import MetricsRegistry
from hydragnn_tpu_torch.obs.triggers import TriggerEngine, TriggerRule

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXACT = dict(rtol=1e-12, atol=1e-12)  # both packages: the same float64 numpy
GAUGES = ("feature_psi", "feature_qshift", "pred_psi", "error_score", "feature_rows", "pred_rows", "labeled_rows")


def _toy_samples(cls=GraphSample, n=12, nodes=6, shift=0.0, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = (rng.normal(0.0, 1.0, size=(nodes, 2)) + shift).astype(np.float32)
        ei = np.stack([np.arange(nodes), (np.arange(nodes) + 1) % nodes]).astype(np.int32)
        out.append(cls(x=x, pos=rng.normal(size=(nodes, 3)).astype(np.float32), edge_index=ei,
                       graph_targets={"energy": np.float32(rng.normal())},
                       node_targets={"forces": rng.normal(size=(nodes, 1)).astype(np.float32)}))
    return out


def _gauges(registry, prefix="serve"):
    return np.array([registry.gauge(f"{prefix}.drift.{g}").value for g in GAUGES], dtype=np.float64)


def _pair(ref, **kw):
    """The same monitor in both packages, each in a registry of its own."""
    kw.setdefault("min_count", 32)
    preg, jreg = MetricsRegistry(enabled=True), JaxRegistry(enabled=True)
    return pd.DriftMonitor(ref, preg, **kw), preg, jd.DriftMonitor(ref, jreg, **kw), jreg


def _stream(n, seed, nodes=(3, 40)):
    """n requests: node features of a varying node count and the three
    kinds of prediction (a graph head, two node heads)."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        k = int(rng.integers(*nodes))
        yield (rng.normal(0.0, 1.0, size=(k, 2)).astype(np.float32),
               {"energy": rng.normal(size=(1,)).astype(np.float32),
                "forces": rng.normal(size=(k, 1)).astype(np.float32),
                "charge": rng.normal(0.5, 2.0, size=(k, 1)).astype(np.float32)})


@pytest.mark.parametrize("chunks", [1, 13, 500])
def test_running_moments_equal_jax(chunks):
    data = np.random.default_rng(chunks).normal(3.0, 2.0, size=(500, 4))
    p, j = pd.RunningMoments(4), jd.RunningMoments(4)
    for part in np.array_split(data, chunks):
        p.update(part)
        j.update(part)
    assert p.count == j.count == 500
    for a, b in ((p.mean, j.mean), (p.variance, j.variance), (p.std, j.std)):
        np.testing.assert_allclose(a, b, **EXACT)
    np.testing.assert_allclose(p.variance, data.var(axis=0), rtol=1e-10)
    one = pd.RunningMoments(1)
    one.update(np.array([1.0, 2.0, 3.0]))
    np.testing.assert_allclose(one.mean, [2.0])


@pytest.mark.parametrize("q", [0.05, 0.5, 0.95])
def test_p2_quantile_equals_jax(q):
    data = np.random.default_rng(1).normal(0.0, 1.0, size=5000)
    p, j = pd.P2Quantile(q), jd.P2Quantile(q)
    for i, v in enumerate(data):
        p.add(v)
        j.add(v)
        if i < 6 or i % 997 == 0:
            np.testing.assert_allclose(p.value, j.value, **EXACT)
    np.testing.assert_allclose(p.value, j.value, **EXACT)
    assert abs(p.value - np.quantile(data, q)) < 0.06
    small = pd.P2Quantile(0.5)
    for v in (5.0, 1.0, 3.0):
        small.add(v)
    assert small.value == 3.0  # exact while at most 5 observations
    with pytest.raises(ValueError):
        pd.P2Quantile(1.0)


def test_hist_counts_and_psi_equal_jax():
    edges = np.linspace(0.0, 1.0, 5)
    v = np.array([-0.5, 0.0, 0.4, 1.0, 1.0, 2.0])
    counts = pd.hist_counts(v, edges)
    np.testing.assert_array_equal(counts, jd.hist_counts(v, edges))
    assert counts.sum() == len(v) and counts[0] == 1 and counts[-1] == 1 and counts[-2] == 2
    rng = np.random.default_rng(3)
    for _ in range(20):
        vals = rng.normal(0.3, 0.6, size=int(rng.integers(1, 300)))
        np.testing.assert_array_equal(pd.hist_counts(vals, edges), jd.hist_counts(vals, edges))
        a, b = rng.dirichlet(np.ones(6)), rng.dirichlet(np.ones(6))
        b[int(rng.integers(6))] = 0.0
        assert pd.psi(a, b) == jd.psi(a, b)
    ref = [0.25] * 4
    assert pd.psi(ref, ref) == pytest.approx(0.0)
    assert pd.psi(ref, [0.7, 0.2, 0.05, 0.05]) > 0.3
    assert np.isfinite(pd.psi(ref, [1.0, 0.0, 0.0, 0.0]))
    np.testing.assert_array_equal(pd._padded_ref_fracs([0.5, 0.5]), jd._padded_ref_fracs([0.5, 0.5]))


@pytest.mark.parametrize("shift", [0.0, 5.0])
def test_monitor_gauges_report_and_summary_equal_jax(shift):
    """One stream through both monitors: the seven gauges after every
    request, then the report and summary; then ``observe_labeled`` and
    ``reset()`` and a second stream."""
    ref = pd.build_reference(_toy_samples(n=40), head_names=["energy", "forces"])
    assert ref == jd.build_reference(_toy_samples(JaxGraphSample, n=40), head_names=["energy", "forces"])
    p, preg, j, jreg = _pair(ref, min_count=16, min_labeled=4)
    for x, preds in _stream(60, seed=4):
        p.observe(x + shift, preds)
        j.observe(x + shift, preds)
        np.testing.assert_allclose(_gauges(preg), _gauges(jreg), **EXACT)
    assert json.dumps(p.report(), sort_keys=True) == json.dumps(j.report(), sort_keys=True)
    assert p.summary() == j.summary()
    assert (_gauges(preg)[0] > 1.0) == (shift > 0)
    rng = np.random.default_rng(5)
    for _ in range(10):
        pred, truth = rng.normal(size=(7, 1)), rng.normal(size=(7, 1))
        p.observe_labeled("forces", pred, truth)
        j.observe_labeled("forces", pred, truth)
        np.testing.assert_allclose(_gauges(preg), _gauges(jreg), **EXACT)
    assert _gauges(preg)[GAUGES.index("labeled_rows")] == 70
    assert p.error_scores() == j.error_scores()
    p.reset()
    j.reset()
    np.testing.assert_array_equal(_gauges(preg), np.zeros(len(GAUGES)))
    np.testing.assert_allclose(_gauges(preg), _gauges(jreg), **EXACT)
    for x, preds in _stream(30, seed=6):
        p.observe(x, preds)
        j.observe(x, preds)
    np.testing.assert_allclose(_gauges(preg), _gauges(jreg), **EXACT)
    assert json.dumps(p.report(), sort_keys=True) == json.dumps(j.report(), sort_keys=True)


def test_warmup_guard_channel_check_and_rules():
    samples = _toy_samples(n=40)
    ref = pd.build_reference(samples)
    p, preg, _, _ = _pair(ref, min_count=10_000)
    for s in samples:
        p.observe(np.asarray(s.x) + 5.0, {})
    assert preg.gauge("serve.drift.feature_psi").value == 0.0
    assert preg.gauge("serve.drift.feature_rows").value > 0
    with pytest.raises(ValueError):
        p.observe(np.zeros((4, 7)), {})
    reg = MetricsRegistry(enabled=True)
    engine = TriggerEngine([TriggerRule("serve_feature_drift", "feature_drift", "serve.drift.feature_psi", 0.25)],
                           registry=reg)
    mon = pd.DriftMonitor(ref, reg, min_count=32)
    for s in samples:
        mon.observe(np.asarray(s.x), {})
    assert engine.evaluate() == []  # clean traffic: quiet
    for s in samples:
        mon.observe(np.asarray(s.x) + 5.0, {})
    verdicts = engine.evaluate()
    assert [v.kind for v in verdicts] == ["feature_drift"] and verdicts[0].observed > 0.25


def test_pred_drift_self_baseline_and_error_track():
    samples = _toy_samples(n=200)
    ref = pd.build_reference(samples, head_names=["energy"])
    stable = np.random.default_rng(2).normal(0.0, 1.0, size=200)
    p, preg, j, jreg = _pair(ref, min_count=32, min_labeled=4)
    for i, s in enumerate(samples[:100]):
        for m in (p, j):
            m.observe(np.asarray(s.x), {"energy": stable[i]})
    assert max(p.head_psi().values()) < 0.25 and preg.gauge("serve.drift.pred_psi").value < 0.25
    for i, s in enumerate(samples[100:]):
        for m in (p, j):
            m.observe(np.asarray(s.x), {"energy": stable[100 + i] + 8.0})
    assert preg.gauge("serve.drift.pred_psi").value > 1.0
    np.testing.assert_allclose(_gauges(preg), _gauges(jreg), **EXACT)
    scale = ref["heads"]["energy"]["scale"]
    for _ in range(8):
        p.observe_labeled("energy", np.array([10.0 * scale]), np.array([0.0]))
    assert preg.gauge("serve.drift.error_score").value > 3.0


def test_validate_drift_report_equals_jax():
    samples = _toy_samples(n=40)
    p, _, _, _ = _pair(pd.build_reference(samples))
    for s in samples:
        p.observe(np.asarray(s.x), {})
    report = json.loads(json.dumps(p.report()))
    assert pd.validate_drift_report(report) == jd.validate_drift_report(report) == []
    broken = dict(report)
    broken.pop("feature")
    for bad in ({"schema": 0}, broken, {"schema": 1, "feature": {"channels": [{}]}, "counts": {}}):
        assert pd.validate_drift_report(bad) == jd.validate_drift_report(bad) != []


def test_build_reference_and_load_reference_errors(tmp_path):
    samples = _toy_samples()
    ref = pd.build_reference(samples, head_names=["energy", "forces"])
    xs = np.concatenate([np.asarray(s.x) for s in samples])[:, 0]
    assert ref["feature"]["channels"][0]["mean"] == pytest.approx(float(xs.mean()), rel=1e-6)
    with pytest.raises(ValueError):
        pd.build_reference([])
    with pytest.raises(FileNotFoundError):
        pd.load_reference(str(tmp_path / "missing.json"))
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"schema": 99}))
    with pytest.raises(ValueError):
        pd.load_reference(str(bad))
    empty = tmp_path / "nostats.jsonl"
    empty.write_text(json.dumps({"v": 2, "kind": "run_start", "t": 0, "rank": 0, "manifest": {}}) + "\n")
    with pytest.raises(ValueError):
        pd.load_reference(str(empty))


@pytest.fixture(scope="module")
def port_training_record(tmp_path_factory):
    """The flight record of a port training run (the flagship at hidden
    8, 2 conv layers, 1 epoch on 20 graphs, the CPU)."""
    from hydragnn_tpu_torch import flagship
    from hydragnn_tpu_torch.api import run_training
    from hydragnn_tpu_torch.data.synthetic import deterministic_graph_data

    log_dir = str(tmp_path_factory.mktemp("train")) + "/"
    old = os.environ.get("HGTORCH_DIAGNOSTICS")
    os.environ["HGTORCH_DIAGNOSTICS"] = "0"
    try:
        cfg = flagship.flagship_config(hidden_dim=8, num_conv_layers=2, batch_size=5, num_epoch=1)
        samples = deterministic_graph_data(number_configurations=20, seed=0, unit_cell_x_range=(2, 3),
                                           unit_cell_y_range=(2, 3), unit_cell_z_range=(2, 3))
        run_training(cfg, samples=samples, log_dir=log_dir, device="cpu")
    finally:
        if old is None:
            os.environ.pop("HGTORCH_DIAGNOSTICS")
        else:
            os.environ["HGTORCH_DIAGNOSTICS"] = old
    (path,) = glob.glob(os.path.join(log_dir, "*", "flight.jsonl"))
    return path


def test_load_reference_reads_both_packages_records(port_training_record, tmp_path):
    """The port's training record through both readers; a record the JAX
    package's recorder wrote through the port's; a bare JSON."""
    p_ref = pd.load_reference(port_training_record)
    assert p_ref == jd.load_reference(port_training_record)
    assert p_ref["schema"] == pd.REFERENCE_SCHEMA == jd.REFERENCE_SCHEMA == 1
    assert len(p_ref["feature"]["channels"]) >= 1 and p_ref["heads"]
    jref = jd.build_reference(_toy_samples(JaxGraphSample))
    jpath = str(tmp_path / "jax_flight.jsonl")
    fr = JaxFlightRecorder(jpath)
    fr.start_run({"stats": jref})
    fr.end_run("completed")
    assert pd.load_reference(jpath) == json.loads(json.dumps(jref))
    bare = tmp_path / "ref.json"
    bare.write_text(json.dumps(jref))
    assert pd.load_reference(str(bare)) == pd.load_reference(jpath)


def test_the_drift_report_cli_exports_and_validates(port_training_record, tmp_path):
    def cli(*args):
        return subprocess.run([sys.executable, "-m", "hydragnn_tpu_torch.tools.drift_report", *args], cwd=REPO,
                              capture_output=True, text=True, timeout=120)

    out = str(tmp_path / "ref.json")
    r = cli("--export-ref", port_training_record, "--out", out)
    assert r.returncode == 0, r.stderr
    with open(out) as f:
        assert json.load(f) == pd.load_reference(port_training_record)
    r = cli("--validate", port_training_record)
    assert r.returncode == 0 and "OK" in r.stdout, r.stdout + r.stderr
    bad = tmp_path / "drift_report.json"
    bad.write_text(json.dumps({"schema": 0}))
    r = cli("--validate", str(bad))
    assert r.returncode == 1 and "INVALID" in r.stdout
