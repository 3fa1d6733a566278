"""The port server's observability planes (``hydragnn_tpu_torch/serve/
server.py`` with ``obs/{spool,drift,triggers,trace}.py``) on the CPU,
held to the JAX package's server where both run: the flagship at the
JAX fixture's size (hidden 8, 2 conv layers, 24 samples, unit cells
2-3), the JAX model's weights carried across by
``convert.variables_from_flax``.

  - ``tests/test_drift.py::test_server_drift_incident_end_to_end`` on the
    port: under an injected shift of 5.0 one ``feature_drift`` incident
    whose bundle and spool pass the JAX package's ``tools/drift_report.py
    --validate`` and ``tools/incident_report.py --validate`` and the
    port's two CLIs; the seven drift gauges equal the JAX server's on the
    same 20 requests (the feature gauges and the counts exactly, the
    prediction gauge within the serving tolerance ``TOL``); a stub pilot
    gets the incident; the Prometheus textfile carries the JAX names.
  - The three SLO rules fire at tiny thresholds and stay quiet at large
    ones; ``ServeConfig`` has the JAX fields and defaults; a failing
    plane disarms with one ``error`` event and fails no request.
  - The Chrome traces: ``to_chrome_trace`` and ``flight_to_chrome`` equal
    the JAX package's on the same spans and records.
  - Every plane off: the answers are bit-equal to those with every plane
    on, and the flight record holds only the kinds it held before.
  - A spooled prediction equals its future's answer after later batches
    ran (no aliasing), the eager oversize path spooled too.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from hydragnn_tpu.flagship import build_flagship
from hydragnn_tpu.obs import drift as jax_drift
from hydragnn_tpu.obs.export import registry_to_prometheus_text as jax_prometheus_text
from hydragnn_tpu.obs.registry import MetricsRegistry as JaxRegistry
from hydragnn_tpu.obs.trace import RequestTrace as JaxRequestTrace
from hydragnn_tpu.obs.trace import Tracer as JaxTracer
from hydragnn_tpu.obs.trace import flight_to_chrome as jax_flight_to_chrome
from hydragnn_tpu.serve import ModelRegistry as JaxModelRegistry
from hydragnn_tpu.serve import ModelServer as JaxModelServer
from hydragnn_tpu.serve import ServeConfig as JaxServeConfig

from hydragnn_tpu_torch.api import prepare_config_and_samples
from hydragnn_tpu_torch.convert import variables_from_flax
from hydragnn_tpu_torch.data.synthetic import deterministic_graph_data
from hydragnn_tpu_torch.flagship import flagship_config
from hydragnn_tpu_torch.obs import (
    FlightRecorder,
    build_reference,
    flight_to_chrome,
    list_incidents,
    read_flight_record,
    read_spool,
    validate_drift_report,
    validate_flight_record,
    validate_incident_bundle,
)
from hydragnn_tpu_torch.obs.trace import RequestTrace, Tracer
from hydragnn_tpu_torch.serve import ModelRegistry, ModelServer, ServeConfig, request_to_dict, structural_fingerprint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-6)  # the JAX package's serving tolerance
HIDDEN, LAYERS, N_SAMPLES, CELLS = 8, 2, 24, (2, 3)
WAIT = 120
GAUGES = ("feature_psi", "feature_qshift", "pred_psi", "error_score", "feature_rows", "pred_rows", "labeled_rows")
OBS_FIELDS = ("slo_p99_ms", "slo_queue_depth", "slo_queue_age_s", "trigger_eval_every_s", "incident_dir", "spool",
              "spool_sample", "spool_max_mb", "spool_shard_mb", "spool_dir", "drift_ref", "drift_feature_psi",
              "drift_pred_psi", "drift_error_score", "drift_min_count")


@pytest.fixture(scope="module")
def setup():
    jcfg, jmodel, jvars, loader = build_flagship(
        n_samples=N_SAMPLES, hidden_dim=HIDDEN, num_conv_layers=LAYERS, batch_size=4, unit_cells=CELLS
    )
    raw = deterministic_graph_data(number_configurations=N_SAMPLES, unit_cell_x_range=CELLS,
                                   unit_cell_y_range=CELLS, unit_cell_z_range=CELLS, seed=0)
    tr, _, _, cfg = prepare_config_and_samples(flagship_config(HIDDEN, LAYERS, 4), raw)
    served = ModelRegistry(device="cpu").register("obs_smoke", cfg["NeuralNetwork"], variables_from_flax(jvars))
    jserved = JaxModelRegistry().register("obs_smoke", jmodel, jvars)
    return {"served": served, "samples": list(tr), "jserved": jserved, "jsamples": list(loader.all_samples)}


@pytest.fixture(autouse=True)
def _no_cooldown_leak(monkeypatch):
    for name in ("HGTORCH_INJECT_DRIFT", "HGTORCH_SPOOL", "HGTORCH_DRIFT_REF", "HYDRAGNN_INJECT_DRIFT"):
        monkeypatch.delenv(name, raising=False)


def _server(setup, flight=None, **kw):
    return ModelServer(setup["served"], setup["samples"], ServeConfig(**kw), flight=flight)


def _gauges(registry):
    return np.array([registry.gauge(f"serve.drift.{g}").value for g in GAUGES], dtype=np.float64)


def _cli(*args):
    return subprocess.run([sys.executable, *args], cwd=REPO, capture_output=True, text=True, timeout=120)


def test_serve_config_has_the_jax_fields_and_defaults():
    port = {f.name: f.default for f in dataclasses.fields(ServeConfig)}
    jax = {f.name: f.default for f in dataclasses.fields(JaxServeConfig)}
    for name in OBS_FIELDS:
        assert port[name] == jax[name], name
    # every JAX field but the AOT executable cache (the port captures CUDA graphs)
    assert set(jax) - set(port) == {"exec_cache_dir"}
    assert set(port) - set(jax) == {"cuda_graphs"}


class _Pilot:
    def __init__(self):
        self.calls = []

    def on_drift_incident(self, incident, verdict):
        self.calls.append((incident.id, verdict.kind))


def test_server_drift_incident_end_to_end(setup, tmp_path, monkeypatch):
    samples = setup["samples"]
    ref = build_reference(samples)
    ref_path = tmp_path / "ref.json"
    ref_path.write_text(json.dumps(ref))
    monkeypatch.setenv("HGTORCH_INJECT_DRIFT", "5.0")
    flight_path = tmp_path / "flight.jsonl"
    cfg = dict(max_batch=4, max_delay_ms=5.0, slo_p99_ms=60_000.0, trigger_eval_every_s=0.05,
               incident_dir=str(tmp_path / "inc"), spool=True, spool_sample=1, spool_dir=str(tmp_path / "spool"),
               drift_ref=str(ref_path), drift_min_count=16)
    requests = [request_to_dict(s) for s in samples[:20]]  # the train split's 19
    pilot = _Pilot()
    server = _server(setup, FlightRecorder(str(flight_path)), **cfg)
    server.attach_pilot(pilot)
    with server:
        answers = [server.predict(r, timeout=WAIT) for r in requests]
        time.sleep(0.3)
        assert server.spool_dir() == str(tmp_path / "spool")
        prom = server.metrics.to_prometheus_text()
    port_gauges = _gauges(server.metrics.registry)
    # the JAX server on the same requests, drift armed, no rules
    monkeypatch.setenv("HYDRAGNN_INJECT_DRIFT", "5.0")
    jcfg = JaxServeConfig(max_batch=4, max_delay_ms=5.0, drift_ref=str(ref_path), drift_min_count=16,
                          drift_feature_psi=None, drift_pred_psi=None, drift_error_score=None)
    with JaxModelServer(setup["jserved"], setup["jsamples"], jcfg) as jserver:
        janswers = [jserver.predict(r, timeout=WAIT) for r in requests]
    jax_gauges = _gauges(jserver.metrics.registry)
    for got, want in zip(answers, janswers):
        for k in want:
            np.testing.assert_allclose(got[k], np.asarray(want[k]), **TOL)
    exact = [GAUGES.index(g) for g in ("feature_psi", "feature_qshift", "feature_rows", "pred_rows", "labeled_rows")]
    np.testing.assert_array_equal(port_gauges[exact], jax_gauges[exact])
    np.testing.assert_allclose(port_gauges, jax_gauges, **TOL)
    assert port_gauges[0] > 0.25
    # the flight record
    events = read_flight_record(str(flight_path))
    assert validate_flight_record(str(flight_path)) == []
    start = next(e for e in events if e["kind"] == "run_start")
    assert start["manifest"]["spool"]["enabled"] and start["manifest"]["drift"]["armed"]
    assert server.obs_arming == {"spool": start["manifest"]["spool"], "drift": start["manifest"]["drift"]}
    end = next(e for e in reversed(events) if e["kind"] == "run_end")
    assert end["spool"]["spooled"] == len(requests) and 0 <= end["spool"]["overhead_frac"] < 1
    assert end["drift"]["feature_psi_max"] > 0.25 and end["triggers"]["fired"] == 1
    drifts = [e for e in events if e["kind"] == "drift"]
    assert [e["rule_kind"] for e in drifts] == ["feature_drift"]
    assert not [e for e in events if e["kind"] == "error"]
    # the bundle: one incident, its drift report and pinned manifests
    (bundle,) = list_incidents(str(tmp_path / "inc"))
    assert validate_incident_bundle(bundle) == []
    with open(os.path.join(bundle, "drift_report.json")) as f:
        report = json.load(f)
    assert validate_drift_report(report) == [] and report["trigger"]["kind"] == "feature_drift"
    assert report["spool_window"]["dir"] == str(tmp_path / "spool") and report["pinned_shards"]
    assert sorted(os.listdir(os.path.join(bundle, "spool_manifests"))) == \
        sorted(f"{n}.json" for n in report["pinned_shards"])
    assert pilot.calls == [(os.path.basename(bundle), "feature_drift")]
    assert server._spool.pinned() == {}  # the close released the pins
    spooled = read_spool(str(tmp_path / "spool"))
    assert len(spooled) == len(requests)
    fp = spooled[0].meta["spool"]["model_fingerprint"]
    assert fp == structural_fingerprint(setup["served"].model.state_dict())
    # the JAX package's two tools and the port's: --validate on the spool,
    # the drift report, the flight record and the incidents; the port's render
    paths = (str(tmp_path / "spool"), os.path.join(bundle, "drift_report.json"), str(flight_path))
    for drift_tool, incident_tool in ((("tools/drift_report.py",), ("tools/incident_report.py",)),
                                      (("-m", "hydragnn_tpu_torch.tools.drift_report"),
                                       ("-m", "hydragnn_tpu_torch.tools.incident_report"))):
        r = _cli(*drift_tool, "--validate", *paths)
        assert r.returncode == 0 and r.stdout.count(": OK") == 3, (drift_tool, r.stdout + r.stderr)
        r = _cli(*incident_tool, "--validate", str(tmp_path / "inc"))
        assert r.returncode == 0 and r.stdout.count(": OK") == 1, (incident_tool, r.stdout + r.stderr)
    r = _cli("-m", "hydragnn_tpu_torch.tools.drift_report", str(flight_path), str(tmp_path / "spool"), paths[1])
    assert r.returncode == 0 and "breaches: 1" in r.stdout and "feature psi_max" in r.stdout, r.stdout + r.stderr
    r = _cli("-m", "hydragnn_tpu_torch.tools.incident_report", str(tmp_path / "inc"))
    assert r.returncode == 0 and "serve_feature_drift" in r.stdout, r.stdout + r.stderr
    # the textfile carries the JAX package's names of the seven gauges
    jreg = JaxRegistry(enabled=True)
    jax_drift.DriftMonitor(ref, jreg, prefix="serve")
    jax_names = {ln.split()[2] for ln in jax_prometheus_text(jreg).splitlines() if ln.startswith("# TYPE")}
    port_names = {ln.split()[2] for ln in prom.splitlines() if ln.startswith("# TYPE")}
    assert {n for n in jax_names if not n.endswith("_peak")} == {f"hydragnn_serve_drift_{g}" for g in GAUGES}
    assert jax_names <= port_names


def _burst(server, requests):
    futs = [server.submit(r) for r in requests]
    return [f.result(timeout=WAIT) for f in futs]


@pytest.mark.parametrize("rule", ["serve_p99", "serve_queue_depth", "serve_queue_age", None])
def test_slo_rules_fire_at_tiny_thresholds_and_stay_quiet_at_large(setup, tmp_path, rule):
    tiny = {"serve_p99": dict(slo_p99_ms=1e-6), "serve_queue_depth": dict(slo_queue_depth=0),
            "serve_queue_age": dict(slo_queue_age_s=1e-9)}
    knobs = tiny.get(rule) or dict(slo_p99_ms=60_000.0, slo_queue_depth=10_000, slo_queue_age_s=600.0)
    flight_path = tmp_path / "flight.jsonl"
    requests = [request_to_dict(s) for s in setup["samples"]] * 2
    with _server(setup, FlightRecorder(str(flight_path)), max_batch=4, max_delay_ms=5.0, trigger_eval_every_s=0.0,
                 incident_dir=str(tmp_path / "inc"), **knobs) as server:
        _burst(server, requests)
        time.sleep(0.1)
        _burst(server, requests[:8])
    events = read_flight_record(str(flight_path))
    end = next(e for e in reversed(events) if e["kind"] == "run_end")
    bundles = list_incidents(str(tmp_path / "inc"))
    assert not [e for e in events if e["kind"] == "error"]
    if rule is None:
        assert bundles == [] and end["triggers"]["fired"] == 0
        assert sorted(end["triggers"]["rules"]) == ["serve_p99", "serve_queue_age", "serve_queue_depth"]
        return
    assert [os.path.basename(b) for b in bundles] == [f"i001-{rule}"]
    assert validate_incident_bundle(bundles[0]) == []
    assert end["triggers"]["incidents"] == [rule]
    assert [e["rule"] for e in events if e["kind"] == "incident"] == [rule]


def test_a_failing_plane_disarms_with_one_error_event(setup, tmp_path):
    flight_path = tmp_path / "flight.jsonl"
    requests = [request_to_dict(s) for s in setup["samples"][:12]]
    with _server(setup, FlightRecorder(str(flight_path)), max_batch=4, max_delay_ms=5.0, spool=True, spool_sample=1,
                 spool_dir=str(tmp_path / "spool")) as server:
        def broken(*a, **k):
            raise OSError("disk gone")

        server._spool.offer = broken
        answers = _burst(server, requests)
        assert server._spool is None and server._drift is None
        assert server.spool_dir() is None and server.pin_spool(["x"]) == [] and server.open_pilot_incident(None) is None
        server.reset_drift()
    assert len(answers) == 12
    errors = [e for e in read_flight_record(str(flight_path)) if e["kind"] == "error"]
    assert [e["where"] for e in errors] == ["spool_drift"] and "disk gone" in errors[0]["error"]


def test_chrome_traces_equal_jax(setup, tmp_path):
    rng = np.random.default_rng(0)
    ptracer, jtracer = Tracer(enabled=True, sample_every=1), JaxTracer(enabled=True, sample_every=1)
    for seq in (-1, 3, 7):
        spans = [{"name": f"serve.{k}", "t0": round(1.7e9 + float(rng.random()), 6),
                  "dur_ms": round(float(rng.random()) * 10, 3), "bucket": k} for k in range(3)]
        pt = RequestTrace(f"{seq + 10:016x}", seq, {"tenant": "acme"})
        jt = JaxRequestTrace(f"{seq + 10:016x}", seq, {"tenant": "acme"})
        pt.spans, jt.spans = [dict(s) for s in spans], [dict(s) for s in spans]
        ptracer.finish(pt)
        jtracer.finish(jt)
    assert ptracer.to_chrome_trace() == jtracer.to_chrome_trace()
    path = ptracer.export_chrome(str(tmp_path / "sub" / "trace.json"))
    with open(path) as f:
        assert json.load(f) == jtracer.to_chrome_trace()
    # a serving record, and a training-like list with epoch and host_epoch events
    flight_path = tmp_path / "flight.jsonl"
    with _server(setup, FlightRecorder(str(flight_path)), max_batch=4, max_delay_ms=5.0) as server:
        _burst(server, [request_to_dict(s) for s in setup["samples"][:8]])
        out = server.export_trace(str(tmp_path / "serve_trace.json"))
    with open(out) as f:
        names = {e["name"] for e in json.load(f)["traceEvents"]}
    assert {"serve.route", "serve.queue_wait", "serve.batch_build", "serve.device_execute"} <= names
    assert flight_to_chrome(str(flight_path)) == jax_flight_to_chrome(str(flight_path))
    assert flight_to_chrome(str(flight_path))["traceEvents"]
    events = [{"kind": "run_start", "manifest": {"log_name": "r"}},
              {"kind": "epoch", "t": 10.0, "time": 2.5, "epoch": 0, "train_loss": 1.0, "rank": 0},
              {"kind": "host_epoch", "t": 11.0, "epoch_s": 3.0, "epoch": 0, "host": 1, "run_id": "x", "mfu": 0.1},
              {"kind": "trace_capture", "trace_id": "ab", "seq": 2, "spans": [{"name": "s", "t0": 1.0, "dur_ms": 2}]}]
    assert flight_to_chrome(events) == jax_flight_to_chrome(events)


def test_planes_off_answers_and_flight_kinds_unchanged(setup, tmp_path):
    """Every plane off (the defaults): the record holds the kinds it held
    before the planes existed, and the answers are bit-equal to a server
    with every plane on (clean traffic)."""
    requests = [request_to_dict(s) for s in setup["samples"]]
    ref_path = tmp_path / "ref.json"
    ref_path.write_text(json.dumps(build_reference(setup["samples"])))
    out = {}
    for mode in ("off", "on"):
        kw = {} if mode == "off" else dict(spool=True, spool_sample=1, spool_dir=str(tmp_path / "spool"),
                                          drift_ref=str(ref_path), slo_p99_ms=60_000.0, slo_queue_depth=10_000,
                                          slo_queue_age_s=600.0, incident_dir=str(tmp_path / "inc"))
        path = tmp_path / f"{mode}.jsonl"
        with _server(setup, FlightRecorder(str(path)), max_batch=4, max_delay_ms=5.0, **kw) as server:
            out[mode] = [server.predict(r, timeout=WAIT) for r in requests]
        out[mode + "_events"] = read_flight_record(str(path))
    for a, b in zip(out["off"], out["on"]):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    assert {e["kind"] for e in out["off_events"]} == {"run_start", "trace_capture", "run_end"}
    man = out["off_events"][0]["manifest"]
    assert man["spool"] == {"enabled": False} and man["drift"] == {"armed": False}
    end = out["off_events"][-1]
    assert not {"spool", "drift", "triggers"} & set(end)
    assert {"spool", "drift", "triggers"} <= set(out["on_events"][-1])
    assert list_incidents(str(tmp_path / "inc")) == []


def _big_graph(setup, nodes):
    sample = setup["samples"][0]
    rng = np.random.default_rng(nodes)
    g = {"x": rng.normal(size=(nodes, np.asarray(sample.x).shape[1])).astype(np.float32),
         "senders": np.arange(nodes - 1, dtype=np.int32), "receivers": np.arange(1, nodes, dtype=np.int32),
         "pos": rng.normal(size=(nodes, 3)).astype(np.float32)}
    if sample.edge_attr is not None:
        g["edge_attr"] = rng.normal(size=(nodes - 1, np.asarray(sample.edge_attr).shape[-1])).astype(np.float32)
    return g


def test_spooled_predictions_equal_their_answers_after_later_batches(setup, tmp_path):
    requests = [request_to_dict(s) for s in setup["samples"]]
    with _server(setup, max_batch=4, max_delay_ms=5.0, spool=True, spool_sample=1,
                 spool_dir=str(tmp_path / "spool")) as server:
        futs = [server.submit(r) for r in requests]
        answers = [f.result(timeout=WAIT) for f in futs]
        huge = _big_graph(setup, server.buckets[-1].node_pad + 5)
        answers.append(server.predict(huge, timeout=WAIT))  # the eager oversize path
        _burst(server, requests)  # later batches run before the spool is read
        kinds = {n: server.served.cfg.output_type[i] for i, n in enumerate(server.served.cfg.output_names)}
    assert server.metrics_snapshot()["oversize_eager"] == 1
    by_seq = {s.meta["spool"]["seq"]: s for s in read_spool(str(tmp_path / "spool"))}
    assert len(by_seq) == 2 * len(requests) + 1
    for seq, ans in enumerate(answers):
        got = by_seq[seq]
        for name, arr in ans.items():
            stored = got.graph_targets[name] if kinds[name] == "graph" else got.node_targets[name]
            np.testing.assert_array_equal(stored, np.asarray(arr, np.float32).reshape(stored.shape), err_msg=name)
    assert np.array_equal(by_seq[len(requests)].x, huge["x"])


def test_structural_fingerprint_is_structural(setup):
    state = setup["served"].model.state_dict()
    fp = structural_fingerprint(state)
    assert fp == structural_fingerprint({k: v * 2 for k, v in state.items()})
    name = next(k for k, v in state.items() if v.is_floating_point() and v.dim() == 2)
    other = dict(state)
    other[name] = torch.zeros(state[name].shape[0] + 1, state[name].shape[1])
    assert structural_fingerprint(other) != fp
    assert structural_fingerprint({k: v.double() if v.is_floating_point() else v for k, v in state.items()}) != fp
