"""The port's pod-visibility plane (``hydragnn_tpu_torch/obs/podview.py``,
the loop's per-host shards and ``host_epoch`` events, the straggler in
``obs/spans.py``, the merge in ``obs/trace.py``'s Chrome export, the pod
rules' incident evidence) against the JAX package's
(``hydragnn_tpu/obs/podview.py``) on the same inputs: shards written from
numpy-seeded summaries are merged, tabled and folded into skew verdicts by
both packages, and the results are equal exactly (events, tables,
verdicts, gauges, straggler specs, the collective attribution given one
explicit ``scaling`` dict). The port reads no ``SCALING_est_*.json`` (a
TPU's estimate): without a dict its attribution is ``modeled: False``.

Two simulated hosts (host 1, then host 0, as ``ci.sh`` runs them) train
the flagship at hidden 8, 2 layers through ``run_training`` in both
packages from one init: the manifests' ``podview`` keys, the record's
event kinds and the merged ``host_epoch`` table agree, and the train
losses hold the loop's AdamW tiers (rtol 1e-4 at epoch 0,
``ADAM_LATER_RTOL`` after; the eval losses are not compared under AdamW,
``test_torch_train_loop.py``).
The JAX package's ``tools/obs_report.py --hosts`` and ``--validate`` read
the port's pod run directory."""

import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from hydragnn_tpu.obs import podview as jpv
from hydragnn_tpu.obs.registry import MetricsRegistry as JaxRegistry

from hydragnn_tpu_torch.obs import podview as tpv
from hydragnn_tpu_torch.obs.flight import FlightRecorder, flight_record_warnings, validate_flight_record
from hydragnn_tpu_torch.obs.registry import MetricsRegistry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_MANIFEST = {"run": "podtest", "mode": "train", "jax_version": None, "backend": "cpu", "device_kind": "cpu",
             "num_processes": 2, "config": {}}


def _both_env(monkeypatch, **kw):
    """Set each knob under the port's name and the JAX package's."""
    for k, v in kw.items():
        for name in (f"HGTORCH_{k}", "HYDRAGNN_" + k):
            if v is None:
                monkeypatch.delenv(name, raising=False)
            else:
                monkeypatch.setenv(name, str(v))


def _write_shard(base_dir, host, epochs, run_id="rid", slow_epochs=(), slow_s=0.5, data_wait_s=0.01, torn=False,
                 seed=0):
    """One simulated host's shard through the port's recorder: run_start,
    one ``host_epoch`` an epoch (durations from a numpy seed), run_end."""
    rng = np.random.default_rng(seed + 17 * host)
    path = tpv.host_flight_path(str(base_dir), host)
    fr = FlightRecorder(path, enabled=True, host=host)
    fr.start_run(dict(_MANIFEST))
    for ep in range(epochs):
        fr.record("host_epoch", epoch=ep, host=host, run_id=run_id, hosts=2,
                  epoch_s=round(1.0 + float(rng.uniform(0, 0.01)) + (slow_s if ep in slow_epochs else 0.0), 6),
                  data_wait_s=data_wait_s, steps=4, nonfinite_skipped=0, mfu=0.11 + host / 100.0)
    fr.end_run(status="completed")
    fr.close()
    if torn:
        with open(path, "a") as f:
            f.write('{"v": 2, "kind": "host_ep')
    return path


# -- shard naming and artifact paths -------------------------------------------


def test_host_flight_path_and_listing_match_jax(tmp_path):
    for h in (0, 1, 3, 12):
        assert tpv.host_flight_path(str(tmp_path), h) == jpv.host_flight_path(str(tmp_path), h)
    _write_shard(tmp_path, 0, 1)
    _write_shard(tmp_path, 2, 1)
    assert tpv.list_host_shards(str(tmp_path)) == jpv.list_host_shards(str(tmp_path))
    assert sorted(tpv.list_host_shards(str(tmp_path))) == [0, 2]


@pytest.mark.parametrize("path", ["/x/train.prom", "/x/serve_probe.prom", "rel/noext", "/a.b/c.json"])
@pytest.mark.parametrize("host", [0, 1, 2, 7])
def test_host_artifact_path_matches_jax(path, host):
    assert tpv.host_artifact_path(path, host) == jpv.host_artifact_path(path, host)


@pytest.mark.parametrize("host,hosts", [("3", "8"), ("3", "2"), (None, "4"), ("1", None), (None, None)])
def test_host_identity_and_enabled_match_jax(monkeypatch, host, hosts):
    _both_env(monkeypatch, PODVIEW_HOST=host, PODVIEW_HOSTS=hosts, PODVIEW=None)
    assert tpv.host_identity() == jpv.host_identity()
    assert tpv.podview_enabled() == jpv.podview_enabled()
    _both_env(monkeypatch, PODVIEW=1)
    assert tpv.podview_enabled() and jpv.podview_enabled()


def test_resolve_run_id_matches_jax(monkeypatch):
    _both_env(monkeypatch, PODVIEW_RUN_ID=None)
    assert tpv.resolve_run_id("fallback") == jpv.resolve_run_id("fallback") == "fallback"
    _both_env(monkeypatch, PODVIEW_RUN_ID="shared-id")
    assert tpv.resolve_run_id("fallback") == jpv.resolve_run_id("fallback") == "shared-id"


# -- the merge reader -----------------------------------------------------------


@pytest.mark.parametrize("case", ["clean", "torn_tail", "missing_host", "duplicate", "explicit_paths", "single_file"])
def test_merge_matches_jax(tmp_path, monkeypatch, case):
    _both_env(monkeypatch, PODVIEW_HOSTS=None)
    if case == "missing_host":
        _write_shard(tmp_path, 0, 2)
    else:
        p0 = _write_shard(tmp_path, 0, 2)
        p1 = _write_shard(tmp_path, 1, 2, torn=case == "torn_tail")
    if case == "duplicate":
        fr = FlightRecorder(p1, enabled=True, host=1)
        fr.record("host_epoch", epoch=0, host=1, run_id="rid", hosts=1, epoch_s=2.0)
        fr.close()
    source = {"explicit_paths": [p0, p1] if case == "explicit_paths" else None,
              "single_file": p1 if case == "single_file" else None}.get(case) or str(tmp_path)
    ours, theirs = tpv.merge_host_flights(source), jpv.merge_host_flights(source)
    assert ours.events == theirs.events
    assert ours.hosts == theirs.hosts
    assert ours.problems == theirs.problems
    assert tpv.host_epoch_table(ours.events) == jpv.host_epoch_table(theirs.events)
    assert tpv.host_epoch_table(ours.events, run_id="rid") == jpv.host_epoch_table(theirs.events, run_id="rid")
    assert all("host" in ev for ev in ours.events)
    assert validate_flight_record(ours.events) == []
    assert flight_record_warnings(ours.events) == []
    want = {"clean": [], "torn_tail": ["torn tail"], "missing_host": ["missing host shard(s): [1]"],
            "duplicate": ["duplicate host_epoch"], "explicit_paths": [], "single_file": []}[case]
    for w in want:
        assert any(w in p for p in ours.problems), ours.problems
    if case == "torn_tail":
        assert len(tpv.host_epoch_table(ours.events)[1]) == 2  # the torn shard's readable part merged


# -- the skew monitor ------------------------------------------------------------


def _monitors(tmp_path, hosts=2, **kw):
    treg, jreg = MetricsRegistry(enabled=True, rank=0), JaxRegistry(enabled=True, rank=0)
    tmon = tpv.SkewMonitor(str(tmp_path), host=0, hosts=hosts, run_id="rid", registry=treg, **kw)
    jmon = jpv.SkewMonitor(str(tmp_path), host=0, hosts=hosts, run_id="rid", registry=jreg, **kw)
    return (tmon, treg), (jmon, jreg)


_GAUGES = ("podview.skew_frac", "podview.slowest_host", "podview.host1.mfu")


@pytest.mark.parametrize("case", ["host_slow", "data_wait", "interconnect"])
def test_skew_monitor_verdicts_gauges_and_report_match_jax(tmp_path, case):
    scaling = {"step_ms_device_single_chip": 80.0, "ici_gbps_assumed": 0.001, "param_bytes_f32": 4.0e6}
    parallel = {"available": True, "data": 2, "fsdp": 1, "params": {"bytes_global": 4.0e6}}
    _write_shard(tmp_path, 1, 2, slow_epochs=(1,), slow_s=0.5, data_wait_s=0.4 if case == "data_wait" else 0.01)
    kw = dict(threshold=0.2)
    if case == "interconnect":
        kw.update(parallel=parallel, scaling=scaling)
    (tmon, treg), (jmon, jreg) = _monitors(tmp_path, **kw)
    own = {"epoch_s": 1.0, "data_wait_s": 0.0, "mfu": 0.11}
    for ep in (0, 1):
        ours = tmon.observe_epoch(ep, dict(own, epoch=ep))
        theirs = jmon.observe_epoch(ep, dict(own, epoch=ep))
        assert ours == theirs
        for g in _GAUGES:
            assert treg.gauge(g).value == jreg.gauge(g).value, g
    assert ours["slowest_host"] == 1
    # the verdict rounds each epoch_s to 4 digits
    assert ours["skew_frac"] == pytest.approx((ours["epoch_s"]["1"] - 1.0) / ours["epoch_s"]["1"], abs=1e-4)
    assert ours["cause"] == case
    rep, jrep = tmon.report(), jmon.report()
    assert {k: v for k, v in rep.items() if k != "overhead_s"} == {k: v for k, v in jrep.items() if k != "overhead_s"}
    assert tpv.validate_podview_report(rep) == [] == jpv.validate_podview_report(rep)
    assert tmon.overhead_s > 0.0


def test_skew_monitor_single_host_stall_and_failure_match_jax(tmp_path, monkeypatch):
    (tmon, treg), (jmon, jreg) = _monitors(tmp_path, hosts=1, threshold=0.25)
    assert tmon.observe_epoch(0, {"epoch_s": 1.0}) is None is jmon.observe_epoch(0, {"epoch_s": 1.0})
    assert treg.gauge("podview.skew_frac").value == jreg.gauge("podview.skew_frac").value == 0.0
    assert treg.gauge("podview.slowest_host").value == jreg.gauge("podview.slowest_host").value == -1.0
    # a peer that never wrote counts as stalled from the monitor's start
    (tmon, treg), _ = _monitors(tmp_path, hosts=2, threshold=0.25)
    tmon._t0 -= 100.0
    tmon.observe_epoch(0, {"epoch_s": 1.0})
    assert treg.gauge("podview.stall_age_s").value >= 100.0
    # a failure degrades to no data, never a raise
    monkeypatch.setattr(tpv, "list_host_shards", lambda *_: (_ for _ in ()).throw(RuntimeError("fs exploded")))
    assert tmon.observe_epoch(1, {"epoch_s": 1.0}) is None


def test_skew_monitor_reads_appended_lines_as_jax_reads_whole_shards(tmp_path):
    """The port's monitor reads only what a shard gained since its last
    epoch; JAX's re-reads every shard whole. Epoch by epoch, with lines
    appended between and a line torn until the next epoch, the verdicts
    and gauges are equal."""
    (tmon, treg), (jmon, jreg) = _monitors(tmp_path, threshold=0.2)
    path = tpv.host_flight_path(str(tmp_path), 1)
    fr = FlightRecorder(path, enabled=True, host=1)
    fr.start_run(dict(_MANIFEST))
    own = {"epoch_s": 1.0, "data_wait_s": 0.0, "mfu": 0.11}
    for ep in range(4):
        if ep == 3:  # the torn line of epoch 2's read, finished
            with open(path, "a") as f:
                f.write('id": "rid", "hosts": 2, "epoch_s": 9.0}\n')
        fr.record("host_epoch", epoch=ep, host=1, run_id="rid", hosts=2, epoch_s=1.0 + 0.3 * ep,
                  data_wait_s=0.01, steps=4, mfu=0.12)
        if ep == 2:  # a line still being written when host 0 reads
            with open(path, "a") as f:
                f.write('{"v": 2, "kind": "host_epoch", "t": 1.0, "rank": 1, "epoch": 3, "host": 1, "run_')
        ours, theirs = tmon.observe_epoch(ep, dict(own, epoch=ep)), jmon.observe_epoch(ep, dict(own, epoch=ep))
        assert ours == theirs and ours["slowest_host"] == (1 if ep else 0)
        for g in _GAUGES:
            assert treg.gauge(g).value == jreg.gauge(g).value, (ep, g)
    fr.close()


@pytest.mark.parametrize("report", [
    {"schema": 1, "host": 0, "hosts": 2, "threshold": 0.25, "history": [], "attribution": {}, "slowest_host": 1},
    {"schema": 1, "host": 0, "hosts": 2, "threshold": 0.25, "history": [], "attribution": {}, "slowest_host": "1"},
    {"schema": "1", "host": None, "hosts": 2, "threshold": "x", "history": {}, "attribution": []},
    [],
])
def test_validate_podview_report_matches_jax(report):
    assert tpv.validate_podview_report(report) == jpv.validate_podview_report(report)


# -- the trigger rules and the incident's evidence --------------------------------


def test_step_skew_and_host_stall_rules_fire_as_jax(tmp_path):
    from hydragnn_tpu.obs.triggers import TriggerEngine as JaxEngine, TriggerRule as JaxRule

    from hydragnn_tpu_torch.obs.triggers import RULE_KINDS, TriggerEngine, TriggerRule

    assert "step_skew" in RULE_KINDS and "host_stall" in RULE_KINDS
    fired = []
    for reg_cls, eng_cls, rule_cls in ((MetricsRegistry, TriggerEngine, TriggerRule),
                                       (JaxRegistry, JaxEngine, JaxRule)):
        reg = reg_cls(enabled=True, rank=0)
        reg.gauge("podview.skew_frac").set(0.6)
        reg.gauge("podview.stall_age_s").set(10.0)
        reg.gauge("podview.slowest_host").set(3.0)
        eng = eng_cls([rule_cls("skew", "step_skew", "podview.skew_frac", 0.25),
                       rule_cls("stall", "host_stall", "podview.stall_age_s", 120.0)], registry=reg, cooldown_s=0.0)
        verdicts = eng.evaluate()
        reg.gauge("podview.skew_frac").set(0.1)
        fired.append(([(v.kind, v.detail) for v in verdicts], eng.evaluate()))
    assert fired[0] == fired[1] == ([("step_skew", {"slowest_host": 3})], [])


def test_incident_bundle_carries_podview_evidence(tmp_path, monkeypatch):
    from hydragnn_tpu_torch.obs.triggers import IncidentRecorder, TriggerVerdict, validate_incident_manifest
    from hydragnn_tpu_torch.utils import profile

    monkeypatch.setattr(profile, "try_start_capture", lambda *a, **k: False)
    run_dir = tmp_path / "run"
    run_dir.mkdir()
    _write_shard(run_dir, 0, 1)
    _write_shard(run_dir, 1, 1, slow_epochs=(0,), slow_s=1.0)
    mon = tpv.SkewMonitor(str(run_dir), host=0, hosts=2, run_id="rid", threshold=0.2)
    mon.observe_epoch(0, {"epoch": 0, "epoch_s": 1.0, "data_wait_s": 0.0})
    rec = IncidentRecorder(str(tmp_path / "incidents"), podview=mon)
    inc = rec.open_incident(TriggerVerdict("skew", "step_skew", "podview.skew_frac", 0.5, 0.2, 1.0,
                                           detail={"slowest_host": 1}))
    for _ in range(3):
        rec.tick()
    rec.finalize()
    assert rec.open is None
    with open(os.path.join(inc.dir, "podview_report.json")) as f:
        report = json.load(f)
    assert tpv.validate_podview_report(report) == [] and report["slowest_host"] == 1
    assert os.path.exists(os.path.join(inc.dir, "flight_tail.host1.jsonl"))
    with open(os.path.join(inc.dir, "incident_manifest.json")) as f:
        manifest = json.load(f)
    assert validate_incident_manifest(manifest) == []
    assert manifest["kind"] == "step_skew" and manifest["files"]["podview_report"] == "podview_report.json"


# -- the straggler -----------------------------------------------------------------


@pytest.mark.parametrize("spec", [None, "1:250", "0:0.5", "garbage", "2:", ":5", "3:1e3"])
def test_straggler_spec_matches_jax(monkeypatch, spec):
    _both_env(monkeypatch, INJECT_STRAGGLER=spec)
    assert tpv.straggler_spec() == jpv.straggler_spec()


@pytest.mark.parametrize("host,sleeps", [("1", True), ("0", False)])
def test_step_spans_straggle_on_the_matching_host_as_jax(monkeypatch, host, sleeps):
    from hydragnn_tpu.obs.spans import StepSpans as JaxSpans

    from hydragnn_tpu_torch.obs.spans import StepSpans

    _both_env(monkeypatch, PODVIEW_HOST=host, PODVIEW_HOSTS="2", INJECT_STRAGGLER="1:50")
    spans, jspans = StepSpans(), JaxSpans()
    assert spans._straggle_s == jspans._straggle_s == (pytest.approx(0.05) if sleeps else 0.0)
    snap, jsnap = spans.epoch_snapshot(), jspans.epoch_snapshot()
    assert (snap["process_index"], snap["process_count"]) == (jsnap["process_index"], jsnap["process_count"])
    assert snap["process_index"] == int(host)


# -- no TPU estimate in the port; the attribution on an explicit dict ------------


def test_the_port_reads_no_scaling_estimate(tmp_path, monkeypatch):
    _both_env(monkeypatch, PODVIEW_SKEW=None)
    assert glob.glob(os.path.join(REPO, "SCALING_est_*.json"))  # the JAX package's TPU estimates are there
    assert tpv.load_skew_tolerance() == tpv.DEFAULT_SKEW_THRESHOLD == jpv.DEFAULT_SKEW_THRESHOLD
    assert tpv.default_skew_threshold() == 0.25
    parallel = {"available": True, "data": 4, "fsdp": 1, "params": {"bytes_global": 4.0e6}}
    off = tpv.collective_attribution(parallel)
    assert off["modeled"] is False and off["wire_ms"] is None and "no scaling estimate" in off["note"]
    assert tpv.SkewMonitor(str(tmp_path), parallel=parallel).report()["attribution"]["modeled"] is False
    # an explicit estimate file is read as the JAX package reads one
    est = tmp_path / "est.json"
    est.write_text(json.dumps({"skew_tolerance": {"default_step_skew_threshold": 0.31}}))
    assert tpv.load_skew_tolerance(str(est)) == jpv.load_skew_tolerance(str(est)) == 0.31
    bare = tmp_path / "bare.json"
    bare.write_text(json.dumps({"mesh": [1]}))
    assert tpv.load_skew_tolerance(str(bare)) == jpv.load_skew_tolerance(str(bare))
    _both_env(monkeypatch, PODVIEW_SKEW="0.4")
    assert tpv.default_skew_threshold() == jpv.default_skew_threshold() == pytest.approx(0.4)


@pytest.mark.parametrize("data,fsdp", [(4, 1), (4, 2), (1, 2), (1, 1), (2, 2)])
@pytest.mark.parametrize("scaling", [
    {"step_ms_device_single_chip": 80.0, "ici_gbps_assumed": 45.0, "param_bytes_f32": 4.0e6},
    {"step_ms_device_single_chip": 12.5, "param_bytes_f32": 6.775836e6},
    {"ici_gbps_assumed": 45.0},
])
def test_collective_attribution_matches_jax_on_one_dict(data, fsdp, scaling):
    parallel = {"available": True, "data": data, "fsdp": fsdp, "params": {"bytes_global": 4.0e6}}
    assert tpv.collective_attribution(parallel, scaling) == jpv.collective_attribution(parallel, scaling)
    assert tpv.collective_attribution(None, scaling) == jpv.collective_attribution(None, scaling)


# -- the Chrome export ---------------------------------------------------------------


def test_chrome_export_one_track_per_host_as_jax(tmp_path):
    from hydragnn_tpu.obs.trace import flight_to_chrome as jax_to_chrome

    from hydragnn_tpu_torch.obs.trace import export_flight_chrome, flight_to_chrome

    _write_shard(tmp_path, 0, 2)
    _write_shard(tmp_path, 1, 2)
    merged = tpv.merge_host_flights(str(tmp_path))
    events = flight_to_chrome(merged.events)["traceEvents"]
    assert events == jax_to_chrome(merged.events)["traceEvents"]
    assert {e["tid"] for e in events if e.get("ph") == "X" and str(e.get("name", "")).startswith("host")} == {0, 1}
    assert {e["args"]["name"] for e in events if e.get("name") == "thread_name"} == {"host 0", "host 1"}
    out = tmp_path / "trace.json"
    export_flight_chrome(str(tmp_path), str(out))  # a run directory: merged first
    assert json.loads(out.read_text())["traceEvents"] == events


# -- two simulated hosts through run_training in both packages --------------------


def _train_both(tmp_path, monkeypatch):
    """Host 1, then host 0, through each package's ``run_training`` on the
    same samples from one init (the JAX package's, loaded into the port)."""
    import hydragnn_tpu.api as japi
    from hydragnn_tpu import flagship as jflagship
    from hydragnn_tpu.data.synthetic import deterministic_graph_data as jdata

    import hydragnn_tpu_torch.api as tapi
    from hydragnn_tpu_torch import flagship as tflagship
    from hydragnn_tpu_torch.convert import variables_from_flax
    from hydragnn_tpu_torch.data.synthetic import deterministic_graph_data as tdata

    unit = dict(unit_cell_x_range=(2, 3), unit_cell_y_range=(2, 3), unit_cell_z_range=(2, 3))
    init = {}
    real_jcreate, real_tcreate = japi.create_model_config, tapi.create_model_config

    def jcreate(*a, **k):
        model, variables = real_jcreate(*a, **k)
        init.setdefault("variables", variables)
        return model, variables

    def tcreate(*a, **k):
        model = real_tcreate(*a, **k)
        model.load_state_dict(variables_from_flax(init["variables"]), strict=True)
        return model

    monkeypatch.setattr(japi, "create_model_config", jcreate)
    monkeypatch.setattr(tapi, "create_model_config", tcreate)
    _both_env(monkeypatch, DIAGNOSTICS="0")
    runs = {}
    for pkg, flagship, data, run in (("jax", jflagship, jdata, japi.run_training),
                                     ("port", tflagship, tdata, tapi.run_training)):
        for host in (1, 0):
            _both_env(monkeypatch, PODVIEW_HOSTS="2", PODVIEW_HOST=str(host), PODVIEW_RUN_ID="podsmoke")
            cfg = flagship.flagship_config(hidden_dim=8, num_conv_layers=2, batch_size=5, num_epoch=2)
            cfg["NeuralNetwork"]["Training"]["scan_epoch"] = False
            cfg["NeuralNetwork"]["Training"]["checkpoint_every"] = 1
            kw = {"device": "cpu"} if pkg == "port" else {}
            out = run(cfg, samples=data(number_configurations=20, seed=0, **unit),
                      log_dir=str(tmp_path / pkg / "logs") + "/", **kw)
            runs.setdefault(pkg, {})[host] = out[2]
    return runs


def test_two_simulated_hosts_through_run_training_match_jax(tmp_path, monkeypatch):
    from hydragnn_tpu.obs.flight import read_flight_record as jax_read

    from hydragnn_tpu_torch.obs.flight import read_flight_record
    from test_torch_train_loop import ADAM_LATER_RTOL, LOSS_RTOL

    runs = _train_both(tmp_path, monkeypatch)
    (jdir,) = glob.glob(str(tmp_path / "jax" / "logs" / "*/"))
    (tdir,) = glob.glob(str(tmp_path / "port" / "logs" / "*/"))
    for host in (0, 1):
        jh, th = runs["jax"][host], runs["port"][host]
        np.testing.assert_allclose(th["train_loss"][:1], jh["train_loss"][:1], rtol=LOSS_RTOL)
        np.testing.assert_allclose(th["train_loss"][1:], jh["train_loss"][1:], rtol=ADAM_LATER_RTOL)
    for name in ("flight.jsonl", "flight.host1.jsonl"):
        jev, tev = jax_read(os.path.join(jdir, name)), read_flight_record(os.path.join(tdir, name))
        (jstart,), (tstart,) = [e for e in jev if e["kind"] == "run_start"], [e for e in tev if e["kind"] == "run_start"]
        assert tstart["manifest"]["podview"] == jstart["manifest"]["podview"]
        (jend,), (tend,) = [e for e in jev if e["kind"] == "run_end"], [e for e in tev if e["kind"] == "run_end"]
        assert sorted(tend["podview"]) == sorted(jend["podview"])
        assert {k: tend["podview"][k] for k in ("enabled", "host", "hosts", "run_id")} == \
            {k: jend["podview"][k] for k in ("enabled", "host", "hosts", "run_id")}
        # the JAX record's extra kinds are its compile events (XLA compiles; the port compiles nothing)
        assert {e["kind"] for e in tev} == {e["kind"] for e in jev} - {"compile"}
        assert validate_flight_record(tev) == []
    merged, jmerged = tpv.merge_host_flights(tdir), jpv.merge_host_flights(jdir)
    assert merged.hosts == jmerged.hosts == [0, 1] and merged.problems == jmerged.problems == []
    table, jtable = tpv.host_epoch_table(merged.events, "podsmoke"), jpv.host_epoch_table(jmerged.events, "podsmoke")
    assert {e: sorted(v) for e, v in table.items()} == {e: sorted(v) for e, v in jtable.items()} == {0: [0, 1], 1: [0, 1]}
    for e in table:
        for h in table[e]:
            assert sorted(table[e][h]) == sorted(jtable[e][h])
    assert [e for e in merged.events if e["kind"] == "podview"]  # host 0's monitor read host 1's shard
    end = [e for e in read_flight_record(os.path.join(tdir, "flight.jsonl")) if e["kind"] == "run_end"][-1]
    assert end["podview"]["overhead_frac"] < 0.05
    # both packages' pods commit their generations
    from hydragnn_tpu.resilience.podckpt import list_committed_generations as jgens

    from hydragnn_tpu_torch.resilience.podckpt import list_committed_generations

    assert list_committed_generations(tdir.rstrip("/")) == jgens(jdir.rstrip("/")) == [1, 2]
    # the JAX package's reporter reads the port's pod run directory
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    hosts = subprocess.run([sys.executable, os.path.join(REPO, "tools", "obs_report.py"), "--hosts", tdir],
                           capture_output=True, text=True, env=env, timeout=240)
    assert hosts.returncode == 0, hosts.stderr[-2000:]
    assert "slowest" in hosts.stdout and "== hosts (2): 0, 1 ==" in hosts.stdout
    val = subprocess.run([sys.executable, os.path.join(REPO, "tools", "obs_report.py"), "--validate", tdir],
                         capture_output=True, text=True, env=env, timeout=240)
    assert val.returncode == 0, val.stderr[-2000:]
    assert "podckpt: last committed gen 2" in val.stdout
