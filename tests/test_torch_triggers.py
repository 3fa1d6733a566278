"""The port's SLO triggers and incident bundles (``hydragnn_tpu_torch/obs/triggers.py``)
against the JAX package's (``hydragnn_tpu/obs/triggers.py``), and the
profiler capture slot they share with the ``Profile`` section
(``hydragnn_tpu_torch/utils/profile.py``).

The engines are fed the same observed series and counter values under
the same injected clock, and must give the same verdicts (rule, kind,
observed value, fired or suppressed) evaluation by evaluation; the
rule kinds and bundle layouts are equal; a port bundle passes both
packages' validators and the JAX package's ``tools/incident_report.py
--validate``.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from hydragnn_tpu.obs import registry as jax_registry
from hydragnn_tpu.obs import triggers as jax_triggers

from hydragnn_tpu_torch.obs import read_flight_record, registry, triggers
from hydragnn_tpu_torch.resilience import inject
from hydragnn_tpu_torch.utils import profile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UNIT = dict(unit_cell_x_range=(2, 3), unit_cell_y_range=(2, 3), unit_cell_z_range=(2, 3))


def test_rule_kinds_equal_the_jax_list():
    assert triggers.RULE_KINDS == jax_triggers.RULE_KINDS
    assert len(triggers.RULE_KINDS) == 13
    with pytest.raises(ValueError):
        triggers.TriggerRule("x", "no_such_kind", "m", 1.0)


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _engines(rules, cooldown_s, max_incidents):
    """The two engines over their own registries and one shared clock."""
    clock = _Clock()
    port_reg, jax_reg = registry.MetricsRegistry(), jax_registry.MetricsRegistry()
    port = triggers.TriggerEngine([triggers.TriggerRule(*r) for r in rules], registry=port_reg,
                                  cooldown_s=cooldown_s, max_incidents=max_incidents, clock=clock)
    jx = jax_triggers.TriggerEngine([jax_triggers.TriggerRule(*r) for r in rules], registry=jax_reg,
                                    cooldown_s=cooldown_s, max_incidents=max_incidents, clock=clock)
    return clock, (port, port_reg), (jx, jax_reg)


TRAIN_RULES = [
    ("train_nonfinite_burst", "nonfinite_burst", "train.nonfinite_skipped", 2.0),
    ("train_loss_spike", "loss_spike", "train_loss", 3.0),
    ("train_mfu_drop", "mfu_drop", "mfu", 0.5),
]


@pytest.mark.parametrize("case", ["loss_spike", "mfu_drop", "nonfinite_burst", "cooldown", "max_incidents",
                                  "one_verdict_an_evaluate"])
def test_the_same_series_give_the_same_verdicts(case, monkeypatch):
    monkeypatch.delenv("HGTORCH_INJECT_TRIGGER", raising=False)
    monkeypatch.delenv("HYDRAGNN_INJECT_TRIGGER", raising=False)
    cooldown, max_inc = {"cooldown": (100.0, 5), "max_incidents": (0.0, 2)}.get(case, (0.0, 10))
    clock, (port, preg), (jx, jreg) = _engines(TRAIN_RULES, cooldown, max_inc)
    losses = [1.0, 0.9, 0.8, 5.0, 0.7, 0.6, 9.0, 0.5, 8.0, 0.4]
    mfus = [0.4, 0.41, 0.39, 0.1, 0.4, 0.05, 0.4, 0.02, 0.4, 0.01]
    skipped = [0, 0, 3, 3, 4, 9, 9, 12, 12, 20]
    got, want = [], []
    for i in range(len(losses)):
        clock.t = 10.0 * i
        if case in ("loss_spike", "cooldown", "max_incidents", "one_verdict_an_evaluate"):
            for e in (port, jx):
                e.observe("train_loss", losses[i])
        if case in ("mfu_drop", "one_verdict_an_evaluate"):
            for e in (port, jx):
                e.observe("mfu", mfus[i])
                e.observe("mfu", None)  # a None sample is dropped
        if case in ("nonfinite_burst", "one_verdict_an_evaluate"):
            for reg in (preg, jreg):
                c = reg.counter("train.nonfinite_skipped")
                c.inc(skipped[i] - c.value)
        got.append([(v.rule, v.kind, v.observed, v.threshold, v.detail) for v in port.evaluate()])
        want.append([(v.rule, v.kind, v.observed, v.threshold, v.detail) for v in jx.evaluate()])
        assert len(got[-1]) <= 1
    assert got == want
    assert any(got), "the case fired nothing: it tests nothing"
    assert port.suppressed == jx.suppressed
    ps, js = port.summary(), jx.summary()
    assert {k: ps[k] for k in ("rules", "fired", "suppressed", "incidents")} == {
        k: js[k] for k in ("rules", "fired", "suppressed", "incidents")}
    if case == "max_incidents":
        assert ps["fired"] == 2 and ps["suppressed"] > 0
    if case == "cooldown":
        assert ps["fired"] >= 1 and ps["suppressed"] > 0


def test_the_counter_baseline_counts_from_the_engine_start():
    reg = registry.MetricsRegistry()
    reg.counter("train.nonfinite_skipped").inc(7)  # an earlier run's skips
    eng = triggers.TriggerEngine([triggers.TriggerRule(*TRAIN_RULES[0])], registry=reg, cooldown_s=0.0)
    eng.baseline_counters()
    assert eng.evaluate() == []
    reg.counter("train.nonfinite_skipped").inc(2)
    assert [v.observed for v in eng.evaluate()] == [2.0]


def test_the_injected_trigger_fires_once(monkeypatch):
    monkeypatch.setenv("HGTORCH_INJECT_TRIGGER", "train_loss_spike")
    inject.TRIGGER.reset()
    try:
        eng = triggers.TriggerEngine([triggers.TriggerRule(*r) for r in TRAIN_RULES],
                                     registry=registry.MetricsRegistry(), cooldown_s=0.0)
        first = eng.evaluate()
        assert [(v.rule, v.injected, v.observed) for v in first] == [("train_loss_spike", True, -1.0)]
        assert first[0].detail == {"injected": "HGTORCH_INJECT_TRIGGER"}
        assert eng.evaluate() == [] and eng.evaluate() == []
        other = triggers.TriggerEngine([triggers.TriggerRule("serve_p99", "latency_p99", "lat", 1.0)],
                                       registry=registry.MetricsRegistry())
        assert other.evaluate() == []
    finally:
        inject.TRIGGER.reset()


def _verdict():
    return triggers.TriggerVerdict("train_loss_spike", "loss_spike", "train_loss", 5.0, 3.0, 1.0,
                                   detail={"rolling_median": 1.0, "window": 3})


def _incident_report(root):
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, os.path.join(REPO, "tools", "incident_report.py"), "--validate", root],
                          capture_output=True, text=True, env=env, timeout=300)


def test_a_port_bundle_passes_both_validators_and_the_report_tool(tmp_path):
    flight_path = str(tmp_path / "flight.jsonl")
    with open(flight_path, "w") as f:
        f.write(json.dumps({"v": 2, "kind": "run_start", "t": 0.0, "rank": 0, "manifest": {}}) + "\n")
    reg = registry.MetricsRegistry()
    reg.counter("train.nonfinite_skipped").inc(1)
    root = str(tmp_path / "incidents")
    rec = triggers.IncidentRecorder(root, registry=reg, flight_path=flight_path, profile_steps=2, profile_s=60.0)
    inc = rec.open_incident(_verdict())
    assert inc is not None and rec.open_incident(_verdict()) is None  # one open at a time
    for _ in range(3):
        torch.ones(64, 64) @ torch.ones(64, 64)
        rec.tick()
    assert rec.open is None and rec.closed_ids == [inc.id]
    bundles = triggers.list_incidents(root)
    assert bundles == jax_triggers.list_incidents(root) == [inc.dir]
    assert triggers.validate_incident_bundle(inc.dir) == []
    assert jax_triggers.validate_incident_bundle(inc.dir) == []
    with open(os.path.join(inc.dir, triggers.INCIDENT_MANIFEST)) as f:
        man = json.load(f)
    assert jax_triggers.validate_incident_manifest(man) == []
    assert man["status"] == "ok" and man["profile"]["captured"] and man["profile"]["nonempty"]
    assert sorted(man["files"]) == ["chip_hygiene", "flight_tail", "memory", "metrics", "trigger"]
    with open(os.path.join(inc.dir, "chip_hygiene.json")) as f:
        assert "available" in json.load(f)
    with open(os.path.join(inc.dir, "memory.json")) as f:
        assert json.load(f) == {"available": False}
    assert os.listdir(os.path.join(inc.dir, "profile")) == ["trace.pt.trace.json"]
    out = _incident_report(root)
    assert out.returncode == 0, out.stdout + out.stderr


def test_the_capture_slot_is_exclusive(tmp_path):
    assert not profile.capture_active()
    assert profile.try_start_capture(str(tmp_path / "a"), cuda=False)
    try:
        assert profile.capture_active()
        assert not profile.try_start_capture(str(tmp_path / "b"), cuda=False)
        prof = profile.Profiler(str(tmp_path / "p"), {"enable": 1, "target_epoch": 0}, "cpu")
        with pytest.raises(RuntimeError, match="another capture holds the profiler"):
            prof._start()
    finally:
        path = profile.stop_capture()
    assert path == str(tmp_path / "a" / "trace.pt.trace.json") and os.path.getsize(path) > 0
    assert not profile.capture_active() and profile.stop_capture() is None
    assert profile.try_start_capture(str(tmp_path / "c"), cuda=False)
    profile.stop_capture()
    # the Profile's capture holds the slot while it runs: an incident is refused
    prof = profile.Profiler(str(tmp_path / "p"), {"enable": 1, "target_epoch": 0}, "cpu")
    prof._start()
    try:
        assert not profile.try_start_capture(str(tmp_path / "d"), cuda=False)
    finally:
        prof._stop()
    assert not profile.capture_active()


def _flagship_run(tmp_path, monkeypatch, training=None, profile_section=None, loader_wrap=None):
    """run_training / train_with_loaders on the CPU at hidden 8, 2 layers,
    batch 5, 3 epochs, per-step; returns the run's directory."""
    from hydragnn_tpu_torch.api import prepare_loaders_and_config, train_with_loaders
    from hydragnn_tpu_torch.data.synthetic import deterministic_graph_data
    from hydragnn_tpu_torch.flagship import flagship_config
    from hydragnn_tpu_torch.utils.config import get_log_name_config

    cfg = flagship_config(hidden_dim=8, num_conv_layers=2, batch_size=5, num_epoch=3)
    cfg["NeuralNetwork"]["Training"].update(scan_epoch=False, slo_triggers=True, **(training or {}))
    if profile_section is not None:
        cfg["NeuralNetwork"]["Profile"] = profile_section
    samples = deterministic_graph_data(number_configurations=20, seed=0, **UNIT)
    loaders = list(prepare_loaders_and_config(cfg, samples))
    done = loaders.pop()
    if loader_wrap is not None:
        loaders[0] = loader_wrap(loaders[0])
    log_dir = str(tmp_path / "logs") + "/"
    try:
        train_with_loaders(done, *loaders, log_dir=log_dir, device="cpu")
    finally:
        run_dir = os.path.join(log_dir, get_log_name_config(done))
    return run_dir


def test_the_profile_epoch_wins_over_an_incident(tmp_path, monkeypatch):
    """An incident opened at epoch 0's end would capture in epoch 1, the
    Profile's target epoch: it is closed before that epoch starts, with
    no capture, and the Profile's epoch runs with the slot free."""
    monkeypatch.setenv("HGTORCH_INJECT_TRIGGER", "train_loss_spike")
    inject.TRIGGER.reset()
    try:
        run_dir = _flagship_run(tmp_path, monkeypatch, profile_section={"enable": 1, "target_epoch": 1})
    finally:
        inject.TRIGGER.reset()
    (bundle,) = triggers.list_incidents(os.path.join(run_dir, "incidents"))
    with open(os.path.join(bundle, triggers.INCIDENT_MANIFEST)) as f:
        man = json.load(f)
    assert man["status"] == "truncated" and man["profile"]["steps"] == 0 and not man["profile"]["captured"]
    assert triggers.validate_incident_bundle(bundle) == [] == jax_triggers.validate_incident_bundle(bundle)
    assert not profile.capture_active()


class _RaiseAt:
    """A train loader whose epoch ``epoch`` raises after ``after`` batches."""

    def __init__(self, inner, epoch, after):
        self.inner, self.epoch, self.after, self._epoch = inner, epoch, after, 0

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def __len__(self):
        return len(self.inner)

    def set_epoch(self, epoch):
        self._epoch = epoch
        self.inner.set_epoch(epoch)

    def __iter__(self):
        for i, b in enumerate(self.inner):
            if self._epoch == self.epoch and i == self.after:
                raise RuntimeError("injected loader fault")
            yield b


def test_a_crash_mid_incident_leaves_a_readable_bundle(tmp_path, monkeypatch):
    """The run raises in epoch 1 while the incident opened at epoch 0's
    end is capturing: the bundle closes as truncated and validates, the
    flight record ends with ``error`` and ``run_end{failed}``; a bundle
    whose manifest never landed reads as exactly that."""
    monkeypatch.setenv("HGTORCH_INJECT_TRIGGER", "train_loss_spike")
    inject.TRIGGER.reset()
    try:
        with pytest.raises(RuntimeError, match="injected loader fault"):
            _flagship_run(tmp_path, monkeypatch, loader_wrap=lambda ld: _RaiseAt(ld, epoch=1, after=2))
    finally:
        inject.TRIGGER.reset()
    assert not profile.capture_active()
    (run_dir,) = [os.path.join(str(tmp_path / "logs"), d) for d in os.listdir(str(tmp_path / "logs"))]
    (bundle,) = triggers.list_incidents(os.path.join(run_dir, "incidents"))
    with open(os.path.join(bundle, triggers.INCIDENT_MANIFEST)) as f:
        man = json.load(f)
    assert man["status"] == "truncated" and man["profile"]["captured"] and man["profile"]["steps"] == 2
    assert triggers.validate_incident_bundle(bundle) == [] == jax_triggers.validate_incident_bundle(bundle)
    kinds = [e["kind"] for e in read_flight_record(os.path.join(run_dir, "flight.jsonl"))]
    assert kinds[-2:] == ["error", "run_end"] and "incident" in kinds
    # a manifest that never landed: both validators say so, the report tool renders it
    os.remove(os.path.join(bundle, triggers.INCIDENT_MANIFEST))
    want = ["manifest missing (run crashed mid-incident-write?)"]
    assert triggers.validate_incident_bundle(bundle) == want == jax_triggers.validate_incident_bundle(bundle)
    assert _incident_report(os.path.join(run_dir, "incidents")).returncode == 1
