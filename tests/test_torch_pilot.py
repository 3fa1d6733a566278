"""The port's retrain pilot (``hydragnn_tpu_torch/pilot/``) against the
JAX package's (``hydragnn_tpu/pilot/``) on the CPU.

  - The journal: a journal one package writes, the other's ``recover``
    reads, torn tail and all.
  - The state machine: the JAX ``RetrainPilot`` and the port's over the
    same ``FakeServer``/``FakeClock`` stubs (``tests/test_pilot.py``'s)
    and the same tuner, canary and reload outcomes: the journals (less
    ``t``), the ``pilot`` flight events (less ``t``), the five gauges and
    the server's calls are equal, in every case.
  - The numbers: ``_split`` and ``_sample_mae`` equal on seeded inputs;
    the port's ``_score`` within ``SCORE_TOL = 1e-5`` of the JAX one's on
    the same weights and samples (the two forwards are the serving
    parity's, ``rtol=1e-5``).
  - The whole fine-tune: both packages' ``fine_tune`` on the same spool
    shards from serving runs with the same weights, under SGD: the
    candidate's losses at ``LOSS_RTOL = 1e-4`` (the loop parity's) and
    the same ``fine_tune`` manifest block.
  - The child: the tune CLI exits 0, 70 and 78 as the JAX one does;
    ``HGTORCH_INJECT_PILOT_HUNG_TUNE`` under ``max_wall_s`` ends ``hung``;
    a real cycle on the CPU tiny server ends in ``cooldown``, reloaded.
  - The torn reload (``_tear_checkpoint``): a candidate with no versioned
    checkpoints fails to load in both packages; with versioned ones
    (``Training.checkpoint_every``) both restore the newest intact
    version, so the "torn" reload succeeds (ROADMAP C8, copied).
  - The injections, the knobs, ``tools/serve_probe.py --pilot`` on the
    port server's textfile, ``tools/obs_report.py --faults`` on a port
    record, and the JAX validator on it.

The flagship is the JAX fixture's size (hidden 8, 2 conv layers, 24
samples, unit cells 2-3), the JAX weights carried across by
``convert.variables_from_flax``.
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
from hydragnn_tpu.obs.flight import FlightRecorder as JaxFlight
from hydragnn_tpu.obs.flight import read_flight_record as jax_read_flight
from hydragnn_tpu.obs.flight import validate_flight_record as jax_validate_flight
from hydragnn_tpu.obs.registry import MetricsRegistry as JaxRegistry
from hydragnn_tpu.obs.triggers import TriggerVerdict as JaxVerdict
from hydragnn_tpu.pilot import journal as jax_journal
from hydragnn_tpu.pilot import pilot as jax_pilot
from hydragnn_tpu.pilot import tune as jax_tune
from hydragnn_tpu.serve import ModelRegistry as JaxModelRegistry
from hydragnn_tpu.serve import ModelServer as JaxModelServer
from hydragnn_tpu.serve import ServeConfig as JaxServeConfig
from hydragnn_tpu.serve.server import ReloadFailed as JaxReloadFailed

import hydragnn_tpu_torch.pilot as port_pkg
from hydragnn_tpu_torch.api import prepare_config_and_samples
from hydragnn_tpu_torch.convert import variables_from_flax
from hydragnn_tpu_torch.data.synthetic import deterministic_graph_data
from hydragnn_tpu_torch.flagship import flagship_config
from hydragnn_tpu_torch.obs import FlightRecorder, MetricsRegistry, RequestSpool, build_reference
from hydragnn_tpu_torch.obs import read_flight_record, validate_flight_record
from hydragnn_tpu_torch.obs.triggers import TriggerVerdict
from hydragnn_tpu_torch.pilot import journal as port_journal
from hydragnn_tpu_torch.pilot import pilot as port_pilot
from hydragnn_tpu_torch.pilot import tune as port_tune
from hydragnn_tpu_torch.resilience import inject
from hydragnn_tpu_torch.resilience.supervisor import Supervisor, SupervisorPolicy, wall_clock_runner
from hydragnn_tpu_torch.serve import ModelRegistry, ModelServer, ServeConfig, request_to_dict
from hydragnn_tpu_torch.serve.server import ReloadFailed
from hydragnn_tpu_torch.utils.checkpoint import save_model
from hydragnn_tpu_torch.utils.config import save_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HIDDEN, LAYERS, N_SAMPLES, CELLS = 8, 2, 24, (2, 3)
SCORE_TOL = 1e-5
LOSS_RTOL = 1e-4
WAIT = 120

PACKAGES = {
    "jax": dict(pilot=jax_pilot, journal=jax_journal, registry=JaxRegistry, flight=JaxFlight,
                read_flight=jax_read_flight, verdict=JaxVerdict, reload_failed=JaxReloadFailed),
    "port": dict(pilot=port_pilot, journal=port_journal, registry=MetricsRegistry, flight=FlightRecorder,
                 read_flight=read_flight_record, verdict=TriggerVerdict, reload_failed=ReloadFailed),
}


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for name in list(os.environ):
        if name.startswith(("HGTORCH_INJECT_", "HYDRAGNN_INJECT_", "HGTORCH_PILOT_", "HYDRAGNN_PILOT_")):
            monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("HGTORCH_DIAGNOSTICS", "0")
    monkeypatch.setenv("HYDRAGNN_DIAGNOSTICS", "0")


# ---------------------------------------------------------------------------
# the stubs of tests/test_pilot.py, over either package
# ---------------------------------------------------------------------------


class FakeClock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class FakeMetrics:
    def __init__(self, registry_cls):
        self.registry = registry_cls(enabled=True)
        self.prefix = "serve"


class FakeServer:
    """The slice of ModelServer the pilot talks to, with bookkeeping."""

    def __init__(self, log_dir, registry_cls, flight=None):
        self.log_dir = str(log_dir)
        self.flight = flight
        self.metrics = FakeMetrics(registry_cls)
        self.pins = []
        self.unpin_calls = []
        self.drift_resets = 0
        self.pilot_incidents = []

    def pin_spool(self, shards):
        names = [os.path.basename(str(s)) for s in shards]
        self.pins.extend(names)
        return names

    def unpin_spool(self, shards):
        self.unpin_calls.append(list(shards))
        for s in shards:
            if s in self.pins:
                self.pins.remove(s)

    def spool_dir(self):
        return None

    def reset_drift(self):
        self.drift_resets += 1

    def open_pilot_incident(self, verdict):
        self.pilot_incidents.append((verdict.kind, verdict.observed, verdict.threshold, verdict.metric))
        return None


class FakeIncident:
    def __init__(self, root, report, inc_id="inc-1"):
        self.id = inc_id
        self.dir = os.path.join(str(root), inc_id)
        os.makedirs(self.dir, exist_ok=True)
        if report is not None:
            with open(os.path.join(self.dir, "drift_report.json"), "w") as f:
                json.dump(report, f)


class Harness:
    """One package's pilot over the stubs, in its own directory."""

    def __init__(self, pkg, root, **cfg_kw):
        self.pkg = PACKAGES[pkg]
        self.root = root
        self.clock = FakeClock()
        self.flight_path = str(root / "flight.jsonl")
        self.flight = self.pkg["flight"](self.flight_path)
        self.server = FakeServer(root / "logs", self.pkg["registry"], flight=self.flight)
        self.cfg_kw = dict(cooldown_s=30.0, stuck_after=3, **cfg_kw)
        self.tunes, self.reloads = [], []
        self.tuner = lambda c: {"status": "completed"}
        self.canary = lambda c: {"ok": True}
        self.reloader = lambda c: {"ok": True}
        self.pilot = None

    def journal(self):
        return self.pkg["journal"].PilotJournal(str(self.root / "logs" / "run" / self.pkg["journal"].JOURNAL_NAME))

    def make(self):
        def tuner(c):
            self.tunes.append(c)
            return self.tuner(c)

        def reloader(c):
            self.reloads.append(c)
            return self.reloader(c)

        mod = self.pkg["pilot"]
        self.pilot = mod.RetrainPilot(self.server, "run", config=mod.PilotConfig(**self.cfg_kw), tuner=tuner,
                                      reloader=reloader, clock=self.clock, async_cycles=False)
        self.pilot._canary = lambda c: self.canary(c)
        return self.pilot

    def incident(self, inc_id="inc-1", shards=("shard-000001",)):
        inc = FakeIncident(self.root / "incidents", {"pinned_shards": list(shards)}, inc_id=inc_id)
        verdict = self.pkg["verdict"]("serve_feature_drift", "feature_drift", "serve.drift.feature_psi", 0.9, 0.25,
                                      1.0)
        return self.pilot.on_drift_incident(inc, verdict)

    def outcome(self, returned):
        self.flight.close()
        journal = [{k: v for k, v in e.items() if k != "t"} for e in self.journal().entries()]
        events = [{k: v for k, v in e.items() if k != "t"} for e in self.pkg["read_flight"](self.flight_path)
                  if e["kind"] == "pilot"]
        reg = self.server.metrics.registry
        gauges = {g: reg.gauge(f"serve.pilot.{g}").value
                  for g in ("state", "last_cycle_ok", "cycles", "failed_cycles", "suppressed")}
        return dict(returned=returned, journal=journal, events=events, gauges=gauges, status=self.pilot.status(),
                    tunes=self.tunes, reloads=self.reloads, drift_resets=self.server.drift_resets,
                    unpins=self.server.unpin_calls, pins=self.server.pins, pages=self.server.pilot_incidents)


def _case_success(h):
    h.make()
    return [h.incident()]


def _case_storm_in_cooldown(h):
    h.make()
    out = [h.incident()]
    out += [h.incident(inc_id=f"storm-{i}") for i in range(3)]
    h.clock.advance(31.0)
    out.append(h.incident(inc_id="later"))
    return out


def _case_incident_during_cycle(h):
    inner = []

    def tuner(c):
        inner.append(h.incident(inc_id="inner"))
        return {"status": "completed"}

    h.tuner = tuner
    h.make()
    return [h.incident(), inner]


def _case_tuner_gave_up(h):
    h.tuner = lambda c: {"status": "gave_up", "attempts": 3, "cause": "crash"}
    h.make()
    return [h.incident()]


def _case_tuner_raised(h):
    def tuner(c):
        raise RuntimeError("supervisor exploded")

    h.tuner = tuner
    h.make()
    return [h.incident()]


def _case_canary_regression(h):
    h.canary = lambda c: {"ok": False, "reference": {"baseline_mae": 0.1, "candidate_mae": 9.0, "passed": False},
                          "window": None}
    h.make()
    return [h.incident()]


def _case_reload_failed(h):
    def reloader(c):
        raise h.pkg["reload_failed"]("canary rejected torn checkpoint")

    h.reloader = reloader
    h.make()
    return [h.incident()]


def _case_stuck_after_k(h):
    h.cfg_kw.update(stuck_after=2, cooldown_s=10.0)
    h.tuner = lambda c: {"status": "gave_up", "cause": "crash"}
    h.make()
    out = [h.incident(inc_id="a")]
    h.clock.advance(11.0)
    out.append(h.incident(inc_id="b"))
    h.clock.advance(1000.0)
    out += [h.incident(inc_id="c"), h.pilot.poll()]
    return out


def _case_crash_mid_cycle(h):
    j = h.journal()
    j.append("drift_confirmed", 2, 0)
    j.append("fine_tuning", 2, 0, candidate="run-pilot-c2")
    with open(j.path, "a") as f:
        f.write('{"t": 9.9, "state": "fi')  # killed mid-append
    h.make()
    out = [h.pilot.poll()]
    h.clock.advance(31.0)
    out += [h.pilot.poll(), h.incident()]
    return out


def _case_crash_escalates(h):
    h.journal().append("canary", 5, 2)  # two failures burned already
    h.make()
    return [h.pilot.poll()]


def _case_recovered_stuck(h):
    h.journal().append("stuck", 7, 3)
    h.make()
    return [h.pilot.poll(), h.incident()]


def _case_recovered_cooldown(h):
    h.journal().append("cooldown", 1, 1, reason="canary_regression")
    h.make()
    out = [h.pilot.poll()]
    h.clock.advance(29.0)
    out.append(h.pilot.poll())
    h.clock.advance(1.1)
    out += [h.pilot.poll(), h.incident()]
    return out


CASES = {
    "success": _case_success,
    "storm_in_cooldown": _case_storm_in_cooldown,
    "incident_during_cycle": _case_incident_during_cycle,
    "tuner_gave_up": _case_tuner_gave_up,
    "tuner_raised": _case_tuner_raised,
    "canary_regression": _case_canary_regression,
    "reload_failed": _case_reload_failed,
    "stuck_after_k": _case_stuck_after_k,
    "crash_mid_cycle": _case_crash_mid_cycle,
    "crash_escalates": _case_crash_escalates,
    "recovered_stuck": _case_recovered_stuck,
    "recovered_cooldown": _case_recovered_cooldown,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_state_machine_equals_jax(case, tmp_path):
    got = {}
    for pkg in ("jax", "port"):
        (tmp_path / pkg).mkdir()
        h = Harness(pkg, tmp_path / pkg)
        got[pkg] = h.outcome(CASES[case](h))
    assert got["port"] == got["jax"]
    assert got["port"]["journal"], "the case journaled nothing"


def test_pins_held_through_cycle_released_after(tmp_path):
    held = {}
    for pkg in ("jax", "port"):
        (tmp_path / pkg).mkdir()
        h = Harness(pkg, tmp_path / pkg)
        h.tuner = lambda c, h=h, pkg=pkg: held.setdefault(pkg, list(h.server.pins)) and {"status": "completed"}
        h.make()
        h.incident(shards=("shard-000003", "shard-000004"))
        assert h.server.pins == []
        assert h.server.unpin_calls == [["shard-000003", "shard-000004"]]
        assert h.pilot.status()["pinned_shards"] == []
    assert held["port"] == held["jax"] == ["shard-000003", "shard-000004"]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_journal_reads_across_packages(writer, tmp_path):
    reader = "port" if writer == "jax" else "jax"
    path = str(tmp_path / "j.jsonl")
    w = PACKAGES[writer]["journal"].PilotJournal(path)
    r = PACKAGES[reader]["journal"].PilotJournal(path)
    assert r.recover() == {"status": "fresh"}
    w.append("idle", 0, 0, reason="fresh")
    w.append("drift_confirmed", 1, 0, rule="r", pinned_shards=["shard-000001"])
    assert r.recover() == {"status": "crashed_mid_cycle", "state": "drift_confirmed", "cycle": 1,
                           "failed_cycles": 0}
    with open(path, "a") as f:
        f.write('{"t": 1.0, "state": "can')  # a torn tail
    assert [e["state"] for e in r.entries()] == ["idle", "drift_confirmed"]
    r.append("cooldown", 1, 1, reason="canary_regression")  # starts on a fresh line
    for j in (w, r):
        assert j.recover() == {"status": "clean", "state": "cooldown", "cycle": 1, "failed_cycles": 1}
        assert [e["state"] for e in j.entries()] == ["idle", "drift_confirmed", "cooldown"]
    assert port_journal.RESTING_STATES == jax_journal.RESTING_STATES
    assert port_journal.MID_CYCLE_STATES == jax_journal.MID_CYCLE_STATES
    assert port_journal.JOURNAL_NAME == jax_journal.JOURNAL_NAME


@pytest.mark.parametrize("n", [3, 4, 10, 24, 37])
def test_split_equals_jax(n):
    assert port_tune._split(list(range(n))) == jax_tune._split(list(range(n)))


def test_split_refuses_fewer_than_three():
    for split in (port_tune._split, jax_tune._split):
        with pytest.raises(ValueError):
            split([0, 1])


def test_sample_mae_equals_jax():
    from hydragnn_tpu.data.dataset import GraphSample as JaxSample
    from hydragnn_tpu_torch.data.dataset import GraphSample

    rng = np.random.default_rng(0)
    for _ in range(5):
        n = int(rng.integers(2, 9))
        fields = dict(x=np.zeros((n, 2), np.float32), pos=np.zeros((n, 3), np.float32),
                      edge_index=np.zeros((2, n), np.int32),
                      graph_targets={"energy": rng.normal(size=(1,)).astype(np.float32)},
                      node_targets={"forces": rng.normal(size=(n, 1)).astype(np.float32)})
        result = {"energy": rng.normal(size=(1,)), "forces": rng.normal(size=(n, 1)), "mystery": np.asarray([9.9])}
        assert port_pilot._sample_mae(result, GraphSample(**fields)) == jax_pilot._sample_mae(result, JaxSample(**fields))
    assert port_pilot._sample_mae({"mystery": np.asarray([1.0])}, GraphSample(**fields)) == 0.0


def test_states_codes_and_package_surface_equal_jax():
    assert port_pilot.PILOT_STATES == jax_pilot.PILOT_STATES
    assert port_pilot.STATE_CODES == jax_pilot.STATE_CODES
    assert sorted(port_pkg.__all__) == sorted(__import__("hydragnn_tpu.pilot", fromlist=["x"]).__all__)


def test_pilot_config_defaults_and_knobs_equal_jax(monkeypatch):
    port_fields = [f.name for f in dataclasses.fields(port_pilot.PilotConfig)]
    assert port_fields == [f.name for f in dataclasses.fields(jax_pilot.PilotConfig)]
    assert dataclasses.asdict(port_pilot.PilotConfig()) == dataclasses.asdict(jax_pilot.PilotConfig())
    knobs = {"cooldown_s": "COOLDOWN_S", "stuck_after": "STUCK_AFTER", "tune_attempts": "TUNE_ATTEMPTS",
             "tune_backoff_s": "TUNE_BACKOFF_S", "max_wall_s": "MAX_WALL_S", "canary_samples": "CANARY_SAMPLES",
             "canary_tol": "CANARY_TOL", "tune_epochs": "TUNE_EPOCHS"}
    assert sorted(knobs) == sorted(port_fields)
    for i, (field, knob) in enumerate(knobs.items()):
        monkeypatch.setenv(f"HGTORCH_PILOT_{knob}", str(7 + i))
        monkeypatch.setenv(f"HYDRAGNN_PILOT_{knob}", str(7 + i))
    assert dataclasses.asdict(port_pilot.PilotConfig()) == dataclasses.asdict(jax_pilot.PilotConfig())
    assert port_pilot.PilotConfig().stuck_after == 8


def test_pilot_injections_are_registered_and_stripped(monkeypatch):
    src = open(os.path.join(REPO, "hydragnn_tpu_torch", "pilot", "pilot.py")).read()
    src += open(os.path.join(REPO, "hydragnn_tpu_torch", "pilot", "tune.py")).read()
    src += open(os.path.join(REPO, "hydragnn_tpu_torch", "resilience", "inject.py")).read()
    import re

    literals = set(re.findall(r"HGTORCH_INJECT_PILOT_[A-Z_]+", src))
    assert literals == {f"HGTORCH_INJECT_PILOT_{s}" for s in ("TRAIN_CRASH", "HUNG_TUNE", "CANARY_REGRESS",
                                                              "TORN_RELOAD")}
    assert literals <= set(inject.INJECTIONS)
    env = {name: "1" for name in literals}
    env["PATH"] = "/bin"
    assert inject.strip_injection_env(env) == {"PATH": "/bin"}
    assert sorted(inject.active_injections(env=env)) == sorted(literals)
    for name in literals:
        monkeypatch.setenv(name, "1")
    assert inject.pilot_train_crashes() == 1 and inject.pilot_canary_regress() and inject.pilot_torn_reload()


# ---------------------------------------------------------------------------
# real models: the canary's scores, the fine-tune, the child, the cycle
# ---------------------------------------------------------------------------


def _raw():
    return deterministic_graph_data(number_configurations=N_SAMPLES, unit_cell_x_range=CELLS,
                                    unit_cell_y_range=CELLS, unit_cell_z_range=CELLS, seed=0)


def _training(cfg):
    t = cfg["NeuralNetwork"]["Training"]
    t["Optimizer"] = {"type": "SGD", "learning_rate": 0.05}
    t["batch_size"] = 4
    return cfg


@pytest.fixture(scope="module")
def setup():
    """The JAX fixture's model and samples, the port's served model with
    the same weights, and both packages' resolved configs under SGD."""
    jcfg, jmodel, jvars, loader = build_flagship(n_samples=N_SAMPLES, hidden_dim=HIDDEN, num_conv_layers=LAYERS,
                                                 batch_size=4, unit_cells=CELLS)
    tr, _, _, cfg = prepare_config_and_samples(flagship_config(HIDDEN, LAYERS, 4), _raw())
    served = ModelRegistry(device="cpu").register("pilot_smoke", cfg["NeuralNetwork"], variables_from_flax(jvars))
    return {"cfg": _training(cfg), "jcfg": _training(jcfg), "jmodel": jmodel, "jvars": jvars, "served": served,
            "samples": list(tr), "jsamples": list(loader.all_samples)}


def _save_runs(setup, log_dir, run="run", checkpoint_every=0):
    """The serving run on disk in both packages: ``<log_dir>/{jax,port}/<run>``."""
    from hydragnn_tpu.train import create_train_state, select_optimizer
    from hydragnn_tpu.utils.checkpoint import save_model as jax_save_model
    from hydragnn_tpu.utils.config import save_config as jax_save_config

    jcfg, cfg = json.loads(json.dumps(setup["jcfg"])), json.loads(json.dumps(setup["cfg"]))
    for c in (jcfg, cfg):
        if checkpoint_every:
            c["NeuralNetwork"]["Training"]["checkpoint_every"] = checkpoint_every
    jdir, pdir = os.path.join(log_dir, "jax") + "/", os.path.join(log_dir, "port") + "/"
    state = create_train_state(setup["jvars"], select_optimizer(jcfg["NeuralNetwork"]["Training"]))
    jax_save_model(state, run, jdir)
    jax_save_config(jcfg, run, jdir)
    save_model(setup["served"].model, run, pdir)
    save_config(cfg, run, pdir)
    return jdir, pdir


def _spool(setup, root, n=20):
    """Spool shards of the served answers to ``n`` samples (the port's
    spool; its shards are the JAX package's bytes)."""
    spool = RequestSpool(str(root), sample_every=1, shard_mb=0.002, max_mb=64.0,
                         head_kinds={"sum_x_x2_x3": "graph", "x": "node", "x2": "node", "x3": "node"})
    model = setup["served"].model
    from hydragnn_tpu_torch.graph.batch import batch_graphs

    for i, s in enumerate(setup["samples"][:n]):
        g = request_to_dict(s)
        with torch.inference_mode():
            outs = model(batch_graphs([g]), train=False)
        nn_ = g["x"].shape[0]
        result = {name: (o[0] if kind == "graph" else o[:nn_]).numpy()
                  for o, name, kind in zip(outs, model.cfg.output_names, model.cfg.output_type)}
        spool.offer(g, result, seq=i)
    spool.finalize()
    from hydragnn_tpu_torch.obs.spool import list_shards

    return [os.path.basename(p) for p in list_shards(str(root))]


def test_fine_tune_history_equals_jax(setup, tmp_path, monkeypatch):
    """Both packages' ``fine_tune`` from serving runs with the same weights
    on the same spool shards, SGD, 2 epochs: the same losses (rtol 1e-4)
    and the same ``fine_tune`` manifest block."""
    import hydragnn_tpu.train as jax_train
    import hydragnn_tpu_torch.train.loop as port_loop

    jdir, pdir = _save_runs(setup, str(tmp_path))
    shards = _spool(setup, tmp_path / "spool")
    assert len(shards) >= 2
    hist = {}

    def capture(side, fn):
        def wrapped(*a, **kw):
            out = fn(*a, **kw)
            hist[side] = out[1] if side == "jax" else out
            return out

        return wrapped

    monkeypatch.setattr(jax_train, "train_validate_test", capture("jax", jax_train.train_validate_test))
    monkeypatch.setattr(port_loop, "train_validate_test", capture("port", port_loop.train_validate_test))
    spool_dir = str(tmp_path / "spool")
    jout = jax_tune.fine_tune(jdir, "run", "run-pilot-c1", spool_dir=spool_dir, shards=shards, epochs=2)
    out = port_tune.fine_tune(pdir, "run", "run-pilot-c1", spool_dir=spool_dir, shards=shards, epochs=2,
                              device="cpu")
    assert out == jout
    assert sum(out["splits"]) == out["num_samples"] == len(setup["samples"][:20]) and out["epochs"] == 2
    for key in ("train_loss", "val_loss", "test_loss"):
        assert len(hist["port"][key]) == 2
        np.testing.assert_allclose(hist["port"][key], hist["jax"][key], rtol=LOSS_RTOL, err_msg=key)
    blocks = []
    for d, reader in ((jdir, jax_read_flight), (pdir, read_flight_record)):
        start = next(e for e in reader(os.path.join(d, "run-pilot-c1", "flight.jsonl")) if e["kind"] == "run_start")
        blocks.append(start["manifest"]["fine_tune"])
    assert blocks[1] == {**blocks[0], "spool_dir": spool_dir} == blocks[0]
    # the serving checkpoint was never written
    assert os.path.exists(os.path.join(pdir, "run-pilot-c1", "run-pilot-c1.pt"))
    assert os.path.exists(os.path.join(pdir, "run-pilot-c1", "config.json"))


def test_score_equals_jax(setup, tmp_path):
    """The port's ``_score`` (the live weights' eager forward through the
    server's cache, and a candidate module's) within 1e-5 of the JAX
    one's on the same weights and samples."""
    samples = setup["samples"][:6]
    server = ModelServer(setup["served"], setup["samples"], ServeConfig(max_batch=4))
    jserved = JaxModelRegistry().register("pilot_smoke", setup["jmodel"], setup["jvars"])
    jserver = JaxModelServer(jserved, setup["jsamples"], JaxServeConfig(max_batch=4))
    server.log_dir = jserver.log_dir = str(tmp_path)
    cfg = dict(canary_samples=5)
    p = port_pilot.RetrainPilot(server, "run", config=port_pilot.PilotConfig(**cfg), async_cycles=False,
                                tuner=lambda c: {}, reloader=lambda c: None)
    j = jax_pilot.RetrainPilot(jserver, "run", config=jax_pilot.PilotConfig(**cfg), async_cycles=False,
                               tuner=lambda c: {}, reloader=lambda c: None)
    want = j._score(setup["jvars"], samples)
    got = p._score(None, samples)
    assert want > 0 and abs(got - want) <= SCORE_TOL * max(1.0, abs(want)), (got, want)
    assert abs(p._score(setup["served"].model, samples) - want) <= SCORE_TOL * max(1.0, abs(want))


def _tune_cli(args, env_extra=None, timeout=240):
    env = {k: v for k, v in os.environ.items() if not k.startswith("HGTORCH_INJECT_")}
    env.update(env_extra or {})
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, "-m", "hydragnn_tpu_torch.pilot.tune", *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize("rc", [0, 70, 78])
def test_tune_cli_exit_codes_equal_jax(rc, setup, tmp_path, monkeypatch):
    jdir, pdir = _save_runs(setup, str(tmp_path))
    spool_dir = str(tmp_path / "spool")
    _spool(setup, spool_dir, n=8)
    serving = "missing-run" if rc == 78 else "run"
    if rc == 70:
        monkeypatch.setenv("HYDRAGNN_INJECT_PILOT_TRAIN_CRASH", "1")
    common = ["--serving-run", serving, "--candidate", "cand", "--spool-dir", spool_dir, "--epochs", "1"]
    assert jax_tune.main(["--log-dir", jdir, *common]) == rc
    r = _tune_cli(["--log-dir", pdir, *common, "--device", "cpu"],
                  {"HGTORCH_INJECT_PILOT_TRAIN_CRASH": "1"} if rc == 70 else None)
    assert r.returncode == rc, r.stderr[-2000:]
    if rc == 0:
        assert json.loads(r.stdout.strip().splitlines()[-1])["candidate"] == "cand"
        assert os.path.exists(os.path.join(pdir, "cand", "cand.pt"))


def test_hung_tune_is_killed_and_classified_hung(tmp_path):
    argv = [sys.executable, "-m", "hydragnn_tpu_torch.pilot.tune", "--log-dir", str(tmp_path), "--serving-run",
            "run", "--candidate", "cand", "--device", "cpu"]
    env = dict(os.environ, HGTORCH_INJECT_PILOT_HUNG_TUNE="600", PYTHONPATH=REPO)
    t0 = time.monotonic()
    out = Supervisor(argv, policy=SupervisorPolicy(max_restarts=0), env=env, runner=wall_clock_runner(8.0)).run()
    assert out["status"] == "gave_up" and out["cause"] == "hung" and out["exit_code"] == 79
    assert time.monotonic() - t0 < 60


def _write_versions(setup, log_dir, run):
    """A candidate as ``fine_tune`` leaves it under ``checkpoint_every``:
    versioned checkpoints from the loop, then the final pointer."""
    from hydragnn_tpu.train import create_train_state, select_optimizer
    from hydragnn_tpu.utils.checkpoint import save_model as jax_save_model

    state = create_train_state(setup["jvars"], select_optimizer(setup["jcfg"]["NeuralNetwork"]["Training"]))
    jax_save_model(state, run, os.path.join(log_dir, "jax") + "/", keep_last=3)
    jax_save_model(state, run, os.path.join(log_dir, "jax") + "/")
    opt = torch.optim.SGD(setup["served"].model.parameters(), lr=0.05)
    opt.steps = 0
    save_model(setup["served"].model, run, os.path.join(log_dir, "port") + "/", optimizer=opt, keep_last=3)
    save_model(setup["served"].model, run, os.path.join(log_dir, "port") + "/")


@pytest.mark.parametrize("versioned", [False, True], ids=["pointer_only", "checkpoint_every"])
def test_torn_candidate_reload_in_both_packages(versioned, setup, tmp_path):
    """``PILOT_TORN_RELOAD`` truncates the candidate's pointer. With the
    pointer alone (the flagship's config) both packages' validating
    loaders refuse it, so the reload fails and the old weights serve.
    With versioned checkpoints both restore the newest intact version,
    and the "torn" reload goes through: ROADMAP C8, the reference's own,
    copied."""
    from hydragnn_tpu.serve.registry import load_served_variables as jax_load

    from hydragnn_tpu_torch.serve.registry import load_served_variables

    if versioned:
        _write_versions(setup, str(tmp_path), "cand")
    else:
        _save_runs(setup, str(tmp_path), run="cand")
    jax_pilot._tear_checkpoint(str(tmp_path / "jax"), "cand")
    port_pilot._tear_checkpoint(str(tmp_path / "port"), "cand")
    jserved = JaxModelRegistry().register("pilot_smoke", setup["jmodel"], setup["jvars"],
                                          nn_config=setup["jcfg"]["NeuralNetwork"])
    outcomes = {}
    for side, load, served in (("jax", jax_load, jserved), ("port", load_served_variables, setup["served"])):
        try:
            load(served, "cand", str(tmp_path / side) + "/")
            outcomes[side] = "loaded"
        except Exception as exc:  # the validating loader's refusal, and nothing else
            assert isinstance(exc, (ValueError, RuntimeError, EOFError, OSError)) or "msgpack" in repr(exc) \
                or "Unpickl" in repr(exc), repr(exc)
            outcomes[side] = "refused"
    want = "loaded" if versioned else "refused"
    assert outcomes == {"jax": want, "port": want}


def _pilot_server(setup, tmp_path, flight):
    ref_path = tmp_path / "ref.json"
    ref_path.write_text(json.dumps(build_reference(setup["samples"])))
    cfg = ServeConfig(max_batch=4, max_delay_ms=5.0, slo_p99_ms=60_000.0, trigger_eval_every_s=0.05,
                      incident_dir=str(tmp_path / "inc"), spool=True, spool_sample=1,
                      spool_dir=str(tmp_path / "spool"), drift_ref=str(ref_path), drift_min_count=400,
                      drift_pred_psi=None)
    served = ModelRegistry(device="cpu").register("pilot_smoke", setup["cfg"]["NeuralNetwork"],
                                                  variables_from_flax(setup["jvars"]))
    server = ModelServer(served, setup["samples"], cfg, flight=flight)
    server.log_dir = str(tmp_path / "logs") + "/"
    save_model(served.model, "run", server.log_dir)
    save_config(setup["cfg"], "run", server.log_dir)
    return server


def test_real_cycle_on_the_cpu_server_reloads(setup, tmp_path, monkeypatch):
    """A shift of 5.0 opens one feature_drift incident; the pilot's
    default tuner runs the real supervised child on the CPU; the
    candidate passes the canary and is reloaded: the journal holds the
    five transitions, the server answers on the candidate's weights, the
    serving checkpoint is unchanged, and the record passes both
    validators and ``tools/obs_report.py --faults``."""
    monkeypatch.setenv("HGTORCH_INJECT_DRIFT", "5.0")
    flight_path = str(tmp_path / "flight.jsonl")
    server = _pilot_server(setup, tmp_path, FlightRecorder(flight_path))
    ckpt = os.path.join(server.log_dir, "run", "run.pt")
    before = open(ckpt, "rb").read()
    pilot = port_pilot.RetrainPilot(server, "run", reference_samples=setup["samples"][:8],
                                    config=port_pilot.PilotConfig(tune_epochs=1, max_wall_s=200.0))
    server.attach_pilot(pilot)
    requests = [request_to_dict(s) for s in setup["samples"][:20]]
    with server:
        answers = [server.predict(r, timeout=WAIT) for r in requests]
        deadline = time.monotonic() + 200
        while pilot.poll() in ("idle", "drift_confirmed", "fine_tuning", "canary", "reloading") \
                and time.monotonic() < deadline:
            if pilot.state == "idle":
                server.predict(requests[0], timeout=WAIT)
            time.sleep(0.05)
        pilot.join(timeout=WAIT)
        after = server.predict(requests[0], timeout=WAIT)
        prom = str(tmp_path / "serve.prom")
        server.export_prometheus(prom)
    assert len(answers) == len(requests)
    states = [e["state"] for e in pilot.journal.entries()]
    assert states == ["idle", "drift_confirmed", "fine_tuning", "canary", "reloading", "cooldown"], states
    tail = pilot.journal.last()["detail"]
    assert tail["reason"] == "reloaded" and tail["candidate"] == "run-pilot-c1"
    assert tail["reference"]["passed"] and tail["window"]["passed"]
    assert open(ckpt, "rb").read() == before
    # the server answers on the candidate's weights
    from hydragnn_tpu_torch.graph.batch import batch_graphs
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.serve.registry import load_served_variables

    cand = create_model(server.served.cfg, device="cpu")
    cand.load_state_dict(load_served_variables(server.served, "run-pilot-c1", server.log_dir))
    g = dict(requests[0], x=inject.maybe_drift_shift(requests[0]["x"]))
    with torch.inference_mode():
        want = cand(batch_graphs([g]), train=False)
    n = g["x"].shape[0]
    for o, name, kind in zip(want, cand.cfg.output_names, cand.cfg.output_type):
        np.testing.assert_allclose(after[name], (o[0] if kind == "graph" else o[:n]).numpy(), rtol=1e-5, atol=1e-6)
    events = read_flight_record(flight_path)
    assert validate_flight_record(flight_path) == [] and jax_validate_flight(events) == []
    assert [e["state"] for e in events if e["kind"] == "pilot"][-1] == "cooldown"
    assert not [e for e in events if e["kind"] == "error"]
    r = subprocess.run([sys.executable, "tools/obs_report.py", "--faults", flight_path], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and "[pilot] state=cooldown" in r.stdout and "pilot_cycles=1" in r.stdout, r.stdout
    # tools/serve_probe.py --pilot on the server's textfile: the last cycle ok
    r = subprocess.run([sys.executable, "tools/serve_probe.py", "--prom", prom, "--pilot"], cwd=REPO,
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == 0, r.stdout + r.stderr


def _probe():
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import serve_probe

        return serve_probe
    finally:
        sys.path.pop(0)


def test_serve_probe_reads_the_port_pilot_gauges(setup, tmp_path):
    """``tools/serve_probe.py``'s state table is the port's, and its
    ``--pilot`` exit codes 0, 1 and 2 follow the port server's textfile
    with a pilot attached (idle, failed, stuck) and without one."""
    sp = _probe()
    assert tuple(sp._PILOT_STATES) == port_pilot.PILOT_STATES
    assert sp._PILOT_STUCK == port_pilot.STATE_CODES["stuck"]
    server = ModelServer(setup["served"], setup["samples"], ServeConfig(max_batch=4))
    server.log_dir = str(tmp_path)
    prom = str(tmp_path / "serve.prom")
    server.export_prometheus(prom)
    assert sp.probe_pilot(prom)[0] == 2  # no pilot attached
    pilot = port_pilot.RetrainPilot(server, "run", config=port_pilot.PilotConfig(stuck_after=1), async_cycles=False,
                                    tuner=lambda c: {"status": "gave_up", "cause": "crash"})
    server.attach_pilot(pilot)
    server.export_prometheus(prom)
    rc, msg = sp.probe_pilot(prom)
    assert rc == 0 and "idle" in msg
    inc = FakeIncident(tmp_path / "inc", {"pinned_shards": []})
    pilot.on_drift_incident(inc, TriggerVerdict("r", "feature_drift", "m", 1.0, 0.5, 0.0))
    server.export_prometheus(prom)
    rc, msg = sp.probe_pilot(prom)
    assert rc == 1 and "STUCK" in msg


def test_canary_regress_injection_rejects_the_candidate(setup, tmp_path, monkeypatch):
    """``HGTORCH_INJECT_PILOT_CANARY_REGRESS`` on a real canary: the
    candidate (the serving weights themselves) is rejected and nothing
    is reloaded; without it the same candidate passes with equal MAEs."""
    _, pdir = _save_runs(setup, str(tmp_path), run="run-pilot-c1")
    server = ModelServer(setup["served"], setup["samples"], ServeConfig(max_batch=4))
    server.log_dir = pdir
    pilot = port_pilot.RetrainPilot(server, "run", reference_samples=setup["samples"][:4], async_cycles=False)
    ok = pilot._canary("run-pilot-c1")
    assert ok["ok"] and ok["reference"]["baseline_mae"] == ok["reference"]["candidate_mae"] and ok["window"] is None
    monkeypatch.setenv("HGTORCH_INJECT_PILOT_CANARY_REGRESS", "1")
    bad = pilot._canary("run-pilot-c1")
    assert not bad["ok"] and not bad["reference"]["passed"]


def test_canary_builds_its_model_under_the_device_lock(setup, tmp_path, monkeypatch):
    """The canary's scratch model is built and loaded under the shared
    side of ``serve/buckets.py:DEVICE_LOCK``, as a fleet spawn's is:
    never beside a capture on the same card."""
    from hydragnn_tpu_torch.serve import buckets

    _, pdir = _save_runs(setup, str(tmp_path), run="run-pilot-c1")
    server = ModelServer(setup["served"], setup["samples"], ServeConfig(max_batch=4))
    server.log_dir = pdir
    pilot = port_pilot.RetrainPilot(server, "run", reference_samples=setup["samples"][:2], async_cycles=False)
    held = []
    create, load = buckets.create_model, torch.nn.Module.load_state_dict
    monkeypatch.setattr(buckets, "create_model",
                        lambda *a, **kw: (held.append(("create", buckets.DEVICE_LOCK._shared > 0)),
                                          create(*a, **kw))[1])
    monkeypatch.setattr(torch.nn.Module, "load_state_dict",
                        lambda self, *a, **kw: (held.append(("load", buckets.DEVICE_LOCK._shared > 0)),
                                                load(self, *a, **kw))[1])
    assert pilot._canary("run-pilot-c1")["ok"]
    # before them, the validating read loads the candidate into a host
    # scratch model (serve/registry.py), which touches no card
    assert held[-2:] == [("create", True), ("load", True)] and [h for h in held if h[0] == "create"] == held[-2:-1]
