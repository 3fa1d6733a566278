"""The port's serving fleet (``hydragnn_tpu_torch/fleet/``) against the JAX
package's (``hydragnn_tpu/fleet/``) on the CPU, and held to
``docs/FLEET.md`` where the JAX tests are red (ROADMAP C2).

  - The controller: ``tests/test_fleet.py``'s decision cases (sustained
    breach, cooldown, hold at the cap, quiet scale-down, the quiet timer
    reset, reap during cooldown, failures as decisions, decisions as
    flight events) through both packages' ``FleetController`` over the
    same stub fleet and fake clock: equal decisions and calls.
  - The router: quota, shed, placement and the death retry through both
    packages' ``FleetRouter`` over the same stub replicas: equal
    placements, typed rejections and counters.
  - The fleet on the CPU tiny flagship (the JAX fixture's size: hidden 8,
    2 conv layers, 24 samples, the JAX weights carried across by
    ``convert.variables_from_flax``): answers within ``TOL`` (rtol 1e-5,
    atol 1e-6, the serving parity's) of the JAX fleet's; kill, then the
    controller's replace; the roll aborted mid-roll; the same weights
    rolled bit-identically (the three red JAX cases, passing here); each
    replica owns its weights (a roll to other weights leaves r1 on the
    old ones until its turn, and a reload on r0 changes none of r1's
    answers: ROADMAP C7 is the JAX fleet's shared weights); a quiet
    scale-down drops no request; the probes through
    ``tools/serve_probe.py --fleet``; a failed spawn raises
    ``ReplicaFailed`` and is an ``up_failed`` decision; a spawn or a
    scale-down asked for during a roll waits for it, so the new replica
    serves the roll's weights and the roll loses no replica.
  - The process-wide device lock (``serve/buckets.py:DEVICE_LOCK``):
    its exclusive side waits for the shared one and bars new shared
    holders; every module build holds its shared side, and a run, an
    eager forward and a weight write wait while a capture holds its
    exclusive side.
"""

import dataclasses
import os
import subprocess
import sys
import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from hydragnn_tpu import fleet as jax_fleet
from hydragnn_tpu.flagship import build_flagship
from hydragnn_tpu.obs.flight import FlightRecorder as JaxFlight
from hydragnn_tpu.obs.flight import read_flight_record as jax_read_flight
from hydragnn_tpu.obs.flight import validate_flight_record as jax_validate_flight
from hydragnn_tpu.obs.registry import MetricsRegistry as JaxRegistry
from hydragnn_tpu.serve import ModelRegistry as JaxModelRegistry
from hydragnn_tpu.serve import Overloaded as JaxOverloaded
from hydragnn_tpu.serve import ServeConfig as JaxServeConfig
from hydragnn_tpu.serve.server import RequestFailed as JaxRequestFailed

from hydragnn_tpu_torch import fleet as port_fleet
from hydragnn_tpu_torch.api import prepare_config_and_samples
from hydragnn_tpu_torch.convert import variables_from_flax
from hydragnn_tpu_torch.data.synthetic import deterministic_graph_data
from hydragnn_tpu_torch.flagship import flagship_config
from hydragnn_tpu_torch.fleet import ControllerConfig, Fleet, FleetController, ReplicaFailed
from hydragnn_tpu_torch.obs import FlightRecorder, MetricsRegistry, read_flight_record, validate_flight_record
from hydragnn_tpu_torch.serve import ModelRegistry, Overloaded, ServeConfig, request_to_dict
from hydragnn_tpu_torch.serve import buckets
from hydragnn_tpu_torch.serve.buckets import SharedExclusiveLock
from hydragnn_tpu_torch.serve.server import ReloadFailed, RequestFailed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-6)
HIDDEN, LAYERS, N_SAMPLES, CELLS = 8, 2, 24, (2, 3)
WAIT = 120

PACKAGES = {
    "jax": dict(fleet=jax_fleet, registry=JaxRegistry, flight=JaxFlight, read_flight=jax_read_flight,
                overloaded=JaxOverloaded, request_failed=JaxRequestFailed),
    "port": dict(fleet=port_fleet, registry=MetricsRegistry, flight=FlightRecorder, read_flight=read_flight_record,
                 overloaded=Overloaded, request_failed=RequestFailed),
}


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for name in list(os.environ):
        if name.startswith(("HGTORCH_INJECT_", "HYDRAGNN_INJECT_", "HGTORCH_FLEET_", "HYDRAGNN_FLEET_")):
            monkeypatch.delenv(name, raising=False)


class FakeClock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


# ---------------------------------------------------------------------------
# the controller (tests/test_fleet.py's stub fleet), both packages
# ---------------------------------------------------------------------------


class FakeFleet:
    """A duck-typed fleet: the scaling verbs record their calls."""

    def __init__(self, replicas: int = 1, load: int = 0):
        self.n = replicas
        self.load = load
        self.dead: list = []
        self.calls: list = []
        self.fail_scale_up = False
        self.fail_replace = False

    def replica_count(self) -> int:
        return self.n

    def dead_replicas(self) -> list:
        return list(self.dead)

    def total_load(self) -> int:
        return self.load

    def scale_up(self, reason: str = "manual") -> str:
        self.calls.append(("up", reason))
        if self.fail_scale_up:
            raise RuntimeError("spawn exploded")
        self.n += 1
        return f"r{self.n}"

    def scale_down(self, reason: str = "manual", timeout=None) -> str:
        self.calls.append(("down", reason))
        self.n -= 1
        return "r0"

    def replace(self, name: str, reason: str = "dead_replica") -> str:
        self.calls.append(("replace", name))
        if self.fail_replace:
            raise RuntimeError("respawn exploded")
        self.dead.remove(name)
        return f"{name}bis"


def _controller(pkg, fleet, clk, flight=None, **cfg_kw):
    mod = PACKAGES[pkg]["fleet"]
    reg = PACKAGES[pkg]["registry"]()
    gauge = reg.gauge("fleet.queue_depth")
    defaults = dict(min_replicas=1, max_replicas=3, cooldown_s=60.0, quiet_for_s=120.0, eval_every_s=1.0,
                    breach_evals=2, slo_queue_depth=8.0)
    defaults.update(cfg_kw)
    return mod.FleetController(fleet, registry=reg, config=mod.ControllerConfig(**defaults), flight=flight,
                               clock=clk), gauge


def _sustained_breach(pkg):
    fleet, clk = FakeFleet(1), FakeClock()
    ctl, gauge = _controller(pkg, fleet, clk)
    gauge.set(20)
    out = [ctl.step()]
    clk.advance(1.0)
    out.append(ctl.step())
    return fleet, ctl, out


def _cooldown_rearms(pkg):
    fleet, clk = FakeFleet(1), FakeClock()
    ctl, gauge = _controller(pkg, fleet, clk)
    gauge.set(20)
    out = [ctl.step()]
    clk.advance(1.0)
    out.append(ctl.step())
    for _ in range(5):
        clk.advance(1.0)
        out.append(ctl.step())
    clk.advance(60.0)
    out.append(ctl.step())
    return fleet, ctl, out


def _hold_at_max(pkg):
    fleet, clk = FakeFleet(3), FakeClock()
    ctl, gauge = _controller(pkg, fleet, clk, max_replicas=3)
    gauge.set(20)
    out = [ctl.step()]
    clk.advance(1.0)
    out.append(ctl.step())
    return fleet, ctl, out


def _quiet_scale_down(pkg):
    fleet, clk = FakeFleet(3, load=0), FakeClock()
    ctl, gauge = _controller(pkg, fleet, clk, min_replicas=2)
    gauge.set(0)
    out = [ctl.step()]
    for dt in (119.0, 1.0, 500.0):
        clk.advance(dt)
        out.append(ctl.step())
    return fleet, ctl, out


def _load_resets_quiet(pkg):
    fleet, clk = FakeFleet(2, load=0), FakeClock()
    ctl, _ = _controller(pkg, fleet, clk)
    out = [ctl.step()]
    clk.advance(100.0)
    fleet.load = 5
    out.append(ctl.step())
    fleet.load = 0
    for dt in (119.0, 119.0, 2.0):
        clk.advance(dt)
        out.append(ctl.step())
    return fleet, ctl, out


def _reap_during_cooldown(pkg):
    fleet, clk = FakeFleet(2), FakeClock()
    ctl, gauge = _controller(pkg, fleet, clk)
    gauge.set(20)
    out = [ctl.step()]
    clk.advance(1.0)
    out.append(ctl.step())
    fleet.dead = ["r1"]
    clk.advance(1.0)
    out.append(ctl.step())
    return fleet, ctl, out


def _failures_are_decisions(pkg):
    fleet, clk = FakeFleet(1), FakeClock()
    fleet.fail_scale_up = True
    ctl, gauge = _controller(pkg, fleet, clk)
    gauge.set(20)
    out = [ctl.step()]
    clk.advance(1.0)
    out.append(ctl.step())
    fleet2 = FakeFleet(2)
    fleet2.fail_replace = True
    fleet2.dead = ["r9"]
    ctl2, _ = _controller(pkg, fleet2, FakeClock())
    out.append(ctl2.step())
    return fleet, ctl, out + [fleet2.calls]


CONTROLLER_CASES = {
    "sustained_breach_scales_up_once": _sustained_breach,
    "cooldown_suppresses_then_rearms": _cooldown_rearms,
    "breach_at_max_records_hold": _hold_at_max,
    "quiet_fleet_scales_down_to_min": _quiet_scale_down,
    "load_resets_quiet_timer": _load_resets_quiet,
    "dead_replica_replaced_during_cooldown": _reap_during_cooldown,
    "scale_failures_become_decisions": _failures_are_decisions,
}


@pytest.mark.parametrize("case", sorted(CONTROLLER_CASES))
def test_controller_decisions_equal_jax(case):
    got = {}
    for pkg in ("jax", "port"):
        fleet, ctl, out = CONTROLLER_CASES[case](pkg)
        got[pkg] = dict(steps=out, log=ctl.decision_log(), calls=fleet.calls, replicas=fleet.n)
    assert got["port"] == got["jax"]
    assert any(got["port"]["steps"])


def test_controller_decisions_are_flight_events_jax_accepts(tmp_path):
    events = {}
    for pkg in ("jax", "port"):
        path = str(tmp_path / f"{pkg}.jsonl")
        flight = PACKAGES[pkg]["flight"](path)
        fleet, clk = FakeFleet(1), FakeClock()
        ctl, gauge = _controller(pkg, fleet, clk, flight=flight, max_replicas=2, cooldown_s=0.0, quiet_for_s=1e9,
                                 breach_evals=1)
        gauge.set(20)
        ctl.step()
        flight.close()
        events[pkg] = [{k: v for k, v in e.items() if k != "t"}
                       for e in PACKAGES[pkg]["read_flight"](path) if e["kind"] == "fleet_scale"]
    assert events["port"] == events["jax"]
    assert [(e["action"], e["replicas"]) for e in events["port"]] == [("up", 2)]
    assert jax_validate_flight(read_flight_record(str(tmp_path / "port.jsonl"))) == []
    assert validate_flight_record(str(tmp_path / "port.jsonl")) == []


# ---------------------------------------------------------------------------
# the router (stub replicas), both packages
# ---------------------------------------------------------------------------


class FakeReplica:
    def __init__(self, name: str, model: str = "m", load: int = 0):
        self.name = name
        self.model = model
        self._load = load
        self.ready = True
        self.live = True
        self.submitted: list = []
        self.fail_with = None

    def load(self) -> int:
        return self._load

    def queue_depth(self) -> int:
        return self._load

    def submit(self, sample, tenant=None) -> Future:
        fut: Future = Future()
        self.submitted.append((sample, fut))
        if self.fail_with is not None:
            fut.set_exception(self.fail_with)
        return fut


COUNTERS = ("requests_total", "results_total", "rejected_quota", "rejected_shed", "rejected_no_replica",
            "death_retries", "failed")


def _router_outcome(pkg, case):
    mod = PACKAGES[pkg]["fleet"]
    reg = PACKAGES[pkg]["registry"]()
    clk = FakeClock()
    events = []

    def attempt(fn):
        try:
            fut = fn()
        except Exception as exc:
            events.append(("raised", type(exc).__name__, getattr(exc, "tenant", None),
                           bool(getattr(exc, "trace_id", None))))
            return None
        events.append("admitted")
        return fut

    def resolved(fut):
        try:
            events.append(("result", fut.result(timeout=5)))
        except Exception as exc:
            events.append(("failed", type(exc).__name__, isinstance(exc, PACKAGES[pkg]["overloaded"])))

    if case == "quota":
        router = mod.FleetRouter(reg, clock=clk)
        r0 = FakeReplica("r0")
        router.attach(r0)
        router.set_quota("acme", mod.TenantQuota(rate=1e-9, burst=1.0))
        attempt(lambda: router.submit("s0", tenant="acme"))
        attempt(lambda: router.submit("s1", tenant="acme"))
        attempt(lambda: router.submit("s2", tenant="other"))
        reps = [r0]
        traced = [t.attrs.get("tenant") for t in router.traces()]
        events.append(("traces", traced))
    elif case == "shed":
        router = mod.FleetRouter(reg, config=mod.RouterConfig(shed_load=1))
        r0 = FakeReplica("r0", load=5)
        router.attach(r0)
        router.set_quota("bulk", mod.TenantQuota(priority="batch"))
        attempt(lambda: router.submit("s", tenant="bulk"))
        attempt(lambda: router.submit("s", tenant="interactive"))
        reps = [r0]
    elif case == "placement":
        router = mod.FleetRouter(reg)
        heavy, light = FakeReplica("r0", load=5), FakeReplica("r1", load=1)
        router.attach(heavy)
        router.attach(light)
        attempt(lambda: router.submit("s"))
        router.pause("r1")
        attempt(lambda: router.submit("s2"))
        router.resume("r1")
        heavy.ready = False
        attempt(lambda: router.submit("s3"))
        reps = [heavy, light]
    elif case == "no_ready_replica":
        router = mod.FleetRouter(reg)
        resolved(attempt(lambda: router.submit("s")))
        reps = []
    else:  # death_retry
        router = mod.FleetRouter(reg)
        dying, healthy = FakeReplica("r0", load=0), FakeReplica("r1", load=3)
        dying.fail_with = PACKAGES[pkg]["request_failed"]("dispatch died", reason="dispatch")
        router.attach(dying)
        router.attach(healthy)
        fut = attempt(lambda: router.submit("s"))
        healthy.submitted[0][1].set_result({"e": 1.0})
        resolved(fut)
        healthy.fail_with = PACKAGES[pkg]["request_failed"]("nan", reason="nonfinite")
        dying.ready = False
        resolved(attempt(lambda: router.submit("s2")))
        reps = [dying, healthy]
    counters = {c: reg.get(f"fleet.{c}").value for c in COUNTERS}
    tenants = {n: reg.get(n).value for n in reg.names() if n.startswith("fleet.tenant.") and not n.endswith("_s")}
    return dict(events=events, counters=counters, tenants=tenants,
                placed={r.name: [s for s, _ in r.submitted] for r in reps})


@pytest.mark.parametrize("case", ["quota", "shed", "placement", "no_ready_replica", "death_retry"])
def test_router_admission_equals_jax(case):
    got = {pkg: _router_outcome(pkg, case) for pkg in ("jax", "port")}
    assert got["port"] == got["jax"]


def test_fleet_surface_and_knobs_equal_jax(monkeypatch):
    assert sorted(port_fleet.__all__) == sorted(jax_fleet.__all__)
    assert port_fleet.router.PRIORITIES == jax_fleet.router.PRIORITIES
    assert issubclass(port_fleet.TenantOverloaded, Overloaded)
    for cls in ("ControllerConfig", "RouterConfig", "TenantQuota"):
        port_f = [(f.name, f.default) for f in dataclasses.fields(getattr(port_fleet, cls))]
        assert port_f == [(f.name, f.default) for f in dataclasses.fields(getattr(jax_fleet, cls))], cls

    def resolved(mod, reg):
        ctl = mod.FleetController(FakeFleet(), registry=reg)
        router = mod.FleetRouter(reg)
        return (ctl.min_replicas, ctl.max_replicas, ctl.cooldown_s, ctl.quiet_for_s, ctl.eval_every_s,
                router._default_rate, router._default_burst)

    assert resolved(port_fleet, MetricsRegistry()) == resolved(jax_fleet, JaxRegistry()) == (1, 4, 30.0, 60.0, 1.0,
                                                                                          0.0, 32.0)
    for i, knob in enumerate(("MIN_REPLICAS", "MAX_REPLICAS", "COOLDOWN_S", "QUIET_S", "EVAL_EVERY_S",
                              "TENANT_RATE", "TENANT_BURST")):
        monkeypatch.setenv(f"HGTORCH_FLEET_{knob}", str(2 + i))
        monkeypatch.setenv(f"HYDRAGNN_FLEET_{knob}", str(2 + i))
    assert resolved(port_fleet, MetricsRegistry()) == resolved(jax_fleet, JaxRegistry()) == (2, 3, 4.0, 5.0, 6.0,
                                                                                          7.0, 8.0)


def test_device_lock_exclusive_waits_for_shared_and_bars_new_ones():
    lock = SharedExclusiveLock("t.T._lock")
    order = []
    held, release = threading.Event(), threading.Event()

    def reader(tag):
        with lock.shared():
            order.append(f"{tag}+")
            held.set()
            release.wait(5)
        order.append(f"{tag}-")

    def writer():
        with lock.exclusive():
            order.append("W")

    r1 = threading.Thread(target=reader, args=("a",))
    r1.start()
    assert held.wait(5)
    w = threading.Thread(target=writer)
    w.start()
    deadline = time.monotonic() + 5
    while not lock._waiting and time.monotonic() < deadline:
        time.sleep(0.001)
    r2 = threading.Thread(target=lambda: (lock.shared().__enter__(), order.append("b+")))
    r2.start()
    time.sleep(0.05)
    assert order == ["a+"]  # the writer waits for a; b waits behind the writer
    release.set()
    for t in (r1, w, r2):
        t.join(5)
    assert order == ["a+", "a-", "W", "b+"]


# ---------------------------------------------------------------------------
# the fleet on the CPU tiny flagship
# ---------------------------------------------------------------------------


def _raw():
    return deterministic_graph_data(number_configurations=N_SAMPLES, unit_cell_x_range=CELLS,
                                    unit_cell_y_range=CELLS, unit_cell_z_range=CELLS, seed=0)


@pytest.fixture(scope="module")
def flagship():
    jcfg, jmodel, jvars, loader = build_flagship(n_samples=N_SAMPLES, hidden_dim=HIDDEN, num_conv_layers=LAYERS,
                                                 batch_size=4, unit_cells=CELLS)
    tr, _, _, cfg = prepare_config_and_samples(flagship_config(HIDDEN, LAYERS, 4), _raw())
    served = ModelRegistry(device="cpu").register("fleet_smoke", cfg["NeuralNetwork"], variables_from_flax(jvars))
    return {"served": served, "samples": list(tr), "jmodel": jmodel, "jvars": jvars,
            "jsamples": list(loader.all_samples)}


def _serve_cfg():
    return ServeConfig(max_batch=4, num_buckets=2, max_delay_ms=2.0)


def _scaled(flagship, factor):
    return {k: (v * factor if v.is_floating_point() else v) for k, v in flagship["served"].model.state_dict().items()}


def _equal(a, b):
    return sorted(a) == sorted(b) and all(np.array_equal(np.asarray(a[k]), np.asarray(b[k])) for k in a)


def test_fleet_answers_match_the_jax_fleet(flagship):
    requests = [request_to_dict(s) for s in flagship["samples"][:6]]
    with Fleet() as fleet:
        fleet.add_model("m", flagship["served"], flagship["samples"], _serve_cfg(), replicas=2)
        got = [fleet.predict(r, timeout=WAIT) for r in requests]
        h = fleet.health()
        assert h["replica_count"] == h["ready_count"] == h["live_count"] == 2 and h["models"] == ["m"]
        # each replica's metrics live under fleet.<name>. on the fleet registry
        names = fleet.registry.names()
        assert {"fleet.r0.requests_total", "fleet.r1.requests_total", "fleet.queue_depth"} <= set(names)
    jserved = JaxModelRegistry().register("fleet_smoke", flagship["jmodel"], flagship["jvars"])
    with jax_fleet.Fleet() as jfleet:
        jfleet.add_model("m", jserved, flagship["jsamples"],
                         JaxServeConfig(max_batch=4, num_buckets=2, max_delay_ms=2.0), replicas=1)
        want = [jfleet.predict(r, timeout=WAIT) for r in requests]
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_allclose(g[k], np.asarray(w[k]), **TOL)


def test_kill_then_controller_restores_capacity(flagship, tmp_path):
    """``tests/test_fleet.py``'s red case on the port: a killed replica is
    reaped and replaced by the controller's step; the replacement captures
    its own graphs (``compile_warmup``), the survivor captures none."""
    flight_path = str(tmp_path / "flight.jsonl")
    with Fleet(flight=FlightRecorder(flight_path)) as fleet:
        fleet.add_model("m", flagship["served"], flagship["samples"], _serve_cfg(), replicas=2)
        survivor, victim = fleet.get_replica("r1"), fleet.get_replica("r0")
        warm = survivor.server.metrics_snapshot()["compile_warmup"]
        futures = [fleet.submit(s) for s in flagship["samples"][:8]]
        victim.kill()
        assert fleet.dead_replicas() == ["r0"]
        answers = [f.result(timeout=WAIT) for f in futures]  # the router retries each dead future
        assert all(isinstance(a, dict) and a for a in answers)
        ctl = FleetController(fleet, registry=fleet.registry, flight=fleet.flight,
                              config=ControllerConfig(min_replicas=1, max_replicas=3))
        out = ctl.step()
        assert [d["action"] for d in out] == ["replace"] and out[0]["dead"] == "r0"
        assert fleet.dead_replicas() == [] and fleet.replica_count() == 2
        (new,) = [r for r in fleet.replicas() if r.name != "r1"]
        assert new.ready and new.name == "r2"
        n_buckets = len(new.server.buckets)
        assert new.server.metrics_snapshot()["compile_warmup"] == 2 * n_buckets
        assert survivor.server.metrics_snapshot()["compile_warmup"] == warm == 2 * n_buckets
        assert isinstance(fleet.predict(flagship["samples"][1], timeout=WAIT), dict)
    events = read_flight_record(flight_path)
    assert [e["action"] for e in events if e["kind"] == "fleet_scale"] == ["replace"]
    assert jax_validate_flight(events) == []


def test_rolling_reload_aborts_when_replica_dies_mid_roll(flagship, tmp_path):
    """The red JAX case on the port: the roll visits r0 first, r0 is
    dead, the roll aborts with ``ReloadFailed`` before any swap, every
    submitted future resolves, the survivor answers on the old weights,
    one ``fleet_reload`` event with ``aborted_roll`` and none ok."""
    flight_path = str(tmp_path / "flight.jsonl")
    with Fleet(flight=FlightRecorder(flight_path)) as fleet:
        fleet.add_model("m", flagship["served"], flagship["samples"], _serve_cfg(), replicas=2)
        victim = sorted(fleet.replicas(), key=lambda r: r.name)[0]
        before = fleet.predict(flagship["samples"][0], timeout=WAIT)
        victim.kill()
        futures = [fleet.submit(s) for s in flagship["samples"][:6]]
        with pytest.raises(ReloadFailed, match="died mid-roll"):
            fleet.rolling_reload("m", variables=_scaled(flagship, 1.5), drain_timeout_s=5.0)
        resolved = 0
        for f in futures:
            try:
                f.result(timeout=WAIT)
            except RequestFailed:
                pass
            resolved += 1
        assert resolved == len(futures)
        assert fleet.health()["ready_count"] >= 1
        assert _equal(fleet.predict(flagship["samples"][0], timeout=WAIT), before)
    events = read_flight_record(flight_path)
    reloads = [e for e in events if e["kind"] == "fleet_reload"]
    assert [e["replica"] for e in reloads if e.get("aborted_roll")] == [victim.name]
    assert not [e for e in reloads if e.get("ok")]


def test_rolling_reload_is_bit_identical_for_same_weights(flagship, tmp_path):
    flight_path = str(tmp_path / "flight.jsonl")
    with Fleet(flight=FlightRecorder(flight_path)) as fleet:
        fleet.add_model("m", flagship["served"], flagship["samples"], _serve_cfg(), replicas=2)
        before = [r.server.predict(flagship["samples"][0], timeout=WAIT) for r in fleet.replicas()]
        outcomes = fleet.rolling_reload("m", variables=flagship["served"].model.state_dict())
        assert [(o["replica"], o["ok"]) for o in outcomes] == [("r0", True), ("r1", True)]
        assert all(r.ready for r in fleet.replicas())
        after = [r.server.predict(flagship["samples"][0], timeout=WAIT) for r in fleet.replicas()]
        assert all(_equal(a, b) for a, b in zip(before, after))
    events = read_flight_record(flight_path)
    assert [(e["replica"], e["ok"]) for e in events if e["kind"] == "fleet_reload"] == [("r0", True), ("r1", True)]
    assert jax_validate_flight(events) == []
    r = subprocess.run([sys.executable, "tools/obs_report.py", "--faults", flight_path], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.count("[fleet_reload]") == 2, r.stdout + r.stderr


def test_replicas_own_their_weights_through_a_roll(flagship):
    """A roll to other weights: after r0's swap and before r1's, r1 still
    answers on the old weights; after the roll both, and a replica
    spawned after it, answer on the new ones. The model's ``served``
    module is never a replica's."""
    sample = flagship["samples"][0]
    new_state = _scaled(flagship, 1.5)
    before_served = {k: v.clone() for k, v in flagship["served"].model.state_dict().items()}
    seen = {}
    with Fleet() as fleet:
        reps = fleet.add_model("m", flagship["served"], flagship["samples"], _serve_cfg(), replicas=2)
        assert all(r.server.served.model is not flagship["served"].model for r in reps)
        assert reps[0].server.served.model is not reps[1].server.served.model
        old = reps[1].server.predict(sample, timeout=WAIT)
        r0_reload = reps[0].server.reload

        def reload_then_look(*a, **kw):
            info = r0_reload(*a, **kw)
            seen["r0"] = reps[0].server.predict(sample, timeout=WAIT)
            seen["r1"] = reps[1].server.predict(sample, timeout=WAIT)
            return info

        reps[0].server.reload = reload_then_look
        fleet.rolling_reload("m", variables=new_state)
        assert _equal(seen["r1"], old) and not _equal(seen["r0"], old)
        new = reps[1].server.predict(sample, timeout=WAIT)
        assert _equal(new, seen["r0"])
        spawned = fleet.get_replica(fleet.scale_up())
        assert _equal(spawned.server.predict(sample, timeout=WAIT), new)
    after_served = flagship["served"].model.state_dict()
    assert all(torch.equal(after_served[k], v) for k, v in before_served.items())


def test_reload_on_one_replica_changes_no_other_replica(flagship):
    sample = flagship["samples"][2]
    before_served = {k: v.clone() for k, v in flagship["served"].model.state_dict().items()}
    with Fleet() as fleet:
        r0, r1 = fleet.add_model("m", flagship["served"], flagship["samples"], _serve_cfg(), replicas=2)
        b0, b1 = r0.server.predict(sample, timeout=WAIT), r1.server.predict(sample, timeout=WAIT)
        assert _equal(b0, b1)
        r0.server.reload(variables=_scaled(flagship, 0.5))
        assert not _equal(r0.server.predict(sample, timeout=WAIT), b0)
        assert _equal(r1.server.predict(sample, timeout=WAIT), b1)
    after_served = flagship["served"].model.state_dict()
    assert all(torch.equal(after_served[k], v) for k, v in before_served.items())


def test_quiet_scale_down_drains_without_dropping(flagship):
    with Fleet() as fleet:
        fleet.add_model("m", flagship["served"], flagship["samples"], _serve_cfg(), replicas=2)
        futures = [fleet.submit(s) for s in flagship["samples"] * 2]
        ctl = FleetController(fleet, registry=fleet.registry,
                              config=ControllerConfig(min_replicas=1, max_replicas=2, quiet_for_s=0.0,
                                                      cooldown_s=0.0, quiet_load=10_000))
        out = ctl.step()
        assert [d["action"] for d in out] == ["down"] and fleet.replica_count() == 1
        answers = [f.result(timeout=WAIT) for f in futures]
        assert len(answers) == len(futures) and all(isinstance(a, dict) and a for a in answers)
        retired = out[0]["retired"]
        assert fleet.get_replica(retired) is None


def test_fleet_probes_through_serve_probe(flagship, tmp_path):
    with Fleet() as fleet:
        fleet.add_model("m", flagship["served"], flagship["samples"], _serve_cfg(), replicas=2)
        probe_dir = str(tmp_path / "probes")
        paths = fleet.export_probes(probe_dir)
        assert sorted(os.path.basename(p) for p in paths) == ["r0.prom", "r1.prom", "router.prom"]
        r = subprocess.run([sys.executable, "tools/serve_probe.py", "--fleet", probe_dir], cwd=REPO,
                           capture_output=True, text=True, timeout=60)
        assert r.returncode == 0, r.stdout + r.stderr
        for name in ("router", "r0", "r1"):
            assert name in r.stdout
        fleet.get_replica("r0").kill()
        fleet.get_replica("r1").drain(timeout=5.0)
        fleet.export_probes(probe_dir)
        r = subprocess.run([sys.executable, "tools/serve_probe.py", "--fleet", probe_dir], cwd=REPO,
                           capture_output=True, text=True, timeout=60)
        assert r.returncode != 0, r.stdout


def test_failed_spawn_raises_and_is_an_up_failed_decision(flagship, tmp_path, monkeypatch):
    from hydragnn_tpu_torch.fleet import fleet as fleet_mod

    flight_path = str(tmp_path / "flight.jsonl")
    with Fleet(flight=FlightRecorder(flight_path)) as fleet:
        fleet.add_model("m", flagship["served"], flagship["samples"], _serve_cfg(), replicas=1)

        def broken_start(self):
            raise RuntimeError("capture failed")

        monkeypatch.setattr(fleet_mod.ModelServer, "start", broken_start)
        with pytest.raises(ReplicaFailed, match="capture failed"):
            fleet.scale_up()
        fleet.registry.gauge("fleet.queue_depth").set(100)
        ctl = FleetController(fleet, registry=fleet.registry, flight=fleet.flight,
                              config=ControllerConfig(min_replicas=1, max_replicas=3, breach_evals=1,
                                                      slo_queue_depth=8.0, cooldown_s=0.0))
        out = ctl.step()
        assert [d["action"] for d in out] == ["up_failed"] and "ReplicaFailed" in out[0]["error"]
        assert fleet.replica_count() == 1
        monkeypatch.undo()
        fleet.registry.gauge("fleet.queue_depth").set(100)
        out = ctl.step()
        assert [d["action"] for d in out] == ["up"] and fleet.replica_count() == 2
        assert all(isinstance(fleet.predict(s, timeout=WAIT), dict) for s in flagship["samples"][:4])
    events = read_flight_record(flight_path)
    assert [e["action"] for e in events if e["kind"] == "fleet_scale"] == ["up_failed", "up"]
    assert jax_validate_flight(events) == []
    r = subprocess.run([sys.executable, "tools/obs_report.py", "--faults", flight_path], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and "[fleet_scale]" in r.stdout, r.stdout + r.stderr


def test_fleet_tenant_and_trace_ride_to_the_replica(flagship):
    with Fleet(quotas={"acme": port_fleet.TenantQuota(rate=1e-9, burst=2.0)}) as fleet:
        fleet.add_model("m", flagship["served"], flagship["samples"], _serve_cfg(), replicas=1)
        assert isinstance(fleet.predict(flagship["samples"][0], tenant="acme", timeout=WAIT), dict)
        assert isinstance(fleet.predict(flagship["samples"][1], tenant="acme", timeout=WAIT), dict)
        with pytest.raises(port_fleet.TenantOverloaded) as ei:
            fleet.submit(flagship["samples"][2], tenant="acme")
        assert ei.value.tenant == "acme" and ei.value.trace_id
        assert fleet.registry.get("fleet.tenant.acme.requests").value == 3
        assert fleet.registry.get("fleet.tenant.acme.rejected").value == 1
        traces = fleet.router.traces()
        marks = [s["name"] for t in traces if t.attrs.get("tenant") == "acme" for s in t.spans]
        assert "fleet.admit" in marks and "fleet.complete" in marks and "fleet.reject" in marks


def _roll_with(fleet, flagship, during):
    """Roll ``m`` to 1.5x the weights, calling ``during()`` in a thread
    right after r0's swap; returns the outcomes and that thread, which
    must still be waiting when r1's turn comes."""
    reps = sorted(fleet.replicas(), key=lambda r: r.name)
    r0_reload, box = reps[0].server.reload, {}

    def reload_then_start(*a, **kw):
        info = r0_reload(*a, **kw)
        box["t"] = threading.Thread(target=lambda: box.setdefault("out", during()))
        box["t"].start()
        box["t"].join(0.5)
        box["waited"] = box["t"].is_alive()
        return info

    reps[0].server.reload = reload_then_start
    outcomes = fleet.rolling_reload("m", variables=_scaled(flagship, 1.5), drain_timeout_s=5.0)
    box["t"].join(WAIT)
    return outcomes, box


def test_spawn_during_a_roll_serves_the_rolls_weights(flagship):
    """A scale-up asked for during a roll waits for the roll (the model's
    lock) and then serves the weights the roll made, not the old ones."""
    sample = flagship["samples"][0]
    with Fleet() as fleet:
        fleet.add_model("m", flagship["served"], flagship["samples"], _serve_cfg(), replicas=2)
        old = fleet.get_replica("r0").server.predict(sample, timeout=WAIT)
        outcomes, box = _roll_with(fleet, flagship, fleet.scale_up)
        assert box["waited"] and box["out"] == "r2"
        assert [(o["replica"], o["ok"]) for o in outcomes] == [("r0", True), ("r1", True)]
        new = fleet.get_replica("r1").server.predict(sample, timeout=WAIT)
        assert not _equal(new, old)
        assert _equal(fleet.get_replica("r2").server.predict(sample, timeout=WAIT), new)


def test_scale_down_during_a_roll_waits_for_it(flagship):
    """A scale-down asked for during a roll retires no replica the roll
    has yet to visit: the roll completes on both, then one replica goes
    and the other answers on the new weights."""
    sample = flagship["samples"][1]
    with Fleet() as fleet:
        fleet.add_model("m", flagship["served"], flagship["samples"], _serve_cfg(), replicas=2)
        outcomes, box = _roll_with(fleet, flagship, fleet.scale_down)
        assert box["waited"] and box["out"] in ("r0", "r1")
        assert [(o["replica"], o["ok"]) for o in outcomes] == [("r0", True), ("r1", True)]
        (left,) = fleet.replicas()
        assert left.name != box["out"]
        with Fleet() as other:
            other.add_model("m", flagship["served"], flagship["samples"], _serve_cfg(), replicas=1)
            other.rolling_reload("m", variables=_scaled(flagship, 1.5))
            want = other.predict(sample, timeout=WAIT)
        assert _equal(left.server.predict(sample, timeout=WAIT), want)


def test_every_module_build_holds_the_device_lock(flagship, monkeypatch):
    """A spawn's module and its cache's standby are built, and loaded,
    under DEVICE_LOCK's shared side: never beside another replica's
    capture."""
    held = []
    create, load = buckets.create_model, torch.nn.Module.load_state_dict
    monkeypatch.setattr(buckets, "create_model",
                        lambda *a, **kw: (held.append(("create", buckets.DEVICE_LOCK._shared > 0)),
                                          create(*a, **kw))[1])
    monkeypatch.setattr(torch.nn.Module, "load_state_dict",
                        lambda self, *a, **kw: (held.append(("load", buckets.DEVICE_LOCK._shared > 0)),
                                                load(self, *a, **kw))[1])
    with Fleet() as fleet:
        fleet.add_model("m", flagship["served"], flagship["samples"], _serve_cfg(), replicas=2)
    assert held == [("create", True), ("load", True)] * 4  # each replica: its module, then its standby


@pytest.mark.parametrize("call", ["run", "run_eager", "load_standby"])
def test_device_work_waits_for_the_device_lock(call, flagship):
    with Fleet() as fleet:
        (rep,) = fleet.add_model("m", flagship["served"], flagship["samples"], _serve_cfg(), replicas=1)
        cache, bucket = rep.server._cache, rep.server.buckets[0]
        work = {"run": lambda: cache.run(None, bucket.index, cache.warm_batch(bucket)),
                "run_eager": lambda: cache.run_eager(cache.warm_batch(bucket)),
                "load_standby": lambda: cache.load_standby(cache.live_model().state_dict())}[call]
        done = threading.Event()
        t = threading.Thread(target=lambda: (work(), done.set()))
        with buckets.DEVICE_LOCK.exclusive():  # as a capture holds it
            t.start()
            assert not done.wait(0.3)
        t.join(WAIT)
        assert done.is_set()
