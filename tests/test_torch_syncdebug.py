"""The port's lock-order witness (``hydragnn_tpu_torch/utils/syncdebug.py``)
against the JAX package's (``hydragnn_tpu/utils/syncdebug.py``): off, it
returns the raw lock; on, the same acquisition orders give the same
violations on both, an inversion becomes a ``lock_order`` flight event
that the JAX package's ``validate_flight_record`` accepts, the injected
self-test fires once, and a Condition's ``wait`` works through the
wrapper. A child process stands the serving path up with the witness on:
every lock of the port is made under the JAX package's name, clean
traffic records no violation, and ``HGTORCH_INJECT_LOCK_ORDER`` on two of
the server's locks records one event while the server goes on answering.
No tolerance: every comparison is exact."""

import json
import os
import subprocess
import sys
import threading

import pytest

from hydragnn_tpu.obs.flight import validate_flight_record as jax_validate
from hydragnn_tpu.utils import syncdebug as jsd

from hydragnn_tpu_torch.obs.flight import FlightRecorder, read_flight_record
from hydragnn_tpu_torch.utils import syncdebug as tsd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def witness(monkeypatch):
    """Both witnesses on, with no state, and reset again afterwards."""
    monkeypatch.setenv("HGTORCH_LOCK_DEBUG", "1")
    monkeypatch.setenv("HYDRAGNN_LOCK_DEBUG", "1")
    monkeypatch.delenv("HGTORCH_INJECT_LOCK_ORDER", raising=False)
    monkeypatch.delenv("HYDRAGNN_INJECT_LOCK_ORDER", raising=False)
    tsd.reset()
    jsd.reset()
    yield
    tsd.reset()
    jsd.reset()


def _comparable(v):
    return {k: v[k] for k in ("locks", "edge", "conflict", "injected")}


def test_off_returns_the_raw_lock(monkeypatch):
    monkeypatch.delenv("HGTORCH_LOCK_DEBUG", raising=False)
    tsd.reset()
    try:
        lock = threading.Lock()
        assert tsd.maybe_wrap(lock, "a.A._lock") is lock
        monkeypatch.setenv("HGTORCH_LOCK_DEBUG", "1")
        assert tsd.maybe_wrap(lock, "a.A._lock") is lock  # the decision is read once a process
    finally:
        tsd.reset()
    monkeypatch.setenv("HGTORCH_LOCK_DEBUG", "0")
    assert tsd.maybe_wrap(lock, "a.A._lock") is lock
    tsd.reset()


ORDERS = {
    "inversion": [("x.X._a", "x.X._b"), ("x.X._b", "x.X._a")],
    "consistent": [("x.X._a", "x.X._b"), ("x.X._a", "x.X._b")],
    "transitive": [("x.X._a", "x.X._b"), ("x.X._b", "x.X._c"), ("x.X._c", "x.X._a")],
    "same_name": [("x.X._a", "x.X._a")],
}


@pytest.mark.parametrize("order", list(ORDERS.values()), ids=list(ORDERS))
def test_violations_match_jax(order, witness):
    """Each pair is taken nested (outer, then inner) on both witnesses,
    on names outside the JAX package's static graph: equal violations."""
    out = {}
    for mod in (jsd, tsd):
        locks = {}
        for outer, inner in order:
            for name in (outer, inner):
                locks.setdefault(name, mod.maybe_wrap(threading.RLock(), name))
            with locks[outer]:
                with locks[inner]:
                    pass
        out[mod] = [_comparable(v) for v in mod.violations()]
    assert out[tsd] == out[jsd]
    assert len(out[tsd]) == (0 if order in (ORDERS["consistent"], ORDERS["same_name"]) else 1)


def test_an_inversion_is_a_valid_lock_order_event(witness, tmp_path):
    path = str(tmp_path / "flight.jsonl")
    flight = FlightRecorder(path)
    flight.start_run({"run": "witness"})
    a = tsd.maybe_wrap(threading.Lock(), "w.W._a")
    b = tsd.maybe_wrap(threading.Lock(), "w.W._b")
    with a:
        with b:
            pass
    done = threading.Event()

    def other():  # the inversion on another thread: the witness warns and carries on
        with b:
            with a:
                done.set()

    t = threading.Thread(target=other, name="inverter")
    t.start()
    t.join(5.0)
    assert done.is_set()
    flight.close()
    events = read_flight_record(path)
    (ev,) = [e for e in events if e["kind"] == "lock_order"]
    assert ev["locks"] == ["w.W._b", "w.W._a"] and ev["thread"] == "inverter" and ev["injected"] is False
    assert any(k.startswith("inverter(") for k in ev["stacks"])
    assert not jax_validate(events)
    assert len(tsd.violations()) == 1


def test_the_injected_self_test_fires_once(witness, monkeypatch, tmp_path):
    monkeypatch.setenv("HGTORCH_INJECT_LOCK_ORDER", "s.S._one,s.S._two")
    flight = FlightRecorder(str(tmp_path / "flight.jsonl"))
    tsd.maybe_wrap(threading.Lock(), "s.S._one")
    assert tsd.violations() == []  # the second lock does not exist yet
    for _ in range(3):
        tsd.maybe_wrap(threading.Lock(), "s.S._two")
        tsd.maybe_wrap(threading.Lock(), "s.S._one")
    (v,) = tsd.violations()
    assert v["injected"] is True and v["locks"] == ["s.S._two", "s.S._one"]
    flight.close()
    (ev,) = [e for e in read_flight_record(flight.path) if e["kind"] == "lock_order"]
    assert ev["conflict"] == "s.S._one->s.S._two"


def test_condition_wait_through_the_witness(witness):
    cv = tsd.maybe_wrap(threading.Condition(), "c.C._cv")
    other = tsd.maybe_wrap(threading.Lock(), "c.C._other")
    items = []

    def producer():
        for i in range(3):
            with cv:
                items.append(i)
                cv.notify_all()

    with cv:
        t = threading.Thread(target=producer)
        t.start()
        assert cv.wait_for(lambda: len(items) == 3, timeout=5.0)
        assert not cv.wait(0.01)  # times out, the lock held again after
        with other:
            pass
    t.join()
    assert tsd._held() == []
    assert tsd.violations() == []
    assert isinstance(cv, tsd.WitnessLock) and "c.C._cv" in repr(cv)


_SERVE_CHILD = r"""
import json, sys
sys.path.insert(0, {repo!r})
import os
from hydragnn_tpu_torch.api import serve_model
from hydragnn_tpu_torch.data.synthetic import deterministic_graph_data
from hydragnn_tpu_torch.flagship import flagship_config
from hydragnn_tpu_torch.obs.flight import FlightRecorder
from hydragnn_tpu_torch.obs import registry as obs_registry
from hydragnn_tpu_torch.serve import ServeConfig
from hydragnn_tpu_torch.utils import profile, syncdebug

out = {{"module_locks": [type(obs_registry._GLOBAL_LOCK).__name__, type(profile._CAPTURE_LOCK).__name__]}}
for label, inject in (("clean", None), ("injected", "server.ModelServer._reload_lock,server.ModelServer._pin_lock")):
    if inject:
        syncdebug.reset()
        os.environ["HGTORCH_INJECT_LOCK_ORDER"] = inject
    flight = FlightRecorder(sys.argv[1] + f"/{{label}}.jsonl")
    raw = deterministic_graph_data(number_configurations=32, unit_cell_x_range=(2, 4), unit_cell_y_range=(2, 4),
                                   unit_cell_z_range=(2, 4), seed=4)  # prepared in place by serve_model
    server = serve_model(flagship_config(8, 2), raw, serve_config=ServeConfig(max_batch=4, max_delay_ms=5.0),
                         device="cpu", flight=flight)
    answers = server.predict_many(server.reference_samples[:6], timeout=60)
    server.stop()
    flight.close()
    out[label] = {{"answers": len(answers), "violations": len(syncdebug.violations()),
                   "registered": sorted(syncdebug._REGISTERED)}}
print("RESULT", json.dumps(out))
"""

SERVE_LOCKS = {
    "batcher.MicroBatchQueue._cv", "buckets.BucketGraphCache._lock", "flight.FlightRecorder._lock",
    "registry.Counter._lock", "registry.Gauge._lock", "registry.Histogram._lock", "registry.MetricsRegistry._lock",
    "server.ModelServer._eager_lock", "server.ModelServer._pin_lock", "server.ModelServer._reload_lock",
    "trace.Tracer._lock",
}


def test_serving_under_the_witness_in_a_child(tmp_path):
    script = tmp_path / "serve_child.py"
    script.write_text(_SERVE_CHILD.format(repo=REPO))
    env = {k: v for k, v in os.environ.items() if not k.startswith("HGTORCH_INJECT_")}
    env.update(HGTORCH_LOCK_DEBUG="1", OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, str(script), str(tmp_path)], env=env, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    (res,) = [json.loads(ln.split(" ", 1)[1]) for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
    assert res["module_locks"] == ["WitnessLock", "WitnessLock"]
    assert res["clean"]["answers"] == res["injected"]["answers"] == 6
    assert res["clean"]["violations"] == 0 and res["injected"]["violations"] == 1
    assert SERVE_LOCKS <= set(res["clean"]["registered"]), sorted(SERVE_LOCKS - set(res["clean"]["registered"]))
    clean = read_flight_record(str(tmp_path / "clean.jsonl"))
    assert not [e for e in clean if e["kind"] == "lock_order"]
    events = read_flight_record(str(tmp_path / "injected.jsonl"))
    (ev,) = [e for e in events if e["kind"] == "lock_order"]
    assert ev["injected"] is True
    assert ev["locks"] == ["server.ModelServer._pin_lock", "server.ModelServer._reload_lock"]
    assert not jax_validate(events)
    assert events[-1]["kind"] == "run_end" and events[-1]["status"] == "stopped"
