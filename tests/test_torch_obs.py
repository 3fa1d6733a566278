"""The port's observability and resilience pieces on the CPU, each held
to its JAX counterpart: the metrics registry and its exporters (the
Prometheus text line for line, the serving snapshot's key set), the
flight recorder (read and validated by the JAX package), per-request
traces, the serve fault injections' spec grammar, the restart policy,
the hang watchdog and the dispatch supervisor, and the batcher's
oldest-request age. Every wait has its own deadline."""

import json
import threading
import time

import numpy as np
import pytest

from hydragnn_tpu.obs import export as jax_export
from hydragnn_tpu.obs.flight import read_flight_record as jax_read_flight
from hydragnn_tpu.obs.flight import validate_flight_record as jax_validate_flight
from hydragnn_tpu.obs.registry import MetricsRegistry as JaxRegistry
from hydragnn_tpu.obs.trace import RequestTrace as JaxRequestTrace
from hydragnn_tpu.resilience import inject as jax_inject
from hydragnn_tpu.resilience.supervisor import SupervisorPolicy as JaxPolicy
from hydragnn_tpu.serve.metrics import ServeMetrics as JaxServeMetrics

from hydragnn_tpu_torch.obs import export, registry as reg
from hydragnn_tpu_torch.obs.flight import FlightRecorder, read_flight_record, validate_flight_record
from hydragnn_tpu_torch.obs.trace import RequestTrace, Tracer
from hydragnn_tpu_torch.resilience import inject
from hydragnn_tpu_torch.resilience.supervisor import SupervisorPolicy
from hydragnn_tpu_torch.resilience.watchdog import HangWatchdog, dump_thread_stacks
from hydragnn_tpu_torch.serve import MicroBatchQueue, ServeMetrics
from hydragnn_tpu_torch.serve.supervise import DispatchSupervisor
from hydragnn_tpu_torch.utils.tensorboard import write_scalar_dict

WAIT = 10.0


def _until(pred, seconds=WAIT):
    deadline = time.monotonic() + seconds
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.005)
    return False


def _drive(r):
    """The same recording sequence on either registry."""
    r.counter("serve.requests_total").inc()
    r.counter("serve.requests_total").inc(2)
    r.counter("loader.wait_s").inc(0.25)
    g = r.gauge("serve.queue_depth")
    for v in (3, 7, 2):
        g.set(v)
    h = r.histogram("serve.latency_s", window=4)
    for v in (0.5, 0.1, 0.3, 0.2, 0.9):
        h.observe(v)


# ---------------------------------------------------------------------------
# registry and export
# ---------------------------------------------------------------------------


def test_registry_snapshot_equals_jax():
    mine, theirs = reg.MetricsRegistry(rank=0), JaxRegistry(rank=0)
    _drive(mine)
    _drive(theirs)
    assert mine.snapshot() == theirs.snapshot()
    assert mine.names() == theirs.names()
    assert mine.gauge("serve.queue_depth").peak == 7
    assert mine.histogram("serve.latency_s").count == 5  # all-time count, window of 4
    with pytest.raises(TypeError):
        mine.gauge("serve.requests_total")


def test_disabled_registry_hands_out_null_metrics(monkeypatch):
    r = reg.MetricsRegistry(enabled=False)
    assert r.counter("a") is reg.NULL_COUNTER and r.gauge("b") is reg.NULL_GAUGE
    assert r.histogram("c") is reg.NULL_HISTOGRAM
    r.counter("a").inc(5)
    assert r.snapshot() == {} and reg.NULL_COUNTER.value == 0
    assert reg.telemetry_enabled()
    monkeypatch.setenv("HGTORCH_TELEMETRY", "off")
    assert not reg.telemetry_enabled() and Tracer().begin(seq=0) is None


def test_prometheus_text_equals_jax(tmp_path):
    mine, theirs = reg.MetricsRegistry(rank=0), JaxRegistry(rank=0)
    _drive(mine)
    _drive(theirs)
    assert export.registry_to_prometheus_text(mine) == jax_export.registry_to_prometheus_text(theirs)
    for name in ("serve.ready", "serve.bucket_0.flush_full", "a-b.c"):
        assert export.prometheus_name(name) == jax_export.prometheus_name(name)
    path = str(tmp_path / "sub" / "m.prom")
    export.registry_to_prometheus(mine, path)
    with open(path) as f:
        assert f.read() == jax_export.registry_to_prometheus_text(theirs)
    assert [p.name for p in (tmp_path / "sub").iterdir()] == ["m.prom"]  # no temporary file left


def _drive_serve(m):
    m.record_request(0)
    m.record_request(None)
    m.record_batch(0, occupancy=3, capacity=4, reason="full")
    m.record_batch(1, occupancy=1, capacity=4, reason="retry_single")
    m.record_compile(hit=False, warmup=True)
    m.record_compile(hit=True)
    m.record_compile(hit=False)
    m.record_reject()
    m.record_oversize("eager")
    m.record_error(2)
    m.record_quarantine()
    m.record_poison_retry(3)
    m.record_dispatch_restart()
    m.record_reload(ok=True)
    m.record_reload(ok=False)
    m.set_health(True, False, 0.25, 2)
    m.set_queue_depth(5, 0.125)
    m.observe_latency(0.010)
    m.observe_latency(0.030)


def test_serve_metrics_snapshot_and_prometheus_names_match_jax():
    mine, theirs = ServeMetrics(num_buckets=2), JaxServeMetrics(num_buckets=2)
    mine.registry._rank = theirs.registry._rank = 0
    _drive_serve(mine)
    _drive_serve(theirs)
    got, want = mine.snapshot(), theirs.snapshot()
    assert set(want) <= set(got)
    assert set(got) - set(want) == {"forwards_total", "batches_total", "graph_replays_total"}
    for k in want:
        assert got[k] == want[k], k
    mine_lines = set(mine.to_prometheus_text().splitlines())
    jax_lines = set(jax_export.registry_to_prometheus_text(theirs.registry).splitlines())
    # every sample the JAX server exports, the port exports with the same name and value
    assert jax_lines <= mine_lines
    extra = {ln.split("{")[0] for ln in mine_lines - jax_lines if not ln.startswith("#")}
    assert extra == {"hydragnn_serve_forwards_total", "hydragnn_serve_graph_replays_total"}


def test_serve_metrics_tensorboard_and_jsonl_export(tmp_path):
    m = ServeMetrics(num_buckets=2)
    _drive_serve(m)

    class Rec:
        def __init__(self):
            self.rows = []

        def add_scalar(self, tag, value, step):
            self.rows.append((tag, value, step))

    w = Rec()
    n = m.to_tensorboard(w, step=7)
    assert n == len(w.rows) > 10 and all(t.startswith("serve/") and s == 7 for t, _, s in w.rows)
    assert ("serve/buckets/bucket_0/occupancy_mean", 3.0, 7) in w.rows
    w2 = Rec()
    assert export.registry_to_tensorboard(w2, m.registry, step=1) == len(w2.rows) > 10
    path = str(tmp_path / "m.jsonl")
    export.registry_to_jsonl(path, m.registry, extra={"run": "x"})
    export.registry_to_jsonl(path, m.registry)
    with open(path) as f:
        lines = [json.loads(x) for x in f]
    assert len(lines) == 2 and lines[0]["run"] == "x" and lines[0]["rank"] == 0
    assert lines[0]["metrics"]["serve"]["requests_total"] == 2


def test_write_scalar_dict_is_the_jax_one():
    from hydragnn_tpu.utils.tensorboard import write_scalar_dict as jax_write

    class Rec(list):
        def add_scalar(self, tag, value, step):
            self.append((tag, value, step))

    m = ServeMetrics(num_buckets=1)
    m.record_request(0)
    m.observe_latency(0.5)
    a, b = Rec(), Rec()
    write_scalar_dict(a, m.snapshot(), 3, prefix="serve")
    jax_write(b, m.snapshot(), 3, prefix="serve")
    assert a == b


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------


def test_flight_record_reads_and_validates_with_jax(tmp_path):
    path = str(tmp_path / "flight.jsonl")
    with FlightRecorder(path) as fl:
        fl.start_run({"mode": "serve"}, device="cpu")
        fl.record("quarantine", seq=7, reason="exception", bucket=0, error="boom", arr=np.arange(3))
        fl.record("dispatch_restart", attempt=1, cause="crash", delay_s=0.05)
        fl.record("reload", source="run42", swap_s=0.2)
        fl.record("reload_failed", source="run43", error="canary", rolled_back=True)
        fl.error(ValueError("bad"), where="x")
        fl.end_run(status="stopped", metrics={"n": np.float32(1.5)})
    events = read_flight_record(path)
    assert events == jax_read_flight(path)
    assert [e["v"] for e in events] == [2] * 7 and all(e["rank"] == 0 for e in events)
    man = events[0]["manifest"]
    assert man["jax_version"] is None and man["backend"] == "cpu" and man["num_processes"] == 1
    assert "torch_version" in man and "cuda_version" in man and man["device_name"] is None
    assert events[1]["arr"] == [0, 1, 2] and events[5]["error_type"] == "ValueError"
    assert validate_flight_record(path) == [] and jax_validate_flight(path) == []
    # a crash's truncated tail is skipped; a broken line inside is flagged
    with open(path, "a") as f:
        f.write('{"v": 2, "kind": "epo')
    assert len(read_flight_record(path)) == 7
    bad = events + [{"kind": "quarantine", "v": 2, "t": 0, "rank": 0}]
    assert validate_flight_record(bad) == jax_validate_flight(bad) != []


def test_flight_recorder_disabled_is_inert(tmp_path):
    fl = FlightRecorder(None)
    fl.record("reload", source="x")
    fl.start_run({})
    fl.close()
    assert not fl.enabled
    fl2 = FlightRecorder(str(tmp_path / "f.jsonl"), enabled=False)
    fl2.record("reload", source="x")
    assert not (tmp_path / "f.jsonl").exists()


# ---------------------------------------------------------------------------
# traces
# ---------------------------------------------------------------------------


def test_request_trace_matches_jax_shape():
    mine, theirs = RequestTrace("abc", seq=4, attrs={"tenant": "t"}), JaxRequestTrace("abc", seq=4, attrs={"tenant": "t"})
    for tr in (mine, theirs):
        tr.add_span("serve.batch_build", 10.0, 10.5, occupancy=3)
        tr.add_span("serve.device_execute", 10.5, 10.25)
    assert mine.to_dict() == theirs.to_dict()
    assert mine.spans[0]["dur_ms"] == 500.0 and mine.spans[1]["dur_ms"] == 0.0
    t = mine.mark("serve.route", bucket=1)
    assert mine.spans[-1]["name"] == "serve.route" and t >= mine.t_admit


def test_tracer_samples_every_nth_into_flight(tmp_path, monkeypatch):
    path = str(tmp_path / "flight.jsonl")
    fl = FlightRecorder(path)
    tracer = Tracer(flight=fl, sample_every=3, keep=4)
    for seq in range(7):
        tr = tracer.begin(seq=seq)
        tr.mark("serve.route")
        tracer.finish(tr)
    tracer.finish(None)
    fl.close()
    caps = [e for e in read_flight_record(path) if e["kind"] == "trace_capture"]
    assert [e["seq"] for e in caps] == [0, 3, 6] and all(len(e["trace_id"]) == 16 for e in caps)
    assert [t.seq for t in tracer.traces()] == [3, 4, 5, 6]
    monkeypatch.setenv("HGTORCH_TRACE", "0")
    assert Tracer().begin(seq=1) is None
    monkeypatch.setenv("HGTORCH_TRACE", "1")
    monkeypatch.setenv("HGTORCH_TRACE_SAMPLE", "5")
    assert Tracer().sample_every == 5


# ---------------------------------------------------------------------------
# fault injection
# ---------------------------------------------------------------------------


def _outcome(fn):
    try:
        return ("ok", fn())
    except RuntimeError as exc:
        return ("raised", type(exc))


@pytest.mark.parametrize("spec", ["", "1", "3"])
def test_serve_injections_follow_the_jax_grammar(monkeypatch, spec):
    for suffix in ("SERVE_RAISE", "SERVE_NAN", "SERVE_KILL_DISPATCH", "SERVE_TORN_RELOAD"):
        monkeypatch.setenv(f"HGTORCH_INJECT_{suffix}", spec)
        monkeypatch.setenv(f"HYDRAGNN_INJECT_{suffix}", spec)
    outs = [np.ones(2, np.float32)]
    for seqs in ([0, 1], [2, 3], [3]):
        assert _outcome(lambda: inject.maybe_serve_raise(seqs)) == _outcome(lambda: jax_inject.maybe_serve_raise(seqs))
        mine, theirs = inject.maybe_serve_nan(outs, seqs), jax_inject.maybe_serve_nan(outs, seqs)
        assert np.array_equal(np.asarray(mine[0]), np.asarray(theirs[0]), equal_nan=True)
    for k in (1, 2, 3):
        assert (_outcome(lambda: inject.maybe_serve_kill_dispatch(k))
                == _outcome(lambda: jax_inject.maybe_serve_kill_dispatch(k)))
    assert inject.serve_torn_reload() == jax_inject.serve_torn_reload() == bool(spec)


def test_serve_wedge_fires_once(monkeypatch):
    monkeypatch.setattr(inject.SERVE_WEDGE, "fired", False)
    monkeypatch.setenv("HGTORCH_INJECT_SERVE_WEDGE", "2:0")
    inject.maybe_serve_wedge([0, 1])
    assert not inject.SERVE_WEDGE.fired
    inject.maybe_serve_wedge([2])
    assert inject.SERVE_WEDGE.fired and not inject.SERVE_WEDGE.take()


def test_strip_injection_env():
    env = {"HGTORCH_INJECT_SERVE_RAISE": "1", "HGTORCH_INJECT_X": "2", "PATH": "/bin", "HGTORCH_TRACE": "0"}
    assert inject.strip_injection_env(env) == {"PATH": "/bin", "HGTORCH_TRACE": "0"}


# ---------------------------------------------------------------------------
# restart policy, watchdog, dispatch supervisor
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [{}, dict(backoff_base_s=0.05, backoff_factor=2.0, backoff_max_s=2.0),
                                dict(backoff_base_s=3.0, backoff_factor=1.5, backoff_max_s=10.0)])
def test_supervisor_policy_backoff_equals_jax(kw):
    mine, theirs = SupervisorPolicy(**kw), JaxPolicy(**kw)
    assert [mine.backoff(n) for n in range(1, 12)] == [theirs.backoff(n) for n in range(1, 12)]
    assert mine.max_restarts == theirs.max_restarts == 5


def test_watchdog_fires_on_a_gated_stall_and_rearms(tmp_path):
    path = str(tmp_path / "flight.jsonl")
    fl = FlightRecorder(path)
    fired, busy = [], {"v": False}
    wd = HangWatchdog(0.1, flight=fl, action=lambda: fired.append(1), poll_s=0.01, warmup_beats=0,
                      gate=lambda: busy["v"], rearm=True, end_run_on_fire=False)
    wd.start()
    try:
        time.sleep(0.3)
        assert not wd.fired  # idle: the gate holds it
        busy["v"] = True
        assert _until(lambda: wd.fired)
        wd.beat()
        assert _until(lambda: not wd.fired)  # a fresh beat re-arms
        assert _until(lambda: wd.fired)  # and the next stall fires again
    finally:
        wd.stop()
        fl.close()
    assert wd.fire_count >= 2 and len(fired) == wd.fire_count
    events = read_flight_record(path)
    assert events and all(e["kind"] == "watchdog" and "MainThread" in e["stacks"] for e in events)
    assert "MainThread" in dump_thread_stacks()
    with pytest.raises(ValueError):
        HangWatchdog(0)


def test_watchdog_without_rearm_ends_the_run(tmp_path):
    path = str(tmp_path / "flight.jsonl")
    fired = []
    wd = HangWatchdog(0.05, flight=FlightRecorder(path), action=lambda: fired.append(1), poll_s=0.01,
                      warmup_beats=0)
    wd.start()
    assert _until(lambda: bool(fired))
    wd.stop()
    kinds = [e["kind"] for e in read_flight_record(path)]
    assert kinds == ["watchdog", "run_end"] and wd.fire_count == 1


class _Metrics:
    def __init__(self):
        self.restarts = 0

    def record_dispatch_restart(self):
        self.restarts += 1


def test_dispatch_supervisor_restarts_then_gives_up(tmp_path):
    path = str(tmp_path / "flight.jsonl")
    runs, gave_up, ticks = [], [], []

    def target():
        runs.append(threading.current_thread().name)
        raise RuntimeError(f"boom {len(runs)}")

    metrics = _Metrics()
    sup = DispatchSupervisor(target, policy=SupervisorPolicy(max_restarts=2, backoff_base_s=0.01),
                             flight=FlightRecorder(path), metrics=metrics, on_giveup=gave_up.append,
                             on_tick=lambda: ticks.append(1), tick_every_s=0.01, poll_s=0.01)
    sup.start()
    try:
        assert _until(lambda: sup.failed)
        assert _until(lambda: bool(gave_up))
    finally:
        sup.stop(timeout=WAIT)
    assert len(runs) == 3 and sup.restarts == 3 == metrics.restarts and ticks
    assert str(gave_up[0]) == "boom 3"
    ev = [e for e in read_flight_record(path) if e["kind"] == "dispatch_restart"]
    assert [e["cause"] for e in ev] == ["crash", "crash", "gave_up"]
    assert [e["attempt"] for e in ev] == [1, 2, 3] and ev[0]["delay_s"] == 0.01


def test_dispatch_supervisor_clean_exit_is_not_restarted():
    stop = threading.Event()
    sup = DispatchSupervisor(lambda: stop.wait(WAIT), poll_s=0.01)
    sup.start()
    assert sup.alive and not sup.stalled and sup.heartbeat_age() < WAIT
    sup.busy(True)
    sup.beat()
    stop.set()
    sup.stop(timeout=WAIT)
    assert not sup.alive and sup.restarts == 0 and not sup.failed


def test_batcher_oldest_age_and_tenant():
    q = MicroBatchQueue(num_buckets=2, max_batch=4, max_delay_s=60.0, max_pending=8)
    assert q.oldest_age_s() == 0.0
    q.put(1, "a", seq=3, tenant="t1", trace="tr")
    time.sleep(0.02)
    q.put(0, "b", seq=4)
    age = q.oldest_age_s()
    assert 0.015 <= age < WAIT
    q.close()
    got = [q.take_batch() for _ in range(2)]
    reqs = {r.item: r for _, rs, _ in got for r in rs}
    assert reqs["a"].tenant == "t1" and reqs["a"].trace == "tr" and reqs["a"].seq == 3
    assert reqs["b"].tenant == "default" and reqs["b"].trace is None
    assert q.oldest_age_s() == 0.0 and q.take_batch() is None
