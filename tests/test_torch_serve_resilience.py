"""The port's serving resilience and the rest of its server on the CPU,
mirroring ``tests/test_serve_resilience.py`` and the server cases of
``tests/test_serve.py`` at the JAX fixture's size (the flagship at
hidden 8, 2 conv layers, 24 samples, unit cells 2-3), with the JAX
model's weights carried across by ``convert.variables_from_flax``:
poison isolation (raise, NaN, the single-request quarantine), the
supervised dispatch (a killed thread restarted, a wedge seen and
cleared), typed ``ServerClosed`` and the submit-vs-stop race, reload
without re-capture (answers equal the JAX server's after the same
reload, ``rtol=1e-5, atol=1e-6``) and its rollback, the registry's
torn-pointer fallback, health and the Prometheus textfile through
``tools/serve_probe.py``, the port's flight file checked by the JAX
package's validator and rendered by ``tools/obs_report.py --faults``,
and the eager-bucket decision. Every wait has its own deadline.
"""

import copy
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import jax

from hydragnn_tpu.flagship import build_flagship
from hydragnn_tpu.obs.flight import flight_record_warnings as jax_flight_warnings
from hydragnn_tpu.obs.flight import validate_flight_record as jax_validate_flight
from hydragnn_tpu.serve import ModelRegistry as JaxModelRegistry
from hydragnn_tpu.serve import ModelServer as JaxModelServer
from hydragnn_tpu.serve import ServeConfig as JaxServeConfig

import hydragnn_tpu_torch
from hydragnn_tpu_torch.api import prepare_config_and_samples
from hydragnn_tpu_torch.convert import variables_from_flax
from hydragnn_tpu_torch.data.synthetic import deterministic_graph_data
from hydragnn_tpu_torch.flagship import flagship_config
from hydragnn_tpu_torch.graph.batch import batch_graphs
from hydragnn_tpu_torch.models.create import model_config_from_dict
from hydragnn_tpu_torch.obs import FlightRecorder, read_flight_record, validate_flight_record
from hydragnn_tpu_torch.resilience import inject
from hydragnn_tpu_torch.serve import (
    MicroBatchQueue,
    ModelRegistry,
    ModelServer,
    Oversize,
    Overloaded,
    ReloadFailed,
    RequestFailed,
    ServeConfig,
    ServerClosed,
    request_to_dict,
)
from hydragnn_tpu_torch.serve.buckets import eager_reason
from hydragnn_tpu_torch.utils.checkpoint import save_model

REPO = __file__.rsplit("/", 2)[0]
TOL = dict(rtol=1e-5, atol=1e-6)  # the JAX package's serving tolerance
HIDDEN, LAYERS, N_SAMPLES, CELLS = 8, 2, 24, (2, 3)
WAIT = 120  # seconds any one future or join may take


def _raw():
    return deterministic_graph_data(
        number_configurations=N_SAMPLES, unit_cell_x_range=CELLS, unit_cell_y_range=CELLS,
        unit_cell_z_range=CELLS, seed=0,
    )


@pytest.fixture(scope="module")
def setup():
    """The JAX fixture's model and samples, and the port's served model
    on the CPU with the same weights."""
    jcfg, jmodel, jvars, loader = build_flagship(
        n_samples=N_SAMPLES, hidden_dim=HIDDEN, num_conv_layers=LAYERS, batch_size=4, unit_cells=CELLS
    )
    tr, _, _, cfg = prepare_config_and_samples(flagship_config(HIDDEN, LAYERS, 4), _raw())
    served = ModelRegistry(device="cpu").register("resilience_smoke", cfg["NeuralNetwork"], variables_from_flax(jvars))
    return {"cfg": cfg, "served": served, "samples": list(tr), "jmodel": jmodel, "jvars": jvars,
            "jsamples": list(loader.all_samples)}


def _direct_forward(served, sample):
    """The unbatched natural-pad forward of the served weights, sliced
    as the server slices."""
    g = request_to_dict(sample)
    with torch.inference_mode():
        outputs = served.model(batch_graphs([g]), train=False)
    n = int(np.asarray(g["x"]).shape[0])
    cfg = served.cfg
    return {
        cfg.output_names[i]: (o[0] if cfg.output_type[i] == "graph" else o[:n]).numpy()
        for i, o in enumerate(outputs)
    }


def _assert_result_close(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **TOL)


def _server(setup, flight=None, **kw):
    return ModelServer(setup["served"], setup["samples"], ServeConfig(**kw), flight=flight)


def _until(pred, seconds):
    deadline = time.monotonic() + seconds
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.005)
    return False


# ---------------------------------------------------------------------------
# the server (tests/test_serve.py's cases)
# ---------------------------------------------------------------------------


def test_deadline_flush_single_request(setup):
    with _server(setup, max_batch=4, max_delay_ms=30.0) as server:
        t0 = time.monotonic()
        result = server.predict(setup["samples"][0], timeout=WAIT)
        elapsed = time.monotonic() - t0
        snap = server.metrics_snapshot()
    _assert_result_close(result, _direct_forward(setup["served"], setup["samples"][0]))
    flushes = [v for b in snap["buckets"].values() for k, v in b.items() if k == "flush_deadline"]
    assert sum(flushes) == 1 and snap["results_total"] == 1
    # one entry a bucket and weight slot at start, none after
    assert snap["compile_warmup"] == 2 * len(server.buckets) and snap["compile_misses"] == 0
    assert snap["latency"]["p50_ms"] > 0 and elapsed < 60


def test_full_batch_flush_and_occupancy(setup):
    with _server(setup, max_batch=2, max_delay_ms=30_000.0) as server:
        futs = [server.submit(s) for s in setup["samples"][:4]]
        results = [f.result(timeout=WAIT) for f in futs]
        snap = server.metrics_snapshot()
    for s, got in zip(setup["samples"][:4], results):
        _assert_result_close(got, _direct_forward(setup["served"], s))
    assert sum(b.get("flush_full", 0) for b in snap["buckets"].values()) >= 1
    assert any(b["occupancy_mean"] == 2.0 for b in snap["buckets"].values() if b["batches"])
    assert snap["compile_misses"] == 0 and snap["forwards_total"] == snap["batches_total"]


def test_overload_rejection(setup):
    server = _server(setup, max_batch=64, max_delay_ms=3_600_000.0, max_pending=2).start()
    try:
        f1, f2 = server.submit(setup["samples"][0]), server.submit(setup["samples"][1])
        with pytest.raises(Overloaded):
            server.submit(setup["samples"][2])
        assert server.metrics_snapshot()["rejected_overload"] == 1
        assert server.queue_depth() == 2
    finally:
        server.stop()  # drains f1, f2 through the drain flush
    _assert_result_close(f1.result(timeout=10), _direct_forward(setup["served"], setup["samples"][0]))
    _assert_result_close(f2.result(timeout=10), _direct_forward(setup["served"], setup["samples"][1]))


def _chain_graph(n_nodes, sample):
    rng = np.random.default_rng(n_nodes)
    g = {
        "x": rng.normal(size=(n_nodes, np.asarray(sample.x).shape[1])).astype(np.float32),
        "senders": np.arange(n_nodes - 1, dtype=np.int32),
        "receivers": np.arange(1, n_nodes, dtype=np.int32),
        "pos": rng.normal(size=(n_nodes, 3)).astype(np.float32),
    }
    if sample.edge_attr is not None:
        g["edge_attr"] = rng.normal(size=(n_nodes - 1, np.asarray(sample.edge_attr).shape[-1])).astype(np.float32)
    return g


def test_oversize_fallbacks(setup):
    served, sample = setup["served"], setup["samples"][0]
    with _server(setup, max_batch=4, max_delay_ms=5.0) as server:
        big = server.buckets[-1]
        g_mid = _chain_graph(big.cap_nodes + 1, sample)
        assert big.fits_totals(big.cap_nodes + 1, big.cap_nodes, 1)
        _assert_result_close(server.predict(g_mid, timeout=WAIT), _direct_forward(served, g_mid))
        snap = server.metrics_snapshot()
        assert snap["oversize_largest_bucket"] == 1 and snap["compile_misses"] == 0
        g_huge = _chain_graph(big.node_pad + 5, sample)
        _assert_result_close(server.predict(g_huge, timeout=WAIT), _direct_forward(served, g_huge))
        # a new natural pad is the compile miss it is in the JAX package
        snap = server.metrics_snapshot()
        assert snap["oversize_eager"] == 1 and snap["compile_misses"] == 1
        server.predict(g_huge, timeout=WAIT)
        assert server.metrics_snapshot()["compile_misses"] == 1
    with _server(setup, max_batch=4, max_delay_ms=5.0, eager_fallback=False) as server2:
        fut = server2.submit(_chain_graph(server2.buckets[-1].node_pad + 5, sample))
        with pytest.raises(Oversize):
            fut.result(timeout=10)


def test_request_spec_validation(setup):
    with _server(setup, max_batch=2, max_delay_ms=5.0) as server:
        g = _chain_graph(4, setup["samples"][0])
        del g["pos"]
        with pytest.raises(ValueError, match="pos"):
            server.submit(g)
        g2 = _chain_graph(4, setup["samples"][0])
        g2["x"] = np.zeros((4, g2["x"].shape[1] + 1), np.float32)
        with pytest.raises(ValueError, match="feature width"):
            server.submit(g2)


def test_two_thread_concurrent_clients_with_tenants(setup):
    served, samples = setup["served"], setup["samples"]
    expected = [_direct_forward(served, s) for s in samples[:6]]
    results, errors = {0: [], 1: []}, []
    with _server(setup, max_batch=4, max_delay_ms=10.0) as server:
        def client(tid):
            try:
                for _ in range(3):
                    for i, s in enumerate(samples[:6]):
                        results[tid].append((i, server.submit(s, tenant=f"tenant{tid}").result(timeout=WAIT)))
            except BaseException as exc:  # noqa: BLE001 - asserted below
                errors.append(exc)

        threads = [threading.Thread(target=client, args=(t,)) for t in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
            assert not t.is_alive()
        snap = server.metrics_snapshot()
        traces = server._tracer.traces()
    assert not errors
    for tid in (0, 1):
        assert len(results[tid]) == 18
        for i, got in results[tid]:
            _assert_result_close(got, expected[i])
    assert snap["results_total"] == 36 and snap["compile_misses"] == 0
    # every request traced with its tenant and the five serve spans
    assert {t.attrs["tenant"] for t in traces} == {"tenant0", "tenant1"}
    names = [s["name"] for s in traces[-1].spans]
    assert names == ["serve.route", "serve.queue_wait", "serve.batch_build", "serve.device_execute",
                     "serve.postprocess"]


def test_serve_model_serves_the_run_checkpoint(tmp_path):
    """``serve_model(log_dir=...)`` serves ``<log_dir>/<log_name>/`` as
    the JAX package does, equal to ``run_prediction`` on the test split,
    and stamps the server's ``log_dir``."""
    cfg = flagship_config(hidden_dim=8, num_conv_layers=2, batch_size=5, num_epoch=2)

    def data():
        return deterministic_graph_data(number_configurations=40, unit_cell_x_range=(2, 3),
                                        unit_cell_y_range=(2, 3), unit_cell_z_range=(2, 3), seed=0)

    log_dir = str(tmp_path / "logs")
    hydragnn_tpu_torch.run_training(copy.deepcopy(cfg), data(), log_dir=log_dir, device="cpu")
    _, _, trues, preds = hydragnn_tpu_torch.run_prediction(copy.deepcopy(cfg), data(), log_dir=log_dir, device="cpu")
    _, _, test, _ = prepare_config_and_samples(copy.deepcopy(cfg), data())
    server = hydragnn_tpu_torch.serve_model(copy.deepcopy(cfg), data(), log_dir=log_dir, device="cpu",
                                            serve_config=ServeConfig(max_batch=4, max_delay_ms=10.0))
    try:
        results = server.predict_many(list(test), timeout=WAIT)
        snap = server.metrics_snapshot()
        assert server.log_dir == log_dir
    finally:
        server.stop()
    mcfg = server.served.cfg
    for ihead, name in enumerate(mcfg.output_names):
        got = (np.stack if mcfg.output_type[ihead] == "graph" else np.concatenate)([r[name] for r in results])
        np.testing.assert_allclose(got, preds[ihead], **TOL, err_msg=name)
    assert snap["compile_misses"] == 0 and snap["results_total"] == len(test)


def test_serve_model_fsdp_warns_and_serves_replicated():
    cfg = flagship_config(HIDDEN, LAYERS)
    cfg["NeuralNetwork"]["Parallel"] = {"fsdp": 2}
    with pytest.warns(RuntimeWarning, match="fsdp"):
        server = hydragnn_tpu_torch.serve_model(cfg, _raw(), device="cpu", start=False)
    assert server.device.type == "cpu"


# ---------------------------------------------------------------------------
# poison isolation
# ---------------------------------------------------------------------------


def test_poison_raise_fails_only_its_future(setup, monkeypatch, tmp_path):
    served, samples = setup["served"], setup["samples"]
    monkeypatch.setenv("HGTORCH_INJECT_SERVE_RAISE", "1")
    flight = FlightRecorder(str(tmp_path / "flight.jsonl"))
    with _server(setup, flight=flight, max_batch=4, max_delay_ms=200.0) as server:
        futs = [server.submit(s) for s in samples[:4]]
        outcomes = []
        for f in futs:
            try:
                outcomes.append(("ok", f.result(timeout=WAIT)))
            except RequestFailed as exc:
                outcomes.append(("failed", exc))
        snap = server.metrics_snapshot()
        monkeypatch.delenv("HGTORCH_INJECT_SERVE_RAISE")
        _assert_result_close(server.predict(samples[0], timeout=WAIT), _direct_forward(served, samples[0]))
        assert server.health()["ready"]
    assert [o[0] for o in outcomes] == ["ok", "failed", "ok", "ok"]
    assert outcomes[1][1].seq == 1 and outcomes[1][1].reason == "exception"
    for i in (0, 2, 3):
        _assert_result_close(outcomes[i][1], _direct_forward(served, samples[i]))
    assert snap["quarantined"] == 1 and snap["poison_retries"] >= 2 and snap["compile_misses"] == 0
    quar = [e for e in read_flight_record(str(tmp_path / "flight.jsonl")) if e["kind"] == "quarantine"]
    assert len(quar) == 1 and quar[0]["seq"] == 1 and quar[0]["reason"] == "exception"


def test_poison_nan_output_quarantined(setup, monkeypatch):
    served, samples = setup["served"], setup["samples"]
    monkeypatch.setenv("HGTORCH_INJECT_SERVE_NAN", "2")
    failed = {}
    with _server(setup, max_batch=4, max_delay_ms=200.0) as server:
        futs = [server.submit(s) for s in samples[:4]]
        for i, f in enumerate(futs):
            try:
                _assert_result_close(f.result(timeout=WAIT), _direct_forward(served, samples[i]))
            except RequestFailed as exc:
                failed[i] = exc
        snap = server.metrics_snapshot()
    assert list(failed) == [2] and failed[2].reason == "nonfinite"
    assert snap["quarantined"] == 1 and snap["errors"] == 1


def test_single_request_batch_quarantined_directly(setup, monkeypatch):
    monkeypatch.setenv("HGTORCH_INJECT_SERVE_RAISE", "0")
    with _server(setup, max_batch=4, max_delay_ms=5.0) as server:
        with pytest.raises(RequestFailed):
            server.predict(setup["samples"][0], timeout=WAIT)
        snap = server.metrics_snapshot()
    assert snap["quarantined"] == 1 and snap["poison_retries"] == 0


def test_batch_unlike_the_captured_one_raises(setup):
    """A batch whose fields differ from the bucket's warm batch fails,
    and is never re-captured."""
    with _server(setup, max_batch=2, max_delay_ms=5.0) as server:
        b = server.buckets[0]
        warm = server._cache.warm_batch(b)
        before = server.metrics_snapshot()["compile_warmup"]
        with pytest.raises(ValueError, match="edge_attr"):
            server._cache.run(None, b.index, batch_graphs(
                [{"x": np.zeros((2, warm.nodes.shape[1]), np.float32), "senders": np.zeros(1, np.int32),
                  "receivers": np.ones(1, np.int32)}],
                n_node_pad=b.node_pad, n_edge_pad=b.edge_pad, n_graph_pad=b.graph_pad))
        assert server.metrics_snapshot()["compile_warmup"] == before


# ---------------------------------------------------------------------------
# supervised dispatch: thread death and a wedged forward
# ---------------------------------------------------------------------------


def test_dispatch_death_recovery(setup, monkeypatch, tmp_path):
    served, samples = setup["served"], setup["samples"]
    monkeypatch.setenv("HGTORCH_INJECT_SERVE_KILL_DISPATCH", "2")
    flight = FlightRecorder(str(tmp_path / "flight.jsonl"))
    server = _server(setup, flight=flight, max_batch=2, max_delay_ms=10.0, dispatch_backoff_base_s=0.5).start()
    try:
        futs = [server.submit(s) for s in samples[:8]]
        saw_not_ready = saw_ready_again = False
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            ready = server.health()["ready"]
            if not ready:
                saw_not_ready = True
            elif saw_not_ready:
                saw_ready_again = True
                break
            time.sleep(0.005)
        results = dispatch_failed = 0
        for f in futs:
            try:
                f.result(timeout=WAIT)
                results += 1
            except RequestFailed as exc:
                assert exc.reason == "dispatch"
                dispatch_failed += 1
        assert saw_not_ready and saw_ready_again
        assert dispatch_failed >= 1 and results + dispatch_failed == 8
        _assert_result_close(server.predict(samples[0], timeout=WAIT), _direct_forward(served, samples[0]))
        snap = server.metrics_snapshot()
        assert snap["compile_misses"] == 0 and snap["dispatch_restarts"] == 1
        assert server.health()["dispatch_restarts"] == 1
    finally:
        server.stop()
    restarts = [e for e in read_flight_record(str(tmp_path / "flight.jsonl")) if e["kind"] == "dispatch_restart"]
    assert len(restarts) == 1 and restarts[0]["cause"] == "crash"


def test_dispatch_giveup_fails_queued_and_closes(setup, monkeypatch):
    """Past its restart budget the supervisor gives up: queued futures
    fail typed, submit raises ServerClosed, health says why."""
    monkeypatch.setenv("HGTORCH_INJECT_SERVE_KILL_DISPATCH", "1")
    server = _server(setup, max_batch=2, max_delay_ms=10.0, max_dispatch_restarts=0).start()
    try:
        fut = server.submit(setup["samples"][0])
        with pytest.raises(RequestFailed) as err:
            fut.result(timeout=WAIT)
        assert err.value.reason == "dispatch"
        assert _until(lambda: server.health()["dispatch_failed"], 10.0)
        with pytest.raises(ServerClosed):
            server.submit(setup["samples"][0])
        assert "dispatch supervisor gave up" in server.health()["reasons"]
    finally:
        server.stop()


def test_wedged_dispatch_flips_liveness_then_recovers(setup, monkeypatch, tmp_path):
    served, samples = setup["served"], setup["samples"]
    monkeypatch.setattr(inject.SERVE_WEDGE, "fired", False)
    monkeypatch.setenv("HGTORCH_INJECT_SERVE_WEDGE", "1:1")
    flight = FlightRecorder(str(tmp_path / "flight.jsonl"))
    with _server(setup, flight=flight, max_batch=4, max_delay_ms=50.0, dispatch_stall_s=0.2) as server:
        futs = [server.submit(s) for s in samples[:4]]
        saw_stalled = False
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            h = server.health()
            if h["dispatch_stalled"]:
                saw_stalled = True
                assert not h["live"] and not h["ready"]
                break
            time.sleep(0.01)
        for i, f in enumerate(futs):
            _assert_result_close(f.result(timeout=WAIT), _direct_forward(served, samples[i]))
        assert saw_stalled, "the watchdog never flagged the wedged forward"
        assert _until(lambda: server.health()["ready"], 5.0)
        h = server.health()
        assert h["ready"] and not h["dispatch_stalled"]
        assert server.metrics_snapshot()["dispatch_restarts"] == 0
    events = read_flight_record(str(tmp_path / "flight.jsonl"))
    wd = [e for e in events if e["kind"] == "watchdog"]
    assert len(wd) == 1 and "stacks" in wd[0]
    assert events[-1]["kind"] == "run_end" and events[-1]["status"] == "stopped"


# ---------------------------------------------------------------------------
# typed ServerClosed and the submit-vs-stop race
# ---------------------------------------------------------------------------


def test_server_closed_is_typed_and_immediate(setup):
    q = MicroBatchQueue(num_buckets=1, max_batch=2, max_delay_s=0.1, max_pending=4)
    q.close()
    with pytest.raises(ServerClosed):
        q.put(0, "x")
    server = _server(setup, max_batch=2, max_delay_ms=5.0)
    server.start()
    server.stop()
    with pytest.raises(ServerClosed):
        server.submit(setup["samples"][0])
    with pytest.raises(ServerClosed):
        server.start()


def test_submit_vs_stop_race_leaves_no_hanging_future(setup):
    samples = setup["samples"]
    server = _server(setup, max_batch=4, max_delay_ms=5.0).start()
    futures, rejected = [], []
    lock = threading.Lock()

    def feeder():
        deadline = time.monotonic() + 5.0
        i = 0
        while time.monotonic() < deadline:
            i += 1
            try:
                f = server.submit(samples[i % len(samples)])
                with lock:
                    futures.append(f)
            except Overloaded:
                time.sleep(0.001)
            except ServerClosed as exc:
                with lock:
                    rejected.append(exc)
                return

    threads = [threading.Thread(target=feeder) for _ in range(2)]
    for t in threads:
        t.start()
    time.sleep(0.05)
    server.stop()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert any(isinstance(e, ServerClosed) for e in rejected)
    for f in futures:
        f.result(timeout=30)


# ---------------------------------------------------------------------------
# reload without re-capture
# ---------------------------------------------------------------------------


def _scaled(jvars, factor):
    def scale(a):
        arr = np.asarray(a)
        return arr * factor if np.issubdtype(arr.dtype, np.floating) else a

    return {"params": jax.tree_util.tree_map(scale, jvars["params"]), "batch_stats": jvars.get("batch_stats", {})}


def test_reload_swaps_weights_without_recapture_and_equals_jax(setup, tmp_path):
    """Reload into the standby slot: 0 compile misses, the new weights
    serve, and the answers equal the JAX server's after the same
    reload."""
    served, samples, jvars = setup["served"], setup["samples"], setup["jvars"]
    new_jvars = _scaled(jvars, 1.5)
    live_before = {k: v.clone() for k, v in served.model.state_dict().items()}
    flight = FlightRecorder(str(tmp_path / "flight.jsonl"))
    jserved = JaxModelRegistry().register("resilience_smoke", setup["jmodel"], jvars)
    requests = [request_to_dict(s) for s in samples[:4]]
    try:
        with _server(setup, flight=flight, max_batch=4, max_delay_ms=5.0) as server:
            before = server.predict(requests[0], timeout=WAIT)
            info = server.reload(variables=variables_from_flax(new_jvars))
            after = [server.predict(r, timeout=WAIT) for r in requests]
            snap = server.metrics_snapshot()
            assert snap["reloads"] == 1 and snap["reload_failed"] == 0
            assert snap["compile_misses"] == 0 and snap["compile_warmup"] == 2 * len(server.buckets)
            assert info["canary_buckets"] == len(server.buckets) and info["slot"] == 1
            assert server.health()["ready"]
            # the slot that was live keeps the old weights, bit for bit
            old_slot = server._cache.models[0].state_dict()
            assert all(torch.equal(old_slot[k], v) for k, v in live_before.items())
        assert any(not np.allclose(after[0][k], before[k]) for k in before)
        with JaxModelServer(jserved, setup["jsamples"], JaxServeConfig(max_batch=4, max_delay_ms=5.0)) as jserver:
            jserver.reload(variables=new_jvars)
            jafter = [jserver.predict(r, timeout=WAIT) for r in requests]
        for got, want in zip(after, jafter):
            _assert_result_close(got, {k: np.asarray(v) for k, v in want.items()})
        events = read_flight_record(str(tmp_path / "flight.jsonl"))
        assert [e["source"] for e in events if e["kind"] == "reload"] == ["<variables>"]
    finally:
        served.model.load_state_dict(live_before)  # the module fixture serves on
        jserved.variables = jvars


def test_reload_rolls_back_on_canary_failure(setup, monkeypatch, tmp_path):
    served, samples = setup["served"], setup["samples"]
    live = {k: v.clone() for k, v in served.model.state_dict().items()}
    flight = FlightRecorder(str(tmp_path / "flight.jsonl"))
    with _server(setup, flight=flight, max_batch=4, max_delay_ms=5.0) as server:
        before = server.predict(samples[0], timeout=WAIT)
        monkeypatch.setenv("HGTORCH_INJECT_SERVE_TORN_RELOAD", "1")
        with pytest.raises(ReloadFailed):
            server.reload(variables=served.model.state_dict())
        monkeypatch.delenv("HGTORCH_INJECT_SERVE_TORN_RELOAD")
        with pytest.raises(ReloadFailed):
            server.reload(variables={"nope": torch.zeros(3)})
        after = server.predict(samples[0], timeout=WAIT)
        for k in before:
            np.testing.assert_array_equal(after[k], before[k])  # the old weights serve, bit for bit
        snap = server.metrics_snapshot()
        assert snap["reload_failed"] == 2 and snap["reloads"] == 0 and server._cache.active == 0
        assert server.health()["ready"]
    assert all(torch.equal(served.model.state_dict()[k], v) for k, v in live.items())
    fails = [e for e in read_flight_record(str(tmp_path / "flight.jsonl")) if e["kind"] == "reload_failed"]
    assert len(fails) == 2 and all(e["rolled_back"] for e in fails)


def test_reload_from_a_run_checkpoint(setup, tmp_path):
    """``reload("run")`` restores through the validating loader under the
    server's ``log_dir``; a reload of the same weights answers the same."""
    served, samples = setup["served"], setup["samples"]
    log_dir = str(tmp_path / "logs")
    save_model(served.model, "run_a", path=log_dir, keep_last=2)
    with _server(setup, max_batch=4, max_delay_ms=5.0) as server:
        server.log_dir = log_dir
        before = server.predict(samples[0], timeout=WAIT)
        assert server.reload("run_a")["source"] == "run_a"
        after = server.predict(samples[0], timeout=WAIT)
        with pytest.raises(ReloadFailed):
            server.reload("no_such_run")
        snap = server.metrics_snapshot()
    for k in before:
        np.testing.assert_array_equal(after[k], before[k])
    assert snap["reloads"] == 1 and snap["reload_failed"] == 1 and snap["compile_misses"] == 0
    with pytest.raises(ValueError):
        server.reload()


# ---------------------------------------------------------------------------
# registry: the validating checkpoint path
# ---------------------------------------------------------------------------


def test_registry_load_falls_back_on_torn_pointer(setup, tmp_path):
    served = setup["served"]
    log_dir = str(tmp_path / "logs") + "/"
    save_model(served.model, "torn_run", path=log_dir, keep_last=2)
    pointer = log_dir + "torn_run/torn_run.pt"
    with open(pointer, "r+b") as f:
        f.truncate(max(f.seek(0, 2) // 2, 1))
    registry = ModelRegistry(log_dir, device="cpu")
    with pytest.warns(RuntimeWarning, match="integrity"):
        loaded = registry.load("torn_run", setup["cfg"]["NeuralNetwork"], example_graph=setup["samples"][0])
    want, got = served.model.state_dict(), loaded.model.state_dict()
    assert set(want) == set(got) and all(torch.equal(want[k], got[k]) for k in want)
    assert registry.names() == ["torn_run"] and registry.get("torn_run") is loaded


# ---------------------------------------------------------------------------
# probes: health(), the Prometheus textfile, serve_probe's exit codes
# ---------------------------------------------------------------------------


def _probe(args):
    return subprocess.run([sys.executable, f"{REPO}/tools/serve_probe.py", *args], capture_output=True, text=True,
                          timeout=60).returncode


def test_health_probe_and_prometheus_textfile(setup, tmp_path):
    prom = str(tmp_path / "serve.prom")
    server = _server(setup, max_batch=2, max_delay_ms=5.0, prometheus_path=prom, prometheus_every_s=0.05)
    h = server.health()
    assert not h["live"] and h["reasons"] == ["not started", "buckets warming (0/%d)" % len(server.buckets)]
    server.start()
    try:
        h = server.health()
        assert h["live"] and h["ready"] and h["warm_buckets"] == h["num_buckets"] and h["reasons"] == []
        assert h["bucket_executor"] == "eager" and h["eager_reason"] == "the device is the CPU"

        def exported():
            try:
                with open(prom) as f:
                    return "hydragnn_serve_ready" in f.read()
            except OSError:
                return False

        assert _until(exported, 5.0)
        assert _probe(["--prom", prom]) == 0
        assert _probe(["--prom", prom, "--live"]) == 0
        assert _probe(["--prom", prom, "--max-age", "1e-9"]) == 2
        assert _probe(["--prom", str(tmp_path / "missing.prom")]) == 2
    finally:
        server.stop()
    server.export_prometheus(prom)
    assert _probe(["--prom", prom]) == 1
    assert _probe(["--prom", prom, "--live"]) == 1


def test_flight_file_passes_both_validators_and_renders(setup, monkeypatch, tmp_path):
    """A serving run's flight file with every serve fault kind: the
    port's and the JAX package's validators find no problem, the JAX
    reader no unknown kind, and ``obs_report.py --faults`` narrates it."""
    path = str(tmp_path / "flight.jsonl")
    monkeypatch.setenv("HGTORCH_INJECT_SERVE_RAISE", "0")
    monkeypatch.setenv("HGTORCH_INJECT_SERVE_KILL_DISPATCH", "2")
    monkeypatch.setenv("HGTORCH_TRACE_SAMPLE", "1")
    with _server(setup, flight=FlightRecorder(path), max_batch=2, max_delay_ms=5.0) as server:
        with pytest.raises(RequestFailed):
            server.predict(setup["samples"][0], timeout=WAIT)
        with pytest.raises(RequestFailed):
            server.predict(setup["samples"][1], timeout=WAIT)  # the killed batch
        assert _until(lambda: server.health()["ready"], 10.0)
        monkeypatch.delenv("HGTORCH_INJECT_SERVE_RAISE")
        server.predict(setup["samples"][2], timeout=WAIT)
        server.reload(variables=setup["served"].model.state_dict())
        monkeypatch.setenv("HGTORCH_INJECT_SERVE_TORN_RELOAD", "1")
        with pytest.raises(ReloadFailed):
            server.reload(variables=setup["served"].model.state_dict())
    events = read_flight_record(path)
    kinds = [e["kind"] for e in events]
    for kind in ("run_start", "quarantine", "dispatch_restart", "reload", "reload_failed", "trace_capture", "run_end"):
        assert kind in kinds, kind
    man = events[0]["manifest"]
    assert man["jax_version"] is None and man["backend"] == "cpu" and man["num_processes"] == 1
    assert man["bucket_executor"] == "eager" and man["weight_slots"] == 2 and len(man["buckets"]) == len(server.buckets)
    assert validate_flight_record(path) == [] and jax_validate_flight(path) == []
    assert jax_flight_warnings(path) == []
    out = subprocess.run([sys.executable, f"{REPO}/tools/obs_report.py", "--faults", path], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    for token in ("quarantine", "dispatch_restart", "reload", "reload_failed"):
        assert token in out.stdout
    assert "quarantined=1" in out.stdout and "reloads=1" in out.stdout


# ---------------------------------------------------------------------------
# which buckets are graphs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "edit, want",
    [
        ({}, None),
        ({"model_type": "MFC"}, "MFConv.degree_groups reads the degree counts on the host"),
        ({"node_head_type": "mlp_per_node"}, "PerNodeMLP.forward reads the position counts on the host"),
        ({"model_type": "SchNet", "radius_graph_in_forward": True},
         "radius_graph_in_forward copies its radius from the host"),
    ],
    ids=["pna", "mfc", "mlp_per_node", "schnet_inforward_radius"],
)
def test_eager_bucket_decision(setup, edit, want):
    """Decided from the model config alone, before any capture: MFC, an
    ``mlp_per_node`` head and SchNet's in-forward radius graph touch the
    host inside their forward."""
    nn = copy.deepcopy(setup["cfg"]["NeuralNetwork"])
    arch = nn["Architecture"]
    if "model_type" in edit:
        arch["model_type"] = edit["model_type"]
    if "radius_graph_in_forward" in edit:
        arch.update(radius_graph_in_forward=True, num_gaussians=50, num_filters=8)
    if "node_head_type" in edit:
        nn["Architecture"]["output_heads"]["node"]["type"] = edit["node_head_type"]
        arch["num_nodes"] = arch.get("num_nodes") or 64
    cfg = model_config_from_dict(nn)
    assert eager_reason(cfg, torch.device("cuda")) == want
    assert eager_reason(cfg, torch.device("cuda"), cuda_graphs=False) == "ServeConfig.cuda_graphs is false"
    assert eager_reason(cfg, torch.device("cpu")) == "the device is the CPU"
