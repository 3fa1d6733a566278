"""The port's serving path on the CPU: ``serve_model(..., device="cpu")``
answers requests from several threads across more than one bucket, plus
oversize requests (largest-bucket and eager paths), and every answer
equals the port's unbatched forward on that graph and the JAX model's
forward with the same weights (``rtol=1e-4, atol=1e-5``, float32).
Without a card, the default ``device`` raises.
"""

import threading

import numpy as np
import pytest
import torch

import jax

from hydragnn_tpu.data.ingest import prepare_dataset as jax_prepare_dataset
from hydragnn_tpu.data.synthetic import deterministic_graph_data as jax_data
from hydragnn_tpu.flagship import flagship_config as jax_flagship_config
from hydragnn_tpu.graph.batch import batch_graphs as jax_batch_graphs
from hydragnn_tpu.models.base import HydraModel as JaxHydraModel
from hydragnn_tpu.models.create import model_config_from_dict as jax_model_config
from hydragnn_tpu.utils.config import update_config as jax_update_config

import hydragnn_tpu_torch
from hydragnn_tpu_torch.convert import variables_from_flax
from hydragnn_tpu_torch.data.radius_graph import edge_lengths, radius_graph
from hydragnn_tpu_torch.data.synthetic import deterministic_graph_data
from hydragnn_tpu_torch.flagship import flagship_config
from hydragnn_tpu_torch.graph.batch import batch_graphs
from hydragnn_tpu_torch.serve import MicroBatchQueue, Overloaded, RequestFailed, ServeConfig
from hydragnn_tpu_torch.serve.server import request_to_dict

TOL = dict(rtol=1e-4, atol=1e-5)
HIDDEN, LAYERS, N_SAMPLES = 16, 2, 32


def _raw(mod):
    return mod(
        number_configurations=N_SAMPLES,
        unit_cell_x_range=(2, 4),
        unit_cell_y_range=(2, 4),
        unit_cell_z_range=(2, 4),
        seed=4,
    )


def _bcc_request(cells, seed):
    """A prepared-looking request bigger than any dataset graph."""
    g = np.stack(np.meshgrid(*[np.arange(cells)] * 3, indexing="ij"), -1).reshape(-1, 3)
    pos = np.concatenate([g, g + 0.5]).astype(np.float32)
    ei = radius_graph(pos, 2.0, max_num_neighbors=100)
    x = np.random.default_rng(seed).random((pos.shape[0], 1)).astype(np.float32)
    ea = edge_lengths(pos, ei) / 2.0
    return {"x": x, "senders": ei[0], "receivers": ei[1], "pos": pos, "edge_attr": ea}


@pytest.fixture(scope="module")
def served():
    jcfg = jax_flagship_config(HIDDEN, LAYERS)
    tr, va, te, _, _ = jax_prepare_dataset(_raw(jax_data), jcfg)
    jcfg = jax_update_config(jcfg, tr, va, te)
    jmodel = JaxHydraModel(jax_model_config(jcfg["NeuralNetwork"]))
    example = jax_batch_graphs([request_to_dict(s) for s in tr[:2]])
    jvars = jax.jit(lambda b: jmodel.init(jax.random.PRNGKey(0), b, train=False))(example)
    rng = np.random.default_rng(9)
    jvars = jax.tree_util.tree_map(
        lambda a: (rng.normal(scale=0.3, size=np.shape(a))).astype(np.float32), jvars
    )
    jvars["batch_stats"] = jax.tree_util.tree_map(np.abs, jvars["batch_stats"])
    server = hydragnn_tpu_torch.serve_model(
        flagship_config(HIDDEN, LAYERS),
        _raw(deterministic_graph_data),
        params=variables_from_flax(jvars),
        serve_config=ServeConfig(max_batch=4, max_delay_ms=20.0),
        device="cpu",
    )
    yield server, jax.jit(lambda v, b: jmodel.apply(v, b, train=False)), jvars
    server.stop()


def _requests(server):
    reqs = [request_to_dict(s) for s in server.reference_samples]
    return reqs + [_bcc_request(4, 1), _bcc_request(7, 2)]


def test_served_answers_match_direct_and_jax_forward(served):
    server, jax_forward, jvars = served
    reqs = _requests(server)
    results = [None] * len(reqs)

    def worker(k):
        futs = [(i, server.submit(reqs[i])) for i in range(k, len(reqs), 4)]
        for i, f in futs:
            results[i] = f.result(timeout=120)

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
        assert not t.is_alive()

    snap = server.metrics_snapshot()
    assert snap["results_total"] >= len(reqs) and snap["errors"] == 0
    used = [b for b in snap["buckets"].values() if b["batches"]]
    assert len(used) > 1  # more than one bucket served
    assert snap["oversize_largest_bucket"] == 1 and snap["oversize_eager"] == 1
    assert snap["latency"]["p99_ms"] >= snap["latency"]["p50_ms"] > 0

    cfg = server.served.cfg
    # the JAX reference: one batch of the dataset requests, one of the two
    # oversize ones (a batched forward equals the unbatched one per graph)
    jax_rows = []
    for group in (reqs[:-2], reqs[-2:]):
        jref = [np.asarray(o) for o in jax_forward(jvars, jax_batch_graphs(group))]
        off = 0
        for gi, g in enumerate(group):
            n = g["x"].shape[0]
            jax_rows.append([o[gi] if t == "graph" else o[off : off + n] for o, t in zip(jref, cfg.output_type)])
            off += n
    for g, res, jrow in zip(reqs, results, jax_rows):
        with torch.no_grad():
            direct = server.served.model(batch_graphs([g]), train=False)
        n = g["x"].shape[0]
        for ihead, name in enumerate(cfg.output_names):
            d = direct[ihead].numpy()
            d = d[0] if cfg.output_type[ihead] == "graph" else d[:n]
            assert np.all(np.isfinite(res[name]))
            np.testing.assert_allclose(res[name], d, **TOL)
            np.testing.assert_allclose(res[name], jrow[ihead], **TOL)


def test_nonfinite_request_is_isolated(served):
    server = served[0]
    good = [request_to_dict(s) for s in server.reference_samples[:3]]
    bad = dict(good[0])
    bad["x"] = np.full_like(good[0]["x"], np.nan)
    futs = [server.submit(g) for g in good[:2]] + [server.submit(bad)]
    assert all(np.isfinite(v).all() for f in futs[:2] for v in f.result(60).values())
    with pytest.raises(RequestFailed) as err:
        futs[2].result(60)
    assert err.value.reason == "nonfinite"


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        hydragnn_tpu_torch.serve_model(flagship_config(HIDDEN, LAYERS), _raw(deterministic_graph_data))


def test_queue_backpressure_and_flush_reasons():
    q = MicroBatchQueue(num_buckets=2, max_batch=2, max_delay_s=0.01, max_pending=3)
    q.put(0, "a")
    q.put(0, "b")
    q.put(1, "c")
    with pytest.raises(Overloaded):
        q.put(1, "d")
    assert q.take_batch()[2] == "full"
    bucket, reqs, reason = q.take_batch()
    assert (bucket, [r.item for r in reqs], reason) == (1, ["c"], "deadline")
    q.close()
    assert q.take_batch() is None


def test_serve_model_loads_a_saved_state_dict(served, tmp_path):
    server = served[0]
    path = tmp_path / "weights.pt"
    torch.save(server.served.model.state_dict(), path)
    other = hydragnn_tpu_torch.serve_model(
        flagship_config(HIDDEN, LAYERS), _raw(deterministic_graph_data),
        params=str(path), device="cpu", start=False,
    )
    want = server.served.model.state_dict()
    got = other.served.model.state_dict()
    assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)


def test_shared_counters_survive_thread_contention():
    """More threads than cores hammer the launch count and the serving
    metrics with a tiny switch interval; no increment may be lost."""
    import sys

    from hydragnn_tpu_torch.ops.pna_aggregate import LaunchCount
    from hydragnn_tpu_torch.serve import ServeMetrics

    count, metrics = LaunchCount(), ServeMetrics(num_buckets=2)
    n_threads, n_iter = 32, 300
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for i in range(n_iter):
                count.add()
                metrics.record_request(i % 2)
                metrics.record_forward()
                metrics.observe_latency(1e-3)

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    total = n_threads * n_iter
    snap = metrics.snapshot()
    assert count.value == total
    assert snap["requests_total"] == snap["forwards_total"] == snap["results_total"] == total
    assert sum(b["requests"] for b in snap["buckets"].values()) == total
