"""Parity of the port's ``batch_graphs``, pad plans and masked segment
ops with the JAX package's: every emitted batch field equal, value and
dtype, on the same graphs (including unsorted, sender-major edge orders
the batcher must canonicalize)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydragnn_tpu.data.loader import bucket_pad_plans as jax_bucket_pad_plans
from hydragnn_tpu.data.loader import pad_plan_for as jax_pad_plan_for
from hydragnn_tpu.graph import segment as jax_segment
from hydragnn_tpu.graph.batch import batch_graphs as jax_batch_graphs

from hydragnn_tpu_torch.data.loader import bucket_pad_plans, pad_plan_for
from hydragnn_tpu_torch.graph import segment as t_segment
from hydragnn_tpu_torch.graph.batch import GraphBatch, batch_graphs


def _graphs(seed, n_graphs=5, unsorted=False, with_pos=True):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_graphs):
        n = int(rng.integers(3, 12))
        e = int(rng.integers(2, 30))
        s = rng.integers(0, n, e)
        r = rng.integers(0, n, e)
        if not unsorted:
            order = np.lexsort((s, r))
            s, r = s[order], r[order]
        g = {
            "x": rng.normal(size=(n, 2)).astype(np.float32),
            "senders": s,
            "receivers": r,
            "edge_attr": rng.random((e, 1)).astype(np.float32),
            "graph_targets": {"energy": rng.normal(size=(1,)).astype(np.float32)},
            "node_targets": {"charge": rng.normal(size=(n, 1)).astype(np.float32)},
        }
        if with_pos:
            g["pos"] = rng.normal(size=(n, 3)).astype(np.float32)
        out.append(g)
    return out


def _fields(batch: GraphBatch):
    return [f.name for f in dataclasses.fields(batch)]


@pytest.mark.parametrize(
    "unsorted,pad",
    [(False, None), (True, None), (False, (96, 200, 9)), (True, (64, 160, 7))],
)
def test_batch_graphs_fields_equal(unsorted, pad):
    graphs = _graphs(7, unsorted=unsorted)
    kw = {} if pad is None else dict(n_node_pad=pad[0], n_edge_pad=pad[1], n_graph_pad=pad[2])
    ours = batch_graphs(graphs, **kw)
    ref = jax_batch_graphs(graphs, **kw)
    for name in _fields(ours):
        a, b = getattr(ours, name), getattr(ref, name)
        if isinstance(a, dict):
            assert sorted(a) == sorted(b), name
            for k in a:
                np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]), err_msg=f"{name}/{k}")
            continue
        assert (a is None) == (b is None), name
        if a is None:
            continue
        if not isinstance(a, torch.Tensor):  # run_align, a static int
            assert a == b, name
            continue
        b = np.asarray(b)
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
        assert a.numpy().dtype == b.dtype, name
    # receivers sorted ascending: the CSR kernel's contract
    recv = ours.receivers.numpy()
    assert np.all(recv[:-1] <= recv[1:])


def test_batch_to_device_moves_every_tensor():
    b = batch_graphs(_graphs(3)).to("cpu")
    for name in _fields(b):
        v = getattr(b, name)
        if isinstance(v, torch.Tensor):
            assert v.device.type == "cpu"


def test_batch_graphs_rejects_small_pads():
    with pytest.raises(ValueError):
        batch_graphs(_graphs(1), n_node_pad=4)


@pytest.mark.parametrize("batch_size,num_buckets", [(4, 3), (8, 3), (2, 1)])
def test_pad_plans_same_ladder(batch_size, num_buckets):
    rng = np.random.default_rng(batch_size)

    class S:
        def __init__(self, n, e):
            self.num_nodes, self.num_edges = n, e

    sizes = [S(int(n), int(e)) for n, e in zip(rng.integers(5, 60, 40), rng.integers(10, 900, 40))]
    assert pad_plan_for(sizes, batch_size) == jax_pad_plan_for(sizes, batch_size)
    assert bucket_pad_plans(sizes, batch_size, num_buckets) == jax_bucket_pad_plans(
        sizes, batch_size, num_buckets
    )


@pytest.mark.parametrize("op", ["segment_sum", "segment_count", "segment_mean", "segment_max", "segment_min"])
def test_segment_ops_match_jax(op):
    """Masked forward segment ops (graph/segment.py) against the JAX
    package's, with empty and all-masked segments: sums and means to
    1e-6, counts and extrema exactly."""
    rng = np.random.default_rng(len(op))
    n, e = 12, 80
    ids = np.sort(rng.integers(0, n - 3, e)).astype(np.int32)  # last 3 rows empty
    data = rng.normal(size=(e, 4)).astype(np.float32)
    mask = rng.random(e) > 0.3
    mask[ids == 2] = False  # an all-masked row
    if op == "segment_count":
        ours = t_segment.segment_count(torch.from_numpy(ids), n, torch.from_numpy(mask))
        ref = jax_segment.segment_count(jnp.asarray(ids), n, jnp.asarray(mask))
    else:
        ours = getattr(t_segment, op)(torch.from_numpy(data), torch.from_numpy(ids), n, torch.from_numpy(mask))
        ref = getattr(jax_segment, op)(jnp.asarray(data), jnp.asarray(ids), n, jnp.asarray(mask))
    if op in ("segment_sum", "segment_mean"):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
