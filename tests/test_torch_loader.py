"""Parity of the port's run-aligned ``batch_graphs`` and ``GraphLoader``
with the JAX package's: every batch field equal, value and dtype
(``sender_win`` and ``run_align`` included), batch by batch, for epochs
0 and 1 of a shuffled loader, on the same prepared samples."""

import dataclasses

import numpy as np
import pytest
import torch

from hydragnn_tpu.data.ingest import prepare_dataset as jax_prepare_dataset
from hydragnn_tpu.data.loader import GraphLoader as JaxGraphLoader
from hydragnn_tpu.data.synthetic import deterministic_graph_data as jax_data
from hydragnn_tpu.flagship import flagship_config as jax_flagship_config
from hydragnn_tpu.graph.batch import batch_graphs as jax_batch_graphs

from hydragnn_tpu_torch.data.ingest import prepare_dataset
from hydragnn_tpu_torch.data.loader import GraphLoader
from hydragnn_tpu_torch.data.synthetic import deterministic_graph_data
from hydragnn_tpu_torch.flagship import flagship_config
from hydragnn_tpu_torch.graph.batch import batch_graphs
from hydragnn_tpu_torch.models.create import create_model_config


def _assert_batches_equal(ours, ref):
    for f in dataclasses.fields(ours):
        a, b = getattr(ours, f.name), getattr(ref, f.name)
        if isinstance(a, dict):
            assert sorted(a) == sorted(b), f.name
            for k in a:
                np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]), err_msg=f"{f.name}/{k}")
        elif isinstance(a, torch.Tensor):
            b = np.asarray(b)
            np.testing.assert_array_equal(a.numpy(), b, err_msg=f.name)
            assert a.numpy().dtype == b.dtype, f.name
        else:
            assert a == b, f.name


def _graphs(seed, n_graphs=6, unsorted=False):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_graphs):
        n = int(rng.integers(3, 14))
        e = int(rng.integers(2, 40))
        s, r = rng.integers(0, n, e), rng.integers(0, n, e)
        if not unsorted:
            order = np.lexsort((s, r))
            s, r = s[order], r[order]
        out.append({
            "x": rng.normal(size=(n, 2)).astype(np.float32),
            "senders": s,
            "receivers": r,
            "edge_attr": rng.random((e, 1)).astype(np.float32),
            "graph_targets": {"energy": rng.normal(size=(1,)).astype(np.float32)},
            "node_targets": {"charge": rng.normal(size=(n, 1)).astype(np.float32)},
        })
    return out


@pytest.mark.parametrize(
    "k,unsorted,win_rows", [(8, False, None), (8, True, 32), (3, False, 16), (4, True, None)]
)
def test_batch_graphs_run_aligned_fields_equal(k, unsorted, win_rows):
    graphs = _graphs(11 + k, unsorted=unsorted)
    # 960 edge slots: room for the aligned runs, a multiple of each K
    kw = dict(n_node_pad=112, n_edge_pad=960, n_graph_pad=8, run_align=k, win_block_rows=win_rows)
    ours, ref = batch_graphs(graphs, **kw), jax_batch_graphs(graphs, **kw)
    _assert_batches_equal(ours, ref)
    assert ours.run_align == k
    # the layout contract: one receiver per K-group (or batch tail), masked
    # slots at real nodes are self-loops, and the windows cover every sender
    recv, send = ours.receivers.numpy(), ours.senders.numpy()
    mask, nmask = ours.edge_mask.numpy(), ours.node_mask.numpy()
    groups = recv.reshape(-1, k)
    assert (groups == groups[:, :1]).all()
    pad_at_real = ~mask & nmask[recv]
    assert (send[pad_at_real] == recv[pad_at_real]).all()
    win = ours.sender_win.numpy()
    b = -(-ours.num_nodes // win.shape[1])
    b = -(-b // 16) * 16
    pos = np.arange(send.shape[0])
    assert ((pos >= win[0][send // b]) & (pos < win[1][send // b])).all()


def test_batch_graphs_run_align_rejects_bad_pads():
    graphs = _graphs(2)
    with pytest.raises(ValueError):
        batch_graphs(graphs, n_node_pad=112, n_edge_pad=324, n_graph_pad=8, run_align=8)  # not a multiple of 8
    with pytest.raises(ValueError):
        batch_graphs(graphs, n_node_pad=112, n_edge_pad=128, n_graph_pad=8, run_align=8)  # too small


def _prepared(mod_data, mod_prep, cfg, n=24):
    samples = mod_data(
        number_configurations=n, unit_cell_x_range=(2, 4), unit_cell_y_range=(2, 4),
        unit_cell_z_range=(2, 4), seed=3,
    )
    train, _, _, _, _ = mod_prep(samples, cfg)
    return train


@pytest.fixture(scope="module")
def train_splits():
    return (
        _prepared(deterministic_graph_data, prepare_dataset, flagship_config(batch_size=5)),
        _prepared(jax_data, jax_prepare_dataset, jax_flagship_config(batch_size=5)),
    )


@pytest.mark.parametrize("shuffle,drop_last", [(True, False), (True, True), (False, False)])
def test_graph_loader_batches_equal_jax(train_splits, shuffle, drop_last):
    ours_s, ref_s = train_splits
    ours = GraphLoader(ours_s, 5, shuffle=shuffle, seed=4, drop_last=drop_last)
    ref = JaxGraphLoader(ref_s, 5, shuffle=shuffle, seed=4, drop_last=drop_last, prefetch=0)
    assert len(ours) == len(ref)
    assert (ours.pad_nodes, ours.pad_edges, ours.pad_graphs) == (ref.pad_nodes, ref.pad_edges, ref.pad_graphs)
    assert ours.run_align == ref.run_align == 8 and ref.dense_slots is None
    assert ours.win_block_rows == ref.win_block_rows
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        n = 0
        for a, b in zip(ours, ref):
            _assert_batches_equal(a, b)
            n += 1
        assert n == len(ours)


def test_graph_loader_dense_auto_raises():
    """A dataset whose degrees are tight enough for the JAX loader's dense
    slot map (one ring of equal-degree nodes per sample): the port's
    loader picks the same map, its batches equal the JAX loader's, and
    PNA's dense branch runs on such a batch (it raised until that branch
    was ported) and gives what its CSR branch gives on the same graphs."""

    class Ring:
        def __init__(self, n):
            src = np.arange(n)
            self.edge_index = np.stack([np.concatenate([src, src]), np.concatenate([(src + 1) % n, (src - 1) % n])])
            self.num_nodes, self.num_edges = n, 2 * n
            self.x = np.zeros((n, 1), np.float32)
            self.pos = self.edge_attr = None
            self.graph_targets, self.node_targets = {}, {}

    rings = [Ring(10) for _ in range(4)]
    jloader = JaxGraphLoader(rings, 2, prefetch=0)
    loader = GraphLoader(rings, 2)
    assert jloader.dense_slots == loader.dense_slots == 2 and loader.run_align == 0
    for ours, ref in zip(loader, jloader):
        _assert_batches_equal(ours, ref)
    batch = next(iter(loader))
    assert batch.dense_senders.shape == (batch.num_nodes, 2)
    cfg = flagship_config(hidden_dim=4, num_conv_layers=1)["NeuralNetwork"]
    cfg["Architecture"].update(input_dim=1, output_dim=[1], output_type=["graph"], pna_deg=[0, 0, 40])
    cfg["Variables_of_interest"] = {"output_names": ["e"]}
    cfg["Architecture"]["task_weights"] = [1.0]
    model = create_model_config(cfg, device="cpu")
    with torch.no_grad():
        dense_out = model(batch)[0]
    loader = GraphLoader(rings, 2, dense_slots=False)
    assert loader.run_align == 8 and loader.dense_slots is None and len(loader) == 2
    with torch.no_grad():
        csr_out = model(next(iter(loader)))[0]
    assert torch.isfinite(dense_out).all()
    torch.testing.assert_close(dense_out, csr_out, rtol=1e-5, atol=1e-6)
