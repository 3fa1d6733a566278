"""The training path's CUDA kernels (B1–B4) against their plain PyTorch
versions, and ``pna_aggregate``'s refusal of autograd on the card. Every
test here needs a card and skips without one; this file imports no JAX,
so it runs on the card machine:
``python -m pytest tests/test_torch_cuda_kernels.py -m cuda --noconftest``.

Tolerances: sums ``rtol=1e-6, atol=1e-6`` (the inputs are on a 1/4 grid,
so every order sums them exactly and the kernels match bit for bit in
practice); gathers and maxima bit-equal; two launches bitwise equal (no
atomics).
"""

import numpy as np
import pytest
import torch

from hydragnn_tpu_torch.graph.batch import batch_graphs
from hydragnn_tpu_torch.ops import gather_rows as gr_mod
from hydragnn_tpu_torch.ops import segment_sum as ss_mod
from hydragnn_tpu_torch.ops import segment_sum_local as sl_mod
from hydragnn_tpu_torch.ops.gather_stats import gather_stats, gather_stats_plain

SUM_TOL = dict(rtol=1e-6, atol=1e-6)
K = 8


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _aligned_batch(seed):
    rng = np.random.default_rng(seed)
    graphs = []
    for _ in range(40):
        n = int(rng.integers(4, 30))
        e = int(rng.integers(10, 200))
        s, r = rng.integers(0, n, e), rng.integers(0, n, e)
        order = np.lexsort((s, r))
        graphs.append({"x": np.zeros((n, 1), np.float32), "senders": s[order], "receivers": r[order]})
    b = batch_graphs(graphs, n_node_pad=1200, n_edge_pad=12000, n_graph_pad=41, run_align=K, win_block_rows=128)
    mask = b.edge_mask.clone()
    mask[8:16] = False  # a whole K-group masked
    return b, mask


def _grid(shape, seed, dtype):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((np.round(rng.normal(size=shape) * 4.0) / 4.0 + 0.0).astype(np.float32)).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h", [1, 128])
def test_cuda_kernels_match_plain(h, dtype):
    dev = _cuda()
    b, mask = _aligned_batch(h)
    n, e = b.num_nodes, b.num_edges
    send, recv8, win = b.senders, b.receivers[::K].contiguous(), b.sender_win
    table = _grid((n, h), h, dtype)
    data = _grid((e, h), h + 1, dtype)
    stats8 = _grid((e // K, 2 * h), h + 2, torch.float32)
    cases = [
        ("gather_stats", lambda d: gather_stats(*d(table, send, mask), K), gather_stats_plain(table, send, mask, K)),
        ("segment_sum", lambda d: ss_mod.segment_sum(*d(stats8, recv8), n), ss_mod.segment_sum_plain(stats8, recv8, n)),
        ("gather_rows", lambda d: gr_mod.gather_rows(*d(table, send)), gr_mod.gather_rows_plain(table, send)),
        ("segment_sum_local", lambda d: sl_mod.segment_sum_local(*d(data, send, win), n),
         sl_mod.segment_sum_local_plain(data, send, n)),
    ]

    def on_card(*ts):
        return [t.to(dev) for t in ts]

    for name, run, ref in cases:
        ref = ref if isinstance(ref, tuple) else (ref,)
        out1, out2 = run(on_card), run(on_card)
        torch.cuda.synchronize()
        out1 = out1 if isinstance(out1, tuple) else (out1,)
        out2 = out2 if isinstance(out2, tuple) else (out2,)
        for a, c, r in zip(out1, out2, ref):
            assert torch.equal(a, c), name
            if r.dtype == torch.float32 and name != "gather_rows":
                np.testing.assert_allclose(a.cpu().numpy(), r.numpy(), err_msg=name, **SUM_TOL)
            else:
                assert torch.equal(a.cpu(), r), name


@pytest.mark.cuda
def test_cuda_pna_aggregate_refuses_autograd():
    dev = _cuda()
    from hydragnn_tpu_torch.ops.pna_aggregate import pna_aggregate

    v = torch.randn(16, 4, device=dev, requires_grad=True)
    recv = torch.arange(16, dtype=torch.int32, device=dev) // 4
    with pytest.raises(NotImplementedError, match="B6"):
        pna_aggregate(v, recv, 4)
    with torch.no_grad():
        pna_aggregate(v, recv, 4)
