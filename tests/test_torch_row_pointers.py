"""The receivers' CSR row pointers, built once per forward: the chassis'
``EdgeContext.row_ptr`` (``models/convs.py``) on every batch
layout the port builds, the kernel wrappers' checks of a ``row_ptr``
they are handed, and the models' forward and backward with and without
them on the CPU, held to the JAX package.

On the CPU the row pointers are ``torch.searchsorted`` and the plain
versions of B5 and B8 do not read them, so a forward with them equals
one without them bit for bit; the card's side (the pass, and the
kernels walking it) is in ``tests/test_torch_cuda_kernels.py``.
Tolerances: the row pointers exact; the parity with the JAX package
``tests/test_torch_pna_layouts.py``'s (outputs and gradients
``rtol=1e-4, atol=1e-5``).
"""

import numpy as np
import pytest
import torch

from hydragnn_tpu_torch.api import prepare_config_and_samples
from hydragnn_tpu_torch.data.synthetic import deterministic_graph_data
from hydragnn_tpu_torch.flagship import flagship_config
from hydragnn_tpu_torch.graph.batch import batch_graphs
from hydragnn_tpu_torch.models.base import HydraModel, model_loss
from hydragnn_tpu_torch.models.convs import EdgeContext
from hydragnn_tpu_torch.models.create import create_model_config
from hydragnn_tpu_torch.ops import fused_conv as fc
from hydragnn_tpu_torch.ops import pna_aggregate_bwd as bwd
from hydragnn_tpu_torch.ops import row_pointers as rp
from hydragnn_tpu_torch.ops.pna_aggregate import pna_aggregate
from hydragnn_tpu_torch.serve import ServeConfig, build_bucket_ladder, request_to_dict

from test_torch_conv_stacks import _both as stack_both
from test_torch_pna_layouts import _both, _compare_step


def _searchsorted(receivers, n):
    return np.searchsorted(receivers.numpy(), np.arange(n + 1), side="left").astype(np.int32)


def _assert_row_ptr(ctx):
    n = ctx.node_mask.shape[0]
    assert ctx.row_ptr is not None and ctx.row_ptr.dtype == torch.int32
    np.testing.assert_array_equal(ctx.row_ptr.numpy(), _searchsorted(ctx.receivers, n))


@pytest.mark.parametrize("layout", ["run_aligned", "unaligned", "dense"])
@pytest.mark.parametrize("model_type", ["PNA", "GIN"])
def test_edge_context_row_ptr_on_every_layout(model_type, layout, monkeypatch):
    """The row pointers are built at their first read: a forward of GIN
    reads them (B8) on every layout, one of PNA only on the unaligned one
    (B5), and builds none where its statistics come from B1 (run-aligned)
    or the dense slot map. Where read, they are the receivers'."""
    cfg, _, loader, _ = _both(layout, model_type=model_type)
    batch = next(iter(loader))
    assert (batch.dense_senders is not None) == (layout == "dense")
    model = create_model_config(cfg["NeuralNetwork"], device="cpu")
    seen = []
    build = HydraModel.edge_context
    monkeypatch.setattr(HydraModel, "edge_context", lambda self, b: seen.append(build(self, b)) or seen[-1])
    model(batch, train=False)
    (ctx,) = seen
    read = "row_ptr" in vars(ctx)
    assert read == (model_type == "GIN" or layout == "unaligned")
    _assert_row_ptr(ctx)


def test_edge_context_row_ptr_on_a_serving_bucket():
    """The flagship served: its largest bucket's batch, as the server pads
    it, carries the receivers' row pointers."""
    cfg = flagship_config()
    raw = deterministic_graph_data(number_configurations=16, unit_cell_x_range=(2, 3),
                                   unit_cell_y_range=(2, 3), unit_cell_z_range=(2, 3), seed=0)
    tr, va, te, cfg = prepare_config_and_samples(cfg, raw)
    prepared = list(tr) + list(va) + list(te)
    top = build_bucket_ladder(prepared, ServeConfig().max_batch)[-1]
    batch = batch_graphs([request_to_dict(s) for s in prepared[: top.max_batch]], n_node_pad=top.node_pad,
                         n_edge_pad=top.edge_pad, n_graph_pad=top.graph_pad)
    model = create_model_config(cfg["NeuralNetwork"], device="cpu")
    _assert_row_ptr(model.edge_context(batch))


def test_edge_context_row_ptr_on_the_inforward_radius_graph():
    """SchNet rebuilding its radius graph in the forward: the row
    pointers are those of the rebuilt receivers."""
    cfg, _, loader, _ = stack_both("SchNet")
    cfg["NeuralNetwork"]["Architecture"]["radius_graph_in_forward"] = True
    batch = next(iter(loader))
    model = create_model_config(cfg["NeuralNetwork"], device="cpu")
    ctx = model.edge_context(batch)
    assert ctx.receivers.shape != batch.receivers.shape or not torch.equal(ctx.receivers, batch.receivers)
    _assert_row_ptr(ctx)


def _bad_row_ptrs(n):
    good = rp.row_pointers(torch.tensor([0, 0, 2], dtype=torch.int32), n)
    return {
        "length": (good[:-1], ValueError),
        "dtype": (good.long(), TypeError),
        "device": (good.to("meta"), ValueError),
        "strided": (torch.zeros(2 * (n + 1), dtype=torch.int32)[::2], ValueError),
    }


@pytest.mark.parametrize("bad", ["length", "dtype", "device", "strided"])
def test_wrappers_reject_a_bad_row_ptr(bad):
    """B5, B6 and B8's wrappers (and B8's autograd op) raise on a
    ``row_ptr`` of the wrong length, type, device or layout, on the CPU
    too, where the plain versions would not read it. (B7 walks edges and
    takes no row pointers.)"""
    n, h = 4, 3
    recv = torch.tensor([0, 0, 2], dtype=torch.int32)
    send = torch.tensor([1, 3, 0], dtype=torch.int32)
    mask = torch.tensor([True, False, True])
    v = torch.randn(3, h)
    row_ptr, err = _bad_row_ptrs(n)[bad]
    both = torch.zeros(n, 2 * h)
    calls = [
        lambda: pna_aggregate(v, recv, n, mask, row_ptr=row_ptr),
        lambda: pna_aggregate(v.clone().requires_grad_(True), recv, n, mask, row_ptr=row_ptr),
        lambda: fc.fused_conv(torch.randn(n, h), send, recv, mask, n, row_ptr=row_ptr),
        lambda: fc.fused_aggregate(torch.randn(n, h, requires_grad=True), send, recv, mask, n, row_ptr=row_ptr),
        lambda: bwd.pna_bwd_count(v, recv, mask, both, n, row_ptr),
    ]
    for call in calls:
        with pytest.raises(err, match="row_ptr"):
            call()


def test_row_pointers_rejects_bad_receivers():
    with pytest.raises(ValueError):
        rp.row_pointers(torch.zeros(2, 2, dtype=torch.int32), 3)
    with pytest.raises(ValueError):
        rp.row_pointers(torch.zeros(2, dtype=torch.int32), 0)
    before = rp.launches.value
    rp.row_pointers(torch.zeros(2, dtype=torch.int32), 3)
    assert rp.launches.value == before  # the CPU's searchsorted is no launch


@pytest.mark.parametrize("model_type,layout", [("PNA", "unaligned"), ("GIN", "run_aligned"), ("GIN", "unaligned")])
def test_forward_and_backward_equal_without_row_ptr_and_match_jax(model_type, layout, monkeypatch):
    """One train-mode forward and backward with the chassis' row
    pointers, held to the JAX package, then again without them (every
    wrapper builds its own): outputs and gradients bit-equal."""
    cfg, jcfg, loader, jloader = _both(layout, model_type=model_type)
    batch, jbatch = next(iter(loader)), next(iter(jloader))
    model = _compare_step(cfg, jcfg, batch, jbatch)
    assert model.edge_context(batch).row_ptr is not None

    def step():
        model.zero_grad(set_to_none=True)
        outs = model(batch, train=True)
        loss, _ = model_loss(model.cfg, outs, batch)
        loss.backward()
        return [o.detach() for o in outs] + [p.grad.clone() for p in model.parameters()]

    with_ptr = step()
    monkeypatch.setattr(EdgeContext, "row_ptr", property(lambda self: None))
    assert model.edge_context(batch).row_ptr is None
    without = step()
    assert len(with_ptr) == len(without)
    for a, b in zip(with_ptr, without):
        assert torch.equal(a, b)

