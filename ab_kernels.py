#!/usr/bin/env python3
"""ab_kernels.py — time the port's B1 (``gather_stats``) and the backward
of its autograd op (``gather_presum_stats``), B4 (``segment_sum_local``),
B5 (``pna_aggregate``), B8 (``fused_conv``, K = 0) walks and B9
(``fused_conv_stack``), the
receivers' row-pointer pass, and the train steps and the served forward
that carry them, from one checkout of the repository, so that two
commits can be compared on one card in one run.

    python3 ab_kernels.py [--root DIR] [--tag NAME]   # on a CUDA machine

``--root`` (default: this file's directory) is the checkout whose
``hydragnn_tpu_torch`` is imported; its kernels are built from its own
sources. To compare a parent commit with a change, unpack the parent
into a gitignored directory (``git archive``) and run both in turns on
one card: parent, change, change, parent.

Prints one ``[ab]`` line per measurement (ms per call between CUDA
events, eager and in a CUDA graph; eager times are the median, and
``ms_min`` the least, of three timings, five for the served forward)
and, last, one JSON object with all of them. The inputs are made from seed 0 as ``chip_smoke.py`` makes
them:
  - the flagship's run-aligned training batch (1,024 BCC graphs: 32,752
    node rows, 810,888 edge slots) for B8 identity at H = 1 and 128, B8
    scale at F = 126, B8 identity at H = 1 with the shared row pointers
    (``b8_identity_h1_row_ptr``, where the checkout's ``fused_conv``
    takes them), the row-pointer pass alone (``row_pointers``), B4 at H
    = 1 and 128;
    ``torch.sparse.mm`` and ``index_add_`` beside them; B1 forward at H =
    128 and 1 (eager and in a CUDA graph) and the op's backward through
    ``torch.autograd.grad`` (eager: autograd replays on the forward's
    stream, outside a graph's capture), both through the public API;
  - the molecular data's dense-map batch (``tests/test_train_e2e.py``'s
    data, 64 graphs): B8 and B4 on its edge list and on its dense slots;
  - a synthetic batch of 4,096 rows of 24 slots with one row of 60,000
    slots (5 real, the rest masked) for B8, and one row of 60,000 edges
    for B4;
  - B5 (``b5_{train,serve}_h{128,1}_{f32,bf16}``, and ``_row_ptr``
    with the shared row pointers where the checkout's ``pna_aggregate``
    takes them) on random v at the flagship's unaligned training batch
    ([699,368 x H] into 32,752 rows) and at the largest serving bucket
    of ``chip_smoke.py``'s 64 graphs ([11,528 x H] into 448 rows), with
    the two ``torch.segment_reduce`` calls that compute the same
    statistics beside them (``segment_reduce_pair_*``, eager: they
    cannot be captured in a CUDA graph);
  - one device train step (batch on the card) of the run-aligned PNA
    flagship, GIN and SchNet at batch 1024, and of the flagship on the
    unaligned layout (``step_PNA_unaligned``); for PNA and GIN also the
    step's train-mode forward alone (``forward_*``), its forward and
    backward without the optimizer (``forward_backward_*``) and the
    optimizer's step alone on the step's gradients (``optimizer_*``) and
    the card's busy time a step (``step_device_*``); ``--steps-only`` times just these, 15 repetitions each; one eval forward of the
    flagship on the largest serving bucket (``serve_forward_bucket8``,
    eager, the batch on the card);
  - B9 (``fused_conv_stack``, hidden 128, 6 layers) on both flagship
    layouts: the forward (``b9_forward_{run_aligned,unaligned}``), its
    node products' and walks' device time (``b9_split_*``, by
    torch.profiler) and the per-layer library composition
    (``b9_library_*``: torch.addmm, the sigmoid, torch.sparse.mm);
  - the training loop's batch (the flagship's first run-aligned train
    batch at batch 128, whose masked tail runs past its edge
    occupancy): B2 on B1's K-group statistics (``b2_b128``) and B4 on
    B1's backward's grad_v (``b4_b128``), each also with the occupancy
    bound (``_bound``) where the checkout's kernels take it; B2 at the
    batch-1024 shape (``b2_b1024``, ``_bound``); the guarded train step
    at batch 128 (``step_guarded_b128``: ms, the card's busy ms and
    launches, B2's and B4's device ms and calls by torch.profiler);
    B5, B6 and B7 at H = 128 on the same graphs' unaligned batch of 128
    (``b{5,6,7}_b128_unaligned``, and ``_bound`` with the occupancy
    bound where the checkout's kernels take it), B6 and B7 at the
    unaligned batch of 1,024 (``b{6,7}_b1024_unaligned``, with the bound
    where taken, as the main path calls them) and on a hub of 60,000
    slots among 4,096 rows of 24 (``b{6,7}_hub``); the guarded train
    step on that unaligned batch of 128 (``step_guarded_b128_unaligned``:
    ms, the card's busy ms and launches, B5's, B6's and B7's device ms
    and calls). Their bounds are ``chip_smoke.py``'s ``[timing]`` lines
    at the same shapes.
"""

import argparse
import glob
import importlib
import inspect
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile


def cuda_ms(fn, iters):
    """Mean ms per call over ``iters`` warm calls, between CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def graph_ms(fn, iters):
    """ms per call of ``iters`` calls captured in one CUDA graph."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    g.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def long_row_inputs(dev, h, seed=0, rows=4096, slots=24, long_slots=60_000):
    """B8's synthetic skew batch: ``rows`` rows of ``slots`` slots (about
    3/4 real) and row 100 of ``long_slots`` slots, 5 of them real; sorted
    receivers; x [rows, h] normal. B4's: the same receivers as ids, so
    row 100 has ``long_slots`` edges, with their window plan."""
    rng = np.random.default_rng(seed)
    counts = np.full(rows, slots)
    counts[100] = long_slots
    recv = np.repeat(np.arange(rows), counts).astype(np.int32)
    mask = rng.random(recv.size) > 0.25
    row100 = np.flatnonzero(recv == 100)
    mask[row100] = False
    mask[row100[[0, 1, 2, -2, -1]]] = True
    send = rng.integers(0, rows, recv.size).astype(np.int32)
    x = torch.from_numpy(rng.normal(size=(rows, h)).astype(np.float32)).to(dev)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return x, t(send), t(recv), t(mask), rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--tag", default="change")
    ap.add_argument("--no-steps", action="store_true", help="kernels only")
    ap.add_argument("--steps-only", action="store_true",
                    help="only the batch-1024 PNA and GIN steps and their parts (more repetitions)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ab_kernels: needs a CUDA card")
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import hydragnn_tpu_torch
    from hydragnn_tpu_torch.api import prepare_config_and_samples, prepare_loaders_and_config
    from hydragnn_tpu_torch.data.loader import GraphLoader
    from hydragnn_tpu_torch.graph.batch import batch_graphs
    from hydragnn_tpu_torch.data.synthetic import deterministic_graph_data
    from hydragnn_tpu_torch.flagship import flagship_config
    from hydragnn_tpu_torch.graph.batch import _block_windows
    from hydragnn_tpu_torch.models.create import create_model_config
    from hydragnn_tpu_torch.ops import fused_conv as b8
    from hydragnn_tpu_torch.ops import gather_stats as b1
    from hydragnn_tpu_torch.ops import pna_aggregate as b5
    from hydragnn_tpu_torch.ops import pna_aggregate_bwd as b67
    from hydragnn_tpu_torch.ops import segment_sum as b2
    from hydragnn_tpu_torch.ops import segment_sum_local as b4
    from hydragnn_tpu_torch.ops._build import CSRC_DIR, build_all
    from hydragnn_tpu_torch.serve import ServeConfig, build_bucket_ladder, request_to_dict
    from hydragnn_tpu_torch.train.optimizer import select_optimizer
    from hydragnn_tpu_torch.train.state import make_train_step, train_step

    if not os.path.abspath(hydragnn_tpu_torch.__file__).startswith(root):
        raise SystemExit(f"ab_kernels: imported {hydragnn_tpu_torch.__file__}, not from {root}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    dev = hydragnn_tpu_torch.resolve_device("cuda")
    build_all(sorted(os.path.basename(p) for p in glob.glob(os.path.join(CSRC_DIR, "*.cu"))))
    try:  # one shared pass since the row pointers moved into the chassis
        from hydragnn_tpu_torch.ops.row_pointers import row_pointers
    except ImportError:  # before: B8's own pass, run alone
        row_pointers = b8.row_pointers
    b8_takes_ptr = "row_ptr" in inspect.signature(b8.fused_conv).parameters
    b5_takes_ptr = "row_ptr" in inspect.signature(b5.pna_aggregate).parameters
    b2_takes_bound = "real_rows" in inspect.signature(b2.segment_sum).parameters
    b4_takes_bound = "real_edges" in inspect.signature(b4.segment_sum_local).parameters
    pna_takes_bound = "real_edges" in inspect.signature(b67.pna_bwd_grad).parameters
    results = {}

    def record(name, **kw):
        results[name] = kw
        print(f"[ab] tag={args.tag} name={name} " + " ".join(
            f"{k}={round(v, 5) if isinstance(v, float) else v}" for k, v in kw.items()), flush=True)

    def eager(fn, iters, reps=3):
        """(median, min) of ``reps`` eager timings: the host's noise
        lands on single timings, the minimum shows the host's best."""
        t = [cuda_ms(fn, iters) for _ in range(reps)]
        return float(np.median(t)), min(t)

    def both(name, fn, iters=50, g_iters=20, **extra):
        ms, ms_min = eager(fn, iters)
        record(name, ms=ms, ms_min=ms_min, graph_ms=graph_ms(fn, g_iters), **extra)

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    # the flagship's run-aligned training batch
    def stack_config(model_type, batch_size=1024):
        cfg = flagship_config(batch_size=batch_size, num_epoch=1)
        arch = cfg["NeuralNetwork"]["Architecture"]
        arch["model_type"] = model_type
        if model_type == "SchNet":
            arch["num_filters"], arch["num_gaussians"] = 126, 50
        return cfg

    def samples():  # made anew for each config: preparing them normalises in place
        return deterministic_graph_data(number_configurations=1280, unit_cell_x_range=(2, 4),
                                        unit_cell_y_range=(2, 4), unit_cell_z_range=(2, 4), seed=0)

    loaders = {mt: prepare_loaders_and_config(stack_config(mt), samples()) for mt in ("PNA", "GIN", "SchNet")}

    def model_steps(kinds, reps):
        """The train step of each model type at batch 1024, and for PNA
        and GIN its train-mode forward, its forward and backward without
        the optimizer, and the optimizer alone on the step's gradients."""
        from hydragnn_tpu_torch.models.base import model_loss

        for mt in kinds:
            tl, done = loaders[mt][0], loaders[mt][3]
            model = create_model_config(done["NeuralNetwork"], seed=1, device="cuda")
            opt = select_optimizer(model, done["NeuralNetwork"]["Training"])
            b = next(iter(tl)).to(dev)
            ms, ms_min = eager(lambda: train_step(model, opt, b), 5, reps=reps)
            record(f"step_{mt}", ms=ms, ms_min=ms_min, run_align=b.run_align)
            if mt in ("PNA", "GIN"):
                def fwd_bwd():
                    opt.zero_grad(set_to_none=True)
                    model_loss(model.cfg, model(b, train=True), b)[0].backward()

                ms, ms_min = eager(lambda: model(b, train=True), 5, reps=reps)
                record(f"forward_{mt}", ms=ms, ms_min=ms_min)
                ms, ms_min = eager(fwd_bwd, 5, reps=reps)
                record(f"forward_backward_{mt}", ms=ms, ms_min=ms_min)
                ms, ms_min = eager(opt.step, 20, reps=reps)
                record(f"optimizer_{mt}", ms=ms, ms_min=ms_min, params=sum(p.numel() for p in model.parameters()))
                # the card's busy time a step (torch.profiler over 3 steps)
                with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                    for _ in range(3):
                        train_step(model, opt, b)
                    torch.cuda.synchronize()
                busy = [ev for ev in prof.key_averages() if ev.self_device_time_total > 0]
                record(f"step_device_{mt}", ms=sum(ev.self_device_time_total for ev in busy) / 3e3 if busy
                       else "not measured", launches=sum(ev.count for ev in busy) // 3)

    def loop_batch():
        """The training loop's batch: the flagship's first run-aligned
        train batch at batch 128, on the card; its host copy; and its
        completed config."""
        tl128, _, _, done128 = prepare_loaders_and_config(stack_config("PNA", batch_size=128), samples())
        h128 = next(iter(tl128))
        return h128.to(dev), h128, done128, tl128

    def guarded_step_b128(reps):
        """The guarded train step at batch 128, on the run-aligned batch
        and on the same graphs' unaligned batch: ms, and by torch.profiler
        (3 steps) the card's busy ms, launches, and the device ms and
        calls a step of B2 and B4 (run-aligned) or B5, B6 and B7
        (unaligned)."""
        b, _, done128, tl128 = loop_batch()
        ub = next(iter(GraphLoader(tl128.samples, 128, dense_slots=False, run_align=False))).to(dev)
        model = create_model_config(done128["NeuralNetwork"], seed=1, device="cuda")
        step = make_train_step(model, select_optimizer(model, done128["NeuralNetwork"]["Training"]),
                               guard_nonfinite=True)
        consec = torch.zeros((), dtype=torch.int32, device=dev)
        kernels = {"": {"b2": ("segment_sum_kernel",), "b4": ("segment_sum_local_kernel",)},
                   "_unaligned": {"b5": ("pna_aggregate_warp_kernel", "pna_aggregate_h1_kernel"),
                                  "b6": ("pna_bwd_count_kernel", "pna_bwd_count_h1_kernel",
                                         "pna_bwd_count_long_kernel"),
                                  "b7": ("pna_bwd_grad_kernel",)}}
        for tag, bb in (("", b), ("_unaligned", ub)):
            ms, ms_min = eager(lambda: step(bb, consec), 5, reps=reps)
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    step(bb, consec)
                torch.cuda.synchronize()
            busy = [ev for ev in prof.key_averages() if ev.self_device_time_total > 0]
            per = {}
            for name, keys in kernels[tag].items():
                evs = [ev for ev in busy if any(k in ev.key for k in keys)]
                per[f"{name}_device_ms"] = sum(ev.self_device_time_total for ev in evs) / 3e3
                per[f"{name}_calls"] = sum(ev.count for ev in evs) // 3
            record(f"step_guarded_b128{tag}", ms=ms, ms_min=ms_min,
                   device_busy_ms=sum(ev.self_device_time_total for ev in busy) / 3e3 if busy else "not measured",
                   launches=sum(ev.count for ev in busy) // 3, **per, E=bb.num_edges,
                   occupancy=int(bb.edge_occupancy))

    if args.steps_only:
        model_steps(("PNA", "GIN"), 15)
        guarded_step_b128(15)
        print(card)
        print(json.dumps({"tag": args.tag, "card": card, "results": results}))
        return
    host = next(iter(loaders["PNA"][0]))
    bd = host.to(dev)
    n, e = host.num_nodes, host.num_edges
    send, recv, mask, occ, win = bd.senders, bd.receivers, bd.edge_mask, bd.edge_occupancy, bd.sender_win
    shape = dict(E=e, N=n, real=int(host.edge_mask.sum()))
    x128, x1, x126 = randn(n, 128), randn(n, 1), randn(n, 126)
    s126 = randn(e, 126)
    both("b8_identity_h128", lambda: b8.fused_conv(x128, send, recv, mask, n, real_edges=occ), **shape)
    both("b8_identity_h1", lambda: b8.fused_conv(x1, send, recv, mask, n, real_edges=occ), **shape)
    both("b8_scale_f126", lambda: b8.fused_conv(x126, send, recv, mask, n, scale=s126, real_edges=occ), **shape)
    both("row_pointers", lambda: row_pointers(recv, n), **shape)
    if b8_takes_ptr:
        ptr = row_pointers(recv, n)
        both("b8_identity_h1_row_ptr", lambda: b8.fused_conv(x1, send, recv, mask, n, real_edges=occ, row_ptr=ptr),
             **shape)
    crow = torch.zeros(n + 1, dtype=torch.int64)
    crow[1:] = torch.cumsum(torch.bincount(host.receivers.long(), minlength=n), 0)
    adj = torch.sparse_csr_tensor(crow, host.senders.long(), host.edge_mask.float(), size=(n, n)).to(dev)
    both("sparse_mm_h128", lambda: torch.sparse.mm(adj, x128), **shape)
    both("sparse_mm_h1", lambda: torch.sparse.mm(adj, x1), **shape)
    g128, g1 = randn(e, 128), randn(e, 1)
    send_l = send.long()
    both("b4_h128", lambda: b4.segment_sum_local(g128, send, win, n), blocks=int(win.shape[1]), **shape)
    both("b4_h1", lambda: b4.segment_sum_local(g1, send, win, n), blocks=int(win.shape[1]), **shape)
    both("index_add_h128", lambda: torch.zeros(n, 128, device=dev).index_add_(0, send_l, g128), **shape)
    # B1: the forward kernel, and the autograd op's backward (the op's
    # backward kernel or chain, then B4)
    k = host.run_align
    for hh in (128, 1):
        tab = randn(n, hh)
        both(f"b1_forward_h{hh}", lambda: b1.gather_stats(tab, send, mask, k), K=k, **shape)
        t = tab.clone().requires_grad_(True)
        outs = b1.gather_presum_stats(t, send, mask, win, n, k)
        cots = (randn(e // k, 2 * hh), randn(e // k, 2 * hh))
        record(f"b1_op_backward_h{hh}", ms=cuda_ms(lambda: torch.autograd.grad(outs, t, cots, retain_graph=True), 20),
               K=k, **shape)

    # B2 on B1's K-group statistics at the batch-1024 and the training
    # loop's batch-128 shapes, B4 on B1's backward's grad_v at batch 128;
    # each with the occupancy bound where the checkout's kernels take it
    b128, h128, _, tl128 = loop_batch()
    for tag, bb in (("b1024", bd), ("b128", b128)):
        nn_, ee, kk = bb.num_nodes, bb.num_edges, bb.run_align
        r8 = bb.receivers[::kk].contiguous()
        gocc = torch.div(bb.edge_occupancy + (kk - 1), kk, rounding_mode="floor")
        tab = randn(nn_, 128)
        st, bo = b1.gather_stats(tab, bb.senders, bb.edge_mask, kk)
        dims = dict(rows=ee // kk, real_rows=int(gocc), N=nn_, W=st.shape[1])
        both(f"b2_{tag}", lambda: b2.segment_sum(st, r8, nn_), **dims)
        if b2_takes_bound:
            both(f"b2_{tag}_bound", lambda: b2.segment_sum(st, r8, nn_, real_rows=gocc), **dims)
        if tag == "b128":
            gst = randn(ee // kk, 256)
            gv = b1.gather_presum_bwd(tab, bb.senders, bb.edge_mask, bo, gst, gst, kk)
            dims = dict(E=ee, real_edges=int(bb.edge_occupancy), N=nn_, H=128)
            both("b4_b128", lambda: b4.segment_sum_local(gv, bb.senders, bb.sender_win, nn_), 10, 5, **dims)
            if b4_takes_bound:
                both("b4_b128_bound", lambda: b4.segment_sum_local(gv, bb.senders, bb.sender_win, nn_,
                                                                   real_edges=bb.edge_occupancy), **dims)
        del st, bo

    # B5, B6 and B7 at H = 128 on the unaligned batch of the same 128
    # graphs (the masked tail is one row at the padding node), with the
    # occupancy bound and without it; B6 and B7 also at the unaligned
    # batch of 1,024 graphs and on a 60,000-slot hub among 4,096 rows of
    # 24 (a quarter of the slots masked)
    def pna_bwd_calls(recv, mask, n):
        """B5, B6 and B7 as the checkout takes them on random v at H =
        128: name -> a call with or without the bound."""
        ptr = row_pointers(recv, n)
        v = randn(recv.shape[0], 128)
        bo = b5.pna_aggregate(v, recv, n, mask, row_ptr=ptr)[3]
        gs, gq, gb = randn(n, 128), randn(n, 128), randn(n, 256)
        cnt = b67.pna_bwd_count(v, recv, mask, bo, n, ptr)
        if pna_takes_bound:
            return {"b5": lambda b=None: b5.pna_aggregate(v, recv, n, mask, row_ptr=ptr, real_edges=b),
                    "b6": lambda b=None: b67.pna_bwd_count(v, recv, mask, bo, n, ptr, real_edges=b),
                    "b7": lambda b=None: b67.pna_bwd_grad(v, recv, mask, bo, gs, gq, gb, cnt, real_edges=b)}
        return {"b5": lambda: b5.pna_aggregate(v, recv, n, mask, row_ptr=ptr),
                "b6": lambda: b67.pna_bwd_count(v, recv, mask, bo, n, ptr),
                "b7": lambda: b67.pna_bwd_grad(v, recv, mask, bo, gs, gq, gb, cnt, ptr)}

    u128 = next(iter(GraphLoader(tl128.samples, 128, dense_slots=False, run_align=False)))
    u1024 = next(iter(GraphLoader(loaders["PNA"][0].samples, 1024, dense_slots=False, run_align=False)))
    hub_counts = torch.full((4096,), 24, dtype=torch.long)
    hub_counts[100] = 60_000
    hub_recv = torch.repeat_interleave(torch.arange(4096, dtype=torch.int32), hub_counts).to(dev)
    hub_mask = torch.rand(hub_recv.shape[0], device=dev, generator=gen) > 0.25
    cases = {"b128_unaligned": (u128, ("b5", "b6", "b7"), 10, 5), "b1024_unaligned": (u1024, ("b6", "b7"), 20, 10)}
    for tag, (hb, names, iters, g_iters) in cases.items():
        ud = hb.to(dev)
        occ_u = ud.edge_occupancy
        calls = pna_bwd_calls(ud.receivers, ud.edge_mask, hb.num_nodes)
        udims = dict(E=hb.num_edges, real_edges=int(occ_u), tail=hb.num_edges - int(occ_u), N=hb.num_nodes, H=128)
        for name in names:
            both(f"{name}_{tag}", calls[name], iters, g_iters, **udims)
            if pna_takes_bound:
                both(f"{name}_{tag}_bound", lambda: calls[name](occ_u), iters, g_iters, **udims)
        del calls
    calls = pna_bwd_calls(hub_recv, hub_mask, 4096)
    for name in ("b6", "b7"):
        both(f"{name}_hub", calls[name], 20, 10, E=int(hub_recv.shape[0]), hub=60_000, N=4096, H=128)
    del calls

    # the molecular data's dense-map batch: its edge list and its dense slots
    mcfg = stack_config("GIN", batch_size=64)
    mcfg["Dataset"]["compositional_stratified_splitting"] = True
    mcfg["NeuralNetwork"]["Training"]["perc_train"] = 0.7
    mol = prepare_loaders_and_config(mcfg, deterministic_graph_data(number_configurations=300, seed=0))[0]
    mh = next(iter(mol))
    if not (mol.dense_slots and mh.sender_win is not None and mh.dense_sender_win is not None):
        raise SystemExit("ab_kernels: the molecular loader did not pick the dense map")
    md = mh.to(dev)
    mn, d_slots = mh.num_nodes, mh.dense_senders.shape[1]
    dsend = md.dense_senders.reshape(-1).contiguous()
    drecv = torch.arange(mn, dtype=torch.int32, device=dev).repeat_interleave(d_slots)
    dmask = md.dense_mask.reshape(-1).contiguous()
    mx = randn(mn, 128)
    mol_shape = dict(N=mn, E=mh.num_edges, slots=dsend.numel())
    both("mol_b8_identity_h128_edges", lambda: b8.fused_conv(mx, md.senders, md.receivers, md.edge_mask, mn,
                                                             real_edges=md.edge_occupancy), **mol_shape)
    both("mol_b8_identity_h128_slots", lambda: b8.fused_conv(mx, dsend, drecv, dmask, mn), **mol_shape)
    ms126 = randn(mh.num_edges, 126)
    mx126 = randn(mn, 126)
    both("mol_b8_scale_f126_edges", lambda: b8.fused_conv(mx126, md.senders, md.receivers, md.edge_mask, mn,
                                                          scale=ms126, real_edges=md.edge_occupancy), **mol_shape)
    mg, dg = randn(mh.num_edges, 128), randn(dsend.numel(), 128)
    both("mol_b4_h128_edges", lambda: b4.segment_sum_local(mg, md.senders, md.sender_win, mn), **mol_shape)
    both("mol_b4_h128_slots", lambda: b4.segment_sum_local(dg, dsend, md.dense_sender_win, mn), **mol_shape)

    # B5 at the unaligned training batch and at the largest serving bucket
    u_tl = GraphLoader(loaders["PNA"][0].samples, 1024, dense_slots=False, run_align=False)
    u_host = next(iter(u_tl))
    scfg = flagship_config()
    raw = deterministic_graph_data(number_configurations=64, unit_cell_x_range=(2, 4), unit_cell_y_range=(2, 4),
                                   unit_cell_z_range=(2, 4), seed=0)
    s_tr, s_va, s_te, scfg = prepare_config_and_samples(scfg, raw)
    prepared = list(s_tr) + list(s_va) + list(s_te)
    top = build_bucket_ladder(prepared, ServeConfig().max_batch)[-1]
    biggest = sorted(prepared, key=lambda sm: -sm.num_edges)[: top.max_batch]
    s_host = batch_graphs([request_to_dict(sm) for sm in biggest], n_node_pad=top.node_pad, n_edge_pad=top.edge_pad,
                          n_graph_pad=top.graph_pad)
    for where, hb in (("train", u_host), ("serve", s_host)):
        rn, re_ = hb.num_nodes, hb.num_edges
        r_recv, r_mask = hb.receivers.to(dev), hb.edge_mask.to(dev)
        r_ptr = row_pointers(r_recv, rn)
        lengths = torch.bincount(hb.receivers.long(), minlength=rn).to(dev)
        b5_shape = dict(E=re_, N=rn, real=int(hb.edge_mask.sum()))
        for hh in (128, 1):
            for dt in (torch.float32, torch.bfloat16):
                tag = f"{where}_h{hh}_{str(dt)[6:]}"
                vv = randn(re_, hh).to(dt)
                both(f"b5_{tag}", lambda: b5.pna_aggregate(vv, r_recv, rn, r_mask), **b5_shape)
                if b5_takes_ptr:
                    both(f"b5_{tag}_row_ptr", lambda: b5.pna_aggregate(vv, r_recv, rn, r_mask, row_ptr=r_ptr),
                         **b5_shape)
                if dt == torch.float32:
                    vm = torch.where(r_mask[:, None], vv, 0.0)
                    pair_sum = torch.cat([vm, vm * vm], dim=1)
                    pair_max = torch.where(r_mask[:, None], torch.cat([vv, -vv], dim=1), float("-inf"))
                    record(f"segment_reduce_pair_{tag}", ms=cuda_ms(lambda: (
                        torch.segment_reduce(pair_sum, "sum", lengths=lengths, axis=0),
                        torch.segment_reduce(pair_max, "max", lengths=lengths, axis=0)), 50), **b5_shape)
                    del vm, pair_sum, pair_max

    # B9 (fused_conv_stack) at hidden 128, 6 layers (sigmoid edge
    # activation, relu between layers) on both flagship layouts: the
    # forward, its node products' and walks' device time a layer
    # (torch.profiler over three calls), and the per-layer library
    # composition (torch.addmm, the activation, torch.sparse.mm on the
    # masked adjacency) beside it
    b9 = importlib.import_module("hydragnn_tpu_torch.ops.fused_conv_stack")
    w9, bias9 = randn(6, 128, 128) / 128 ** 0.5, randn(6, 128) * 0.1
    for lay, hb in (("run_aligned", host), ("unaligned", u_host)):
        sd, sn = hb.to(dev), hb.num_nodes
        xs = randn(sn, 128)
        stack_shape = dict(E=hb.num_edges, N=sn, L=6)

        def fwd():
            return b9.fused_conv_stack(xs, sd.senders, sd.receivers, sd.edge_mask, sn, w9, bias9, "sigmoid", "relu",
                                       real_edges=sd.edge_occupancy)

        both(f"b9_forward_{lay}", fwd, 20, 10, **stack_shape)
        fwd()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fwd()
            torch.cuda.synchronize()
        split = {key: sum(ev.self_device_time_total for ev in prof.key_averages() if key in ev.key) / 1e3 / 3
                 for key in ("stack_product", "stack_walk")}
        record(f"b9_split_{lay}", product_ms=split["stack_product"], walk_ms=split["stack_walk"],
               product_layer_ms=split["stack_product"] / 6, walk_layer_ms=split["stack_walk"] / 6, **stack_shape)
        crow9 = torch.zeros(sn + 1, dtype=torch.int64)
        crow9[1:] = torch.cumsum(torch.bincount(hb.receivers.long(), minlength=sn), 0)
        adj9 = torch.sparse_csr_tensor(crow9, hb.senders.long(), hb.edge_mask.float(), size=(sn, sn)).to(dev)

        def lib_stack():
            hh, lo = xs, None
            for layer in range(6):
                lo = torch.sparse.mm(adj9, torch.sigmoid(torch.addmm(bias9[layer], hh, w9[layer])))
                if layer < 5:
                    hh = torch.relu(lo)
            return lo

        both(f"b9_library_{lay}", lib_stack, 10, 3, **stack_shape)

    # one long row
    lx, lsend, lrecv, lmask, ln = long_row_inputs(dev, 128)
    both("long_b8_identity_h128", lambda: b8.fused_conv(lx, lsend, lrecv, lmask, ln), 10, 5,
         slots=int(lrecv.numel()))
    ids_np = lrecv.cpu().numpy()
    lwin = torch.from_numpy(_block_windows(ids_np, np.argsort(ids_np, kind="stable"), ln, 128)).to(dev)
    lg = randn(lrecv.numel(), 128)
    both("long_b4_h128", lambda: b4.segment_sum_local(lg, lrecv, lwin, ln), 10, 5, edges=int(lrecv.numel()))

    if not args.no_steps:
        model_steps(("PNA", "GIN", "SchNet"), 7)
        guarded_step_b128(7)
        model = create_model_config(loaders["PNA"][3]["NeuralNetwork"], seed=1, device="cuda")
        opt = select_optimizer(model, loaders["PNA"][3]["NeuralNetwork"]["Training"])
        b = u_host.to(dev)
        ms, ms_min = eager(lambda: train_step(model, opt, b), 5, reps=7)
        record("step_PNA_unaligned", ms=ms, ms_min=ms_min, run_align=b.run_align)
        model = create_model_config(scfg["NeuralNetwork"], seed=1, device="cuda").eval()
        b = s_host.to(dev)

        def serve_forward():
            with torch.no_grad():
                return model(b, train=False)

        ms, ms_min = eager(serve_forward, 20, reps=5)
        record("serve_forward_bucket8", ms=ms, ms_min=ms_min, N=b.num_nodes, E=b.num_edges)
    print(card)
    print(json.dumps({"tag": args.tag, "card": card, "results": results}))


if __name__ == "__main__":
    t0 = time.time()
    main()
    print(f"[ab] seconds={time.time() - t0:.1f}", file=sys.stderr)
