#!/usr/bin/env python3
"""chip_smoke.py — drive the PyTorch/CUDA port (hydragnn_tpu_torch) on
one NVIDIA card and hold its kernels against their plain versions.

    python3 chip_smoke.py        # from the repository root, on a CUDA machine

Phases, one line each (a failing phase raises; nothing is caught):
  1. device   — the card's name, count and power limit (nvidia-smi).
  2. build    — nvcc builds every kernel of the serving path from the
                sources in the checkout; ptxas registers / shared memory.
  3. check    — each kernel against its plain PyTorch version at the
                shapes of a real flagship serving batch (conv_0 H=1,
                conv_1..5 H=128, f32 and bf16), with empty, all-masked
                and tied segments; two launches bitwise equal.
  4. serve    — the flagship model at full width (hidden 128, 6 PNA
                layers, 4 heads, seeded init) served through
                hydragnn_tpu_torch.serve_model on the card: requests
                from 4 threads, every answer finite and equal to the
                same weights' forward on the CPU (plain versions), and
                kernel launches = 6 x device forwards.
  5. timing   — CUDA-event times of the kernel, its plain version and
                the nearest PyTorch library calls, beside the byte
                bound, at the serving shape and at a 128-graph shape.
  6. summary  — the kernels line, the card line, then the result line.

Without a card (torch.cuda.is_available() false), or outside a checkout
of the repository, it exits non-zero and prints no result.
"""

import json
import subprocess
import sys
import threading
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12  # H100 SXM float32, outside the tensor cores
SUM_TOL = dict(rtol=1e-6, atol=1e-6)  # f32 sums; the maxima must be bit-equal
SERVE_TOL = dict(rtol=1e-4, atol=1e-4)  # card vs CPU forward of the whole model
N_SAMPLES, UNIT_CELLS, SEED = 64, (2, 4), 0


def line(phase, **kw):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()), flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters):
    """Mean milliseconds per call of ``fn`` over ``iters`` warm calls,
    between CUDA events on the current stream."""
    for _ in range(5):
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
    """Milliseconds per call with the host's launch cost removed: ``iters``
    calls captured into one CUDA graph, replayed between events."""
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


def aggregate_bound(v, mask, n):
    """Least time (ms) for the same work: bytes that must move (each
    input read once, each output written once; v rows of masked edges
    are never read) over HBM rate, or operations over the f32 rate."""
    e, h = v.shape
    s = v.element_size()
    real = int(mask.sum())
    nbytes = real * h * s + e * 4 + e * 1 + n * h * 4 * 2 + n * 4 + n * 2 * h * s
    ops = real * h * 5  # add, multiply, add, two comparisons
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare_aggregate(out, ref, label):
    """Kernel outputs vs plain outputs: sums to SUM_TOL, counts and
    maxima bit-equal. Returns the max abs error over all four."""
    s, sq, cnt, both = [t.cpu() for t in out]
    rs, rsq, rcnt, rboth = [t.cpu() for t in ref]
    np.testing.assert_allclose(s.numpy(), rs.numpy(), err_msg=label + " sum", **SUM_TOL)
    np.testing.assert_allclose(sq.numpy(), rsq.numpy(), err_msg=label + " sumsq", **SUM_TOL)
    if not torch.equal(cnt, rcnt):
        raise AssertionError(f"{label}: counts differ")
    if not torch.equal(both.view(torch.int16 if both.dtype == torch.bfloat16 else torch.int32),
                       rboth.view(torch.int16 if rboth.dtype == torch.bfloat16 else torch.int32)):
        raise AssertionError(f"{label}: maxima not bit-equal")
    return max(
        float((s - rs).abs().max()), float((sq - rsq).abs().max()),
        float((cnt - rcnt).abs().max()), float((both.float() - rboth.float()).abs().max()),
    )


def main():
    # ---- 1. device -------------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False — needs a CUDA card")
    import hydragnn_tpu_torch
    from hydragnn_tpu_torch.api import prepare_config_and_samples
    from hydragnn_tpu_torch.data.loader import pad_plan_for
    from hydragnn_tpu_torch.data.synthetic import deterministic_graph_data
    from hydragnn_tpu_torch.flagship import flagship_config
    from hydragnn_tpu_torch.graph.batch import batch_graphs
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.ops import pna_aggregate as agg
    from hydragnn_tpu_torch.serve import ServeConfig, build_bucket_ladder, request_to_dict

    dev = hydragnn_tpu_torch.resolve_device("cuda")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    card = card_line()
    line("device", kind=repr(kind), count=count, nvidia_smi=repr(card),
         torch=torch.__version__, cuda=torch.version.cuda,
         tf32=torch.backends.cuda.matmul.allow_tf32)

    # ---- 2. build --------------------------------------------------------
    t0 = time.time()
    log = agg.build()
    ptxas = [ln.strip() for ln in log.splitlines() if "Used" in ln or "Compiling entry" in ln]
    line("build", kernel="pna_aggregate_fwd", seconds=round(time.time() - t0, 2))
    for ln in ptxas:
        print("  ptxas:", ln)

    # the flagship data, prepared once (the serving phase re-prepares its own copy)
    cfg = flagship_config()
    raw = deterministic_graph_data(
        number_configurations=N_SAMPLES, unit_cell_x_range=UNIT_CELLS,
        unit_cell_y_range=UNIT_CELLS, unit_cell_z_range=UNIT_CELLS, seed=SEED,
    )
    tr, va, te, cfg = prepare_config_and_samples(cfg, raw)
    prepared = list(tr) + list(va) + list(te)
    hidden = cfg["NeuralNetwork"]["Architecture"]["hidden_dim"]
    n_layers = cfg["NeuralNetwork"]["Architecture"]["num_conv_layers"]

    # a full serving batch on the largest bucket: the biggest shapes the
    # main path hands the kernel
    top = build_bucket_ladder(prepared, ServeConfig().max_batch)[-1]
    biggest = sorted(prepared, key=lambda s: -s.num_edges)[: top.max_batch]
    serve_batch = batch_graphs(
        [request_to_dict(s) for s in biggest],
        n_node_pad=top.node_pad, n_edge_pad=top.edge_pad, n_graph_pad=top.graph_pad,
    )

    # ---- 3. check --------------------------------------------------------
    rng = np.random.default_rng(SEED)
    recv = serve_batch.receivers
    n_rows = serve_batch.num_nodes
    dead = torch.isin(recv, torch.tensor([0, 5, 17], dtype=torch.int32))  # all-masked rows
    cases = [
        ("conv0_f32_h1", 1, torch.float32, serve_batch.edge_mask, False),
        ("conv1-5_f32_h128", hidden, torch.float32, serve_batch.edge_mask, False),
        ("conv1-5_bf16_h128", hidden, torch.bfloat16, serve_batch.edge_mask, False),
        ("adversarial_f32_h128", hidden, torch.float32, serve_batch.edge_mask & ~dead, True),
        ("adversarial_bf16_h1", 1, torch.bfloat16, serve_batch.edge_mask & ~dead, True),
    ]
    max_err = 0.0
    for label, h, dtype, mask, ties in cases:
        vals = rng.normal(size=(serve_batch.num_edges, h)).astype(np.float32)
        if ties:
            vals = np.round(vals * 2.0) / 2.0 + 0.0  # many equal values per row, no -0.0
        v = torch.from_numpy(vals).to(dtype)
        ref = agg.pna_aggregate_plain(v, recv, n_rows, mask)  # host copy, sequential f32 order
        args = (v.to(dev), recv.to(dev), n_rows, mask.to(dev))
        out1 = agg.pna_aggregate(*args)
        out2 = agg.pna_aggregate(*args)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(out1, out2)):
            raise AssertionError(f"{label}: two launches differ")
        card_plain = agg.pna_aggregate_plain(*args)
        err = compare_aggregate(out1, ref, label)
        err_card = max(float((a.float() - b.float()).abs().max()) for a, b in zip(out1, card_plain))
        max_err = max(max_err, err)
        line("check", case=label, E=serve_batch.num_edges, N=n_rows, H=h, dtype=str(dtype)[6:],
             max_abs_err=err, max_abs_err_vs_card_plain=err_card,
             empty_rows=int((out1[2] == 0).sum()), deterministic=True)

    # ---- 4. serve --------------------------------------------------------
    raw = deterministic_graph_data(
        number_configurations=N_SAMPLES, unit_cell_x_range=UNIT_CELLS,
        unit_cell_y_range=UNIT_CELLS, unit_cell_z_range=UNIT_CELLS, seed=SEED,
    )
    server = hydragnn_tpu_torch.serve_model(flagship_config(), raw, device="cuda", seed=SEED)
    try:
        requests = [request_to_dict(s) for s in server.reference_samples]
        for r in requests[:8]:  # warm-up: first cuBLAS/allocator use
            server.predict(r, timeout=300)
        work = requests * 2
        results = [None] * len(work)
        lat = [0.0] * len(work)
        snap0 = server.metrics_snapshot()
        agg.launches.reset()
        t_start = time.perf_counter()

        def client(k):
            futs = []
            for i in range(k, len(work), 4):
                t = time.perf_counter()
                f = server.submit(work[i])
                # latency ends when the server resolves the future
                f.add_done_callback(lambda _f, i=i, t=t: lat.__setitem__(i, time.perf_counter() - t))
                futs.append((i, f))
            for i, f in futs:
                results[i] = f.result(timeout=300)

        threads = [threading.Thread(target=client, args=(k,)) for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
            if t.is_alive():
                raise AssertionError("serve: a client thread did not finish")
        wall = time.perf_counter() - t_start
        launches = agg.launches.value
        snap = server.metrics_snapshot()
        forwards = snap["forwards_total"] - snap0["forwards_total"]
        batches = snap["batches_total"] - snap0["batches_total"]
        if None in results:
            raise AssertionError("serve: a request got no answer")
        if forwards != batches or launches != n_layers * batches:
            raise AssertionError(
                f"serve: {launches} kernel launches, {forwards} forwards, {batches} batches; "
                f"want launches = {n_layers} x batches"
            )

        cpu_model = create_model(server.served.cfg, seed=SEED, device="cpu")
        cpu_model.load_state_dict({k: t.cpu() for k, t in server.served.model.state_dict().items()})
        mcfg = server.served.cfg
        worst = 0.0
        for g, res in zip(work, results):
            with torch.no_grad():
                ref = cpu_model(batch_graphs([g]), train=False)
            n = g["x"].shape[0]
            for ih, name in enumerate(mcfg.output_names):
                out = res[name]
                want = ref[ih][0] if mcfg.output_type[ih] == "graph" else ref[ih][:n]
                want = want.numpy()
                if out.shape != want.shape or not np.all(np.isfinite(out)):
                    raise AssertionError(f"serve: head {name} shape {out.shape} or non-finite")
                np.testing.assert_allclose(out, want, err_msg=f"serve head {name}", **SERVE_TOL)
                worst = max(worst, float(np.abs(out - want).max()))
        # light load: one request at a time (each waits out the deadline alone)
        serial = []
        for r in requests[:32]:
            t = time.perf_counter()
            server.predict(r, timeout=300)
            serial.append(time.perf_counter() - t)
    finally:
        server.stop()
    lat_ms = np.sort(np.asarray(lat)) * 1e3
    line("serve", requests=len(work), threads=4, forwards=forwards,
         batches=batches, kernel_launches=launches,
         p50_ms=round(float(np.percentile(lat_ms, 50)), 3),
         p99_ms=round(float(np.percentile(lat_ms, 99)), 3),
         requests_per_s=round(len(work) / wall, 1),
         serial_p50_ms=round(float(np.median(serial)) * 1e3, 3), max_abs_err_vs_cpu=worst,
         hidden=hidden, conv_layers=n_layers, heads=mcfg.num_heads, card=repr(card))
    line("serve-buckets", **{k: json.dumps(v, separators=(",", ":"))
                             for k, v in snap["buckets"].items()})

    # ---- 5. timing -------------------------------------------------------
    # where one full serving batch's time goes: host clock, synchronised
    # between stages, median of 20 (largest bucket, 8 graphs)
    graphs8 = [request_to_dict(s) for s in biggest]
    stages = {"batch_build": [], "h2d": [], "forward": [], "d2h": []}
    for _ in range(20):
        t0 = time.perf_counter()
        b = batch_graphs(graphs8, n_node_pad=top.node_pad, n_edge_pad=top.edge_pad,
                         n_graph_pad=top.graph_pad)
        t1 = time.perf_counter()
        bd = b.to(dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        outs = server.served.forward(bd)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        [o.cpu() for o in outs]
        t4 = time.perf_counter()
        for k, a, z in (("batch_build", t0, t1), ("h2d", t1, t2), ("forward", t2, t3), ("d2h", t3, t4)):
            stages[k].append((z - a) * 1e3)
    line("breakdown", shape="serve_batch8", card=repr(card),
         **{f"{k}_ms": round(float(np.median(v)), 4) for k, v in stages.items()})

    shapes = [("serve_batch8", serve_batch)]
    big_plan = pad_plan_for(prepared * 2, 128)
    shapes.append(("batch128", batch_graphs(
        [request_to_dict(s) for s in (prepared * 2)[:128]],
        n_node_pad=big_plan[0], n_edge_pad=big_plan[1], n_graph_pad=big_plan[2],
    )))
    timing = {}
    for label, b in shapes:
        v = torch.randn(b.num_edges, hidden, generator=torch.Generator().manual_seed(1)).to(dev)
        recv_d, mask_d, n = b.receivers.to(dev), b.edge_mask.to(dev), b.num_nodes
        # library yardstick: segment_reduce over the contiguous sorted runs
        lengths = torch.bincount(b.receivers.long(), minlength=n).to(dev)
        vm = torch.where(mask_d[:, None], v, 0.0)
        pair_sum = torch.cat([vm, vm * vm], dim=1)
        pair_max = torch.where(mask_d[:, None], torch.cat([v, -v], dim=1), float("-inf"))
        run = {
            "kernel": lambda: agg.pna_aggregate(v, recv_d, n, mask_d),
            "plain": lambda: agg.pna_aggregate_plain(v, recv_d, n, mask_d),
            "library": lambda: (
                torch.segment_reduce(pair_sum, "sum", lengths=lengths, axis=0),
                torch.segment_reduce(pair_max, "max", lengths=lengths, axis=0),
            ),
        }
        t = {}
        for name in ("kernel", "plain", "library", "kernel"):  # kernel first and last
            t.setdefault(name, []).append(cuda_ms(run[name], 200))
        bound, bound_by = aggregate_bound(v, b.edge_mask, n)
        timing[label] = {
            "ms": float(np.mean(t["kernel"])),
            "graph_ms": graph_ms(run["kernel"], 50),
            "plain_ms": t["plain"][0],
            "library_ms": t["library"][0],
            "bound_ms": bound,
            "bound_by": bound_by,
            "E": b.num_edges, "N": n, "H": hidden,
        }
        line("timing", shape=label, card=repr(card),
             **{k: (round(x, 5) if isinstance(x, float) else x) for k, x in timing[label].items()})

    # ---- 6. summary ------------------------------------------------------
    main_t = timing["serve_batch8"]
    kernels = [{
        "name": "pna_aggregate_fwd",
        "route": "cuda",
        "source": agg.SOURCE,
        "replaces": agg.REPLACES,
        "checked": True,
        "launches": launches,
        "max_abs_err": max_err,
        "ms": main_t["ms"],
        "plain_ms": main_t["plain_ms"],
        "bound_ms": main_t["bound_ms"],
        "bound_by": main_t["bound_by"],
        "library_ms": main_t["library_ms"],
        "graph_ms": main_t["graph_ms"],
        "shape": {"E": main_t["E"], "N": main_t["N"], "H": main_t["H"]},
    }]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))


if __name__ == "__main__":
    main()
    sys.exit(0)
