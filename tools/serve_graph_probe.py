"""Capture the flagship's full-width eval forward in a CUDA graph at the
largest serving bucket, by hand, and hold a replay against the eager
forward of the same padded batch: bit-equality and the forward's time
(copy in, run, copy out; host clock, synchronised, median of 20), with
PyTorch's default algorithms, then under deterministic algorithms.

    python3 tools/serve_graph_probe.py     # from the repository root, on a CUDA machine
"""
import os, sys, time, json, warnings, subprocess

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np
import torch
import hydragnn_tpu_torch
from hydragnn_tpu_torch.data.synthetic import deterministic_graph_data
from hydragnn_tpu_torch.flagship import flagship_config
from hydragnn_tpu_torch.graph.batch import batch_graphs
from hydragnn_tpu_torch.serve import request_to_dict
from hydragnn_tpu_torch.ops._build import build_all

t0 = time.time()
build_all(["pna_aggregate.cu", "gather_rows.cu", "row_pointers.cu"])
print("build", time.time() - t0, flush=True)
raw = deterministic_graph_data(number_configurations=64, unit_cell_x_range=(2, 4), unit_cell_y_range=(2, 4), unit_cell_z_range=(2, 4), seed=0)
server = hydragnn_tpu_torch.serve_model(flagship_config(), raw, device="cuda", seed=0, start=False)
dev = server.device
top = server.buckets[-1]
reqs = [request_to_dict(s) for s in server.reference_samples]
big = sorted(reqs, key=lambda g: -len(g["senders"]))[:8]
hb = batch_graphs(big, n_node_pad=top.node_pad, n_edge_pad=top.edge_pad, n_graph_pad=top.graph_pad)
model = server.served.model

def bits(t):
    return t.view(torch.int32)

def eager(b):
    with torch.inference_mode():
        return [o.clone() for o in model(b.to(dev), train=False)]

def capture(static):
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s), torch.inference_mode():
        model(static, train=False)
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.inference_mode(), torch.cuda.graph(g):
        out = model(static, train=False)
    return g, out

for det in (False, True):
    if det:
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True, warn_only=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        e1, e2 = eager(hb), eager(hb)
        eager_eq = all(torch.equal(bits(a), bits(b)) for a, b in zip(e1, e2))
        static = hb.to(dev)
        try:
            g, out = capture(static)
            g.replay(); torch.cuda.synchronize()
            rep_eq = [bool(torch.equal(bits(a), bits(b))) for a, b in zip(out, e1)]
            diffs = [float((a - b).abs().max()) for a, b in zip(out, e1)]
            cap = "ok"
        except Exception as exc:
            cap, rep_eq, diffs = repr(exc)[:500], None, None
    print(json.dumps({"det": det, "eager_twice_bit_equal": eager_eq, "capture": cap, "replay_vs_eager_bit_equal": rep_eq,
                      "max_abs_diff": diffs, "warnings": sorted({str(w.message)[:120] for w in caught})[:4]}), flush=True)
    if cap == "ok":
        # timing: copy-in + replay + copy-out vs eager .to + forward + .cpu
        def run_graph():
            for name in ("nodes", "senders", "receivers", "node_graph", "n_node", "n_edge", "node_mask", "edge_mask",
                         "graph_mask", "edge_attr", "pos", "sender_perm", "in_degree", "edge_occupancy", "n_real_nodes",
                         "sender_win"):
                src = getattr(hb, name)
                if src is not None:
                    getattr(static, name).copy_(src, non_blocking=True)
            g.replay()
            return [o.cpu() for o in out]
        def run_eager():
            return [o.cpu() for o in eager(hb)]
        for fn, name in ((run_graph, "graph"), (run_eager, "eager")):
            for _ in range(5): fn()
            ts = []
            for _ in range(20):
                torch.cuda.synchronize(); t = time.perf_counter(); fn(); torch.cuda.synchronize(); ts.append(time.perf_counter() - t)
            print(name, "median_ms", round(float(np.median(ts)) * 1e3, 4), flush=True)
    torch.use_deterministic_algorithms(False)
print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True).stdout)
