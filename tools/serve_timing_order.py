"""chip_smoke.py's serving phases in one process, to see what the
deterministic phases leave behind: [serve-timing] first, then [serve]
and [serve-resilience] (which set CUBLAS_WORKSPACE_CONFIG), then
[serve-timing] again, again with the variable removed, and once more
after a garbage collection. Each [serve-timing] line prints the
variable's value.

    python3 tools/serve_timing_order.py    # from the repository root, on a CUDA machine
"""
import os, sys, time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np
import torch
import chip_smoke
from hydragnn_tpu_torch.ops import pna_aggregate as agg, gather_rows as b3, row_pointers as rp
from hydragnn_tpu_torch.ops._build import build_all
from hydragnn_tpu_torch.data.synthetic import deterministic_graph_data

build_all(["pna_aggregate.cu", "gather_rows.cu", "row_pointers.cu"])
mods = {"pna_aggregate_fwd": agg, "gather_rows": b3, "row_pointers": rp}
pair = (lambda: [m.launches.reset() for m in mods.values()], lambda: {n: m.launches.value for n, m in mods.items()})
raw = lambda: deterministic_graph_data(number_configurations=64, unit_cell_x_range=(2, 4), unit_cell_y_range=(2, 4),
                                       unit_cell_z_range=(2, 4), seed=0)
dev = torch.device("cuda", 0)
card = chip_smoke.card_line()
per = {"pna_aggregate_fwd": 6, "gather_rows": 6, "row_pointers": 1}
print("env before", os.environ.get("CUBLAS_WORKSPACE_CONFIG"), flush=True)
chip_smoke.serve_timing_phase(dev, card, raw)
chip_smoke.serve_phase(dev, card, pair, raw(), per)
chip_smoke.serve_resilience_phase(dev, card, pair, raw())
chip_smoke.serve_timing_phase(dev, card, raw)
os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
chip_smoke.serve_timing_phase(dev, card, raw)
import gc; gc.collect(); torch.cuda.empty_cache()
chip_smoke.serve_timing_phase(dev, card, raw)
