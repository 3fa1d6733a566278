"""QM9 example (the port's copy of ``examples/qm9/qm9.py``): molecular
free-energy regression with a graph head. Each molecule's node feature is
its element, the target the free energy over the atom count, the split
proportional. The raw GDB9 ``.xyz`` files are read where they are
present (``--data``, Fortran ``*^`` exponents included); otherwise a
deterministic synthetic set is generated, the same samples as the JAX
driver's. Edges come from the config's radius graph.

    python -m hydragnn_tpu_torch.examples.qm9.qm9 [--data dataset/qm9/raw] [--nsamples 1000] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np

from hydragnn_tpu_torch.data.dataset import GraphSample
from hydragnn_tpu_torch.data.formats import SYMBOL_TO_Z
from hydragnn_tpu_torch.data.ingest import prepare_dataset
from hydragnn_tpu_torch.device import resolve_device
from hydragnn_tpu_torch.examples import add_device_argument, published_config, set_minmax, train_splits
from hydragnn_tpu_torch.parallel import setup_distributed
from hydragnn_tpu_torch.utils.print_utils import setup_log

# scalar properties on the GDB9 comment line after "gdb <idx>":
# [A, B, C, mu, alpha, homo, lumo, gap, r2, zpve, U0, U, H, G, Cv];
# free energy G is index 13 (the reference's y[:, 10] counts from mu).
G_INDEX = 13


def _gdb9_float(tok: str) -> float:
    return float(tok.replace("*^", "e"))


def read_gdb9_xyz(path: str) -> GraphSample:
    with open(path, encoding="utf-8") as f:
        lines = f.read().splitlines()
    n = int(lines[0].split()[0])
    props = [_gdb9_float(t) for t in lines[1].split()[2:]]
    zs = np.zeros(n, dtype=np.int64)
    pos = np.zeros((n, 3), dtype=np.float64)
    for i in range(n):
        parts = lines[2 + i].split()
        zs[i] = SYMBOL_TO_Z[parts[0]]
        pos[i] = [_gdb9_float(parts[1]), _gdb9_float(parts[2]), _gdb9_float(parts[3])]
    return GraphSample(
        x=zs[:, None].astype(np.float64),
        pos=pos.astype(np.float32),
        graph_y=np.asarray([props[G_INDEX]], dtype=np.float64),
    )


def load_qm9_raw(root: str, limit: int) -> list:
    files = sorted(f for f in os.listdir(root) if f.endswith(".xyz"))[:limit]
    return [read_gdb9_xyz(os.path.join(root, f)) for f in files]


def generate_synthetic_qm9(n_samples: int, seed: int = 0) -> list:
    """Random CHNOF clusters with a smooth per-atom free-energy-like
    target (element contribution + pair interaction), so training is
    well-posed offline."""
    rng = np.random.default_rng(seed)
    contrib = {1: -0.5, 6: -38.0, 7: -54.5, 8: -75.0, 9: -99.7}
    samples = []
    for _ in range(n_samples):
        n = int(rng.integers(4, 18))
        zs = rng.choice([1, 6, 7, 8, 9], size=n, p=[0.5, 0.3, 0.08, 0.08, 0.04])
        pos = rng.normal(0, 1.8, (n, 3))
        diff = pos[:, None] - pos[None, :]
        r = np.sqrt((diff**2).sum(-1)) + np.eye(n) * 1e9
        pair = (np.exp(-r / 1.5)).sum() / 2
        g = sum(contrib[int(z)] for z in zs) - 2.0 * pair
        samples.append(
            GraphSample(
                x=zs[:, None].astype(np.float64),
                pos=pos.astype(np.float32),
                graph_y=np.asarray([g], dtype=np.float64),
            )
        )
    return samples


def main(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data", type=str, default=os.path.join("dataset", "qm9", "raw"))
    parser.add_argument("--nsamples", type=int, default=1000, help="sample cap (the reference's qm9_pre_filter)")
    parser.add_argument("--inputfile", type=str, default="qm9.json")
    add_device_argument(parser)
    args = parser.parse_args(argv)
    resolve_device(args.device)
    setup_distributed(args.device)
    setup_log("qm9_test")
    config = published_config("qm9", args.inputfile)
    if os.path.isdir(args.data) and any(f.endswith(".xyz") for f in os.listdir(args.data)):
        samples = load_qm9_raw(args.data, args.nsamples)
        print(f"read {len(samples)} GDB9 molecules from {args.data}")
    else:
        print(f"no raw QM9 at {args.data}; generating synthetic molecules")
        samples = generate_synthetic_qm9(args.nsamples)
    train, val, test, mm_g, mm_n = prepare_dataset(samples, config)
    set_minmax(config, mm_g, mm_n)
    return train_splits(config, train, val, test, args.device)


if __name__ == "__main__":
    main()
