"""MD17 example (the port's copy of ``examples/md17/md17.py``): energy
regression on a uracil trajectory with a graph head. Node feature: the
element; target: the energy over the atom count; a random ~25% of the
frames (seed 25), capped at ``--maxframes``; radius-graph edges from the
config; a proportional split. An MD17 ``.npz`` (``R``, ``z``, ``E``) is
read where it is present (``--data``); otherwise a synthetic harmonic
uracil trajectory is generated, the same frames as the JAX driver's.

    python -m hydragnn_tpu_torch.examples.md17.md17 [--data dataset/md17/md17_uracil.npz] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np

from hydragnn_tpu_torch.data.dataset import GraphSample
from hydragnn_tpu_torch.data.ingest import prepare_dataset
from hydragnn_tpu_torch.device import resolve_device
from hydragnn_tpu_torch.examples import add_device_argument, published_config, set_minmax, train_splits
from hydragnn_tpu_torch.parallel import setup_distributed
from hydragnn_tpu_torch.utils.print_utils import setup_log

# idealized planar uracil (C4H4N2O2), close enough for a synthetic
# harmonic trajectory around it
_URACIL_Z = np.array([7, 6, 7, 6, 6, 6, 8, 8, 1, 1, 1, 1])
_URACIL_POS = np.array([
    [0.00, 1.39, 0.0], [1.20, 0.69, 0.0], [1.20, -0.69, 0.0],
    [0.00, -1.39, 0.0], [-1.20, -0.69, 0.0], [-1.20, 0.69, 0.0],
    [2.30, 1.30, 0.0], [0.00, -2.60, 0.0],
    [-0.05, 2.40, 0.0], [2.10, -1.20, 0.0], [-2.10, -1.20, 0.0],
    [-2.15, 1.25, 0.0],
])


def load_md17_npz(path: str) -> tuple:
    data = np.load(path)
    return data["R"], data["z"], data["E"].reshape(-1)


def generate_synthetic_md17(n_frames: int = 4000, seed: int = 0) -> tuple:
    """Harmonic fluctuations around the uracil geometry: E = 0.5 k |dx|^2
    (per-frame), a well-posed stand-in for the real trajectory."""
    rng = np.random.default_rng(seed)
    n = len(_URACIL_Z)
    disp = rng.normal(0, 0.08, (n_frames, n, 3))
    R = _URACIL_POS[None] + disp
    k = 55.0
    E = -259640.0 + 0.5 * k * (disp**2).sum(axis=(1, 2))
    return R, _URACIL_Z, E


def main(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data", type=str, default=os.path.join("dataset", "md17", "md17_uracil.npz"))
    parser.add_argument("--subsample", type=float, default=0.25,
                        help="trajectory keep fraction (the reference's md17_pre_filter)")
    parser.add_argument("--maxframes", type=int, default=1000)
    parser.add_argument("--inputfile", type=str, default="md17.json")
    add_device_argument(parser)
    args = parser.parse_args(argv)
    resolve_device(args.device)
    setup_distributed(args.device)
    setup_log("md17_test")
    config = published_config("md17", args.inputfile)
    if os.path.isfile(args.data):
        R, z, E = load_md17_npz(args.data)
        print(f"read {len(E)} MD17 frames from {args.data}")
    else:
        print(f"no MD17 npz at {args.data}; generating synthetic uracil trajectory")
        R, z, E = generate_synthetic_md17()
    rng = np.random.default_rng(25)
    keep = np.where(rng.random(len(E)) < args.subsample)[0][: args.maxframes]
    samples = [
        GraphSample(
            x=np.asarray(z, dtype=np.float64)[:, None],
            pos=R[i].astype(np.float32),
            graph_y=np.asarray([E[i]], dtype=np.float64),
        )
        for i in keep
    ]
    train, val, test, mm_g, mm_n = prepare_dataset(samples, config)
    set_minmax(config, mm_g, mm_n)
    return train_splits(config, train, val, test, args.device)


if __name__ == "__main__":
    main()
