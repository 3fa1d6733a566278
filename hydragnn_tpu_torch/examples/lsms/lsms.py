"""LSMS example (the port's copy of ``examples/lsms/lsms.py``): FePt
free energy with nodal charge density and magnetic moment, from LSMS
text files. Preprocess the raw directory (a compositional stratified
split) into HGC containers, then train from them. Where the raw FePt
set is absent, ``generate_fept_like`` writes a synthetic FePt-like set
in the same layout (``Z index x y z charge_density magnetic_moment``,
the header line the free energy), the same files as the JAX driver's.

    python -m hydragnn_tpu_torch.examples.lsms.lsms --preonly
    python -m hydragnn_tpu_torch.examples.lsms.lsms [--device cpu]
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np

from hydragnn_tpu_torch.data.ingest import load_raw_samples, prepare_dataset
from hydragnn_tpu_torch.device import resolve_device
from hydragnn_tpu_torch.examples import (
    add_device_argument,
    published_config,
    read_split_containers,
    set_minmax,
    train_splits,
    write_split_containers,
)
from hydragnn_tpu_torch.parallel import barrier, get_comm_size_and_rank, setup_distributed
from hydragnn_tpu_torch.utils.config import get_log_name_config
from hydragnn_tpu_torch.utils.print_utils import setup_log

FE, PT = 26, 78


def generate_fept_like(out_dir: str, n_config: int = 200, seed: int = 17) -> None:
    """Synthetic FePt-like LSMS files: 2x2x2 BCC supercells (32 atoms)
    with random Fe/Pt occupation; free energy and nodal charge/moment are
    smooth functions of local composition, so the learning task is
    well-posed (the same idea as tests/deterministic_graph_data.py)."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    # 2x2x2 conventional BCC cells -> 2 atoms/cell * 16 cells = 32 atoms
    base = np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5]])
    cells = np.array(
        [[i, j, k] for i in range(2) for j in range(2) for k in range(4)], dtype=float
    )
    pos = (cells[:, None, :] + base[None, :, :]).reshape(-1, 3) * 2.87  # Fe a0 (A)
    n = pos.shape[0]
    for c in range(n_config):
        z = np.where(rng.random(n) < rng.uniform(0.2, 0.8), FE, PT).astype(float)
        frac_fe = (z == FE).mean()
        # distance to nearest unlike atom drives the fake local moments
        diff = pos[:, None, :] - pos[None, :, :]
        dist = np.sqrt((diff**2).sum(-1)) + np.eye(n) * 1e9
        unlike = z[:, None] != z[None, :]
        d_unlike = np.where(unlike, dist, np.inf).min(axis=1)
        d_unlike = np.where(np.isfinite(d_unlike), d_unlike, dist.min(axis=1))
        moment = np.where(z == FE, 2.2, 0.35) * np.exp(-d_unlike / 5.0)
        charge = z + 0.05 * np.tanh(moment) + rng.normal(0, 0.01, n)
        free_energy = (
            -4.0 * n * (frac_fe * (1 - frac_fe)) - 0.1 * moment.sum()
            + rng.normal(0, 0.05)
        )
        lines = [f"{free_energy:.10g}"]
        for i in range(n):
            lines.append(
                f"{z[i]:.10g}\t{i}\t{pos[i,0]:.10g}\t{pos[i,1]:.10g}\t{pos[i,2]:.10g}"
                f"\t{charge[i]:.10g}\t{moment[i]:.10g}"
            )
        with open(os.path.join(out_dir, f"out_{c:05d}.txt"), "w") as f:
            f.write("\n".join(lines))


def main(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--preonly", action="store_true", help="preprocess only")
    parser.add_argument("--inputfile", type=str, default="lsms.json")
    parser.add_argument("--nconfig", type=int, default=200,
                        help="synthetic configurations when raw data is absent")
    parser.add_argument("--mode", type=str, default="preload", choices=["mmap", "preload", "shm"])
    add_device_argument(parser)
    args = parser.parse_args(argv)
    resolve_device(args.device)
    config = published_config("lsms", args.inputfile)

    setup_distributed(args.device)
    comm_size, rank = get_comm_size_and_rank()
    setup_log(get_log_name_config(config))

    datasetname = config["Dataset"]["name"]
    raw_dir = os.path.abspath(config["Dataset"]["path"]["total"])
    container_dir = os.path.abspath(os.path.join("dataset", f"{datasetname}.hgc"))

    if args.preonly:
        # process 0 generates; every process then runs the deterministic
        # preparation and writes its shard of each split
        if rank == 0 and (not os.path.isdir(raw_dir) or not os.listdir(raw_dir)):
            print(f"raw LSMS data not found at {raw_dir}; generating synthetic")
            generate_fept_like(raw_dir, n_config=args.nconfig)
        barrier("lsms_generate")
        samples = load_raw_samples(config, raw_dir)
        train, val, test, mm_g, mm_n = prepare_dataset(samples, config)
        if rank == 0:
            print(len(samples), len(train), len(val), len(test))
        write_split_containers(container_dir, (train, val, test), comm_size, rank,
                               {"minmax_graph_feature": mm_g, "minmax_node_feature": mm_n})
        return None

    train, val, test, trainset = read_split_containers(container_dir, args.mode)
    set_minmax(config, *trainset.minmax())
    return train_splits(config, train, val, test, args.device)


if __name__ == "__main__":
    main()
