"""Ising-model example (the port's copy of
``examples/ising_model/train_ising.py``): generate configurations,
sharded over the processes; read the raw text, split, write the HGC
containers; then train the multi-task model (graph energy, node spin)
from them.

    python -m hydragnn_tpu_torch.examples.ising_model.train_ising --preonly
    python -m hydragnn_tpu_torch.examples.ising_model.train_ising [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import shutil
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
from hydragnn_tpu_torch.examples.ising_model.create_configurations import create_dataset
from hydragnn_tpu_torch.parallel import barrier, get_comm_size_and_rank, setup_distributed
from hydragnn_tpu_torch.utils.print_utils import setup_log


def main(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--preonly", action="store_true", help="preprocess only")
    parser.add_argument("--natom", type=int, default=3, help="atoms per dimension")
    parser.add_argument("--cutoff", type=int, default=1000, help="configurational histogram cutoff")
    parser.add_argument("--inputfile", type=str, default="ising_model.json")
    parser.add_argument("--mode", type=str, default="preload", choices=["mmap", "preload", "shm"],
                        help="container read mode")
    add_device_argument(parser)
    args = parser.parse_args(argv)
    resolve_device(args.device)
    config = published_config("ising_model", args.inputfile)

    setup_distributed(args.device)
    comm_size, rank = get_comm_size_and_rank()

    modelname = f"ising_model_{args.natom}_{args.cutoff}"
    raw_dir = os.path.abspath(os.path.join("dataset", modelname))
    container_dir = os.path.abspath(os.path.join("dataset", f"{modelname}.hgc"))

    if args.preonly:
        if rank == 0 and os.path.exists(raw_dir):
            shutil.rmtree(raw_dir)
        barrier("ising_rmtree")
        # the sine spin function with random magnitudes; the compositions
        # sharded over the processes
        n = create_dataset(
            L=args.natom,
            histogram_cutoff=args.cutoff,
            out_dir=raw_dir,
            spin_function=lambda x: np.sin(np.pi * x / 2),
            scale_spin=True,
            num_shards=comm_size,
            shard=rank,
        )
        print(f"rank {rank}: generated {n} configurations")
        barrier("ising_generate")
        config["Dataset"]["path"]["total"] = raw_dir
        samples = load_raw_samples(config, raw_dir)
        train, val, test, mm_g, mm_n = prepare_dataset(samples, config)
        print(len(samples), len(train), len(val), len(test))
        write_split_containers(container_dir, (train, val, test), comm_size, rank,
                               {"minmax_graph_feature": mm_g, "minmax_node_feature": mm_n})
        return None

    train, val, test, trainset = read_split_containers(container_dir, args.mode)
    set_minmax(config, *trainset.minmax())
    setup_log("ising_model_test")
    return train_splits(config, train, val, test, args.device)


if __name__ == "__main__":
    main()
