"""CSCE HOMO-LUMO gap example (the port's copy of
``examples/csce/train_gap.py``): one csv split by ratio [0.94, 0.02,
0.04], molecular graphs from the SMILES featurizer (``data/smiles.py``),
HGC containers, then a graph-head model trained from them. Rows carry
(id, smiles, gap, ...), read as row[1] and row[-2]. Where the CSCE csv is
absent, a deterministic sample csv is written, the same file as the JAX
driver's.

    python -m hydragnn_tpu_torch.examples.csce.train_gap --preonly [--sampling 0.2]
    python -m hydragnn_tpu_torch.examples.csce.train_gap [--device cpu]
"""

from __future__ import annotations

import argparse
import csv
import os
from typing import Optional, Sequence

import numpy as np

from hydragnn_tpu_torch.data.container import ContainerWriter
from hydragnn_tpu_torch.data.dataset import update_predicted_values
from hydragnn_tpu_torch.data.smiles import (
    generate_graphdata_from_smilestr,
    get_node_attribute_name,
    mol_from_smiles,
)
from hydragnn_tpu_torch.device import resolve_device
from hydragnn_tpu_torch.examples import add_device_argument, published_config, read_split_containers, train_splits
from hydragnn_tpu_torch.parallel import barrier, get_comm_size_and_rank, nsplit, setup_distributed
from hydragnn_tpu_torch.utils.print_utils import iterate_tqdm, setup_log

# reference element set (examples/csce/train_gap.py:40)
csce_node_types = {"C": 0, "F": 1, "H": 2, "N": 3, "O": 4, "S": 5}

_SAMPLE_SMILES = [
    "C", "CC", "CCC", "CCCC", "CCCCC", "CC(C)C", "CC(C)(C)C",
    "CO", "CCO", "CCCO", "CC(O)C", "OCCO", "COC", "CCOCC",
    "CN", "CCN", "CCCN", "NCCN", "CNC", "CC(C)N",
    "C=C", "CC=C", "C=CC=C", "C#C", "CC#N",
    "CC=O", "CC(=O)C", "CC(=O)O", "CC(=O)N",
    "c1ccccc1", "Cc1ccccc1", "Oc1ccccc1", "Nc1ccccc1", "c1ccncc1",
    "c1ccoc1", "c1ccsc1", "FC(F)F", "CCF", "CS", "CCS", "CSC",
    "C1CCCCC1", "C1CCCC1", "OC1CCCCC1", "C1CCOCC1", "C1CCNCC1",
    "OCC(O)CO", "NCC(=O)O", "CC(N)C(=O)O", "CSCC(N)C(=O)O",
]


def _fake_gap(smiles: str) -> float:
    mol = mol_from_smiles(smiles)
    n_c = sum(a.symbol == "C" for a in mol.atoms)
    n_o = sum(a.symbol == "O" for a in mol.atoms)
    n_arom = sum(a.aromatic for a in mol.atoms)
    n_pi = sum(b.order > 1 for b in mol.bonds)
    return float(np.clip(8.5 - 0.2 * n_c - 0.3 * n_o - 0.4 * n_arom - 0.5 * n_pi,
                         1.0, 10.0))


def make_sample_csv(path: str, seed: int = 43) -> None:
    """CSCE layout: id, smiles, gap, uncertainty (gap = row[-2])."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    rows = []
    i = 0
    for s in _SAMPLE_SMILES:
        for _ in range(6):
            rows.append((i, s, _fake_gap(s), 0.0))
            i += 1
    order = rng.permutation(len(rows))
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["id", "smiles", "gap", "uncertainty"])
        w.writerows([rows[j] for j in order])


def datasets_load(datafile, sampling=None, seed=None, frac=(0.94, 0.02, 0.04)):
    """(reference csce_datasets_load, train_gap.py:47-91)"""
    rng = np.random.default_rng(seed)
    smiles_all, values_all = [], []
    with open(datafile) as f:
        reader = csv.reader(f)
        next(reader)
        for row in reader:
            if sampling is not None and rng.random() > sampling:
                continue
            smiles_all.append(row[1])
            values_all.append([float(row[-2])])
    print("Total:", len(smiles_all), len(values_all))
    n = len(smiles_all)
    if n < 3:
        raise SystemExit(
            f"datafile yielded only {n} molecules"
            + (f" at sampling={sampling}" if sampling is not None else "")
            + "; need >= 3 for train/val/test splits"
        )
    # every split must be non-empty for the container write + training:
    # clamp the cut points to 1 <= lo < hi < n
    lo = min(max(int(frac[0] * n), 1), max(n - 2, 1))
    hi = min(max(int((frac[0] + frac[1]) * n), lo + 1), max(n - 1, lo + 1))
    ix = np.split(np.arange(n), [lo, hi])
    return (
        [[smiles_all[i] for i in part] for part in ix],
        [np.asarray([values_all[i] for i in part], dtype=np.float32) for part in ix],
        float(np.mean(values_all)),
        float(np.std(values_all)),
    )


def main(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--preonly", action="store_true")
    parser.add_argument("--inputfile", type=str, default="csce_gap.json")
    parser.add_argument("--sampling", type=float, default=None)
    parser.add_argument("--mode", type=str, default="preload",
                        choices=["mmap", "preload", "shm"])
    add_device_argument(parser)
    args = parser.parse_args(argv)
    resolve_device(args.device)
    config = published_config("csce", args.inputfile)
    verbosity = config["Verbosity"]["level"]
    var_config = config["NeuralNetwork"]["Variables_of_interest"]

    setup_distributed(args.device)
    comm_size, rank = get_comm_size_and_rank()
    setup_log("csce_gap_eV_fullx")

    datafile = os.path.abspath(os.path.join("dataset", "csce_gap.csv"))
    container_dir = os.path.abspath(os.path.join("dataset", "csce_gap.hgc"))

    node_attr_names, node_attr_dims = get_node_attribute_name(csce_node_types)
    config["Dataset"] = {
        "name": "csce_gap",
        "format": "HGC",
        "node_features": {"name": node_attr_names, "dim": node_attr_dims,
                          "column_index": list(range(len(node_attr_names)))},
        "graph_features": {"name": ["gap"], "dim": [1], "column_index": [0]},
    }

    if args.preonly:
        if rank == 0 and not os.path.exists(datafile):
            print(f"{datafile} not found; writing deterministic sample csv")
            make_sample_csv(datafile)
        barrier("csce_csv")
        smiles_sets, values_sets, ymean, ystd = datasets_load(
            datafile, sampling=args.sampling, seed=43
        )
        for smileset, valueset, setname in zip(
            smiles_sets, values_sets, ("trainset", "valset", "testset")
        ):
            rx = list(nsplit(range(len(smileset)), comm_size))[rank]
            samples = []
            for i in iterate_tqdm(range(rx.start, rx.stop), verbosity):
                samples.append(
                    generate_graphdata_from_smilestr(
                        smileset[i], valueset[i], csce_node_types
                    )
                )
            update_predicted_values(
                samples, var_config["type"], var_config["output_index"],
                var_config["output_names"], [1], node_attr_dims,
            )
            w = ContainerWriter(os.path.join(container_dir, setname))
            w.add(samples)
            w.add_global("ymean", [ymean])
            w.add_global("ystd", [ystd])
            w.save()
            print(f"rank {rank}: {setname} {len(samples)} molecules")
        return None

    train, val, test, _ = read_split_containers(container_dir, args.mode)
    return train_splits(config, train, val, test, args.device)


if __name__ == "__main__":
    main()
