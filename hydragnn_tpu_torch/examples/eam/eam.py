"""EAM example (the port's copy of ``examples/eam/eam.py``): NiNb solid
solution per-atom energies (and forces) from AtomEye CFG files, node
regression with periodic boundaries and rotational invariance. Read the
CFG set (a compositional stratified split) into HGC containers, then
train from them. Where the NiNb set is absent, ``generate_ninb`` writes
synthetic NiNb FCC supercells with a Finnis-Sinclair-style EAM
potential (per-atom energies, finite-difference forces, a ``.bulk``
sidecar), the same files as the JAX driver's.

    python -m hydragnn_tpu_torch.examples.eam.eam --preonly [--inputfile NiNb_EAM_energy.json]
    python -m hydragnn_tpu_torch.examples.eam.eam [--inputfile NiNb_EAM_multitask.json] [--device cpu]
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
from hydragnn_tpu_torch.parallel import barrier, get_comm_size_and_rank, nsplit, setup_distributed
from hydragnn_tpu_torch.utils.config import get_log_name_config
from hydragnn_tpu_torch.utils.print_utils import setup_log

NI, NB = 28, 41
MASS = {NI: 58.693, NB: 92.906}
SYM = {NI: "Ni", NB: "Nb"}

# Finnis-Sinclair-style pair parameters (A: repulsive, XI: cohesive),
# species-pair keyed; values are plausible, not fitted — the point is a
# smooth, physical target function.
_P = {"A": {(NI, NI): 0.10, (NB, NB): 0.16, (NI, NB): 0.13},
      "XI": {(NI, NI): 1.2, (NB, NB): 1.8, (NI, NB): 1.5},
      "R0": {(NI, NI): 2.49, (NB, NB): 2.86, (NI, NB): 2.67}}


def _pairkey(zi, zj):
    return (min(zi, zj), max(zi, zj))


def _pair_matrices(z: np.ndarray):
    """Vectorized A/XI/R0 lookup tables for a species vector (they depend
    only on z, so compute once per configuration)."""
    is_nb = (z == NB).astype(int)
    kind = is_nb[:, None] + is_nb[None, :]  # 0=NiNi, 1=NiNb, 2=NbNb
    keys = [(NI, NI), (NI, NB), (NB, NB)]
    lut = lambda tbl: np.asarray([tbl[k] for k in keys])[kind]
    return lut(_P["A"]), lut(_P["XI"]), lut(_P["R0"])


def eam_atomic_energies(pos, z, cell, pair=None) -> np.ndarray:
    """E_i = sum_j A*exp(-p(r/r0-1)) - sqrt(sum_j xi^2*exp(-2q(r/r0-1)))
    with minimum-image PBC (Finnis-Sinclair / Gupta form)."""
    n = len(z)
    A, XI, R0 = pair if pair is not None else _pair_matrices(z)
    inv = np.linalg.inv(cell)
    d = pos[:, None, :] - pos[None, :, :]
    # minimum image in fractional space
    frac = d @ inv
    frac -= np.round(frac)
    d = frac @ cell
    r = np.sqrt((d**2).sum(-1)) + np.eye(n) * 1e9
    p, q, rc = 10.0, 2.5, 5.0
    mask = (r < rc).astype(float)
    rep = (A * np.exp(-p * (r / R0 - 1.0)) * mask).sum(axis=1)
    rho = (XI**2 * np.exp(-2.0 * q * (r / R0 - 1.0)) * mask).sum(axis=1)
    return rep - np.sqrt(np.maximum(rho, 1e-12))


def eam_forces(pos, z, cell, h=1e-4):
    """Central finite differences of the total EAM energy."""
    pair = _pair_matrices(z)
    f = np.zeros_like(pos)
    for i in range(len(z)):
        for a in range(3):
            pp, pm = pos.copy(), pos.copy()
            pp[i, a] += h
            pm[i, a] -= h
            f[i, a] = -(eam_atomic_energies(pp, z, cell, pair).sum()
                        - eam_atomic_energies(pm, z, cell, pair).sum()) / (2 * h)
    return f


def write_cfg(path: str, pos, z, cell, atomic_e, forces) -> None:
    """AtomEye extended CFG with aux [c_peratom, fx, fy, fz]."""
    n = len(z)
    frac = pos @ np.linalg.inv(cell)
    lines = [f"Number of particles = {n}", "A = 1.0 Angstrom (basic length-scale)"]
    for i in range(3):
        for j in range(3):
            lines.append(f"H0({i+1},{j+1}) = {cell[i, j]:.8f} A")
    lines += [".NO_VELOCITY.", "entry_count = 7",
              "auxiliary[0] = c_peratom [eV]",
              "auxiliary[1] = fx [eV/A]", "auxiliary[2] = fy [eV/A]",
              "auxiliary[3] = fz [eV/A]"]
    for zs in sorted(set(z.tolist())):
        lines.append(f"{MASS[zs]:.4f}")
        lines.append(SYM[zs])
        for i in np.where(z == zs)[0]:
            lines.append(
                f"{frac[i,0]:.8f} {frac[i,1]:.8f} {frac[i,2]:.8f} "
                f"{atomic_e[i]:.8f} {forces[i,0]:.8f} {forces[i,1]:.8f} {forces[i,2]:.8f}"
            )
    with open(path, "w") as f:
        f.write("\n".join(lines))
    # .bulk sidecar (reference cfgdataset.py bulk pathway): columns are
    # total_energy volume bulk_modulus — bulk modulus is a smooth
    # composition blend (GPa-ish) so the bulk configs have a learnable
    # graph target
    frac_ni = float((z == NI).mean())
    bulk_modulus = 180.0 * frac_ni + 170.0 * (1 - frac_ni) - 25.0 * frac_ni * (1 - frac_ni)
    volume = float(abs(np.linalg.det(cell)))
    with open(os.path.splitext(path)[0] + ".bulk", "w") as f:
        f.write(f"{atomic_e.sum():.8f} {volume:.8f} {bulk_modulus:.8f}\n")


def generate_ninb(out_dir: str, n_config: int = 100, seed: int = 7,
                  num_shards: int = 1, shard: int = 0) -> None:
    """This shard's synthetic NiNb configurations: 2x2x2 FCC supercells
    (32 atoms), random occupation and displacements, per-atom EAM
    energies and finite-difference forces, as CFG files."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed + shard)
    # 2x2x2 FCC supercell: 32 atoms
    base = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
    cells = np.array([[i, j, k] for i in range(2) for j in range(2) for k in range(2)],
                     dtype=float)
    frac = ((cells[:, None, :] + base[None, :, :]).reshape(-1, 3)) / 2.0
    a0 = 3.52 * 2  # 2x2x2 supercell of Ni FCC
    my = list(nsplit(range(n_config), num_shards))[shard]
    for c in my:
        cell = np.eye(3) * a0 * rng.uniform(0.98, 1.02)
        z = np.where(rng.random(len(frac)) < rng.uniform(0.1, 0.9), NI, NB)
        pos = frac @ cell + rng.normal(0, 0.05, (len(frac), 3))
        e = eam_atomic_energies(pos, z, cell)
        f = eam_forces(pos, z, cell)
        write_cfg(os.path.join(out_dir, f"NiNb_{c:05d}.cfg"), pos, z, cell, e, f)


def _have_current_cfg(raw_dir: str) -> bool:
    """Whether ``raw_dir`` holds CFG files whose ``.bulk`` sidecars carry
    [total_energy volume bulk_modulus]; a directory from an older
    generator (fewer columns) is removed."""
    if not (os.path.isdir(raw_dir) and any(f.endswith(".cfg") for f in os.listdir(raw_dir))):
        return False
    bulks = sorted(f for f in os.listdir(raw_dir) if f.endswith(".bulk"))
    if bulks:
        with open(os.path.join(raw_dir, bulks[0])) as f:
            if len(f.readline().split()) < 3:
                print("stale .bulk sidecars detected; regenerating dataset")
                shutil.rmtree(raw_dir)
                return False
    return True


def main(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--preonly", action="store_true")
    parser.add_argument("--inputfile", type=str, default="NiNb_EAM_energy.json")
    parser.add_argument("--nconfig", type=int, default=100,
                        help="synthetic configurations when raw data is absent")
    parser.add_argument("--mode", type=str, default="preload", choices=["mmap", "preload", "shm"])
    add_device_argument(parser)
    args = parser.parse_args(argv)
    resolve_device(args.device)
    config = published_config("eam", args.inputfile)

    setup_distributed(args.device)
    comm_size, rank = get_comm_size_and_rank()
    setup_log(get_log_name_config(config))

    datasetname = config["Dataset"]["name"]
    raw_dir = os.path.abspath(config["Dataset"]["path"]["total"])
    # a container per config: the packed targets depend on the config's
    # Variables_of_interest
    config_stem = os.path.splitext(os.path.basename(args.inputfile))[0]
    container_dir = os.path.abspath(os.path.join("dataset", f"{datasetname}_{config_stem}.hgc"))

    if args.preonly:
        if not _have_current_cfg(raw_dir):
            print(f"raw CFG data not found at {raw_dir}; generating synthetic NiNb")
            generate_ninb(raw_dir, n_config=args.nconfig, num_shards=comm_size, shard=rank)
        barrier("eam_generate")
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
