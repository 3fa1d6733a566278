"""3-D Ising-model dataset generator (the port's copy of
``examples/ising_model/create_configurations.py``: the same draws from
the same seeded generator, the same files).

Enumerates spin configurations of an L x L x L periodic lattice by
number-of-down-spins composition; compositions with more than
``histogram_cutoff`` possible configurations are randomly subsampled,
smaller ones are enumerated exhaustively (distinct multiset
permutations). The dimensionless energy: the per-site neighbour sum
includes the six periodic nearest neighbours plus the site itself, and
the total is divided by 6. A nonlinear spin function and random
spin-magnitude scaling extend the classic model.

Files are in the LSMS text layout (``data/lsms.py``): a row per site,
``config_value site_index x y z spin``.

    python -m hydragnn_tpu_torch.examples.ising_model.create_configurations
"""

from __future__ import annotations

import math
import os
from typing import Callable, Optional

import numpy as np

from hydragnn_tpu_torch.parallel import nsplit


def ising_energy_and_features(
    config: np.ndarray,
    spin_function: Callable[[np.ndarray], np.ndarray] = lambda x: x,
    scale_spin: bool = False,
    rng: Optional[np.random.Generator] = None,
):
    """Energy + per-site features for one L^3 configuration of +-1 spins.

    Returns (total_energy, features[L^3, 5]) with feature columns
    [config, x, y, z, spin], sites ordered x-major (z fastest).
    """
    L = config.shape[0]
    if scale_spin:
        rng = rng or np.random.default_rng()
        config = config * rng.random((L, L, L))
    spin = spin_function(config)

    # six periodic nearest neighbours + the site itself (reference
    # create_configurations.py:55-63 counts spin[x,y,z] once in nb)
    nb = spin.copy()
    for axis in range(3):
        nb += np.roll(spin, 1, axis=axis) + np.roll(spin, -1, axis=axis)
    total_energy = float(-(nb * spin).sum() / 6.0)

    xs, ys, zs = np.meshgrid(np.arange(L), np.arange(L), np.arange(L), indexing="ij")
    features = np.stack(
        [
            config.reshape(-1),
            xs.reshape(-1).astype(np.float64),
            ys.reshape(-1).astype(np.float64),
            zs.reshape(-1).astype(np.float64),
            spin.reshape(-1),
        ],
        axis=1,
    )
    return total_energy, features


def distinct_permutations(items: np.ndarray):
    """Lexicographic distinct permutations of a multiset (replaces
    sympy's multiset_permutations; standard next-permutation algorithm)."""
    a = np.sort(np.asarray(items))[::-1][::-1].copy()  # ascending
    n = len(a)
    while True:
        yield a.copy()
        # find rightmost i with a[i] < a[i+1]
        i = n - 2
        while i >= 0 and a[i] >= a[i + 1]:
            i -= 1
        if i < 0:
            return
        j = n - 1
        while a[j] <= a[i]:
            j -= 1
        a[i], a[j] = a[j], a[i]
        a[i + 1 :] = a[i + 1 :][::-1]


def write_ising_file(total_energy: float, features: np.ndarray, path: str) -> None:
    """LSMS row layout: ``config site_index x y z spin``."""
    lines = [f"{total_energy:.10g}"]
    for i in range(features.shape[0]):
        c, x, y, z, s = features[i]
        lines.append(f"{c:.10g}\t{i}\t{x:.10g}\t{y:.10g}\t{z:.10g}\t{s:.10g}")
    with open(path, "w") as f:
        f.write("\n".join(lines))


def create_dataset(
    L: int,
    histogram_cutoff: int,
    out_dir: str,
    spin_function: Callable = lambda x: x,
    scale_spin: bool = False,
    seed: int = 0,
    num_shards: int = 1,
    shard: int = 0,
    compositions=None,
) -> int:
    """Generate the sharded dataset; shard s handles every composition
    (num_downs value) assigned to it (the reference shards the
    composition loop across MPI ranks, train_ising.py:63-108). Returns
    the number of files written by this shard."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed + shard)
    n_sites = L**3
    if compositions is None:
        compositions = list(nsplit(range(n_sites), num_shards))[shard]

    written = 0
    for num_downs in compositions:
        primal = np.ones(n_sites)
        primal[:num_downs] = -1.0
        prefix = f"output_{num_downs}_"
        if math.comb(n_sites, num_downs) > histogram_cutoff:
            configs = (
                rng.permutation(primal).reshape(L, L, L)
                for _ in range(histogram_cutoff)
            )
        else:
            configs = (p.reshape(L, L, L) for p in distinct_permutations(primal))
        for count, config in enumerate(configs):
            e, feats = ising_energy_and_features(config, spin_function, scale_spin, rng)
            write_ising_file(e, feats, os.path.join(out_dir, f"{prefix}{count}.txt"))
            written += 1
    return written


def main() -> None:
    """L = 3, cutoff 1000, the sine spin function with random magnitudes,
    into ``./dataset/ising_model``."""
    out = os.path.join("dataset", "ising_model")
    n = create_dataset(
        L=3,
        histogram_cutoff=1000,
        out_dir=out,
        spin_function=lambda x: np.sin(np.pi * x / 2),
        scale_spin=True,
    )
    print(f"wrote {n} configurations to {out}")


if __name__ == "__main__":
    main()
