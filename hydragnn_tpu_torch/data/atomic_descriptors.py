"""Per-element embedding tables (mendeleev-free atomic descriptors; the
port's copy of ``hydragnn_tpu/data/atomic_descriptors.py``).

The reference builds per-element feature embeddings from the ``mendeleev``
package and caches them to JSON (reference:
hydragnn/utils/atomicdescriptors.py:12-243): one-hot element type, group id,
period, covalent radius, electron affinity, block one-hot, atomic volume,
atomic number, atomic weight, Pauling electronegativity, valence-electron
count, and first ionization energy; real-valued properties are min-max
normalized over the selected elements, and an optional ``one_hot`` mode
buckets them into 10 categorical bins.

``mendeleev`` is not available in this environment, so the element data is
embedded below (standard physical-constant values: covalent radii in pm,
electron affinities and first ionization energies in eV, atomic volumes in
cm^3/mol, Pauling electronegativities). Same API, numpy instead of torch.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

_BLOCKS = ["s", "p", "d", "f"]

# symbol: (Z, group, period, cov_radius, electron_affinity, block,
#          atomic_volume, atomic_weight, electronegativity, n_valence,
#          first_ionization_energy)
_ELEMENTS: Dict[str, tuple] = {
    "H":  (1, 1, 1, 31, 0.754, "s", 14.1, 1.008, 2.20, 1, 13.598),
    "He": (2, 18, 1, 28, 0.0, "s", 31.8, 4.003, 0.0, 2, 24.587),
    "Li": (3, 1, 2, 128, 0.618, "s", 13.1, 6.940, 0.98, 1, 5.392),
    "Be": (4, 2, 2, 96, 0.0, "s", 5.0, 9.012, 1.57, 2, 9.323),
    "B":  (5, 13, 2, 84, 0.277, "p", 4.6, 10.810, 2.04, 3, 8.298),
    "C":  (6, 14, 2, 76, 1.263, "p", 5.3, 12.011, 2.55, 4, 11.260),
    "N":  (7, 15, 2, 71, -0.070, "p", 17.3, 14.007, 3.04, 5, 14.534),
    "O":  (8, 16, 2, 66, 1.461, "p", 14.0, 15.999, 3.44, 6, 13.618),
    "F":  (9, 17, 2, 57, 3.401, "p", 17.1, 18.998, 3.98, 7, 17.423),
    "Ne": (10, 18, 2, 58, 0.0, "p", 16.8, 20.180, 0.0, 8, 21.565),
    "Na": (11, 1, 3, 166, 0.548, "s", 23.7, 22.990, 0.93, 1, 5.139),
    "Mg": (12, 2, 3, 141, 0.0, "s", 14.0, 24.305, 1.31, 2, 7.646),
    "Al": (13, 13, 3, 121, 0.441, "p", 10.0, 26.982, 1.61, 3, 5.986),
    "Si": (14, 14, 3, 111, 1.385, "p", 12.1, 28.085, 1.90, 4, 8.152),
    "P":  (15, 15, 3, 107, 0.746, "p", 17.0, 30.974, 2.19, 5, 10.487),
    "S":  (16, 16, 3, 105, 2.077, "p", 15.5, 32.060, 2.58, 6, 10.360),
    "Cl": (17, 17, 3, 102, 3.613, "p", 18.7, 35.450, 3.16, 7, 12.968),
    "Ar": (18, 18, 3, 106, 0.0, "p", 24.2, 39.948, 0.0, 8, 15.760),
    "K":  (19, 1, 4, 203, 0.501, "s", 45.3, 39.098, 0.82, 1, 4.341),
    "Ca": (20, 2, 4, 176, 0.025, "s", 29.9, 40.078, 1.00, 2, 6.113),
    "Sc": (21, 3, 4, 170, 0.188, "d", 15.0, 44.956, 1.36, 3, 6.561),
    "Ti": (22, 4, 4, 160, 0.079, "d", 10.6, 47.867, 1.54, 4, 6.828),
    "V":  (23, 5, 4, 153, 0.525, "d", 8.35, 50.942, 1.63, 5, 6.746),
    "Cr": (24, 6, 4, 139, 0.666, "d", 7.23, 51.996, 1.66, 6, 6.767),
    "Mn": (25, 7, 4, 139, 0.0, "d", 7.39, 54.938, 1.55, 7, 7.434),
    "Fe": (26, 8, 4, 132, 0.151, "d", 7.1, 55.845, 1.83, 8, 7.902),
    "Co": (27, 9, 4, 126, 0.662, "d", 6.7, 58.933, 1.88, 9, 7.881),
    "Ni": (28, 10, 4, 124, 1.156, "d", 6.6, 58.693, 1.91, 10, 7.640),
    "Cu": (29, 11, 4, 132, 1.235, "d", 7.1, 63.546, 1.90, 11, 7.726),
    "Zn": (30, 12, 4, 122, 0.0, "d", 9.2, 65.380, 1.65, 12, 9.394),
    "Ga": (31, 13, 4, 122, 0.430, "p", 11.8, 69.723, 1.81, 3, 5.999),
    "Ge": (32, 14, 4, 120, 1.233, "p", 13.6, 72.630, 2.01, 4, 7.899),
    "As": (33, 15, 4, 119, 0.804, "p", 13.1, 74.922, 2.18, 5, 9.789),
    "Se": (34, 16, 4, 120, 2.021, "p", 16.5, 78.971, 2.55, 6, 9.752),
    "Br": (35, 17, 4, 120, 3.364, "p", 23.5, 79.904, 2.96, 7, 11.814),
    "Kr": (36, 18, 4, 116, 0.0, "p", 32.2, 83.798, 3.00, 8, 14.000),
    "Rb": (37, 1, 5, 220, 0.486, "s", 55.9, 85.468, 0.82, 1, 4.177),
    "Sr": (38, 2, 5, 195, 0.048, "s", 33.7, 87.620, 0.95, 2, 5.695),
    "Zr": (40, 4, 5, 175, 0.426, "d", 14.1, 91.224, 1.33, 4, 6.634),
    "Mo": (42, 6, 5, 154, 0.748, "d", 9.4, 95.950, 2.16, 6, 7.092),
    "Ru": (44, 8, 5, 146, 1.050, "d", 8.3, 101.070, 2.20, 8, 7.360),
    "Rh": (45, 9, 5, 142, 1.137, "d", 8.3, 102.906, 2.28, 9, 7.459),
    "Pd": (46, 10, 5, 139, 0.562, "d", 8.9, 106.420, 2.20, 10, 8.337),
    "Ag": (47, 11, 5, 145, 1.302, "d", 10.3, 107.868, 1.93, 11, 7.576),
    "Cd": (48, 12, 5, 144, 0.0, "d", 13.1, 112.414, 1.69, 12, 8.994),
    "In": (49, 13, 5, 142, 0.404, "p", 15.7, 114.818, 1.78, 3, 5.786),
    "Sn": (50, 14, 5, 139, 1.112, "p", 16.3, 118.710, 1.96, 4, 7.344),
    "Sb": (51, 15, 5, 139, 1.046, "p", 18.4, 121.760, 2.05, 5, 8.608),
    "Te": (52, 16, 5, 138, 1.971, "p", 20.5, 127.600, 2.10, 6, 9.010),
    "I":  (53, 17, 5, 139, 3.059, "p", 25.7, 126.904, 2.66, 7, 10.451),
    "Xe": (54, 18, 5, 140, 0.0, "p", 42.9, 131.293, 2.60, 8, 12.130),
    "Pt": (78, 10, 6, 136, 2.128, "d", 9.1, 195.084, 2.28, 10, 8.959),
    "Au": (79, 11, 6, 136, 2.309, "d", 10.2, 196.967, 2.54, 11, 9.226),
    "Pb": (82, 14, 6, 146, 0.356, "p", 18.3, 207.200, 2.33, 4, 7.417),
}

SYMBOLS = list(_ELEMENTS.keys())
ATOMIC_NUMBER = {sym: v[0] for sym, v in _ELEMENTS.items()}
_BY_Z = {v[0]: sym for sym, v in _ELEMENTS.items()}


def _normalize(vals: List[float], name: str) -> np.ndarray:
    arr = np.asarray(vals, dtype=np.float64)
    lo, hi = arr.min(), arr.max()
    if hi == lo:
        return np.zeros_like(arr)
    return (arr - lo) / (hi - lo)


def _real_to_onehot(vals: np.ndarray, num_classes: int = 10) -> np.ndarray:
    """Bucket a real property into ``num_classes`` bins then one-hot
    (reference __realtocategorical__, atomicdescriptors.py:140-146)."""
    lo, hi = vals.min(), vals.max()
    delta = (hi - lo) / num_classes if hi > lo else 1.0
    cats = np.minimum((vals - lo) / delta, num_classes - 1).astype(np.int64)
    return np.eye(num_classes, dtype=np.float32)[cats]


def _int_to_onehot(vals: np.ndarray) -> np.ndarray:
    cats = vals.astype(np.int64)
    return np.eye(int(cats.max()) + 1, dtype=np.float32)[cats]


class atomicdescriptors:
    """Same contract as the reference class: build (or load) a JSON-cached
    per-element embedding dict keyed by atomic number string, and serve it
    via ``get_atom_features(symbol_or_Z)``."""

    def __init__(
        self,
        embeddingfilename: str,
        overwritten: bool = True,
        element_types: Optional[Sequence[str]] = ("C", "H", "O", "N", "F", "S"),
        one_hot: bool = False,
    ):
        if os.path.exists(embeddingfilename) and not overwritten:
            with open(embeddingfilename, "r") as f:
                self.atom_embeddings = json.load(f)
            return

        if element_types is None:
            self.element_types = list(SYMBOLS)
        else:
            unknown = [e for e in element_types if e not in _ELEMENTS]
            if unknown:
                raise ValueError(f"elements not in the embedded table: {unknown}")
            # keep periodic-table order, like mendeleev.get_all_elements()
            self.element_types = [s for s in SYMBOLS if s in set(element_types)]
        self.one_hot = one_hot
        n = len(self.element_types)
        rows = [_ELEMENTS[s] for s in self.element_types]

        type_id = np.eye(n, dtype=np.float32)
        group_id = np.asarray([r[1] - 1 for r in rows], dtype=np.float64)
        period = np.asarray([r[2] - 1 for r in rows], dtype=np.float64)
        cov_radius = _normalize([r[3] for r in rows], "covalent_radius")
        e_affinity = _normalize([r[4] for r in rows], "electron_affinity")
        block = np.eye(len(_BLOCKS), dtype=np.float32)[
            [_BLOCKS.index(r[5]) for r in rows]
        ]
        volume = _normalize([r[6] for r in rows], "atomic_volume")
        z = np.asarray([float(r[0]) for r in rows], dtype=np.float64)
        weight = _normalize([r[7] for r in rows], "atomic_weight")
        en = _normalize([r[8] for r in rows], "electronegativity")
        nvalence = np.asarray([float(r[9]) for r in rows], dtype=np.float64)
        ion = _normalize([r[10] for r in rows], "ionenergies")

        if one_hot:
            group_id = _int_to_onehot(group_id)
            period = _int_to_onehot(period)
            z_col = _int_to_onehot(z)
            nvalence = _int_to_onehot(nvalence)
            cov_radius = _real_to_onehot(cov_radius)
            e_affinity = _real_to_onehot(e_affinity)
            volume = _real_to_onehot(volume)
            weight = _real_to_onehot(weight)
            en = _real_to_onehot(en)
            ion = _real_to_onehot(ion)
        else:
            group_id = group_id[:, None]
            period = period[:, None]
            z_col = z[:, None]
            nvalence = nvalence[:, None]
            cov_radius = cov_radius[:, None]
            e_affinity = e_affinity[:, None]
            volume = volume[:, None]
            weight = weight[:, None]
            en = en[:, None]
            ion = ion[:, None]

        cols = [type_id, group_id, period, cov_radius, e_affinity, block,
                volume, z_col, weight, en, nvalence, ion]
        table = np.concatenate([np.atleast_2d(c) for c in cols], axis=1)

        self.atom_embeddings = {
            str(ATOMIC_NUMBER[s]): table[i].tolist()
            for i, s in enumerate(self.element_types)
        }
        with open(embeddingfilename, "w") as f:
            json.dump(self.atom_embeddings, f)

    def get_atom_features(self, atomtype) -> np.ndarray:
        if isinstance(atomtype, str):
            atomtype = ATOMIC_NUMBER[atomtype]
        return np.asarray(self.atom_embeddings[str(atomtype)], dtype=np.float32)

