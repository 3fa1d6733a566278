"""Native readers for XYZ and AtomEye CFG atomistic formats (the port's
copy of ``hydragnn_tpu/data/formats.py``; numpy only).

The reference reads both through ase (reference:
hydragnn/utils/xyzdataset.py:13-71 uses ase.io.read + a ``<name>_energy.txt``
sidecar; hydragnn/utils/cfgdataset.py:12-84 uses ase.io.cfg.read_cfg + a
``<name>.bulk`` sidecar). ase is not a dependency here, so the parsers are
native and produce the same GraphSample content:

  XYZ:  x = [Z] proton numbers, pos, meta['cell'] from an extended-XYZ
        ``Lattice="..."`` comment when present, graph_y from the
        ``_energy.txt`` sidecar columns selected by the dataset config.
  CFG:  x = [Z, mass, c_peratom, fx, fy, fz] (the reference's column
        order, cfgdataset.py:57-66), pos = H0 @ s (reduced -> cartesian),
        meta['cell'] = H0, graph_y from the ``.bulk`` sidecar.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from hydragnn_tpu_torch.data.dataset import GraphSample

# fmt: off
ELEMENT_SYMBOLS = [
    "X", "H", "He", "Li", "Be", "B", "C", "N", "O", "F", "Ne", "Na", "Mg",
    "Al", "Si", "P", "S", "Cl", "Ar", "K", "Ca", "Sc", "Ti", "V", "Cr",
    "Mn", "Fe", "Co", "Ni", "Cu", "Zn", "Ga", "Ge", "As", "Se", "Br",
    "Kr", "Rb", "Sr", "Y", "Zr", "Nb", "Mo", "Tc", "Ru", "Rh", "Pd",
    "Ag", "Cd", "In", "Sn", "Sb", "Te", "I", "Xe", "Cs", "Ba", "La",
    "Ce", "Pr", "Nd", "Pm", "Sm", "Eu", "Gd", "Tb", "Dy", "Ho", "Er",
    "Tm", "Yb", "Lu", "Hf", "Ta", "W", "Re", "Os", "Ir", "Pt", "Au",
    "Hg", "Tl", "Pb", "Bi", "Po", "At", "Rn", "Fr", "Ra", "Ac", "Th",
    "Pa", "U", "Np", "Pu", "Am", "Cm", "Bk", "Cf", "Es", "Fm", "Md",
    "No", "Lr",
]
# fmt: on
SYMBOL_TO_Z = {s: z for z, s in enumerate(ELEMENT_SYMBOLS)}

# standard atomic weights, Z-indexed (0 pad); enough elements for the
# CFG mass->Z inference fallback
ATOMIC_MASSES = np.array(
    [0.0, 1.008, 4.0026, 6.94, 9.0122, 10.81, 12.011, 14.007, 15.999, 18.998,
     20.180, 22.990, 24.305, 26.982, 28.085, 30.974, 32.06, 35.45, 39.948,
     39.098, 40.078, 44.956, 47.867, 50.942, 51.996, 54.938, 55.845, 58.933,
     58.693, 63.546, 65.38, 69.723, 72.630, 74.922, 78.971, 79.904, 83.798,
     85.468, 87.62, 88.906, 91.224, 92.906, 95.95, 97.0, 101.07, 102.91,
     106.42, 107.87, 112.41, 114.82, 118.71, 121.76, 127.60, 126.90, 131.29,
     132.91, 137.33, 138.91, 140.12, 140.91, 144.24, 145.0, 150.36, 151.96,
     157.25, 158.93, 162.50, 164.93, 167.26, 168.93, 173.05, 174.97, 178.49,
     180.95, 183.84, 186.21, 190.23, 192.22, 195.08, 196.97, 200.59, 204.38,
     207.2, 208.98, 209.0, 210.0, 222.0]
)


def _sidecar_graph_features(
    path: str, graph_feature_dims: Sequence[int], graph_feature_cols: Sequence[int]
) -> np.ndarray:
    """Read the single-line sidecar and select the configured columns
    (reference: xyzdataset.py:58-70 / cfgdataset.py:69-82)."""
    with open(path, "r", encoding="utf-8") as f:
        tokens = f.readlines()[0].split()
    g_feature: List[float] = []
    for item in range(len(graph_feature_dims)):
        for icomp in range(graph_feature_dims[item]):
            g_feature.append(float(tokens[graph_feature_cols[item] + icomp]))
    return np.asarray(g_feature, dtype=np.float64)


# ---------------------------------------------------------------- XYZ ----


def read_xyz_file(path: str) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Parse one (extended) XYZ file -> (Z [n], pos [n,3], cell [3,3]|None)."""
    with open(path, "r", encoding="utf-8") as f:
        lines = f.read().splitlines()
    n = int(lines[0].split()[0])
    comment = lines[1] if len(lines) > 1 else ""
    cell = None
    m = re.search(r'Lattice="([^"]+)"', comment)
    if m:
        vals = np.asarray([float(v) for v in m.group(1).split()], dtype=np.float64)
        if vals.size == 9:
            cell = vals.reshape(3, 3)
    zs = np.zeros(n, dtype=np.int64)
    pos = np.zeros((n, 3), dtype=np.float64)
    for i in range(n):
        parts = lines[2 + i].split()
        sym = parts[0]
        if sym not in SYMBOL_TO_Z:
            try:
                zs[i] = int(sym)
            except ValueError:
                raise ValueError(f"unknown element symbol {sym!r} in {path}")
        else:
            zs[i] = SYMBOL_TO_Z[sym]
        pos[i] = [float(parts[1]), float(parts[2]), float(parts[3])]
    return zs, pos, cell


def read_xyz_sample(
    path: str,
    graph_feature_dims: Sequence[int],
    graph_feature_cols: Sequence[int],
) -> GraphSample:
    """XYZ + ``<name>_energy.txt`` sidecar -> GraphSample
    (x = proton numbers, reference xyzdataset.py:50-71)."""
    zs, pos, cell = read_xyz_file(path)
    energy_path = os.path.splitext(path)[0] + "_energy.txt"
    graph_y = _sidecar_graph_features(energy_path, graph_feature_dims, graph_feature_cols)
    meta = {"cell": cell} if cell is not None else {}
    return GraphSample(
        x=zs[:, None].astype(np.float64),
        pos=pos.astype(np.float32),
        graph_y=graph_y,
        meta=meta,
    )


# ---------------------------------------------------------------- CFG ----


def read_cfg_file(path: str) -> Dict[str, np.ndarray]:
    """Parse an AtomEye extended CFG file.

    Returns dict with ``numbers`` [n], ``masses`` [n], ``pos`` [n,3]
    (cartesian, H0 @ s), ``cell`` [3,3], plus one [n] array per auxiliary
    property (e.g. ``c_peratom``, ``fx``, ``fy``, ``fz``).
    """
    with open(path, "r", encoding="utf-8") as f:
        raw_lines = f.read().splitlines()

    n = None
    scale = 1.0
    h0 = np.zeros((3, 3), dtype=np.float64)
    aux_names: Dict[int, str] = {}
    entry_count = None
    body_start = None
    for li, line in enumerate(raw_lines):
        s = line.strip()
        if not s or s.startswith("#"):
            continue
        if s.startswith("Number of particles"):
            n = int(s.split("=")[1].split()[0])
        elif s.startswith("A ="):
            scale = float(s.split("=")[1].split()[0])
        elif s.startswith("H0("):
            m = re.match(r"H0\((\d),(\d)\)\s*=\s*([-\d.eE+]+)", s)
            if m:
                h0[int(m.group(1)) - 1, int(m.group(2)) - 1] = float(m.group(3))
        elif s.startswith("entry_count"):
            entry_count = int(s.split("=")[1].split()[0])
        elif s.startswith("auxiliary["):
            m = re.match(r"auxiliary\[(\d+)\]\s*=\s*(\S+)", s)
            if m:
                aux_names[int(m.group(1))] = m.group(2)
        elif s == ".NO_VELOCITY.":
            pass
        else:
            # first body line: either a bare mass (extended per-species
            # blocks) or a full position row (legacy single-block)
            if n is not None and entry_count is not None:
                body_start = li
                break
    if n is None or body_start is None:
        raise ValueError(f"malformed CFG file {path}")

    cell = h0 * scale
    numbers = np.zeros(n, dtype=np.int64)
    masses = np.zeros(n, dtype=np.float64)
    pos = np.zeros((n, 3), dtype=np.float64)
    n_aux = entry_count - 3
    aux = {aux_names.get(k, f"aux{k}"): np.zeros(n, dtype=np.float64) for k in range(n_aux)}

    i = 0
    cur_mass = 0.0
    cur_z = 0
    li = body_start
    while li < len(raw_lines) and i < n:
        s = raw_lines[li].strip()
        li += 1
        if not s:
            continue
        parts = s.split()
        if len(parts) == 1:
            # species block header: mass line, then symbol line
            cur_mass = float(parts[0])
            sym = raw_lines[li].strip()
            li += 1
            cur_z = SYMBOL_TO_Z.get(
                sym, int(np.abs(ATOMIC_MASSES - cur_mass).argmin())
            )
            continue
        svec = np.asarray([float(parts[0]), float(parts[1]), float(parts[2])])
        pos[i] = svec @ cell
        numbers[i] = cur_z
        masses[i] = cur_mass
        for k in range(n_aux):
            aux[aux_names.get(k, f"aux{k}")][i] = float(parts[3 + k])
        i += 1
    if i != n:
        raise ValueError(f"CFG file {path}: expected {n} atoms, parsed {i}")
    out = {"numbers": numbers, "masses": masses, "pos": pos, "cell": cell}
    out.update(aux)
    return out


def read_cfg_sample(
    path: str,
    graph_feature_dims: Sequence[int],
    graph_feature_cols: Sequence[int],
) -> GraphSample:
    """CFG + optional ``<name>.bulk`` sidecar -> GraphSample with the
    reference's node-feature packing [Z, mass, c_peratom, fx, fy, fz]
    (reference cfgdataset.py:50-84)."""
    parsed = read_cfg_file(path)
    cols = [
        parsed["numbers"].astype(np.float64),
        parsed["masses"],
        parsed.get("c_peratom", np.zeros(len(parsed["numbers"]))),
        parsed.get("fx", np.zeros(len(parsed["numbers"]))),
        parsed.get("fy", np.zeros(len(parsed["numbers"]))),
        parsed.get("fz", np.zeros(len(parsed["numbers"]))),
    ]
    x = np.stack(cols, axis=1)
    graph_y = None
    bulk_path = os.path.splitext(path)[0] + ".bulk"
    if os.path.exists(bulk_path) and sum(graph_feature_dims) > 0:
        graph_y = _sidecar_graph_features(bulk_path, graph_feature_dims, graph_feature_cols)
    return GraphSample(
        x=x,
        pos=parsed["pos"].astype(np.float32),
        graph_y=graph_y,
        meta={"cell": parsed["cell"]},
    )


# ------------------------------------------------------- dir readers ----


def _dataset_cols(dataset_config: Dict) -> Tuple[Sequence[int], Sequence[int]]:
    gf = dataset_config["graph_features"]
    return gf["dim"], gf["column_index"]


def read_xyz_dir(path: str, dataset_config: Dict) -> List[GraphSample]:
    dims, cols = _dataset_cols(dataset_config)
    samples = []
    for fname in sorted(os.listdir(path)):
        if fname.endswith(".xyz"):
            samples.append(read_xyz_sample(os.path.join(path, fname), dims, cols))
    return samples


def read_cfg_dir(path: str, dataset_config: Dict) -> List[GraphSample]:
    dims, cols = _dataset_cols(dataset_config)
    samples = []
    for fname in sorted(os.listdir(path)):
        if fname.endswith(".cfg"):
            samples.append(read_cfg_sample(os.path.join(path, fname), dims, cols))
    return samples
