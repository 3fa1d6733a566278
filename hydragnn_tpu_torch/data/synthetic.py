"""Deterministic synthetic graph dataset with closed-form targets.

Re-implementation of the reference's keystone test fixture (reference:
tests/deterministic_graph_data.py:20-180): BCC supercells with random unit
cell counts, node feature = random type id, nodal outputs = kNN-smoothed
feature x, x^2 + feature, x^3, graph output = sum of all three nodal
outputs. Because the learned function is known in closed form, end-to-end
accuracy thresholds are meaningful.

The port's copy of ``hydragnn_tpu/data/synthetic.py``: from the same
seed it yields bit-equal samples (tests/test_torch_data.py). Two outputs:
  - ``deterministic_graph_data`` -> in-memory ``GraphSample`` list whose
    feature packing matches what the reference's LSMS reader produces for
    these files — including the charge-density correction
    ``x[:,1] -= x[:,0]`` (reference:
    hydragnn/preprocess/lsms_raw_dataset_loader.py:91-108), so effective
    node features are [type, knn_x^2, knn_x^3] and the raw graph feature
    is the pre-correction total sum.
  - ``write_lsms_files`` -> the same configurations (the same rng
    stream) in the LSMS text format, so the raw-ingestion path can be
    tested against identical data.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from hydragnn_tpu_torch.data.dataset import GraphSample

# Column layout of one LSMS text row written by the reference generator:
# feature, node index, x, y, z, out_x, out_x2, out_x3
#   (reference: tests/deterministic_graph_data.py:133-145)


def _bcc_positions(uc_x: int, uc_y: int, uc_z: int) -> np.ndarray:
    n = 2 * uc_x * uc_y * uc_z
    pos = np.zeros((n, 3), dtype=np.float64)
    i = 0
    for x in range(uc_x):
        for y in range(uc_y):
            for z in range(uc_z):
                pos[i] = (x, y, z)
                pos[i + 1] = (x + 0.5, y + 0.5, z + 0.5)
                i += 2
    return pos


def _knn_average(pos: np.ndarray, values: np.ndarray, k: int) -> np.ndarray:
    """Uniform k-nearest-neighbor regression evaluated at the training
    points (sklearn KNeighborsRegressor semantics: the query point itself
    is among the candidates at distance 0)."""
    diff = pos[:, None, :] - pos[None, :, :]
    dist = np.sqrt((diff * diff).sum(-1))
    order = np.argsort(dist, axis=1, kind="stable")[:, :k]
    return values[order].mean(axis=1)


def _one_configuration(
    rng: np.random.Generator,
    uc: Tuple[int, int, int],
    types: Sequence[int],
    number_neighbors: int,
    linear_only: bool,
):
    pos = _bcc_positions(*uc)
    n = pos.shape[0]
    feature = rng.integers(min(types), max(types) + 1, size=(n,)).astype(np.float64)
    if linear_only:
        out_x = feature.copy()
    else:
        out_x = _knn_average(pos, feature, number_neighbors)
    out_x2 = out_x**2 + feature
    out_x3 = out_x**3
    if linear_only:
        total = out_x.sum()
        totals = (total,)
    else:
        totals = (out_x.sum() + out_x2.sum() + out_x3.sum(), out_x.sum())
    return pos, feature, out_x, out_x2, out_x3, totals


def deterministic_graph_data(
    number_configurations: int = 500,
    unit_cell_x_range: Tuple[int, int] = (1, 3),
    unit_cell_y_range: Tuple[int, int] = (1, 3),
    unit_cell_z_range: Tuple[int, int] = (1, 2),
    number_types: int = 3,
    types: Optional[Sequence[int]] = None,
    number_neighbors: int = 2,
    linear_only: bool = False,
    seed: int = 0,
) -> List[GraphSample]:
    """Generate the dataset in memory.

    Each sample's raw (pre-normalization) packing mirrors the LSMS-reader
    output for the reference files:
      x columns: [feature(type), out_x2 - feature, out_x3]   (3 features)
      graph_y:   [total] where total = sum(out_x)+sum(out_x2)+sum(out_x3)
    Ranges are exclusive on the high end (torch.randint semantics,
    reference: tests/deterministic_graph_data.py:36-49).
    """
    if types is None:
        types = list(range(number_types))
    rng = np.random.default_rng(seed)
    ucx = rng.integers(unit_cell_x_range[0], unit_cell_x_range[1], number_configurations)
    ucy = rng.integers(unit_cell_y_range[0], unit_cell_y_range[1], number_configurations)
    ucz = rng.integers(unit_cell_z_range[0], unit_cell_z_range[1], number_configurations)

    samples: List[GraphSample] = []
    for c in range(number_configurations):
        pos, feature, out_x, out_x2, out_x3, totals = _one_configuration(
            rng, (int(ucx[c]), int(ucy[c]), int(ucz[c])), types, number_neighbors, linear_only
        )
        # LSMS charge-density correction: selected feature col 1 minus col 0
        # (lsms_raw_dataset_loader.py:91-108). With ci.json's column_index
        # [0, 6, 7] that yields [type, out_x2 - type, out_x3].
        if linear_only:
            x = np.stack([feature, out_x - feature], axis=1)
        else:
            x = np.stack([feature, out_x2 - feature, out_x3], axis=1)
        samples.append(
            GraphSample(
                x=np.asarray(x, dtype=np.float64),
                pos=np.asarray(pos, dtype=np.float32),
                graph_y=np.asarray([totals[0]], dtype=np.float64),
            )
        )
    return samples


def write_lsms_files(
    path: str,
    number_configurations: int = 500,
    configuration_start: int = 0,
    seed: int = 0,
    **kwargs,
) -> None:
    """Write the same configurations in the reference's LSMS text format
    (reference: tests/deterministic_graph_data.py:83-180) so the raw text
    ingestion path can round-trip them."""
    types = kwargs.pop("types", None) or list(range(kwargs.pop("number_types", 3)))
    number_neighbors = kwargs.pop("number_neighbors", 2)
    linear_only = kwargs.pop("linear_only", False)
    ucx_r = kwargs.pop("unit_cell_x_range", (1, 3))
    ucy_r = kwargs.pop("unit_cell_y_range", (1, 3))
    ucz_r = kwargs.pop("unit_cell_z_range", (1, 2))
    if kwargs:
        raise TypeError(f"unexpected kwargs: {sorted(kwargs)}")

    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(seed)
    ucx = rng.integers(ucx_r[0], ucx_r[1], number_configurations)
    ucy = rng.integers(ucy_r[0], ucy_r[1], number_configurations)
    ucz = rng.integers(ucz_r[0], ucz_r[1], number_configurations)
    for c in range(number_configurations):
        pos, feature, out_x, out_x2, out_x3, totals = _one_configuration(
            rng, (int(ucx[c]), int(ucy[c]), int(ucz[c])), types, number_neighbors, linear_only
        )
        n = pos.shape[0]
        lines = ["\t".join(f"{t:.10g}" for t in totals)]
        for i in range(n):
            row = [
                feature[i],
                float(i),
                pos[i, 0],
                pos[i, 1],
                pos[i, 2],
                out_x[i],
                out_x2[i],
                out_x3[i],
            ]
            lines.append("\t".join(f"{v:.10g}" for v in row))
        fname = os.path.join(path, f"output{c + configuration_start}.txt")
        with open(fname, "w") as f:
            f.write("\n".join(lines))
