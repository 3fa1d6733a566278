"""End-to-end dataset preparation: raw samples -> model-ready splits.

The port's copy of ``hydragnn_tpu/data/ingest.py`` (numpy only), the
equivalent of the reference chain ``transform_raw_data_to_serialized`` ->
``SerializedDataLoader.load_serialized_data`` -> ``split_dataset``
(reference: hydragnn/preprocess/load_data.py:207-223,335-393 and
hydragnn/preprocess/serialized_dataset_loader.py:106-259). Steps, in the
reference's order:

  1. read raw files (LSMS text, XYZ, CFG, the HGC container) or take
     in-memory samples,
  2. ``*_scaled_num_nodes`` feature scaling,
  3. global min-max normalization,
  4. optional rotation normalization (rotational invariance),
  5. radius-graph edges (plain or PBC) + edge lengths,
  6. global max edge-length normalization,
  7. optional spherical-coordinate and point-pair edge descriptors,
  8. target packing (dict-of-heads) + input-feature column selection,
  9. optional stratified subsample, then the train/val/test split
     (proportional or compositional stratified), or the predefined
     splits of a per-split ``Dataset.path``.

Two behaviours are the JAX package's and are kept as they are: under
PBC the edge lengths come from the unshifted positions (a wrapped edge
gets its in-cell distance), and rotation normalization rotates ``pos``
but not ``meta["cell"]``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from hydragnn_tpu_torch.data.dataset import (
    GraphSample,
    normalize_dataset,
    scale_features_by_num_nodes,
    select_input_features,
    update_predicted_values,
)
from hydragnn_tpu_torch.data.lsms import read_lsms_dir
from hydragnn_tpu_torch.data.radius_graph import edge_lengths, radius_graph, radius_graph_pbc
from hydragnn_tpu_torch.data.splitting import split_dataset, stratified_subsample


def normalize_rotation(samples: Sequence[GraphSample]) -> None:
    """Center positions and rotate onto principal axes, in place (the
    reference's PyG ``NormalizeRotation`` transform, used at
    serialized_dataset_loader.py:128-130). Edge lengths are invariant."""
    for s in samples:
        in_dtype = np.asarray(s.pos).dtype
        pos = np.asarray(s.pos, dtype=np.float64)
        pos = pos - pos.mean(axis=0, keepdims=True)
        # right singular vectors = principal axes. Reduced SVD gives the
        # full (3,3) vt for n >= 3; only n < 3 needs full_matrices (and
        # only then — full mode materializes a discarded n x n U, which
        # is O(n^2) memory on big graphs)
        _, _, vt = np.linalg.svd(pos, full_matrices=pos.shape[0] < 3)
        # preserve a floating input dtype (the reference's transform does;
        # a float64 dataset keeps float64 fidelity through normalization);
        # non-float positions (e.g. integer lattice coordinates) must not
        # be truncated back to ints
        out_dtype = in_dtype if np.issubdtype(in_dtype, np.floating) else np.float32
        s.pos = (pos @ vt.T).astype(out_dtype)


def build_edges(
    samples: Sequence[GraphSample],
    radius: float,
    max_neighbours: Optional[int],
    periodic_boundary_conditions: bool = False,
    rotational_invariance: bool = False,
    spherical_coordinates: bool = False,
    point_pair_features: bool = False,
    max_edge_length: Optional[float] = None,
) -> float:
    """Compute radius-graph edges and normalized edge-length attributes for
    every sample, in place. Returns the max edge length used for
    normalization (compute it once on train+val+test together, like the
    reference's global max all-reduce, serialized_dataset_loader.py:155-169)."""
    if rotational_invariance:
        normalize_rotation(samples)

    for s in samples:
        if periodic_boundary_conditions:
            cell = s.meta.get("cell")
            if cell is None:
                raise ValueError("PBC requested but sample has no meta['cell']")
            ei = radius_graph_pbc(
                s.pos, radius, cell, max_num_neighbors=max_neighbours, loop=False
            )
        else:
            ei = radius_graph(s.pos, radius, max_num_neighbors=max_neighbours, loop=False)
        s.edge_index = ei
        s.edge_attr = edge_lengths(s.pos, ei)

    if max_edge_length is None:
        max_edge_length = max(
            (float(s.edge_attr.max()) for s in samples if s.edge_attr.size), default=1.0
        )
    for s in samples:
        s.edge_attr = (s.edge_attr / max_edge_length).astype(np.float32)

    if spherical_coordinates:
        _append_spherical(samples)
    if point_pair_features:
        _append_point_pair(samples, max_edge_length)
    return max_edge_length


def _append_spherical(samples: Sequence[GraphSample]) -> None:
    """Append (theta, phi) spherical angles to the edge attributes (PyG
    ``Spherical`` transform equivalent; rho is the existing length)."""
    for s in samples:
        src = s.pos[s.edge_index[0]]
        dst = s.pos[s.edge_index[1]]
        d = (dst - src).astype(np.float64)
        rho = np.linalg.norm(d, axis=1)
        theta = np.arctan2(d[:, 1], d[:, 0])
        theta = np.where(theta < 0, theta + 2 * np.pi, theta) / (2 * np.pi)
        safe_rho = np.where(rho > 0, rho, 1.0)
        phi = np.arccos(np.clip(d[:, 2] / safe_rho, -1.0, 1.0)) / np.pi
        s.edge_attr = np.concatenate(
            [s.edge_attr, theta[:, None].astype(np.float32), phi[:, None].astype(np.float32)],
            axis=1,
        )


def _append_point_pair(samples: Sequence[GraphSample], max_edge_length: float) -> None:
    """Append PointPairFeatures to the edge attributes (PyG
    ``PointPairFeatures`` transform equivalent; reference usage:
    hydragnn/utils/abstractrawdataset.py:380-383). Per edge (i -> j) with
    per-node normals n: [rho, angle(n_i, d), angle(n_j, d),
    angle(n_i, n_j)], angles in radians via atan2(|cross|, dot). Like the
    spherical descriptor, rho is normalized by the global max edge length
    (the raw-length column PyG would duplicate is already present,
    normalized). Normals come from ``sample.meta['norm']`` ([N, 3]) — the
    same contract as PyG's required ``data.norm``."""

    def angle(v1, v2):
        cross = np.linalg.norm(np.cross(v1, v2), axis=1)
        dot = (v1 * v2).sum(axis=1)
        return np.arctan2(cross, dot)

    for s in samples:
        norm = s.meta.get("norm") if s.meta else None
        if norm is None:
            raise ValueError(
                "PointPairFeatures requires per-node normals in "
                "sample.meta['norm'] (the PyG transform's data.norm contract)"
            )
        norm = np.asarray(norm, dtype=np.float64)
        d = (s.pos[s.edge_index[1]] - s.pos[s.edge_index[0]]).astype(np.float64)
        rho = np.linalg.norm(d, axis=1) / max_edge_length
        ni, nj = norm[s.edge_index[0]], norm[s.edge_index[1]]
        feats = np.stack(
            [rho, angle(ni, d), angle(nj, d), angle(ni, nj)], axis=1
        ).astype(np.float32)
        s.edge_attr = np.concatenate([s.edge_attr, feats], axis=1)


def _prepare_samples(
    samples: List[GraphSample], config: Dict
) -> Tuple[np.ndarray, np.ndarray]:
    """The shared preparation body (steps 2-8 of the module docstring),
    in place over ``samples``; returns (minmax_graph, minmax_node)."""
    ds_cfg = config["Dataset"]
    nn_cfg = config["NeuralNetwork"]
    arch = nn_cfg["Architecture"]
    voi = nn_cfg["Variables_of_interest"]
    nf, gf = ds_cfg["node_features"], ds_cfg["graph_features"]

    scale_features_by_num_nodes(samples, gf["name"], nf["name"], gf["dim"], nf["dim"])
    mm_g, mm_n = normalize_dataset(samples, gf["dim"], nf["dim"])

    desc = ds_cfg.get("Descriptors", {})
    build_edges(
        samples,
        radius=arch["radius"],
        max_neighbours=arch.get("max_neighbours"),
        periodic_boundary_conditions=arch.get("periodic_boundary_conditions", False),
        rotational_invariance=ds_cfg.get("rotational_invariance", False),
        spherical_coordinates=desc.get("SphericalCoordinates", False),
        point_pair_features=desc.get("PointPairFeatures", False),
    )

    update_predicted_values(
        samples,
        voi["type"],
        voi["output_index"],
        voi["output_names"],
        gf["dim"],
        nf["dim"],
    )
    select_input_features(samples, voi["input_node_features"], nf["dim"])
    return mm_g, mm_n


def prepare_dataset(
    samples: List[GraphSample],
    config: Dict,
) -> Tuple[List[GraphSample], List[GraphSample], List[GraphSample], np.ndarray, np.ndarray]:
    """Full preparation pipeline on an in-memory sample list.

    ``config`` is the reference-shaped top-level dict (Dataset /
    NeuralNetwork sections). Returns (train, val, test, minmax_graph,
    minmax_node).
    """
    mm_g, mm_n = _prepare_samples(samples, config)
    samples = _maybe_subsample(samples, config)
    train, val, test = split_dataset(
        samples,
        config["NeuralNetwork"]["Training"]["perc_train"],
        stratify_splitting=config["Dataset"].get(
            "compositional_stratified_splitting", False
        ),
    )
    return train, val, test, mm_g, mm_n


def _maybe_subsample(samples: List[GraphSample], config: Dict) -> List[GraphSample]:
    """Variables_of_interest.subsample_percentage: stratified downselect
    after preparation, before splitting (reference: the __build_edge tail,
    hydragnn/utils/abstractrawdataset.py:396-403).

    Like the reference (which subsamples after __update_atom_features),
    this runs after input-feature selection: the stratification category
    reads x[:, 0] of the SELECTED features, so composition stratification
    requires the composition/type column listed first in
    ``input_node_features`` — otherwise the categories quietly degrade to
    whatever feature 0 is."""
    frac = config["NeuralNetwork"]["Variables_of_interest"].get("subsample_percentage")
    if frac is None:
        return samples
    return stratified_subsample(samples, float(frac))


def prepare_presplit_dataset(
    train: List[GraphSample],
    val: List[GraphSample],
    test: List[GraphSample],
    config: Dict,
) -> Tuple[List[GraphSample], List[GraphSample], List[GraphSample], np.ndarray, np.ndarray]:
    """Preparation for pre-defined splits (the reference's per-split
    ``Dataset.path.{train,validate,test}`` layout,
    hydragnn/preprocess/load_data.py:352-393): the same pipeline as
    ``prepare_dataset`` with normalization statistics and edge-length
    normalization computed over ALL splits together (the reference's
    global min-max / max-edge reductions span the full dataset), but the
    split membership preserved."""
    counts = (len(train), len(val), len(test))
    merged = list(train) + list(val) + list(test)
    mm_g, mm_n = _prepare_samples(merged, config)
    a, b = counts[0], counts[0] + counts[1]
    # per-split subsample preserves the predefined membership (the
    # reference's serialized loader subsamples each split it loads)
    return (
        _maybe_subsample(merged[:a], config),
        _maybe_subsample(merged[a:b], config),
        _maybe_subsample(merged[b:], config),
        mm_g,
        mm_n,
    )


def load_raw_samples(config: Dict, path: str) -> List[GraphSample]:
    """Format dispatch for raw on-disk datasets (reference:
    hydragnn/preprocess/load_data.py:335-349; format set matches the
    reference's LSMS/CFG/XYZ readers plus the HGC container)."""
    fmt = config["Dataset"]["format"]
    if fmt in ("LSMS", "unit_test"):
        return read_lsms_dir(path, config["Dataset"])
    if fmt == "XYZ":
        from hydragnn_tpu_torch.data.formats import read_xyz_dir

        return read_xyz_dir(path, config["Dataset"])
    if fmt == "CFG":
        from hydragnn_tpu_torch.data.formats import read_cfg_dir

        return read_cfg_dir(path, config["Dataset"])
    if fmt == "HGC":
        from hydragnn_tpu_torch.data.container import ContainerDataset

        return ContainerDataset(path).samples()
    raise NameError(f"Data format not recognized for raw data loader: {fmt}")
