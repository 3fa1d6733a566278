"""Sample representation, normalization, and target packing (the
port's copy of ``hydragnn_tpu/data/dataset.py``; numpy only).

The reference's data layer carries PyG ``Data`` objects whose ``x`` holds
*all* node features column-packed and whose ``y`` is a ragged concatenation
of the selected targets plus a ``y_loc`` offset table (reference:
hydragnn/preprocess/serialized_dataset_loader.py:262-303). The TPU-native
design replaces the ragged contract with explicit dicts:

  GraphSample.x        [n, sum(node_feature_dims)]  — all raw node features
  GraphSample.graph_y  [sum(graph_feature_dims)]    — all raw graph features
  graph_targets / node_targets: {head_name: array}  — selected, packed

Normalization mirrors AbstractRawDataLoader.normalize_dataset (reference:
hydragnn/preprocess/raw_dataset_loader.py:194-279): global min-max per
*feature* (not per column), divide-by-zero-safe.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class GraphSample:
    """One graph, host-side numpy. ``edge_index`` is [2, e] (senders row 0)."""

    x: np.ndarray
    pos: Optional[np.ndarray] = None
    edge_index: Optional[np.ndarray] = None
    edge_attr: Optional[np.ndarray] = None
    graph_y: Optional[np.ndarray] = None
    graph_targets: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    node_targets: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    # free-form extras (e.g. supercell size, composition id)
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def num_nodes(self) -> int:
        return int(self.x.shape[0])

    @property
    def num_edges(self) -> int:
        return 0 if self.edge_index is None else int(self.edge_index.shape[1])


def scale_features_by_num_nodes(
    samples: Sequence[GraphSample],
    graph_feature_names: Sequence[str],
    node_feature_names: Sequence[str],
    graph_feature_dims: Sequence[int],
    node_feature_dims: Sequence[int],
) -> None:
    """Divide ``*_scaled_num_nodes`` features by the node count, in place
    (reference: raw_dataset_loader.py:169-192)."""
    g_cols = _feature_columns(graph_feature_names, graph_feature_dims, "_scaled_num_nodes")
    n_cols = _feature_columns(node_feature_names, node_feature_dims, "_scaled_num_nodes")
    for s in samples:
        if s.graph_y is not None and g_cols:
            s.graph_y[g_cols] = s.graph_y[g_cols] / s.num_nodes
        if n_cols:
            s.x[:, n_cols] = s.x[:, n_cols] / s.num_nodes


def _feature_columns(names, dims, suffix) -> List[int]:
    cols: List[int] = []
    start = 0
    for name, dim in zip(names, dims):
        if suffix in name:
            cols.extend(range(start, start + dim))
        start += dim
    return cols


def compute_minmax(
    samples: Sequence[GraphSample],
    graph_feature_dims: Sequence[int],
    node_feature_dims: Sequence[int],
) -> Tuple[np.ndarray, np.ndarray]:
    """(minmax_graph_feature [2, nG], minmax_node_feature [2, nN]);
    row 0 = min, row 1 = max, over the whole dataset, per feature."""
    ng, nn = len(graph_feature_dims), len(node_feature_dims)
    mm_g = np.full((2, ng), np.inf)
    mm_n = np.full((2, nn), np.inf)
    mm_g[1] *= -1
    mm_n[1] *= -1
    for s in samples:
        start = 0
        for i, dim in enumerate(graph_feature_dims):
            if s.graph_y is not None:
                seg = s.graph_y[start : start + dim]
                mm_g[0, i] = min(mm_g[0, i], float(seg.min()))
                mm_g[1, i] = max(mm_g[1, i], float(seg.max()))
            start += dim
        start = 0
        for i, dim in enumerate(node_feature_dims):
            seg = s.x[:, start : start + dim]
            mm_n[0, i] = min(mm_n[0, i], float(seg.min()))
            mm_n[1, i] = max(mm_n[1, i], float(seg.max()))
            start += dim
    return mm_g, mm_n


def _safe_divide(num: np.ndarray, den: float) -> np.ndarray:
    # reference tensor_divide: 0 where denominator is 0
    if den == 0:
        return np.zeros_like(num)
    return num / den


def normalize_dataset(
    samples: Sequence[GraphSample],
    graph_feature_dims: Sequence[int],
    node_feature_dims: Sequence[int],
    minmax_graph: Optional[np.ndarray] = None,
    minmax_node: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Min-max normalize every feature to [0, 1] in place; returns the
    (graph, node) minmax tables used (computed if not given)."""
    if minmax_graph is None or minmax_node is None:
        minmax_graph, minmax_node = compute_minmax(
            samples, graph_feature_dims, node_feature_dims
        )
    for s in samples:
        start = 0
        for i, dim in enumerate(graph_feature_dims):
            if s.graph_y is not None:
                s.graph_y[start : start + dim] = _safe_divide(
                    s.graph_y[start : start + dim] - minmax_graph[0, i],
                    float(minmax_graph[1, i] - minmax_graph[0, i]),
                )
            start += dim
        start = 0
        for i, dim in enumerate(node_feature_dims):
            s.x[:, start : start + dim] = _safe_divide(
                s.x[:, start : start + dim] - minmax_node[0, i],
                float(minmax_node[1, i] - minmax_node[0, i]),
            )
            start += dim
    return minmax_graph, minmax_node


def update_predicted_values(
    samples: Sequence[GraphSample],
    output_type: Sequence[str],
    output_index: Sequence[int],
    output_names: Sequence[str],
    graph_feature_dims: Sequence[int],
    node_feature_dims: Sequence[int],
) -> None:
    """Populate graph_targets/node_targets dicts from the packed raw
    features — the dict-of-heads replacement for the reference's ragged
    ``y``/``y_loc`` packing (reference:
    hydragnn/preprocess/serialized_dataset_loader.py:262-303)."""
    g_starts = np.concatenate([[0], np.cumsum(graph_feature_dims)]).astype(int)
    n_starts = np.concatenate([[0], np.cumsum(node_feature_dims)]).astype(int)
    for s in samples:
        s.graph_targets = {}
        s.node_targets = {}
        for typ, idx, name in zip(output_type, output_index, output_names):
            if typ == "graph":
                lo, hi = g_starts[idx], g_starts[idx + 1]
                s.graph_targets[name] = np.asarray(s.graph_y[lo:hi], dtype=np.float32)
            elif typ == "node":
                lo, hi = n_starts[idx], n_starts[idx + 1]
                s.node_targets[name] = np.asarray(s.x[:, lo:hi], dtype=np.float32)
            else:
                raise ValueError(f"Unknown output type {typ}")


def select_input_features(
    samples: Sequence[GraphSample],
    input_node_features: Sequence[int],
    node_feature_dims: Sequence[int],
) -> None:
    """Keep only the selected input features in ``x``, in place
    (reference: serialized_dataset_loader.py __update_node_features)."""
    starts = np.concatenate([[0], np.cumsum(node_feature_dims)]).astype(int)
    cols: List[int] = []
    for idx in input_node_features:
        cols.extend(range(starts[idx], starts[idx + 1]))
    for s in samples:
        s.x = np.ascontiguousarray(s.x[:, cols], dtype=np.float32)


def samples_to_graph_dicts(samples: Sequence[GraphSample]) -> List[Dict[str, Any]]:
    """The dict form ``graph/batch.py:batch_graphs`` consumes, targets
    included."""
    out = []
    for s in samples:
        g: Dict[str, Any] = {
            "x": s.x,
            "senders": s.edge_index[0],
            "receivers": s.edge_index[1],
            "graph_targets": s.graph_targets,
            "node_targets": s.node_targets,
        }
        if s.pos is not None:
            g["pos"] = s.pos
        if s.edge_attr is not None:
            g["edge_attr"] = s.edge_attr
        out.append(g)
    return out
