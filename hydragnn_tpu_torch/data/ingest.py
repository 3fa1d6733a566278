"""Dataset preparation: raw in-memory samples -> model-ready splits.

The port's counterpart of ``hydragnn_tpu/data/ingest.py:prepare_dataset``
for the branches the flagship configuration takes, in the reference's
order:

  1. ``*_scaled_num_nodes`` feature scaling,
  2. global min-max normalization,
  3. radius-graph edges + edge lengths (no periodic images),
  4. global max edge-length normalization,
  5. target packing (dict-of-heads) + input-feature column selection,
  6. train/val/test split (proportional or compositional stratified).

Rotational invariance, periodic boundaries, edge descriptors and
subsampling raise ``NotImplementedError``: they belong to the
data-breadth slice (ROADMAP A8).
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
from hydragnn_tpu_torch.data.radius_graph import edge_lengths, radius_graph
from hydragnn_tpu_torch.data.splitting import split_dataset


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"hydragnn_tpu_torch: {what} is not ported yet (ROADMAP A8, data breadth)"
    )


def build_edges(
    samples: Sequence[GraphSample],
    radius: float,
    max_neighbours: Optional[int],
    max_edge_length: Optional[float] = None,
) -> float:
    """Radius-graph edges and normalized edge-length attributes for every
    sample, in place. Returns the max edge length used for
    normalization, taken over all samples together."""
    for s in samples:
        ei = radius_graph(s.pos, radius, max_num_neighbors=max_neighbours, loop=False)
        s.edge_index = ei
        s.edge_attr = edge_lengths(s.pos, ei)
    if max_edge_length is None:
        max_edge_length = max(
            (float(s.edge_attr.max()) for s in samples if s.edge_attr.size), default=1.0
        )
    for s in samples:
        s.edge_attr = (s.edge_attr / max_edge_length).astype(np.float32)
    return max_edge_length


def _prepare_samples(
    samples: List[GraphSample], config: Dict
) -> Tuple[np.ndarray, np.ndarray]:
    """Steps 1-5 of the module docstring, in place over ``samples``;
    returns (minmax_graph, minmax_node)."""
    ds_cfg = config["Dataset"]
    nn_cfg = config["NeuralNetwork"]
    arch = nn_cfg["Architecture"]
    voi = nn_cfg["Variables_of_interest"]
    nf, gf = ds_cfg["node_features"], ds_cfg["graph_features"]

    if ds_cfg.get("rotational_invariance", False):
        raise _not_ported("Dataset.rotational_invariance")
    if arch.get("periodic_boundary_conditions", False):
        raise _not_ported("Architecture.periodic_boundary_conditions")
    desc = ds_cfg.get("Descriptors", {})
    if desc.get("SphericalCoordinates", False) or desc.get("PointPairFeatures", False):
        raise _not_ported("Dataset.Descriptors")

    scale_features_by_num_nodes(samples, gf["name"], nf["name"], gf["dim"], nf["dim"])
    mm_g, mm_n = normalize_dataset(samples, gf["dim"], nf["dim"])
    build_edges(samples, radius=arch["radius"], max_neighbours=arch.get("max_neighbours"))
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
    """Full preparation on an in-memory sample list (in place); returns
    (train, val, test, minmax_graph, minmax_node)."""
    if config["NeuralNetwork"]["Variables_of_interest"].get("subsample_percentage") is not None:
        raise _not_ported("Variables_of_interest.subsample_percentage")
    mm_g, mm_n = _prepare_samples(samples, config)
    train, val, test = split_dataset(
        samples,
        config["NeuralNetwork"]["Training"]["perc_train"],
        stratify_splitting=config["Dataset"].get(
            "compositional_stratified_splitting", False
        ),
    )
    return train, val, test, mm_g, mm_n
