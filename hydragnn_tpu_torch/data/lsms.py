"""LSMS text-format reader (the port's copy of
``hydragnn_tpu/data/lsms.py``; numpy only).

Parses the per-configuration text files the reference consumes (reference:
hydragnn/preprocess/lsms_raw_dataset_loader.py:39-108): line 0 = graph
features, remaining lines = per-node rows
``feature index x y z out...``; graph/node features are picked by the
config's column indices, and the LSMS charge-density correction
``x[:, 1] -= x[:, 0]`` is applied (lsms_raw_dataset_loader.py:91-108).
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence

import numpy as np

from hydragnn_tpu_torch.data.dataset import GraphSample


def read_lsms_file(
    filepath: str,
    graph_feature_dim: Sequence[int],
    graph_feature_col: Sequence[int],
    node_feature_dim: Sequence[int],
    node_feature_col: Sequence[int],
) -> GraphSample:
    with open(filepath, "r", encoding="utf-8") as f:
        lines = f.readlines()
    graph_feat = lines[0].split()
    g = []
    for item in range(len(graph_feature_dim)):
        for icomp in range(graph_feature_dim[item]):
            g.append(float(graph_feat[graph_feature_col[item] + icomp]))

    pos_rows: List[List[float]] = []
    feat_rows: List[List[float]] = []
    for line in lines[1:]:
        if not line.strip():
            continue
        cols = line.split()
        pos_rows.append([float(cols[2]), float(cols[3]), float(cols[4])])
        row = []
        for item in range(len(node_feature_dim)):
            for icomp in range(node_feature_dim[item]):
                row.append(float(cols[node_feature_col[item] + icomp]))
        feat_rows.append(row)

    x = np.asarray(feat_rows, dtype=np.float64)
    # charge-density correction (always applied by the reference LSMS path)
    if x.shape[1] >= 2:
        x[:, 1] = x[:, 1] - x[:, 0]
    return GraphSample(
        x=x,
        pos=np.asarray(pos_rows, dtype=np.float32),
        graph_y=np.asarray(g, dtype=np.float64),
    )


def read_lsms_dir(path: str, dataset_config: Dict) -> List[GraphSample]:
    """Read every file in a directory (sorted, matching the reference's
    sorted(os.listdir), raw_dataset_loader.py:110)."""
    nf = dataset_config["node_features"]
    gf = dataset_config["graph_features"]
    samples = []
    for name in sorted(os.listdir(path)):
        full = os.path.join(path, name)
        if not os.path.isfile(full) or name == ".DS_Store":
            continue
        samples.append(
            read_lsms_file(full, gf["dim"], gf["column_index"], nf["dim"], nf["column_index"])
        )
    return samples
