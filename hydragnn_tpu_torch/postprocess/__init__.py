"""Output denormalization and per-num-nodes unscaling (the port's copy
of ``hydragnn_tpu/postprocess/postprocess.py``: ``output_denormalize``,
``unscale_features_by_num_nodes`` and its config-driven variant). The
plots are in ``postprocess/visualizer.py``."""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def output_denormalize(
    y_minmax: Sequence[Sequence[float]],
    true_values: List[np.ndarray],
    predicted_values: List[np.ndarray],
):
    """Inverse min-max transform per head: ``v·(max − min) + min``."""
    out_true, out_pred = [], []
    for ihead in range(len(y_minmax)):
        ymin = np.asarray(y_minmax[ihead][0], dtype=np.float64)
        ymax = np.asarray(y_minmax[ihead][1], dtype=np.float64)
        scale = ymax - ymin
        out_true.append(np.asarray(true_values[ihead]) * scale + ymin)
        out_pred.append(np.asarray(predicted_values[ihead]) * scale + ymin)
    return out_true, out_pred


def unscale_features_by_num_nodes(
    datasets_list: List[List[np.ndarray]],
    scaled_index_list: Sequence[int],
    nodes_num_list: Sequence[int],
):
    """Multiply ``*_scaled_num_nodes`` heads back by each sample's node
    count (reference: postprocess.py:30-42). ``datasets_list`` entries are
    per-head lists of per-sample arrays."""
    for dataset in datasets_list:
        for scaled_index in scaled_index_list:
            head_value = dataset[scaled_index]
            for isample, n in enumerate(nodes_num_list):
                head_value[isample] = np.asarray(head_value[isample]) * n
    return datasets_list


def unscale_features_by_num_nodes_config(
    config: Dict, datasets_list, nodes_num_list
):
    """Config-driven variant keyed on ``*_scaled_num_nodes`` head names
    (reference: postprocess.py:45-55)."""
    var_config = config["NeuralNetwork"]["Variables_of_interest"]
    output_names = var_config["output_names"]
    scaled_feature_index = [
        i for i in range(len(output_names)) if "_scaled_num_nodes" in output_names[i]
    ]
    if scaled_feature_index:
        if not var_config["denormalize_output"]:
            raise ValueError(
                "Cannot unscale features without 'denormalize_output'"
            )
        datasets_list = unscale_features_by_num_nodes(
            datasets_list, scaled_feature_index, nodes_num_list
        )
    return datasets_list
