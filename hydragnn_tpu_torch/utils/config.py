"""Config loading and data-driven inference.

The port's counterpart of ``hydragnn_tpu/utils/config.py``: the same JSON
schema and the same ``update_config`` contract — after the data is
prepared, the config is completed from it (output dimensions,
input_dim, max_neighbours = max in-degree over the train split, the PNA
degree histogram, edge_dim). It resolves every key the JAX package
resolves, ``Architecture.fused_conv`` (default on) included, except that
package's own runtime knobs (``diagnostics``, ``diag_every``,
``Parallel``), which select TPU code paths the port does not have.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Sequence

import numpy as np

from hydragnn_tpu_torch.data.dataset import GraphSample


def load_config(config_file_or_dict) -> Dict[str, Any]:
    if isinstance(config_file_or_dict, dict):
        return config_file_or_dict
    with open(config_file_or_dict, "r") as f:
        return json.load(f)


def check_if_graph_size_variable(*splits: Sequence[GraphSample]) -> bool:
    """True if node counts differ across any samples."""
    sizes = {s.num_nodes for split in splits for s in split}
    return len(sizes) > 1


def max_in_degree(samples: Sequence[GraphSample]) -> int:
    """Max in-degree over a split."""
    md = 0
    for s in samples:
        if s.num_edges == 0:
            continue
        counts = np.bincount(s.edge_index[1], minlength=s.num_nodes)
        md = max(md, int(counts.max()))
    return md


def pna_degree_histogram(samples: Sequence[GraphSample], max_degree: int) -> List[int]:
    """In-degree histogram over the train split."""
    hist = np.zeros(max_degree + 1, dtype=np.int64)
    for s in samples:
        counts = np.bincount(s.edge_index[1], minlength=s.num_nodes)
        hist += np.bincount(np.clip(counts, 0, max_degree), minlength=max_degree + 1)
    return hist.tolist()


def check_output_dim_consistent(sample: GraphSample, config: Dict[str, Any]) -> None:
    """Declared feature dims must match packed target dims."""
    voi = config["NeuralNetwork"]["Variables_of_interest"]
    ds = config.get("Dataset")
    if ds is None:
        return
    for typ, idx, name in zip(voi["type"], voi["output_index"], voi["output_names"]):
        if typ == "graph":
            expected = ds["graph_features"]["dim"][idx]
            actual = int(np.asarray(sample.graph_targets[name]).reshape(-1).shape[0])
        else:
            expected = ds["node_features"]["dim"][idx]
            actual = int(np.asarray(sample.node_targets[name]).shape[-1])
        if actual != expected:
            raise ValueError(f"head {name}: packed dim {actual} != declared dim {expected}")


def update_config(
    config: Dict[str, Any],
    train: Sequence[GraphSample],
    val: Sequence[GraphSample],
    test: Sequence[GraphSample],
) -> Dict[str, Any]:
    """Complete the config from the prepared data splits (in place;
    returns it)."""
    nn = config["NeuralNetwork"]
    arch = nn["Architecture"]
    voi = nn["Variables_of_interest"]

    graph_size_variable = check_if_graph_size_variable(train, val, test)
    first = train[0]
    if "Dataset" in config:
        check_output_dim_consistent(first, config)

    dims_list = []
    for typ, name in zip(voi["type"], voi["output_names"]):
        if typ == "graph":
            dims_list.append(int(np.asarray(first.graph_targets[name]).reshape(-1).shape[0]))
        elif typ == "node":
            if (
                graph_size_variable
                and arch.get("output_heads", {}).get("node", {}).get("type")
                == "mlp_per_node"
            ):
                raise ValueError(
                    '"mlp_per_node" is not allowed for variable graph size; '
                    'set output_heads.node.type to "mlp" or "conv"'
                )
            dims_list.append(int(np.asarray(first.node_targets[name]).shape[-1]))
        else:
            raise ValueError(f"Unknown output type {typ}")
    arch["output_dim"] = dims_list
    arch["output_type"] = list(voi["type"])
    arch["num_nodes"] = first.num_nodes
    arch["input_dim"] = len(voi["input_node_features"])
    arch["max_neighbours"] = max_in_degree(train)
    if arch["model_type"] == "PNA":
        arch["pna_deg"] = pna_degree_histogram(train, arch["max_neighbours"])
    else:
        arch["pna_deg"] = None
    for key in ("radius", "num_gaussians", "num_filters"):
        arch.setdefault(key, None)

    arch["edge_dim"] = None
    if arch.get("edge_features"):
        if arch["model_type"] not in ("PNA", "CGCNN", "SchNet"):
            raise ValueError("Edge features can only be used with PNA, CGCNN, SchNet.")
        arch["edge_dim"] = len(arch["edge_features"])
    elif arch["model_type"] == "CGCNN":
        arch["edge_dim"] = 0
    # Dataset.Descriptors grow the edge attributes (ingest appends them
    # after the length column): +2 spherical angles, +4 point-pair
    # features, so the model's edge_dim matches what the pipeline built
    desc = config["Dataset"].get("Descriptors", {}) if "Dataset" in config else {}
    extra = (2 if desc.get("SphericalCoordinates") else 0) + (4 if desc.get("PointPairFeatures") else 0)
    if extra:
        if not arch.get("edge_features"):
            raise ValueError(
                "Dataset.Descriptors require Architecture.edge_features "
                '(e.g. ["lengths"]) so the edge attributes are wired into '
                "an edge-aware model (PNA, CGCNN, SchNet)"
            )
        arch["edge_dim"] += extra

    arch.setdefault("freeze_conv_layers", False)
    arch.setdefault("initial_bias", None)
    # the conv layers' gather -> edge network -> scatter runs as one
    # kernel (ops/fused_conv.py); off is the composed path, not ported
    arch.setdefault("fused_conv", True)
    nn["Training"].setdefault("Optimizer", {"type": "AdamW", "learning_rate": 1e-3})
    nn["Training"].setdefault("loss_function_type", "mse")
    arch.setdefault("SyncBatchNorm", False)
    return normalize_output_config(config)


def normalize_output_config(config: Dict[str, Any]) -> Dict[str, Any]:
    """Wire up the denormalization minmax tables."""
    voi = config["NeuralNetwork"]["Variables_of_interest"]
    if voi.get("denormalize_output"):
        node_mm = np.asarray(voi["minmax_node_feature"])
        graph_mm = np.asarray(voi["minmax_graph_feature"])
        voi["x_minmax"] = [node_mm[:, i].tolist() for i in voi["input_node_features"]]
        voi["y_minmax"] = []
        for typ, idx in zip(voi["type"], voi["output_index"]):
            mm = graph_mm if typ == "graph" else node_mm
            voi["y_minmax"].append(mm[:, idx].tolist())
    else:
        voi["denormalize_output"] = False
    return config


def get_log_name_config(config: Dict[str, Any]) -> str:
    """Deterministic run-directory name from the hyperparameters (the JAX
    package's ``get_log_name_config``)."""
    nn = config["NeuralNetwork"]
    arch, training = nn["Architecture"], nn["Training"]
    name = config["Dataset"]["name"] if "Dataset" in config else "dataset"
    cut = name.rfind("_") if name.rfind("_") > 0 else None
    return (
        f"{arch['model_type']}-r-{arch.get('radius')}"
        f"-ncl-{arch['num_conv_layers']}-hd-{arch['hidden_dim']}"
        f"-ne-{training['num_epoch']}"
        f"-lr-{training['Optimizer']['learning_rate']}"
        f"-bs-{training['batch_size']}"
        f"-data-{name[:cut]}"
        "-node_ft-"
        + "".join(str(x) for x in nn["Variables_of_interest"]["input_node_features"])
        + "-task_weights-"
        + "".join(f"{w}-" for w in arch["task_weights"])
    )


def save_config(config: Dict[str, Any], log_name: str, path: str = "./logs/") -> None:
    """JSON dump of the completed config under ``<path>/<log_name>/``."""
    out_dir = os.path.join(path, log_name)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(_jsonable(config), f)


def _jsonable(obj):
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    return obj
