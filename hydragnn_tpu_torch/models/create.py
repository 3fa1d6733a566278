"""Model factory: completed config dict -> seeded ``HydraModel``.

The port's counterpart of ``hydragnn_tpu/models/create.py``: the same
``ModelConfig`` from the same (``update_config``-completed)
``NeuralNetwork`` section, and parameters initialized from a fixed seed
through a ``torch.Generator`` (the analog of the reference's
``torch.manual_seed(0)``). Like the JAX package, it reads no GAT keys
from the config: ``gat_heads`` 6, ``gat_negative_slope`` 0.05 and
``dropout`` 0.25 are ``ModelConfig``'s defaults.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from hydragnn_tpu_torch.device import resolve_device
from hydragnn_tpu_torch.models.base import HydraModel, ModelConfig
from hydragnn_tpu_torch.models.convs import avg_degree_stats


def model_config_from_dict(config: Dict[str, Any]) -> ModelConfig:
    """Static ModelConfig from the ``NeuralNetwork`` section."""
    arch = config["Architecture"]
    training = config.get("Training", {})
    heads_cfg = arch.get("output_heads", {})
    graph_cfg = heads_cfg.get("graph", {})
    node_cfg = heads_cfg.get("node", {})
    pna_lin, pna_log = 1.0, 1.0
    if arch.get("pna_deg") is not None:
        pna_lin, pna_log = avg_degree_stats(arch["pna_deg"])
    model_type = arch["model_type"]
    if arch.get("radius_graph_in_forward") and arch.get("periodic_boundary_conditions"):
        raise ValueError(
            "radius_graph_in_forward does not support periodic_boundary_conditions; "
            "use host-precomputed edges for PBC datasets"
        )
    input_dim = int(arch["input_dim"])
    # CGCNN preserves width: hidden = input
    hidden_dim = input_dim if model_type == "CGCNN" else int(arch["hidden_dim"])
    return ModelConfig(
        model_type=model_type,
        input_dim=input_dim,
        hidden_dim=hidden_dim,
        output_dim=tuple(int(d) for d in arch["output_dim"]),
        output_type=tuple(arch["output_type"]),
        output_names=tuple(config["Variables_of_interest"]["output_names"])
        if "Variables_of_interest" in config
        else tuple(f"head_{i}" for i in range(len(arch["output_dim"]))),
        task_weights=tuple(float(w) for w in arch["task_weights"]),
        num_conv_layers=int(arch["num_conv_layers"]),
        loss_function_type=training.get("loss_function_type", "mse"),
        graph_num_sharedlayers=int(graph_cfg.get("num_sharedlayers", 0)),
        graph_dim_sharedlayers=int(graph_cfg.get("dim_sharedlayers", 0)),
        graph_num_headlayers=int(graph_cfg.get("num_headlayers", 0)),
        graph_dim_headlayers=tuple(graph_cfg.get("dim_headlayers", ())),
        node_num_headlayers=int(node_cfg.get("num_headlayers", 0)),
        node_dim_headlayers=tuple(node_cfg.get("dim_headlayers", ())),
        node_head_type=node_cfg.get("type", "mlp"),
        num_nodes=arch.get("num_nodes"),
        edge_dim=arch.get("edge_dim"),
        max_neighbours=arch.get("max_neighbours"),
        pna_avg_deg_lin=pna_lin,
        pna_avg_deg_log=pna_log,
        num_gaussians=arch.get("num_gaussians"),
        num_filters=arch.get("num_filters"),
        radius=arch.get("radius"),
        inforward_radius=bool(arch.get("radius_graph_in_forward", False)),
        freeze_conv=bool(arch.get("freeze_conv_layers", False)),
        fused_conv=bool(arch.get("fused_conv", True)),
        conv_bf16=bool(arch.get("conv_bf16", False)),
        conv_residency=bool(arch.get("conv_residency", False)),
    )


def create_model(
    cfg: ModelConfig, seed: int = 0, device: Optional[str] = "cuda"
) -> HydraModel:
    """A ``HydraModel`` initialized from ``seed`` (on the CPU), then moved
    to ``device``, in eval mode; GAT's dropout draws from ``seed + 1``
    (the JAX package's dropout key)."""
    dev = resolve_device(device)
    if cfg.model_type == "PNA" and cfg.pna_avg_deg_lin <= 0:
        raise ValueError("PNA requires degree input.")
    gen = torch.Generator().manual_seed(int(seed))
    return HydraModel(cfg, generator=gen, dropout_seed=int(seed) + 1).to(dev).eval()


def create_model_config(
    config: Dict[str, Any], seed: int = 0, device: Optional[str] = "cuda", bn_axis_name=None
) -> HydraModel:
    """The model of the ``NeuralNetwork`` section. ``bn_axis_name`` is
    the group SyncBatchNorm reduces over (``Partitioner.bn_axis_name``),
    taken when ``Architecture.SyncBatchNorm`` is set, as the JAX
    package takes its axis name."""
    model = create_model(model_config_from_dict(config), seed=seed, device=device)
    if bn_axis_name is not None and config["Architecture"].get("SyncBatchNorm"):
        model.set_bn_group(bn_axis_name)
    return model
