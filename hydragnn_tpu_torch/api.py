"""Top-level entry points.

The port's counterpart of ``hydragnn_tpu/api.py``. This slice ports
``serve_model``; ``run_training`` and ``run_prediction`` come with the
training slice (ROADMAP A5, A6).
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

import torch

from hydragnn_tpu_torch.data.ingest import prepare_dataset
from hydragnn_tpu_torch.device import resolve_device
from hydragnn_tpu_torch.utils.config import load_config, update_config


def prepare_config_and_samples(
    config: Dict[str, Any], samples: List
) -> Tuple[List, List, List, Dict[str, Any]]:
    """Data preparation + split + config inference: (train, val, test,
    completed config). ``samples`` are raw in-memory samples and are
    prepared in place. Reading raw datasets from ``Dataset.path`` comes
    with the data-breadth slice (ROADMAP A8)."""
    train, val, test, mm_g, mm_n = prepare_dataset(samples, config)
    voi = config["NeuralNetwork"]["Variables_of_interest"]
    voi["minmax_graph_feature"] = mm_g.tolist()
    voi["minmax_node_feature"] = mm_n.tolist()
    config = update_config(config, train, val, test)
    return train, val, test, config


def serve_model(
    config_file_or_dict,
    samples: Optional[List] = None,
    params: Union[None, str, Mapping[str, torch.Tensor]] = None,
    serve_config=None,
    device: Optional[str] = "cuda",
    start: bool = True,
    seed: int = 0,
):
    """Stand up a batched online-inference server on ``device``.

    The dataset pipeline runs as in the JAX package (normalization,
    radius edges, config inference); its prepared samples size the
    bucket ladder and fix the request field spec, and requests must be
    prepared the same way (``server.reference_samples`` holds them).
    ``params`` is a state dict, or the path of one saved with
    ``torch.save``; None serves the seeded init (``seed``). Predictions
    are in model space (normalized targets).

    Raises without a CUDA card unless ``device="cpu"``. Returns the
    server (started unless ``start=False``); callers own its lifecycle
    (``server.stop()``, or use it as a context manager)."""
    dev = resolve_device(device)
    config = load_config(config_file_or_dict)
    if samples is None:
        raise NotImplementedError(
            "hydragnn_tpu_torch: reading Dataset.path is not ported yet "
            "(ROADMAP A8); pass samples="
        )
    train, val, test, config = prepare_config_and_samples(config, samples)

    from hydragnn_tpu_torch.serve import ModelRegistry, ModelServer, ServeConfig

    registry = ModelRegistry(dev)
    name = config["Dataset"].get("name", "model") if "Dataset" in config else "model"
    nn_config = config["NeuralNetwork"]
    if isinstance(params, str):
        served = registry.load(name, nn_config, params)
    else:
        served = registry.register(name, nn_config, params, seed=seed)
    server = ModelServer(served, list(train) + list(val) + list(test), serve_config or ServeConfig())
    if start:
        server.start()
    return server
