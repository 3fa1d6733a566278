"""Model registry: named weights -> warm models held on a device.

The port's counterpart of ``hydragnn_tpu/serve/registry.py``. Two
admission paths: :meth:`ModelRegistry.register` adopts an in-memory
state dict, and :meth:`ModelRegistry.load` reads one saved with
``torch.save(model.state_dict(), path)`` — the port's own format. A
checkpoint the JAX package wrote is read into a model by
``convert.load_jax_checkpoint``; register its ``state_dict()``.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, List, Mapping, Optional

import torch

from hydragnn_tpu_torch.device import resolve_device
from hydragnn_tpu_torch.graph.batch import GraphBatch
from hydragnn_tpu_torch.models.base import HydraModel
from hydragnn_tpu_torch.models.create import create_model, model_config_from_dict


@dataclasses.dataclass
class ServedModel:
    """A model held warm for inference on ``device``."""

    name: str
    model: HydraModel
    device: torch.device
    nn_config: Optional[Dict[str, Any]] = None

    @property
    def cfg(self):
        return self.model.cfg

    def forward(self, batch: GraphBatch) -> List[torch.Tensor]:
        """Eval forward (running BatchNorm statistics) of a batch that is
        already on ``device``."""
        with torch.inference_mode():
            return self.model(batch, train=False)


class ModelRegistry:
    """Thread-safe name -> :class:`ServedModel` map."""

    def __init__(self, device: Optional[str] = "cuda"):
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._models: Dict[str, ServedModel] = {}  # guarded by _lock

    def register(
        self,
        name: str,
        nn_config: Dict[str, Any],
        state_dict: Optional[Mapping[str, torch.Tensor]] = None,
        seed: int = 0,
    ) -> ServedModel:
        """Build the model from its completed ``NeuralNetwork`` config
        with the seeded init, then load ``state_dict`` (strict) when
        given."""
        model = create_model(model_config_from_dict(nn_config), seed=seed, device=self.device)
        if state_dict is not None:
            model.load_state_dict(state_dict, strict=True)
        served = ServedModel(name=name, model=model, device=self.device, nn_config=nn_config)
        with self._lock:
            self._models[name] = served
        return served

    def load(self, name: str, nn_config: Dict[str, Any], path: str) -> ServedModel:
        """Register the state dict saved at ``path`` with ``torch.save``."""
        state_dict = torch.load(path, map_location="cpu", weights_only=True)
        return self.register(name, nn_config, state_dict)

    def get(self, name: str) -> ServedModel:
        with self._lock:
            if name not in self._models:
                raise KeyError(f"model {name!r} not in registry (loaded: {sorted(self._models)})")
            return self._models[name]
