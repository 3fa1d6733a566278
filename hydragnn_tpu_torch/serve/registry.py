"""Model registry: named runs -> warm models held on a device.

The port's counterpart of ``hydragnn_tpu/serve/registry.py``. Three
admission paths:

  - :meth:`ModelRegistry.load` restores the run's checkpoint under
    ``<log_dir>/<log_name>/`` through the port's validating loader
    (``utils/checkpoint.py:load_existing_model``: sha256 sidecars, and a
    torn or corrupt latest file falls back to the newest intact version
    with a warning), as the JAX package's does;
  - :meth:`ModelRegistry.register` adopts an in-memory state dict (or
    serves the seeded init);
  - :meth:`ModelRegistry.load_state_dict_file` reads one saved with
    ``torch.save(model.state_dict(), path)``.

:func:`load_served_variables` restores a run's weights for a model
already served, the path ``ModelServer.reload`` takes. A checkpoint the
JAX package wrote is read by ``convert.load_jax_checkpoint``; register
its ``state_dict()``. The JAX package's fsdp-sharded serving waits for
ROADMAP A-5c.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
from typing import Any, Dict, List, Mapping, Optional

import torch

from hydragnn_tpu_torch.device import resolve_device
from hydragnn_tpu_torch.models.base import HydraModel
from hydragnn_tpu_torch.models.create import create_model, model_config_from_dict
from hydragnn_tpu_torch.utils.checkpoint import load_existing_model
from hydragnn_tpu_torch.utils import syncdebug


@dataclasses.dataclass
class ServedModel:
    """A model held warm for inference on ``device`` (in eval mode; the
    server runs its forward under ``torch.inference_mode()``). A server's
    reload points ``model`` at the weight slot it made live."""

    name: str
    model: HydraModel
    device: torch.device
    nn_config: Optional[Dict[str, Any]] = None

    @property
    def cfg(self):
        return self.model.cfg


class ModelRegistry:
    """Thread-safe name -> :class:`ServedModel` map; ``load`` reads runs
    under ``log_dir``."""

    def __init__(self, log_dir: str = "./logs/", device: Optional[str] = "cuda"):
        self.log_dir = log_dir
        self.device = resolve_device(device)
        self._lock = syncdebug.maybe_wrap(threading.Lock(), "registry.ModelRegistry._lock")
        self._models: Dict[str, ServedModel] = {}  # guarded by _lock

    def _add(self, served: ServedModel) -> ServedModel:
        with self._lock:
            self._models[served.name] = served
        return served

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
        return self._add(ServedModel(name=name, model=model, device=self.device, nn_config=nn_config))

    def load_state_dict_file(self, name: str, nn_config: Dict[str, Any], path: str) -> ServedModel:
        """Register the state dict saved at ``path`` with ``torch.save``."""
        return self.register(name, nn_config, torch.load(path, map_location="cpu", weights_only=True))

    def load(self, log_name: str, nn_config: Dict[str, Any], example_graph: Any = None, seed: int = 0) -> ServedModel:
        """Build the model from its completed config, then restore the
        checkpoint under ``<log_dir>/<log_name>/`` through the validating
        loader (module docstring). ``example_graph`` is accepted for the
        JAX package's signature; the port builds from the config alone.
        A second load of a name replaces the entry."""
        model = create_model(model_config_from_dict(nn_config), seed=seed, device=self.device)
        load_existing_model(model, log_name, self.log_dir)
        return self._add(ServedModel(name=log_name, model=model, device=self.device, nn_config=nn_config))

    def get(self, name: str) -> ServedModel:
        with self._lock:
            if name not in self._models:
                raise KeyError(f"model {name!r} not in registry (loaded: {sorted(self._models)})")
            return self._models[name]

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._models)


def structural_fingerprint(state_dict: Mapping[str, torch.Tensor]) -> str:
    """The served weights' structure as a hex sha256 over ``(name, shape,
    dtype)`` of every entry, in name order: stable under a change of
    values (a reload of the same architecture), changed by any shape,
    dtype or name. The request spool stamps it on every shard. It is
    not the JAX package's ``abstract_fingerprint`` string: the parameter
    names of the two packages differ."""
    h = hashlib.sha256()
    for name in sorted(state_dict):
        t = state_dict[name]
        h.update(f"{name}|{tuple(t.shape)}|{str(t.dtype).replace('torch.', '')};".encode())
    return h.hexdigest()


def load_served_variables(served: ServedModel, log_name: str, log_dir: str = "./logs/") -> Dict[str, torch.Tensor]:
    """The state dict of the run ``log_name`` under ``log_dir`` for the
    already-served model's architecture, restored on the host through
    the validating loader (sha256 sidecars, torn-pointer fallback)."""
    scratch = create_model(served.cfg, device="cpu")
    load_existing_model(scratch, log_name, log_dir)
    return scratch.state_dict()
