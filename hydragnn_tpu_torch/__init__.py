"""hydragnn_tpu_torch: the PyTorch/CUDA port of ``hydragnn_tpu``.

The JAX package beside this one is the reference; every module here
mirrors the module of the same name there (``data/``, ``graph/``,
``ops/``, ``models/``, ``serve/``, ``utils/``, ``api.py``), and its
tests (``tests/test_torch_*.py``) hold each one to its counterpart on
the same inputs and weights.

This package imports ``torch`` and ``numpy`` only — never ``jax``,
``flax``, ``optax`` or ``hydragnn_tpu``. Its entry points run on the
CUDA card unless the caller passes ``device="cpu"``; without a card
they raise (``device.py``). On a CUDA tensor every kernel wrapper
launches its hand-written Hopper kernel (``ops/``); on a CPU tensor it
runs the kernel's plain PyTorch version.

    import hydragnn_tpu_torch as hg
    model, optimizer, history, config = hg.run_training(config, samples)
    error, tasks, true, pred = hg.run_prediction(config, samples)
    server = hg.serve_model(config, samples, params=model.state_dict())
    server.predict(graph)
"""

from hydragnn_tpu_torch.api import run_prediction, run_training, serve_model  # noqa: F401
from hydragnn_tpu_torch.device import resolve_device  # noqa: F401

__version__ = "0.1.0"
