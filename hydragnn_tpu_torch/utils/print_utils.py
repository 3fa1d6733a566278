"""Verbosity-levelled, process-aware printing and logging (the port's
copy of ``hydragnn_tpu/utils/print_utils.py``): five verbosity levels
(0 silent, 1-2 process 0 only, 3-4 every process), a per-run file and
console logger, the peak device memory and a parameter table.

The process index is the rank of the ``torch.distributed`` group when
one is initialised, else 0.
"""

from __future__ import annotations

import logging
import os
import sys
from typing import Iterable, Optional

import torch

VERBOSITY_LEVELS = (0, 1, 2, 3, 4)
# the logger of the last setup_log; log() writes through it
_logger: Optional[logging.Logger] = None


def process_index() -> int:
    """This process's rank in the initialised ``torch.distributed`` group,
    else 0."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def print_distributed(verbosity_level: int, *args) -> None:
    if verbosity_level not in VERBOSITY_LEVELS:
        raise ValueError(f"Unknown verbosity level: {verbosity_level}")
    rank = process_index()
    if verbosity_level >= 3 or (verbosity_level > 0 and rank == 0):
        print(f"[{rank}]", *args)


def iterate_tqdm(iterable: Iterable, verbosity_level: int, **kwargs):
    """``tqdm(iterable)`` at verbosity >= 2 on process 0 when tqdm is
    installed; the plain iterable otherwise."""
    if verbosity_level >= 2 and process_index() == 0:
        try:
            from tqdm import tqdm
        except ImportError:
            return iterable
        return tqdm(iterable, **kwargs)
    return iterable


def setup_log(prefix: str, log_dir: str = "./logs") -> logging.Logger:
    """File and console logger writing ``log_dir/<prefix>/run.log``
    (``run<rank>.log`` on the other processes; only process 0 also
    writes to stdout)."""
    global _logger
    path = os.path.join(log_dir, prefix)
    os.makedirs(path, exist_ok=True)
    rank = process_index()
    logger = logging.getLogger(f"hydragnn_tpu_torch.{prefix}")
    logger.setLevel(logging.INFO)
    for handler in logger.handlers:
        handler.close()
    logger.handlers.clear()
    fh = logging.FileHandler(os.path.join(path, f"run{'' if rank == 0 else rank}.log"))
    fh.setFormatter(logging.Formatter("%(asctime)s %(message)s"))
    logger.addHandler(fh)
    if rank == 0:
        logger.addHandler(logging.StreamHandler(sys.stdout))
    _logger = logger
    return logger


def log(*args) -> None:
    msg = " ".join(str(a) for a in args)
    if _logger is not None:
        _logger.info(msg)
    elif process_index() == 0:
        print(msg)


def print_peak_memory(verbosity_level: int = 2, prefix: str = "",
                      device: Optional[torch.device] = None) -> Optional[int]:
    """The card's peak allocated bytes (``torch.cuda.max_memory_allocated``
    of ``device``, default the current card), printed at
    ``verbosity_level``; None on the CPU, as the JAX package's returns
    None where the device keeps no memory statistics."""
    if device is not None and torch.device(device).type != "cuda":
        return None
    if not torch.cuda.is_available():
        return None
    peak = int(torch.cuda.max_memory_allocated(device))
    print_distributed(verbosity_level, f"{prefix} peak device memory: {peak / 1e6:.1f} MB")
    return peak


def print_model(model: torch.nn.Module, verbosity_level: int = 2) -> int:
    """A line per parameter (name, shape, size) and the total; returns
    the total parameter count."""
    total = 0
    for name, p in model.named_parameters():
        total += p.numel()
        print_distributed(verbosity_level, f"{name}: {tuple(p.shape)} {p.numel()}")
    print_distributed(verbosity_level, f"Total number of parameters: {total}")
    return total
