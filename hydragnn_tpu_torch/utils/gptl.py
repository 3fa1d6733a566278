"""No-op GPTL timing shim and device trace ranges (the port's copy of
``hydragnn_tpu/utils/gptl.py``).

Every gptl4py symbol is a no-op, so code instrumented for the HPC
timing library runs unchanged without it. ``nvtx_range`` pushes and
pops an NVTX range (``torch.cuda.nvtx``) when a card is present, so the
range shows in a device timeline; without one it does nothing.

    import hydragnn_tpu_torch.utils.gptl as gp
    gp.initialize()
    with gp.nvtx_range("epoch"):
        gp.start("train"); ...; gp.stop("train")
    gp.pr_file("timings.txt"); gp.finalize()
"""

from __future__ import annotations

import contextlib

import torch


def initialize() -> int:
    return 0


def finalize() -> int:
    return 0


def start(name: str) -> int:
    return 0


def stop(name: str) -> int:
    return 0


def setoption(*args) -> int:
    return 0


def reset() -> int:
    return 0


def pr(rank: int = 0) -> int:
    return 0


def pr_file(fname: str) -> int:
    return 0


def pr_summary(comm=None) -> int:
    return 0


def pr_summary_file(fname: str, comm=None) -> int:
    return 0


@contextlib.contextmanager
def nvtx_range(name: str):
    """An NVTX range around the block on a machine with a card."""
    if not torch.cuda.is_available():
        yield
        return
    torch.cuda.nvtx.range_push(name)
    try:
        yield
    finally:
        torch.cuda.nvtx.range_pop()


def profile(name=None):
    """Decorator form: the function's calls inside ``nvtx_range``."""

    def wrap(fn):
        label = name or fn.__name__

        def inner(*args, **kwargs):
            with nvtx_range(label):
                return fn(*args, **kwargs)

        return inner

    return wrap
