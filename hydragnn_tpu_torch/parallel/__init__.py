"""Process helpers over ``torch.distributed`` (the port's copy of the
process part of ``hydragnn_tpu/parallel/mesh.py``): ``nsplit``,
``barrier``, ``setup_distributed`` and ``get_comm_size_and_rank``.

``setup_distributed`` sniffs the launcher's environment as the JAX
package does (``SLURM_NPROCS``, ``OMPI_COMM_WORLD_SIZE``, and torchrun's
``WORLD_SIZE``) and, in a multi-process environment, initialises the
default group: ``nccl`` with a card a local rank when the run is on the
card, ``gloo`` on the CPU. The rendezvous address comes from
``MASTER_ADDR``/``MASTER_PORT`` (``env://``), as torchrun sets them. A
single process gets ``(1, 0)`` and no group.

Data, fully-sharded and edge-sharded parallelism (the rest of the JAX
package's ``parallel/``) are still to be ported (ROADMAP A-5): until
then the examples' training (``examples.train_splits``) and the
container's ``save`` raise ``NotImplementedError`` in a group of more
than one process, rather than train unsynchronised replicas.
"""

from __future__ import annotations

import os
from typing import Iterator, Sequence, Tuple

import torch


def nsplit(seq: Sequence, n: int) -> Iterator:
    """Split ``seq`` into ``n`` near-even contiguous chunks (the first
    ``len(seq) % n`` one longer)."""
    k, m = divmod(len(seq), n)
    return (seq[i * k + min(i, m): (i + 1) * k + min(i + 1, m)] for i in range(n))


def _group():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def get_comm_size_and_rank() -> Tuple[int, int]:
    """(world size, rank) of the initialised group; (1, 0) without one."""
    dist = _group()
    if dist is None:
        return 1, 0
    return dist.get_world_size(), dist.get_rank()


def barrier(tag: str = "barrier") -> None:
    """Every process waits here; a no-op for a single process. ``tag``
    names the point in the caller's code (the JAX package's
    ``sync_global_devices`` takes it)."""
    dist = _group()
    if dist is not None and dist.get_world_size() > 1:
        dist.barrier()


def _env_world_size() -> int:
    """The process count the launcher's environment announces (1 when it
    announces none)."""
    for var in ("WORLD_SIZE", "SLURM_NPROCS", "OMPI_COMM_WORLD_SIZE"):
        value = os.environ.get(var, "")
        if value not in ("", "1"):
            return int(value)
    return 1


def _env_rank(names: Sequence[str]) -> int:
    for var in names:
        if os.environ.get(var, "") != "":
            return int(os.environ[var])
    raise RuntimeError(f"multi-process environment without a rank ({', '.join(names)})")


def setup_distributed(device="cuda") -> Tuple[int, int]:
    """Initialise the default group when the environment announces more
    than one process; returns (world size, rank). On the card each
    process takes the card of its local rank and the group is ``nccl``;
    on the CPU it is ``gloo``."""
    if _group() is not None:
        return get_comm_size_and_rank()
    world = _env_world_size()
    if world == 1:
        return 1, 0
    import torch.distributed as dist

    rank = _env_rank(("RANK", "SLURM_PROCID", "OMPI_COMM_WORLD_RANK"))
    cuda = torch.device(device).type == "cuda"
    if cuda:
        local = _env_rank(("LOCAL_RANK", "SLURM_LOCALID", "OMPI_COMM_WORLD_LOCAL_RANK"))
        torch.cuda.set_device(local)
    dist.init_process_group(backend="nccl" if cuda else "gloo", init_method="env://", world_size=world, rank=rank)
    return get_comm_size_and_rank()
