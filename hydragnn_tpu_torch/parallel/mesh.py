"""Process groups over ``torch.distributed`` (the port's counterpart of
``hydragnn_tpu/parallel/mesh.py``).

The JAX package drives every device of a host from one process and
names them in a ``jax.sharding.Mesh``. The port runs one process per
card: the "devices" of a mesh are the ranks of the default group, and a
mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over them. The
helpers keep the JAX names, each in its per-rank form:

  - ``setup_distributed`` sniffs the launcher's environment as the JAX
    package does (``SLURM_NPROCS``, ``OMPI_COMM_WORLD_SIZE``, and
    torchrun's ``WORLD_SIZE``) and initialises the default group from
    ``MASTER_ADDR``/``MASTER_PORT`` (``env://``): ``nccl`` with a card a
    local rank on the card, ``gloo`` on the CPU, or the ``backend`` the
    caller names (``gloo`` when two ranks share one card, which NCCL
    refuses). A single process gets ``(1, 0)`` and no group.
  - ``make_mesh`` / ``make_multihost_mesh``: a DeviceMesh over the ranks
    (one device a process, so the two are one function here).
  - ``globalize_batch`` is the identity (a rank's batch is its own
    sub-batch already) and ``local_view`` the host copy of a rank's rows.
  - ``local_device_count`` is the cards this process could see (1 on
    the CPU); the world's width is the group's size.
"""

from __future__ import annotations

import os
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

DATA_AXIS = "data"


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


def setup_distributed(device="cuda", backend: Optional[str] = None) -> Tuple[int, int]:
    """Initialise the default group when the environment announces more
    than one process; returns (world size, rank). On the card each
    process takes the card of its local rank (modulo the cards there
    are) and the group is ``nccl``; on the CPU it is ``gloo``. An
    explicit ``backend`` wins."""
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
        torch.cuda.set_device(local % max(torch.cuda.device_count(), 1))
    if backend is None:
        backend = "nccl" if cuda else "gloo"
    dist.init_process_group(backend=backend, init_method="env://", world_size=world, rank=rank)
    return get_comm_size_and_rank()


def mesh_device_type() -> str:
    """The DeviceMesh device type for the default group's backend: the
    card's under NCCL, the CPU's under gloo (which also carries CUDA
    tensors; the mesh only names its groups here)."""
    import torch.distributed as dist

    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(n_devices: Optional[int] = None, axis_names: Sequence[str] = (DATA_AXIS,)):
    """A DeviceMesh over the first ``n_devices`` ranks (all of them by
    default) along the first axis, the other axes of size 1."""
    from torch.distributed.device_mesh import init_device_mesh

    world, _ = get_comm_size_and_rank()
    if _group() is None:
        raise RuntimeError("make_mesh needs an initialised torch.distributed group (setup_distributed)")
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(f"requested {n} devices, have {world}")
    shape = (n,) + (1,) * (len(axis_names) - 1)
    return init_device_mesh(mesh_device_type(), shape, mesh_dim_names=tuple(axis_names))


def make_multihost_mesh(per_process: int = 0, axis_names: Sequence[str] = (DATA_AXIS,)):
    """The mesh over every process's devices: one device a process in the
    port, so ``per_process`` must be 0 or 1."""
    if per_process not in (0, 1):
        raise ValueError(f"process {get_comm_size_and_rank()[1]} has 1 devices, need {per_process}")
    return make_mesh(None, axis_names)


def globalize_batch(mesh, batch, axes=DATA_AXIS):
    """A rank's loader batch is already its sub-batch of the logical
    batch: returned as it is."""
    return batch


def local_view(arr) -> np.ndarray:
    """This rank's rows on the host."""
    if isinstance(arr, torch.Tensor):
        return arr.detach().float().cpu().numpy() if arr.dtype == torch.bfloat16 else arr.detach().cpu().numpy()
    return np.asarray(arr)


def local_device_count() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 1
