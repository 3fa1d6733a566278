"""Giant-graph training (the port's copy of
``examples/giant_graph/train_giant.py``): ONE periodic cubic lattice
(``--nx 50 --ny 50 --nz 48``: 120,000 nodes, 720,000 directed edges),
trained with its edge list split over the ranks of the ``edge`` axis
(``parallel/edge_sharded.py``): each rank keeps a contiguous,
receiver-sorted slice of the edges and every node array whole, GIN's
fused conv (B8) aggregates the slice, and the partial aggregates are
summed over the ranks.

    torchrun --nproc_per_node 2 -m hydragnn_tpu_torch.examples.giant_graph.train_giant
    python -m hydragnn_tpu_torch.examples.giant_graph.train_giant --device cpu   # one process

Every rank's edge tensors hold exactly ``rows / D`` rows of the padded
edge list: the driver checks it and prints the bytes (O(E/D)). The node
target is closed-form (tanh of the neighbour-count-normalized feature
sum), so the loss must fall within the steps.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from hydragnn_tpu_torch.examples import add_device_argument


def build_lattice_graph(nx: int, ny: int, nz: int, seed: int = 0):
    """Periodic cubic lattice: N = nx*ny*nz nodes, 6 directed edges per
    node (+x,-x,+y,-y,+z,-z neighbours) by index arithmetic; the node
    features and the closed-form target, as the JAX driver makes them."""
    n = nx * ny * nz
    ids = np.arange(n, dtype=np.int32)
    ix, iy, iz = ids % nx, (ids // nx) % ny, ids // (nx * ny)

    def nid(x, y, z):
        return (x % nx) + (y % ny) * nx + (z % nz) * nx * ny

    neighbors = [nid(ix + 1, iy, iz), nid(ix - 1, iy, iz), nid(ix, iy + 1, iz), nid(ix, iy - 1, iz),
                 nid(ix, iy, iz + 1), nid(ix, iy, iz - 1)]
    senders = np.concatenate([nb.astype(np.int32) for nb in neighbors])
    receivers = np.concatenate([ids] * 6).astype(np.int32)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    neigh_sum = np.zeros((n, 4), np.float32)
    np.add.at(neigh_sum, receivers, x[senders])
    y = np.tanh(neigh_sum.mean(axis=1, keepdims=True) / 6.0).astype(np.float32)
    return x, senders, receivers, y


def giant_config(hidden: int):
    from hydragnn_tpu_torch.models.base import ModelConfig

    return ModelConfig(
        model_type="GIN", input_dim=4, hidden_dim=hidden, output_dim=(1,), output_type=("node",),
        output_names=("y",), task_weights=(1.0,), num_conv_layers=2, node_num_headlayers=2,
        node_dim_headlayers=(hidden, hidden), node_head_type="mlp",
    )


def build_giant_batch(nx: int, ny: int, nz: int, n_devices: int):
    """The lattice as one padded batch (the edge pad a multiple of the
    edge ranks)."""
    from hydragnn_tpu_torch.graph.batch import batch_graphs

    x, senders, receivers, y = build_lattice_graph(nx, ny, nz)
    n, e = x.shape[0], senders.shape[0]
    g = {"x": x, "senders": senders, "receivers": receivers, "node_targets": {"y": y}}
    return batch_graphs([g], n_node_pad=n + 8, n_edge_pad=((e + n_devices - 1) // n_devices) * n_devices,
                        n_graph_pad=2)


def check_edge_residency(placed, global_rows: int, n_devices: int) -> Dict[str, Dict[str, int]]:
    """Assert O(E/D) edge residency on this rank; return the accounting."""
    acct = {}
    for name in ("senders", "receivers", "edge_mask"):
        t = getattr(placed, name)
        if t.shape[0] * n_devices != global_rows:
            raise AssertionError((name, t.shape[0], global_rows, n_devices))
        acct[name] = {"global_rows": int(global_rows), "rows_per_device": int(t.shape[0]),
                      "bytes_per_device": int(t.numel() * t.element_size())}
    if placed.nodes.shape[0] != placed.in_degree.shape[0]:
        raise AssertionError("node arrays must stay whole")
    return acct


def train_giant(nx: int = 50, ny: int = 50, nz: int = 48, hidden: int = 32, steps: int = 8, lr: float = 0.02,
                device: str = "cuda", seed: int = 0, verbose: bool = True) -> Dict[str, object]:
    """The lattice's training in an initialised group (or one process): returns
    the per-step losses, each step's host-clock ms (a step ends in the
    loss's host read), the residency accounting and the rank."""
    from hydragnn_tpu_torch.device import resolve_device
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.parallel import Partitioner, get_comm_size_and_rank, place_giant_batch
    from hydragnn_tpu_torch.train.optimizer import Optimizer

    dev = resolve_device(device)
    world, rank = get_comm_size_and_rank()
    part = Partitioner(edge=world)
    batch = build_giant_batch(nx, ny, nz, world)
    global_rows = batch.senders.shape[0]
    model = create_model(giant_config(hidden), seed=seed, device=dev)
    optimizer = Optimizer(list(model.parameters()), "AdamW", lr)
    optimizer = part.shard_init(model, optimizer)
    placed = batch if part.single_device else place_giant_batch(part.edge_group, batch)
    acct = check_edge_residency(placed, global_rows, world)
    placed = placed.to(dev)
    if verbose and rank == 0:
        print(f"giant graph: {placed.nodes.shape[0]} nodes, {global_rows} edges, {world} edge ranks", flush=True)
        for k, v in acct.items():
            print(f"  {k}: {v['global_rows']} rows -> {v['rows_per_device']}/device "
                  f"({v['bytes_per_device']} bytes/device)  [O(E/D)]", flush=True)
    step = part.shard_train_step(model, optimizer)
    losses, step_ms = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        loss = step(placed)[0]
        losses.append(float(loss))  # a host read: the step is done
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if verbose and rank == 0:
            print(f"step {i}: loss {losses[-1]:.6f}", flush=True)
    if not np.isfinite(losses).all():
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not decrease: {losses}")
    return {"losses": losses, "step_ms": step_ms, "residency": acct, "rank": rank, "world": world, "model": model}


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--nx", type=int, default=50)
    parser.add_argument("--ny", type=int, default=50)
    parser.add_argument("--nz", type=int, default=48)
    parser.add_argument("--hidden", type=int, default=32)
    parser.add_argument("--steps", type=int, default=8)
    parser.add_argument("--lr", type=float, default=0.02)
    parser.add_argument("--backend", type=str, default=None, help="nccl or gloo (default: nccl on the card)")
    add_device_argument(parser)
    args = parser.parse_args(argv)

    from hydragnn_tpu_torch.parallel import setup_distributed

    setup_distributed(args.device, backend=args.backend)
    out = train_giant(args.nx, args.ny, args.nz, args.hidden, args.steps, args.lr, device=args.device)
    if out["rank"] == 0:
        print("giant-graph sharded training OK", flush=True)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
