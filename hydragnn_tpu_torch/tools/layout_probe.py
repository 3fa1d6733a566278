"""Whether torch's own sharded layouts run where the port's ``[parallel]``
runs: two gloo ranks sharing one card. One step each of a small module
under ``fully_shard`` (FSDP2, each parameter sharded on its largest
dimension the width divides, the placement rule of
``parallel/partitioner.py:_fsdp_dim``) and under
``ZeroRedundancyOptimizer`` over fused AdamW (the port's card rule).

``python -m hydragnn_tpu_torch.tools.layout_probe [--device cpu]``
prints one line per rank and layout, ``ok`` or the error raised, and
exits 0 whatever the layouts did (it records, it does not gate).
"""

from __future__ import annotations

import argparse
import datetime
import os
import socket
import sys

import torch

WORLD = 2


def _module(device):
    torch.manual_seed(0)
    return torch.nn.Sequential(torch.nn.Linear(64, 128), torch.nn.ReLU(), torch.nn.Linear(128, 8)).to(device)


def _step(model, optimizer, device, reduce_grads):
    x = torch.randn(32, 64, device=device)
    loss = model(x).square().mean()
    loss.backward()
    if reduce_grads:
        import torch.distributed as dist

        for p in model.parameters():
            dist.all_reduce(p.grad)
            p.grad /= WORLD
    optimizer.step()
    optimizer.zero_grad()
    return float(loss.detach())


def _fsdp2(device):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    def placement(p):
        dims = [i for i, d in enumerate(p.shape) if d % WORLD == 0]
        return Shard(max(dims, key=lambda i: p.shape[i])) if dims else None

    mesh = init_device_mesh(device.type, (WORLD,), mesh_dim_names=("fsdp",))
    model = fully_shard(_module(device), mesh=mesh, shard_placement_fn=placement)
    fused = {"fused": True} if device.type == "cuda" else {}
    return _step(model, torch.optim.AdamW(model.parameters(), lr=1e-3, **fused), device, False)


def _zero1(device):
    from torch.distributed.optim import ZeroRedundancyOptimizer

    model = _module(device)
    fused = {"fused": True} if device.type == "cuda" else {}
    opt = ZeroRedundancyOptimizer(model.parameters(), optimizer_class=torch.optim.AdamW, lr=1e-3, **fused)
    return _step(model, opt, device, True)


def _rank(rank, port, device_type):
    import torch.distributed as dist

    device = torch.device(device_type, 0) if device_type == "cuda" else torch.device("cpu")
    if device_type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=WORLD, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    try:
        for name, fn in (("fully_shard", _fsdp2), ("ZeroRedundancyOptimizer", _zero1)):
            try:
                print(f"[layout-probe] rank={rank} layout={name} backend=gloo device={device} ok "
                      f"loss={fn(device):.6f}", flush=True)
            except Exception as exc:  # the finding: which layout fails, and how
                msg = " ".join(f"{type(exc).__name__}: {exc}".split())[:400]
                print(f"[layout-probe] rank={rank} layout={name} backend=gloo device={device} failed {msg}",
                      flush=True)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("layout_probe: no card", file=sys.stderr)
        return 1
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    torch.multiprocessing.spawn(_rank, args=(port, args.device), nprocs=WORLD, join=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
