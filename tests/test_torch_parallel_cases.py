"""Groups of gloo processes for the port's parallel tests, with no JAX.

``spawn_group(world, cases, tmp)`` starts ``world`` CPU processes on one
intra-op thread each (ROADMAP C1), makes their default group (gloo) and
runs every case in all of them, in order; a case is ``(name, function
name, kwargs)`` and its result, per rank, comes back as a dict of numpy
arrays and plain values. The functions below are the cases; the tests of
``test_torch_{parallel,partitioner,edge_sharded}.py`` hold their results
against the JAX package's forced-device runs. The file's own tests need
no group.
"""

from __future__ import annotations

import datetime
import os
import pickle
import socket
import traceback

import numpy as np
import pytest
import torch

from hydragnn_tpu_torch.data.loader import GraphLoader
from hydragnn_tpu_torch.graph.batch import batch_graphs, mask_out, pad_batch

GROUP_TIMEOUT_S = 240


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _worker(rank, world, port, spec_path, out_dir):
    torch.set_num_threads(1)
    import sys

    sys.modules["torch.utils.tensorboard"] = None  # no TensorFlow import in a child
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port), HGTORCH_DIAGNOSTICS="0")
    import torch.distributed as dist

    with open(spec_path, "rb") as f:
        cases = pickle.load(f)
    try:
        dist.init_process_group("gloo", init_method="env://", world_size=world, rank=rank,
                                timeout=datetime.timedelta(seconds=120))
        for name, fn, kwargs in cases:
            res = CASES[fn](**kwargs)
            with open(os.path.join(out_dir, f"{name}.rank{rank}.pkl"), "wb") as f:
                pickle.dump(res, f)
    except BaseException:
        with open(os.path.join(out_dir, f"error.rank{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_group(world, cases, tmp_dir):
    """Run ``cases`` in a group of ``world`` processes; returns
    ``{name: [rank 0's result, rank 1's, ...]}``."""
    import multiprocessing

    os.makedirs(tmp_dir, exist_ok=True)
    spec = os.path.join(tmp_dir, "cases.pkl")
    with open(spec, "wb") as f:
        pickle.dump(cases, f)
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_worker, args=(r, world, port, spec, tmp_dir)) for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=GROUP_TIMEOUT_S)
    for p in procs:
        if p.is_alive():
            p.kill()
    errors = [open(os.path.join(tmp_dir, f)).read() for f in sorted(os.listdir(tmp_dir)) if f.startswith("error.")]
    if errors or any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"group failed (exit codes {[p.exitcode for p in procs]}):\n" + "\n".join(errors))
    out = {}
    for name, _, _ in cases:
        out[name] = []
        for r in range(world):
            with open(os.path.join(tmp_dir, f"{name}.rank{r}.pkl"), "rb") as f:
                out[name].append(pickle.load(f))
    return out


def shared_group(world, cases, tmp_path_factory, key):
    """``spawn_group`` once per test session: under pytest-xdist every
    worker that runs a test of the module asks for the module's group,
    and the first one runs it while the others wait on a lock in the
    session's shared temporary directory, then read its results."""
    import fcntl

    base = tmp_path_factory.getbasetemp()
    root = base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base
    done = os.path.join(root, f"{key}.pkl")
    with open(os.path.join(root, f"{key}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(done):
            try:
                result = spawn_group(world, cases, os.path.join(root, f"{key}_group"))
            except AssertionError as exc:
                result = exc
            with open(done, "wb") as f:
                pickle.dump(result, f)
        with open(done, "rb") as f:
            result = pickle.load(f)
    if isinstance(result, Exception):
        raise result
    return result


# ---------------------------------------------------------------------------
# the cases (run in every rank of a group)
# ---------------------------------------------------------------------------


def _model(nn_config, state_dict, bn_group=None):
    from hydragnn_tpu_torch.models.create import create_model_config

    model = create_model_config(nn_config, device="cpu", bn_axis_name=bn_group)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    return model


def _params(model):
    # through state_dict: FSDP gathers its freed whole parameters for it
    names = {n for n, _ in model.named_parameters()}
    return {n: t.detach().numpy().copy() for n, t in model.state_dict().items() if n in names}


def _buffers(model):
    return {n: b.detach().numpy().copy() for n, b in model.named_buffers()}


def dp_steps(nn_config, samples, state_dict, layout, batch_size, steps, remat=False, guard=False, sub_batches=None,
             eval_outputs=False, stats=False, drop_last=True, bf16=False, diag=False):
    """``steps`` train steps of the layout ``{data, fsdp, edge, zero1}``
    on the loader's first batches (``sub_batches`` per step, default the
    layout's data × fsdp; ``bf16``: the mixed-precision step; ``diag``:
    then the per-head diagnostics on the first batch); the losses, the final parameters, the
    statistics, the manifest, and the parameter and optimizer-state bytes
    this rank holds after the last step."""
    from hydragnn_tpu_torch.parallel import Partitioner
    from hydragnn_tpu_torch.parallel.sharded import held_bytes
    from hydragnn_tpu_torch.train.optimizer import select_optimizer

    part = Partitioner(data=layout.get("data", 1), fsdp=layout.get("fsdp", 1), edge=layout.get("edge", 1),
                       zero1=layout.get("zero1", False))
    lead = part.config.data * part.config.fsdp
    model = _model(nn_config, state_dict, part.bn_axis_name)
    optimizer = select_optimizer(model, nn_config["Training"])
    loader = GraphLoader(samples, batch_size, device_stack=sub_batches or lead, drop_last=drop_last,
                         edge_multiple=layout.get("edge_multiple", 8))
    part.attach_loader(loader)
    import warnings

    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        optimizer = part.shard_init(model, optimizer)
    dtype = torch.bfloat16 if bf16 else None
    step = part.shard_train_step(model, optimizer, compute_dtype=dtype, remat=remat, guard_nonfinite=guard)
    batches = list(loader)[:steps]
    losses, tasks = [], []
    consec = torch.zeros((), dtype=torch.int32)
    for i, b in enumerate(batches):
        out = step(b, consec) if guard else step(b)
        losses.append(float(out[0]))
        tasks.append(out[1].numpy().copy())
        if i == 0:
            optimizer.state_dict()  # a checkpoint's gather leaves the run's slices as they were
    param_bytes, opt_bytes = held_bytes(model, optimizer)  # before anything gathers the parameters
    res = {"losses": losses, "tasks": tasks, "params": _params(model), "buffers": _buffers(model),
           "manifest": part.manifest(model, optimizer), "edge_rows": int(batches[0].senders.shape[0]),
           "param_bytes": param_bytes, "opt_bytes": opt_bytes, "steps": int(optimizer.steps),
           "warnings": [str(w.message) for w in seen if issubclass(w.category, RuntimeWarning)]}
    if diag:
        from hydragnn_tpu_torch.obs.introspect import make_diagnostics_step

        res["diag"] = {k: v.double().numpy() for k, v in make_diagnostics_step(model, optimizer, dtype, group=part.world_group)(batches[0]).items()}
    full = optimizer.state_dict()
    res["opt_state"] = {f"{i}.{k}": t.numpy().copy() for i, st in full["rule"]["state"].items()
                        for k, t in st.items() if isinstance(t, torch.Tensor)}
    if eval_outputs:
        ev = part.shard_eval_step(model)
        loss, t_, outputs, count = ev(batches[0])
        res["eval"] = {"loss": float(loss), "tasks": t_.numpy().copy(), "count": float(count),
                       "rows": [int(o.shape[0]) for o in outputs]}
    if stats:
        part.shard_stats_step(model)(batches[0])
        res["stats_buffers"] = _buffers(model)
    return res


def loader_batches(samples, batch_size, device_stack, stack_rank, n):
    """The first ``n`` batches of rank ``stack_rank``'s loader, as arrays."""
    loader = GraphLoader(samples, batch_size, shuffle=True, device_stack=device_stack, stack_rank=stack_rank)
    loader.set_epoch(1)
    out = []
    for b in list(loader)[:n]:
        out.append(batch_arrays(b))
    return out


def batch_arrays(b):
    import dataclasses

    res = {}
    for f in dataclasses.fields(b):
        v = getattr(b, f.name)
        if isinstance(v, dict):
            for k, t in v.items():
                res[f"{f.name}.{k}"] = t.numpy().copy()
        elif isinstance(v, torch.Tensor):
            res[f.name] = v.numpy().copy()
    return res


def train_resume(config, samples, log_dir, epochs, split):
    """``train_with_loaders`` in the group, the layout from ``config``
    (``Parallel``, ``use_zero_redundancy``): ``epochs`` epochs straight,
    and ``split`` epochs then a ``continue`` run to ``epochs`` from that
    checkpoint; each run's history, parameters and whole optimizer
    state, and the files of its log directory."""
    import copy

    from hydragnn_tpu_torch.api import create_dataloaders, train_with_loaders
    from hydragnn_tpu_torch.utils.config import get_log_name_config

    train, val, test = samples
    res, first = {}, None
    for label, n in (("straight", epochs), ("first", split), ("continued", epochs)):
        cfg = copy.deepcopy(config)
        cfg["NeuralNetwork"]["Training"]["num_epoch"] = n
        if label == "continued":
            cfg["NeuralNetwork"]["Training"].update({"continue": 1, "startfrom": first})
        run_dir = os.path.join(log_dir, "straight" if label == "straight" else "resumed")
        model, optimizer, hist = train_with_loaders(cfg, *create_dataloaders(train, val, test, cfg),
                                                    log_dir=run_dir, device="cpu")
        name = get_log_name_config(cfg)
        first = first or (name if label == "first" else None)
        state = optimizer.state_dict()["rule"]["state"]
        res[label] = {"history": {k: hist[k] for k in ("train_loss", "val_loss", "test_loss")},
                      "params": _params(model), "buffers": _buffers(model),
                      "opt_state": {f"{i}.{k}": t.numpy().copy() for i, st in state.items() for k, t in st.items()
                                    if isinstance(t, torch.Tensor)},
                      "files": sorted(os.listdir(os.path.join(run_dir, name))) if os.path.isdir(
                          os.path.join(run_dir, name)) else []}
    return res


def container_save(samples, path):
    """Each rank writes its contiguous shard of ``samples`` into one
    container."""
    from hydragnn_tpu_torch.data.container import ContainerWriter
    from hydragnn_tpu_torch.parallel import get_comm_size_and_rank, nsplit

    world, rank = get_comm_size_and_rank()
    w = ContainerWriter(path)
    w.add(list(nsplit(samples, world))[rank])
    w.add_global("note", "two processes")
    w.save()
    return {"rank": rank}


def edge_aggregate(nodes, senders, receivers, weights, h_w):
    """The edge-sharded sum, with edge data, and the GIN layer."""
    from hydragnn_tpu_torch.parallel import Partitioner
    from hydragnn_tpu_torch.parallel.edge_sharded import (
        edge_sharded_aggregate,
        edge_sharded_gin_layer,
        place_edge_shards,
        shard_edges,
    )
    from hydragnn_tpu_torch.parallel.mesh import get_comm_size_and_rank

    world = get_comm_size_and_rank()[0]
    group = Partitioner(edge=world).edge_group
    snd, rcv, w, mask = shard_edges(senders, receivers, weights, world)
    snd, rcv, w, mask = (torch.from_numpy(a) for a in (snd, rcv, w, mask))
    s_snd, s_rcv, s_w, s_mask = place_edge_shards(group, snd, rcv, w, mask)
    x = torch.from_numpy(nodes)
    agg = edge_sharded_aggregate(group, lambda xi, xj: xj, x, s_snd, s_rcv, s_mask)
    aggw = edge_sharded_aggregate(group, lambda xi, xj, ew: xj * ew, x, s_snd, s_rcv, s_mask, edge_data=s_w)
    w1, b1, w2, b2 = (torch.from_numpy(a) for a in h_w)
    gin = edge_sharded_gin_layer(group, x, s_snd, s_rcv, s_mask, w1, b1, w2, b2)
    return {"sum": agg.numpy(), "weighted": aggw.numpy(), "gin": gin.numpy(), "rows": int(s_snd.shape[0]),
            "global_rows": int(snd.shape[0])}


def giant_step(cfg, graph, state_dict, n_edge_pad, run_align, lr, tie=None):
    """One SGD step of ``cfg`` on one giant graph, edge-sharded over the
    group (or whole on one process); the loss, the parameters and, with
    ``tie``, the gradient of the planted tie's input."""
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.parallel import Partitioner, get_comm_size_and_rank, place_giant_batch
    from hydragnn_tpu_torch.train.optimizer import Optimizer

    world = get_comm_size_and_rank()[0]
    kw = dict(run_align=run_align) if run_align else {}
    batch = batch_graphs([graph], n_node_pad=graph["x"].shape[0] + 8, n_edge_pad=n_edge_pad, n_graph_pad=2, **kw)
    part = Partitioner(edge=world)
    model = create_model(cfg, seed=0, device="cpu")
    model.load_state_dict(state_dict, strict=True)
    opt = part.shard_init(model, Optimizer(list(model.parameters()), "SGD", lr))
    placed = batch if part.single_device else place_giant_batch(part.edge_group, batch)
    step = part.shard_train_step(model, opt)
    loss = float(step(placed)[0])
    return {"loss": loss, "params": _params(model), "rows": int(placed.senders.shape[0]),
            "global_rows": int(batch.senders.shape[0]), "win": placed.sender_win is None}


def tie_grad(v, receivers, n, run_align):
    """The gradient of Σ max-aggregate w.r.t. ``v`` of PNA's statistics,
    edge-sharded over the group (unaligned: B5's Function; run-aligned:
    the K-group maxima and ``edge_max``), and its whole-graph reference."""
    from hydragnn_tpu_torch.graph import segment as S
    from hydragnn_tpu_torch.ops.gather_stats import presum_stats_plain
    from hydragnn_tpu_torch.ops.pna_aggregate import pna_aggregate
    from hydragnn_tpu_torch.parallel import Partitioner, get_comm_size_and_rank
    from hydragnn_tpu_torch.parallel.edge_sharded import edge_max, pna_aggregate_edge_sharded

    world, rank = get_comm_size_and_rank()
    group = Partitioner(edge=world).edge_group
    e = v.shape[0]
    size = e // world
    sl = slice(rank * size, (rank + 1) * size)
    vt = torch.from_numpy(v)
    rt = torch.from_numpy(receivers)
    mask = torch.ones(e, dtype=torch.bool)
    weight = torch.linspace(0.5, 1.5, 2 * v.shape[1])

    def objective(both, vsum):
        return (both * weight).sum() + (vsum * vsum).sum()

    if run_align:
        k = run_align

        def stats(vv, rr, mm, reducer):
            s8, b8 = presum_stats_plain(vv, mm, k)
            r8 = rr[::k].contiguous()
            pair = S.segment_sum_sorted(s8, r8, n)
            return reducer(b8, r8, pair)

        ref_v = vt.clone().requires_grad_(True)
        both = stats(ref_v, rt, mask, lambda b8, r8, pair: (S.segment_max(b8, r8, n, indices_are_sorted=True), pair))
        objective(both[0], both[1][:, :v.shape[1]]).backward()
        loc = vt[sl].clone().requires_grad_(True)
        from torch.distributed.nn.functional import all_reduce

        both_s = stats(loc, rt[sl], mask[sl], lambda b8, r8, pair: (
            edge_max(b8, r8, n, group, indices_are_sorted=True), all_reduce(pair, group=group)))
        objective(both_s[0], both_s[1][:, :v.shape[1]]).backward()
    else:
        ref_v = vt.clone().requires_grad_(True)
        s, _, _, both = pna_aggregate(ref_v, rt, n, mask=mask)
        objective(both, s).backward()
        loc = vt[sl].clone().requires_grad_(True)
        s_s, _, _, both_s = pna_aggregate_edge_sharded(loc, rt[sl], n, group, mask=mask[sl])
        objective(both_s, s_s).backward()
    # the edge group's backward carries the group's width: each rank's
    # gradient is the width times its slice's share
    return {"ref": ref_v.grad.numpy(), "shard": (loc.grad / world).numpy(), "lo": rank * size, "hi": (rank + 1) * size}


def placement_by_name(samples, batch_size):
    """``place_dp_edge_batch`` on a batch whose graph axis was padded out
    to the edge pad: the edge fields are sliced, the graph fields whole."""
    import dataclasses

    from hydragnn_tpu_torch.parallel import Partitioner, get_comm_size_and_rank, place_dp_edge_batch

    world = get_comm_size_and_rank()[0]
    part = Partitioner(edge=world)
    batch = GraphLoader(samples, batch_size, edge_multiple=2 * world).make_batch(np.arange(batch_size))
    e_pad, g = batch.senders.shape[0], batch.graph_mask.shape[0]

    def grow(t):
        return torch.cat([t, torch.zeros((e_pad - g,) + tuple(t.shape[1:]), dtype=t.dtype)])

    batch = dataclasses.replace(batch, graph_mask=grow(batch.graph_mask), n_node=grow(batch.n_node),
                                n_edge=grow(batch.n_edge),
                                graph_targets={k: grow(v) for k, v in batch.graph_targets.items()})
    placed = place_dp_edge_batch(part, batch)
    return {"e_pad": e_pad, "senders": int(placed.senders.shape[0]), "edge_mask": int(placed.edge_mask.shape[0]),
            "graph_mask": int(placed.graph_mask.shape[0]),
            "targets": [int(v.shape[0]) for v in placed.graph_targets.values()], "win": placed.sender_win is None}


def giant_driver(nx, ny, nz, hidden, steps):
    """``train_giant`` (the giant-graph example) in the group."""
    from hydragnn_tpu_torch.examples.giant_graph.train_giant import train_giant

    out = train_giant(nx, ny, nz, hidden, steps, device="cpu", verbose=False)
    return {"losses": out["losses"], "residency": out["residency"]}


def mesh_checks(world):
    """The Partitioner's groups in a group of ``world``: the collapsed
    axes, the mesh's groups, each rank's coordinates, and the errors of a
    layout the group does not fit."""
    from hydragnn_tpu_torch.parallel import Partitioner

    res = {}
    for name, kw in (("data", dict(data=world)), ("fsdp", dict(fsdp=world)),
                     ("data_fsdp", dict(data=2, fsdp=world // 2)), ("data_edge", dict(data=2, edge=world // 2))):
        p = Partitioner(**kw)
        mesh = p.mesh
        res[name] = {"axis_names": p.axis_names, "mesh_dims": tuple(mesh.mesh_dim_names), "coords": p.coords,
                     "lead_rank": p.lead_rank, "sizes": {a: torch.distributed.get_world_size(p.group(a))
                                                         for a in p.axis_names}}
    errors = []
    for kw in (dict(data=2 * world), dict(data=1, fsdp=1, edge=world // 2) if world > 2 else dict(data=world + 1)):
        try:
            Partitioner(**kw)
            errors.append("")
        except ValueError as exc:
            errors.append(str(exc))
    res["errors"] = errors
    return res


def replicated_warning(world):
    """``shard_init`` of a module with a leaf no fsdp width divides, twice:
    the warnings each call gave on this rank, and the manifest."""
    import warnings

    from hydragnn_tpu_torch.parallel import Partitioner
    from hydragnn_tpu_torch.train.optimizer import Optimizer

    module = torch.nn.Module()
    module.w = torch.nn.Parameter(torch.zeros(8, 8))
    module.odd = torch.nn.Parameter(torch.zeros(3, 5))
    part = Partitioner(fsdp=world)
    seen = []
    for _ in range(2):
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            opt = part.shard_init(module, Optimizer(list(module.parameters()), "AdamW", 0.01))
        seen.append([str(w.message) for w in rec if issubclass(w.category, RuntimeWarning)])
    return {"warnings": seen, "manifest": part.manifest(module, opt),
            "shards": [None if sh is None else (sh.dim, sh.width) for sh in opt.shards]}


CASES = {f.__name__: f for f in (replicated_warning, dp_steps, loader_batches, train_resume, container_save, edge_aggregate,
                                 giant_step, tie_grad, placement_by_name, giant_driver, mesh_checks)}


def two_process_worker(rank, port, out_dir):
    """One of two gloo processes (``test_torch_records.py``): the
    launcher's environment, then ``setup_distributed``, ``train_splits``
    over the group, a timer of rank-dependent length, ``barrier`` and
    ``print_timers``; writes what it saw. Here, away from JAX: the child
    imports only this module."""
    import json
    import time as _time

    from hydragnn_tpu_torch.utils import print_utils as t_print
    from hydragnn_tpu_torch.utils import time_utils as t_time

    import torch.distributed as dist

    from hydragnn_tpu_torch.parallel import barrier, get_comm_size_and_rank, setup_distributed

    import sys

    torch.set_num_threads(1)
    sys.modules["torch.utils.tensorboard"] = None  # no TensorFlow import in a child
    os.environ.update(WORLD_SIZE="2", RANK=str(rank), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      HGTORCH_DIAGNOSTICS="0")
    try:
        world = setup_distributed("cpu")
        backend = dist.get_backend()
        from hydragnn_tpu_torch.examples import train_splits

        # the group trains one model: each rank its sub-batch of every step
        cfg, tr, va, te = prepared_flagship(24, batch_size=8)
        cwd = os.getcwd()
        os.chdir(out_dir)
        try:
            res = train_splits(cfg, tr, va, te, "cpu")
        finally:
            os.chdir(cwd)
        trained = {"train_loss": res.history["train_loss"], "stack": res.loaders[0].device_stack,
                   "stack_rank": res.loaders[0].stack_rank,
                   "param": float(next(res.model.parameters()).detach().sum())}
        t_time.reset_timers()
        with t_time.Timer("work"):
            _time.sleep(0.05 * (rank + 1))
        barrier("timed")
        stats = t_time.print_timers(0)
        own = t_time.timers_snapshot()["work"]["elapsed_s"]
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump({"world": world, "again": get_comm_size_and_rank(), "stats": stats["work"], "own": own,
                       "print_rank": t_print.process_index(), "backend": backend, "trained": trained}, f)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


# ---------------------------------------------------------------------------
# tests that need no group
# ---------------------------------------------------------------------------


def _one_graph(n, e, seed, run_align=0):
    rng = np.random.default_rng(seed)
    g = {"x": rng.normal(size=(n, 3)).astype(np.float32),
         "senders": rng.integers(0, n, e).astype(np.int32),
         "receivers": np.sort(rng.integers(0, n, e)).astype(np.int32),
         "graph_targets": {"y": np.asarray([0.5], np.float32)},
         "node_targets": {"t": rng.normal(size=(n, 1)).astype(np.float32)}}
    kw = dict(run_align=run_align) if run_align else {}
    pad = e + 8 if not run_align else 8 * (e + n + 8)
    return batch_graphs([g], n_node_pad=n + 16, n_edge_pad=pad, n_graph_pad=2, **kw)


@pytest.mark.parametrize("grow", [(0, 24, 0), (16, 0, 2), (32, 16, 1)])
def test_pad_batch_keeps_every_real_slot_and_the_derived_plans(grow):
    """``pad_batch`` grows a batch: the real slots keep their values, the
    new edges point at a padding node and are masked, the senders' order
    and window plans are those ``batch_graphs`` emits at the larger
    shape (the window plans at the old block granularity)."""
    from hydragnn_tpu_torch.ops.segment_sum_local import local_block_rows

    b = _one_graph(40, 100, 0)
    dn, de, dg = grow
    p = pad_batch(b, b.num_nodes + dn, b.num_edges + de, b.num_graphs + dg)
    assert (p.num_nodes, p.num_edges, p.num_graphs) == (b.num_nodes + dn, b.num_edges + de, b.num_graphs + dg)
    assert torch.equal(p.nodes[: b.num_nodes], b.nodes) and torch.equal(p.senders[: b.num_edges], b.senders)
    assert not p.edge_mask[b.num_edges:].any() and not p.node_mask[b.num_nodes:].any()
    assert (p.receivers[b.num_edges:] >= int(b.n_real_nodes)).all()
    assert torch.equal(p.sender_perm, torch.argsort(p.senders, stable=True).to(torch.int32))
    assert torch.equal(p.in_degree[: b.num_nodes], b.in_degree) and not p.in_degree[b.num_nodes:].any()
    # every sender position lies in its block's window
    blk = local_block_rows(p.num_nodes, p.sender_win.shape[1])
    ids = p.senders.long() // blk
    assert ((p.sender_win[0, ids] <= torch.arange(p.num_edges)) & (torch.arange(p.num_edges) < p.sender_win[1, ids])).all()
    assert pad_batch(b, b.num_nodes, b.num_edges, b.num_graphs) is b


def test_pad_batch_refuses_a_shrink_and_a_broken_alignment():
    b = _one_graph(20, 40, 1, run_align=8)
    with pytest.raises(ValueError, match="smaller"):
        pad_batch(b, b.num_nodes - 1, b.num_edges, b.num_graphs)
    with pytest.raises(ValueError, match="multiple of run_align"):
        pad_batch(b, b.num_nodes, b.num_edges + 4, b.num_graphs)
    assert pad_batch(b, b.num_nodes, b.num_edges + 16, b.num_graphs).num_edges == b.num_edges + 16


def test_mask_out_is_pure_padding():
    b = _one_graph(30, 60, 2)
    m = mask_out(b)
    assert not (m.node_mask.any() or m.edge_mask.any() or m.graph_mask.any())
    assert int(m.edge_occupancy) == 0 and int(m.n_real_nodes) == 0 and not m.in_degree.any()
    assert (m.senders == b.num_nodes - 1).all() and (m.receivers == b.num_nodes - 1).all()
    assert torch.equal(m.sender_perm, torch.arange(b.num_edges, dtype=torch.int32))
    assert int(m.sender_win[1].sum()) == b.num_edges


def prepared_flagship(n, batch_size=8, hidden=16, layers=2, seed=3, **training):
    """The flagship's config at ``hidden``/``layers`` and its prepared
    splits (the port's data pipeline), with ``training`` keys set."""
    from hydragnn_tpu_torch.api import prepare_config_and_samples
    from hydragnn_tpu_torch.data.synthetic import deterministic_graph_data
    from hydragnn_tpu_torch.flagship import flagship_config

    cfg = flagship_config(hidden, layers, batch_size, 1)
    cfg["NeuralNetwork"]["Training"].update(training)
    raw = deterministic_graph_data(number_configurations=n, unit_cell_x_range=(2, 3), unit_cell_y_range=(2, 3),
                                   unit_cell_z_range=(2, 3), seed=seed)
    tr, va, te, cfg = prepare_config_and_samples(cfg, raw)
    return cfg, tr, va, te


def test_loader_shards_wrap_to_equal_lengths():
    samples = prepared_flagship(24)[1][:10]
    loaders = [GraphLoader(samples, 4, num_shards=3, shard_rank=r) for r in range(3)]
    assert [len(lo.samples) for lo in loaders] == [4, 4, 4]
    assert loaders[2].samples[3] is samples[(2 + 9) % 10]
    assert len({(lo.pad_nodes, lo.pad_edges) for lo in loaders}) == 1
    with pytest.raises(ValueError, match="divisible"):
        GraphLoader(samples, 5, device_stack=2)
