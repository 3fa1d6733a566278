"""Data-parallel train, eval and statistics steps, with the optimizer
state sharded (ZeRO-1) or the parameters and the state sharded (FSDP):
the port's counterpart of ``hydragnn_tpu/parallel/sharded.py``.

One process per card. Every rank runs the forward and backward on its
own sub-batch, then one ``all_reduce`` (a sum over a flat buffer) over
every rank of the run carries, together:

  - the gradients, divided by the ranks: the JAX step's ``pmean`` over
    its batch axes (DDP's all-reduce);
  - the BatchNorm running statistics, divided likewise: the JAX step
    ``pmean``s them after the update;
  - the real-graph-weighted loss and per-head losses and the real graph
    count: the JAX step's ``psum(loss·n) / psum(n)``.

So the non-finite guard (``train/state.py``) decides on the reduced
loss and the global gradient norm, the same verdict on every rank.

The state layout is the Partitioner's (``parallel/partitioner.py``):
replicated, ZeRO-1 (each optimizer tensor split on its first axis over
the ``data`` ranks when that axis divides) or FSDP (each parameter and
optimizer tensor split on its largest ``fsdp``-divisible dimension over
the ``fsdp`` ranks). A sharded layout trains through
:class:`ShardedOptimizer`: the optimizer rule runs on this rank's slices
of the parameters with this rank's slices of the reduced gradients and
of the state. An elementwise rule (SGD, Adam, AdamW, Adadelta, Adamax,
Adagrad, RMSprop) computes on a slice what it computes on the whole
tensor; LAMB's per-tensor norms are reduced over the shard group.

  - **ZeRO-1**: the rule's parameters are views of this rank's slices of
    the model's parameters, which every rank keeps whole; after the rule
    the slices are gathered back into them.
  - **FSDP**: a rank keeps only its slices (:class:`ShardedParams`) and
    frees the storage of the whole parameters between steps. They are
    gathered before a forward, a ``state_dict`` read or a load (hooks on
    the model, and ``train/state.py:_loss`` before the bf16 cast), and
    freed again at the end of each train, eval and statistics step and
    after the read or load. A rank then holds P/f of parameters and 1/f
    of the state between steps, as the JAX layout does; the whole
    parameters and their gradients exist only inside a step.

The collectives are ``all_reduce`` and ``all_gather`` alone, which
gloo also carries on CUDA tensors (two ranks on one card).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from hydragnn_tpu_torch.models.base import model_loss
from hydragnn_tpu_torch.train.optimizer import Optimizer
from hydragnn_tpu_torch.train.state import make_train_step


@dataclasses.dataclass(frozen=True)
class LeafShard:
    """Where one tensor's slices live: split on ``dim`` into ``width``
    equal slices over ``group``, this rank holding slice ``index``, as
    copy ``replica`` of it (the ranks off the group's axis hold the same
    slice; a pod checkpoint takes each slice from its replica 0)."""

    dim: int
    width: int
    index: int
    group: Any
    replica: int = 0

    def take(self, t: torch.Tensor) -> torch.Tensor:
        size = t.shape[self.dim] // self.width
        return t.narrow(self.dim, self.index * size, size)


def _dist():
    import torch.distributed as dist

    return dist


def gather_shards(items: Sequence[Tuple[torch.Tensor, Optional[LeafShard]]]) -> List[torch.Tensor]:
    """The whole tensors of ``(slice, shard)`` pairs (a None shard: the
    tensor is whole already): one ``all_gather`` per group and dtype,
    over the slices packed flat."""
    out: List[Optional[torch.Tensor]] = [None] * len(items)
    buckets: Dict[Tuple[int, torch.dtype], List[int]] = {}
    for i, (t, sh) in enumerate(items):
        if sh is None:
            out[i] = t
        else:
            buckets.setdefault((id(sh.group), t.dtype), []).append(i)
    for idxs in buckets.values():
        sh0 = items[idxs[0]][1]
        flat = torch.cat([items[i][0].reshape(-1) for i in idxs])
        parts = [torch.empty_like(flat) for _ in range(sh0.width)]
        _dist().all_gather(parts, flat, group=sh0.group)
        off = 0
        for i in idxs:
            t, sh = items[i]
            n = t.numel()
            out[i] = torch.cat([p[off:off + n].view(t.shape) for p in parts], dim=sh.dim)
            off += n
    return out  # type: ignore[return-value]


class ShardedParams:
    """FSDP's parameters (module docstring): this rank's slice of each
    sharded parameter (``slices``, which the rule updates) is what it
    keeps; the whole tensor keeps its shape, its storage freed between
    steps. :meth:`unshard` gathers the whole tensors (a collective: every
    rank together), :meth:`reshard` frees them. Installed on the model as
    ``model.sharded_params``, with hooks: a forward unshards (the step
    that runs it reshards at its end); a ``state_dict`` read or a load
    unshards and, if the parameters were freed before it, frees them
    again after it (a load first takes its slices)."""

    def __init__(self, model: torch.nn.Module, shards: Sequence[Optional[LeafShard]]):
        self.pairs = [(p, sh) for p, sh in zip(model.parameters(), shards) if sh is not None]
        self.slices = {id(p): torch.nn.Parameter(sh.take(p.detach()).clone()) for p, sh in self.pairs}
        self.full, self._reopen = True, False
        self._hooks = [
            model.register_forward_pre_hook(lambda *_: self.unshard()),
            model.register_state_dict_pre_hook(lambda *_: self._open()),
            model.register_state_dict_post_hook(lambda *_: self._close()),
            model.register_load_state_dict_pre_hook(lambda *_: self._open()),
            model.register_load_state_dict_post_hook(lambda *_: self._loaded()),
        ]
        self.model = model
        model.sharded_params = self
        self.reshard()

    @torch.no_grad()
    def unshard(self) -> None:
        if self.full:
            return
        whole = gather_shards([(self.slices[id(p)], sh) for p, sh in self.pairs])
        for (p, _), w in zip(self.pairs, whole):
            p.untyped_storage().resize_(w.numel() * w.element_size())
            p.copy_(w)
        self.full = True

    def reshard(self) -> None:
        """Free the whole parameters and their gradients (the slices hold
        the values). Each parameter takes a storage of its own first, so
        what still holds the old one (a state dict just read, a numpy
        view) keeps its values."""
        if not self.full:
            return
        for p, _ in self.pairs:
            p.grad = None
            p.data = torch.empty_like(p)
            p.untyped_storage().resize_(0)
        self.full = False

    def _open(self) -> None:
        self._reopen = not self.full
        self.unshard()

    def _close(self) -> None:
        if self._reopen:
            self._reopen = False
            self.reshard()

    def _loaded(self) -> None:
        self.take_slices()
        self._close()

    @torch.no_grad()
    def take_slices(self) -> None:
        """The slices of the whole parameters (after a load into them)."""
        for p, sh in self.pairs:
            self.slices[id(p)].copy_(sh.take(p))

    def release(self) -> None:
        """The model back to whole, resident parameters, the hooks gone."""
        self.unshard()
        for h in self._hooks:
            h.remove()
        del self.model.sharded_params


class ShardedOptimizer:
    """The run's optimizer under a sharded layout (module docstring):
    ``Optimizer``'s interface over the model's parameters, its rule over
    this rank's slices of them (FSDP's ``store.slices``; under ZeRO-1
    views of the live parameters).

    Args:
      model_params: the model's parameters, in ``named_parameters`` order.
      optimizer: the run's ``Optimizer`` over ``model_params`` (its kind,
        learning rate, freeze mask, accumulation and state are taken).
      shards: one ``LeafShard`` (or None: kept whole) per parameter.
      store: FSDP's :class:`ShardedParams` (None under ZeRO-1).

    ``state_dict`` is the whole optimizer's, gathered from the shards on
    every rank (a collective), in ``Optimizer.state_dict``'s format;
    ``load_state_dict`` takes such a dict and keeps this rank's slices."""

    def __init__(self, model_params: Sequence[torch.nn.Parameter], optimizer: Optimizer,
                 shards: Sequence[Optional[LeafShard]], store: Optional[ShardedParams] = None):
        self.params = list(model_params)
        self.shards = list(shards)
        if len(self.shards) != len(self.params):
            raise ValueError("ShardedOptimizer needs one shard entry per parameter")
        self.store = store
        frozen_ids = {id(p) for g in optimizer.param_groups if g.get("frozen") for p in g["params"]}
        self.masters = [p if sh is None else store.slices[id(p)] if store is not None
                        else torch.nn.Parameter(sh.take(p.detach()))
                        for p, sh in zip(self.params, self.shards)]
        self.kind, self.accum = optimizer.kind, optimizer.accum
        lr = next(g["lr"] for g in optimizer.param_groups if not g.get("frozen")) \
            if any(not g.get("frozen") for g in optimizer.param_groups) else optimizer.param_groups[0]["lr"]
        self.inner = Optimizer(self.masters, self.kind, lr, frozen=[id(p) in frozen_ids for p in self.params],
                               accum=self.accum)
        self._master_shard = {id(m): sh for m, sh in zip(self.masters, self.shards)}
        if self.kind == "FusedLAMB" and any(sh is not None for sh in self.shards):
            self.inner.inner.tensor_norms = self._global_norms
        # the rule's parameters (inner order) -> model parameter index
        pos = {id(m): i for i, m in enumerate(self.masters)}
        self._order = [pos[id(m)] for g in self.inner.param_groups for m in g["params"]]
        self.load_state_dict(optimizer.state_dict())

    # -- Optimizer's interface ------------------------------------------------

    @property
    def steps(self) -> torch.Tensor:
        return self.inner.steps

    @property
    def param_groups(self):
        return self.inner.param_groups

    @property
    def state(self):
        return self.inner.state

    @property
    def shared(self):
        return self.inner.shared

    def count(self):
        return self.inner.count()

    def state_tensors(self) -> List[torch.Tensor]:
        return self.inner.state_tensors()

    def resident_params(self) -> List[torch.Tensor]:
        """The tensors that hold the parameters' values between steps:
        FSDP's slices and whole unsharded leaves, or the model's."""
        return self.masters if self.store is not None else self.params

    def zero_grad(self, set_to_none: bool = True) -> None:
        for p in self.params + self.masters:
            if set_to_none:
                p.grad = None
            elif p.grad is not None:
                p.grad.zero_()

    @torch.no_grad()
    def _global_norms(self, tensors: Sequence[torch.Tensor], params: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """LAMB's norm of each of ``tensors`` (the rule's parameters or
        updates, aligned with ``params``), its square summed over the
        parameter's shard group."""
        sq = torch.stack([t.float().pow(2).sum() for t in tensors])
        by_group: Dict[int, Tuple[Any, List[int]]] = {}
        for i, p in enumerate(params):
            sh = self._master_shard[id(p)]
            if sh is not None:
                by_group.setdefault(id(sh.group), (sh.group, []))[1].append(i)
        for group, rows in by_group.values():
            part = sq[rows]
            _dist().all_reduce(part, group=group)
            sq[rows] = part
        return [s.sqrt().to(t.dtype) for s, t in zip(sq, tensors)]

    @torch.no_grad()
    def step(self) -> None:
        for p, m, sh in zip(self.params, self.masters, self.shards):
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            if sh is not None:
                m.grad = sh.take(g).contiguous()
                # the fused rules take dense tensors: a slice of any axis
                # but the first is not, so the rule gets a copy of it
                m.data = m.data.contiguous()
            elif p.grad is None:
                p.grad = g
        self.inner.step()
        for m, sh in zip(self.masters, self.shards):
            if sh is not None:
                m.grad = None
        if self.store is not None:
            self.store.reshard()  # the next forward gathers the new slices
            return
        sharded = [(p, m, sh) for p, m, sh in zip(self.params, self.masters, self.shards) if sh is not None]
        for (p, m, sh), whole in zip(sharded, gather_shards([(m, sh) for _, m, sh in sharded])):
            p.copy_(whole)
            m.data = sh.take(p.detach())

    @torch.no_grad()
    def dry_update(self, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """What ``step()`` would add to each of the model's ``params`` for
        ``grads`` (a collective: the slices are gathered)."""
        index = {id(p): i for i, p in enumerate(self.params)}
        rows = [index[id(p)] for p in params]
        masters = [self.masters[i] for i in rows]
        shards = [self.shards[i] for i in rows]
        sliced = [g if sh is None else sh.take(g).contiguous() for g, sh in zip(grads, shards)]
        upd = self.inner.dry_update(masters, sliced)
        return gather_shards(list(zip(upd, shards)))

    # -- the whole optimizer's state ------------------------------------------

    def _rule_shard(self, idx: int, t: torch.Tensor) -> Optional[LeafShard]:
        i = self._order[idx]
        sh = self.shards[i]
        if sh is None or t.dim() == 0 or tuple(t.shape) != tuple(self.masters[i].shape):
            return None
        return sh

    def state_dict(self) -> Dict[str, Any]:
        sd = self.inner.state_dict()
        # torch's packed state holds the live per-parameter dicts: copy them
        # before the gathered tensors take their slices' places
        sd["rule"] = dict(sd["rule"], state={idx: dict(st) for idx, st in sd["rule"]["state"].items()})
        entries = [(idx, key, t) for idx, st in sd["rule"]["state"].items() for key, t in st.items()
                   if isinstance(t, torch.Tensor)]
        full = gather_shards([(t, self._rule_shard(idx, t)) for idx, _, t in entries])
        for (idx, key, _), f in zip(entries, full):
            sd["rule"]["state"][idx][key] = f
        return sd

    def load_state_dict(self, state_dict: Dict[str, Any]) -> None:
        rule = dict(state_dict["rule"])
        state = {}
        for idx, st in rule["state"].items():
            i = self._order[int(idx)]
            sh, m = self.shards[i], self.masters[i]
            state[idx] = {k: (sh.take(t).clone() if isinstance(t, torch.Tensor) and sh is not None and t.dim() > 0
                              and tuple(sh.take(t).shape) == tuple(m.shape) else t) for k, t in st.items()}
        rule["state"] = state
        self.inner.load_state_dict(dict(state_dict, rule=rule))


def held_bytes(model: torch.nn.Module, optimizer) -> Tuple[int, int]:
    """(parameter bytes, optimizer-state bytes) this rank holds between
    steps: the model's parameter storages that are allocated (none for
    FSDP's freed whole tensors) and FSDP's slices; the optimizer's state
    tensors."""
    store = getattr(model, "sharded_params", None)
    tensors = list(model.parameters()) + (list(store.slices.values()) if store is not None else [])
    storages = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes() for t in tensors}
    return (sum(n for ptr, n in storages.items() if ptr),
            sum(t.numel() * t.element_size() for t in optimizer.state_tensors()))


def _reshard(model: torch.nn.Module) -> None:
    store = getattr(model, "sharded_params", None)
    if store is not None:
        store.reshard()


def _float_buffers(model: torch.nn.Module) -> List[torch.Tensor]:
    return [b for b in model.buffers() if b.is_floating_point()]


def make_step_sync(model: torch.nn.Module, group, ranks: int, edge: int = 1) -> Callable:
    """``sync(loss, tasks, batch) -> (loss, tasks, count)`` after a
    backward: the one all-reduce of the module docstring over ``group``
    (``ranks`` processes, ``edge`` of them on each sub-batch), the
    gradients and statistics written back in place."""
    params = list(model.parameters())

    @torch.no_grad()
    def sync(loss: torch.Tensor, tasks: torch.Tensor, batch) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        bufs = _float_buffers(model)
        n = batch.graph_mask.sum().float()
        head = torch.cat([(loss.detach().float() * n).reshape(1), tasks.detach().float() * n, n.reshape(1)])
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        flat = torch.cat([g.reshape(-1).float() for g in grads] + [b.reshape(-1).float() for b in bufs] + [head])
        _dist().all_reduce(flat, group=group)
        off = 0
        for p, g in zip(params, grads):
            k = g.numel()
            red = (flat[off:off + k] / ranks).view_as(g).to(g.dtype)
            if p.grad is None:
                p.grad = red
            else:
                p.grad.copy_(red)
            off += k
        for b in bufs:
            k = b.numel()
            b.copy_((flat[off:off + k] / ranks).view_as(b))
            off += k
        return _weighted(flat[off:], edge)

    return sync


def _weighted(sums: torch.Tensor, edge: int):
    count = sums[-1]
    denom = torch.clamp(count, min=1.0)
    return sums[0] / denom, sums[1:-1] / denom, count / edge


def make_sharded_train_step(model, optimizer, group, ranks: int, edge: int = 1, compute_dtype=None,
                            remat: bool = False, guard_nonfinite: bool = False) -> Callable:
    """The partitioned train step: ``make_train_step``'s step with the
    reduction of the module docstring between the backward and the
    update; returns what the plain step returns, then the real graph
    count of the whole step."""
    return make_train_step(model, optimizer, compute_dtype=compute_dtype, remat=remat,
                           guard_nonfinite=guard_nonfinite, sync=make_step_sync(model, group, ranks, edge))


def make_sharded_eval_step(model, group, edge: int = 1) -> Callable:
    """``step(batch) -> (loss, tasks, outputs, count)``: this rank's
    forward with the running statistics, the loss and per-head losses
    weighted over every rank's real graphs; ``outputs`` are this rank's
    rows (the JAX package's ``local_view`` of the sharded outputs)."""

    @torch.no_grad()
    def step(batch):
        outputs = model(batch, train=False)
        _reshard(model)
        loss, tasks = model_loss(model.cfg, outputs, batch)
        n = batch.graph_mask.sum().float()
        sums = torch.cat([(loss.float() * n).reshape(1), torch.stack(tasks).float() * n, n.reshape(1)])
        _dist().all_reduce(sums, group=group)
        loss_g, tasks_g, count = _weighted(sums, edge)
        return loss_g, tasks_g, outputs, count

    return step


def make_sharded_stats_step(model, group, ranks: int) -> Callable:
    """BatchNorm recalibration (``train/state.py:stats_step``) on this
    rank's sub-batch, the running statistics then averaged over every
    rank (SyncBatchNorm, when configured, has reduced the batch
    statistics inside the forward already)."""

    @torch.no_grad()
    def step(batch):
        model(batch, train=False, bn_train=True)
        _reshard(model)
        bufs = _float_buffers(model)
        if bufs:
            flat = torch.cat([b.reshape(-1) for b in bufs])
            _dist().all_reduce(flat, group=group)
            off = 0
            for b in bufs:
                b.copy_((flat[off:off + b.numel()] / ranks).view_as(b))
                off += b.numel()

    return step


def place_state(model: torch.nn.Module, optimizer: Optimizer, shards: Sequence[Optional[LeafShard]],
                fsdp: bool = False):
    """The run's optimizer under ``shards``: the optimizer itself when
    every entry is None, else a :class:`ShardedOptimizer`; with ``fsdp``
    the model keeps only its slices between steps (:class:`ShardedParams`)."""
    if all(sh is None for sh in shards):
        return optimizer
    store = ShardedParams(model, shards) if fsdp else None
    return ShardedOptimizer(list(model.parameters()), optimizer, shards, store)
