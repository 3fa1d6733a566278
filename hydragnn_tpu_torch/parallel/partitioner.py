"""The ``Partitioner``: one sharding story for a run, over
``torch.distributed`` (the port's counterpart of
``hydragnn_tpu/parallel/partitioner.py``).

The JAX package lays a ``(data, fsdp, edge)`` mesh over the devices of
one process. The port runs one process per card: the world has
``data × fsdp × edge`` ranks, rank r standing for mesh position r in
row-major ``AXIS_ORDER`` and owning the JAX loader's sub-batch
``r // edge``. Each axis is a process group of one
``init_device_mesh`` over those named dimensions, size-1 dimensions
collapsed as ``Partitioner._build_mesh`` collapses them.

  - **input**: a rank's loader yields its own sub-batch of the global
    batch (``data/loader.py``, ``device_stack`` and ``stack_rank``);
    with an ``edge`` axis a rank keeps its contiguous slice of the
    sub-batch's edges (``parallel/edge_sharded.py``);
  - **state**: replicated; ZeRO-1 (optimizer tensors on their first axis
    over ``data``); or FSDP (parameters and optimizer tensors on their
    largest ``fsdp``-divisible dimension over ``fsdp``). A tensor that
    cannot split stays replicated, loudly: one rank-0 ``RuntimeWarning``
    naming it and ``parallel.replicated_leaves`` in the flight manifest;
  - **steps**: ``shard_train_step``, ``shard_eval_step`` and
    ``shard_stats_step`` (``parallel/sharded.py``), each the plain step
    of ``train/state.py`` on a single-device partitioner.

Leaf paths are the port's parameter names (``params['convs.0.pre_kernel']``,
``opt_state.mu['convs.0.pre_kernel']`` with optax's slot names), which
``convert.py`` maps one to one onto the JAX package's.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from hydragnn_tpu_torch.parallel.mesh import DATA_AXIS, get_comm_size_and_rank, mesh_device_type

FSDP_AXIS = "fsdp"
EDGE_AXIS = "edge"
# canonical axis order: data outermost (rows of sub-batches), fsdp inside
# it, edge innermost
AXIS_ORDER = (DATA_AXIS, FSDP_AXIS, EDGE_AXIS)


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """Global axis widths of the composed ``(data, fsdp, edge)`` mesh.

    ``data``: sub-batches processed in parallel (DDP width). ``fsdp``:
    parameter/optimizer-state sharding width; the batch also splits over
    this axis, so sub-batches per step = ``data * fsdp``. ``edge``: the
    ranks sharing one sub-batch's edges (giant graphs). ``zero1``: the
    optimizer-state-over-``data`` layout; subsumed by ``fsdp > 1``.
    """

    data: int = 1
    fsdp: int = 1
    edge: int = 1
    zero1: bool = False

    def __post_init__(self):
        for name in ("data", "fsdp", "edge"):
            v = getattr(self, name)
            if not isinstance(v, int) or v < 1:
                raise ValueError(f"Parallel.{name} must be a positive integer, got {v!r}")

    @property
    def num_devices(self) -> int:
        return self.data * self.fsdp * self.edge


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


class Partitioner:
    """Owns the mesh and every sharding decision of a run.

    Construct directly (``Partitioner(data=2)``, ``Partitioner(data=2,
    fsdp=2)``) or from a completed config with :meth:`from_config`. A
    config whose axes are all 1 is the single-device partitioner: no
    mesh, and every ``shard_*`` method is the plain single-device one.
    Otherwise the mesh needs an initialised default group of exactly
    ``data × fsdp × edge`` ranks (``parallel/mesh.py:setup_distributed``);
    it is built at the first use of a group (``mesh``, ``shard_init``,
    the steps), while the layout's description (``axis_names``,
    ``lead_axes``, ``manifest`` without a state) needs none.
    ``devices`` is the world size to check against (default: the
    group's)."""

    def __init__(
        self,
        config: Optional[ParallelConfig] = None,
        *,
        data: int = 1,
        fsdp: int = 1,
        edge: int = 1,
        zero1: bool = False,
        devices: Optional[int] = None,
        multihost: bool = False,
    ):
        if config is None:
            config = ParallelConfig(data=data, fsdp=fsdp, edge=edge, zero1=zero1)
        self.config = config
        self.multihost = bool(multihost)
        self._warned_replicated = False
        self._replicated_leaves: List[str] = []
        self._mesh = None
        self._lead_group = None
        c = config
        total = c.num_devices
        world = devices if devices is not None else get_comm_size_and_rank()[0]
        if total > world and (devices is not None or world > 1):
            raise ValueError(
                f"parallel config (data={c.data}, fsdp={c.fsdp}, edge={c.edge}) needs {total} devices, have {world}"
            )
        if 1 < total < world:
            raise ValueError(
                f"parallel config (data={c.data}, fsdp={c.fsdp}, edge={c.edge}) uses {total} of the group's {world} "
                "processes; every process must hold one mesh position"
            )
        sizes = [(DATA_AXIS, c.data), (FSDP_AXIS, c.fsdp), (EDGE_AXIS, c.edge)]
        axes = [(n, s) for n, s in sizes if s > 1]
        if total == 1 and not self.multihost:
            axes = []
        elif not axes:
            axes = [(DATA_AXIS, 1)]  # degenerate multihost: keep one axis
        self.axis_names: Tuple[str, ...] = tuple(n for n, _ in axes)
        self.mesh_shape: Dict[str, int] = {n: s for n, s in axes}

    # -- construction ------------------------------------------------------

    @classmethod
    def from_config(
        cls,
        nn_config: Dict[str, Any],
        device_stack: int = 1,
        multihost: bool = False,
        devices: Optional[int] = None,
    ) -> "Partitioner":
        """Build from a (completed) ``NeuralNetwork`` config section.

        ``device_stack`` is the batch's device axis: the sub-batches one
        global batch splits into (the world's ranks over ``Parallel.edge``
        in the port); ``Parallel.fsdp`` must divide it. With
        ``multihost`` every process contributes ``device_stack`` of them
        (the JAX multi-host layout; the port's processes hold one each).
        ``Training.Optimizer.use_zero_redundancy`` maps to ZeRO-1,
        subsumed when ``fsdp > 1``."""
        par = dict(nn_config.get("Parallel") or {})
        fsdp = int(par.get("fsdp", 1) or 1)
        edge = int(par.get("edge", 1) or 1)
        zero1 = bool(nn_config.get("Training", {}).get("Optimizer", {}).get("use_zero_redundancy", False))
        if device_stack % fsdp:
            raise ValueError(
                f"Parallel.fsdp={fsdp} must divide the batch device axis "
                f"(device_stack={device_stack}); pick an fsdp width that "
                "divides the local data-parallel width"
            )
        nproc = get_comm_size_and_rank()[0] // (device_stack * edge) if multihost else 1
        data = (device_stack // fsdp) * max(nproc, 1)
        if fsdp > 1 and zero1:
            zero1 = False  # fsdp shards the optimizer state (and the parameters) itself
        return cls(ParallelConfig(data=data, fsdp=fsdp, edge=edge, zero1=zero1), devices=devices,
                   multihost=multihost)

    # -- topology ----------------------------------------------------------

    @property
    def single_device(self) -> bool:
        """True for a plain single-device run: the signal the fixed-epoch
        dispatch reads instead of sniffing groups itself."""
        return self.config.num_devices == 1

    @property
    def num_devices(self) -> int:
        return self.config.num_devices

    @property
    def lead_axes(self) -> Tuple[str, ...]:
        """Mesh axes the batch's sub-batches split over."""
        return tuple(a for a in (DATA_AXIS, FSDP_AXIS) if a in self.axis_names)

    @property
    def lead_spec(self):
        ax = self.lead_axes
        if not ax:
            return None
        return ax[0] if len(ax) == 1 else ax

    @property
    def fsdp_factor(self) -> int:
        return self.config.fsdp

    @property
    def device_stack(self) -> int:
        """Sub-batches per process: 1, a process drives one card."""
        return 1

    @property
    def coords(self) -> Tuple[int, int, int]:
        """This rank's (data, fsdp, edge) position."""
        c = self.config
        r = get_comm_size_and_rank()[1]
        return r // (c.fsdp * c.edge), (r // c.edge) % c.fsdp, r % c.edge

    @property
    def lead_rank(self) -> int:
        """This rank's sub-batch: its position over ``data × fsdp``."""
        return get_comm_size_and_rank()[1] // self.config.edge

    @property
    def mesh(self):
        """The DeviceMesh over the named, uncollapsed axes (None
        single-device); built at the first read, by every rank."""
        if self._mesh is None and not self.single_device:
            from torch.distributed.device_mesh import init_device_mesh

            world = get_comm_size_and_rank()[0]
            if world != self.num_devices:
                raise ValueError(
                    f"parallel config (data={self.config.data}, fsdp={self.config.fsdp}, edge={self.config.edge}) "
                    f"needs {self.num_devices} devices, have {world}"
                )
            shape = tuple(self.mesh_shape[a] for a in self.axis_names)
            self._mesh = init_device_mesh(mesh_device_type(), shape, mesh_dim_names=self.axis_names)
            c = self.config
            if c.edge > 1 and c.data > 1 and c.fsdp > 1:
                # the sub-batch ranks of one edge position: data × fsdp flattened
                import torch.distributed as dist

                for e in range(c.edge):
                    g = dist.new_group(list(range(e, world, c.edge)))
                    if e == self.coords[2]:
                        self._lead_group = g
        return self._mesh

    def group(self, axis: str):
        """The process group of ``axis`` this rank belongs to (None when
        the axis has width 1)."""
        if axis not in self.axis_names or self.mesh_shape[axis] == 1:
            return None
        return self.mesh.get_group(axis)

    @property
    def world_group(self):
        """Every rank of the run: the group gradients, losses and running
        statistics reduce over."""
        import torch.distributed as dist

        return None if self.single_device else dist.group.WORLD

    @property
    def lead_group(self):
        """The ranks of this rank's edge position: the sub-batches of one
        step."""
        c = self.config
        if self.single_device or c.data * c.fsdp == 1:
            return None
        if c.edge == 1:
            return self.world_group
        if c.fsdp == 1:
            return self.group(DATA_AXIS)
        if c.data == 1:
            return self.group(FSDP_AXIS)
        self.mesh  # builds the flattened groups
        return self._lead_group

    @property
    def bn_axis_name(self):
        """The group SyncBatchNorm reduces its statistics over: the
        sub-batches of a step (None single-device)."""
        return self.lead_group

    @property
    def edge_group(self):
        return self.group(EDGE_AXIS)

    # -- input -------------------------------------------------------------

    def attach_loader(self, loader) -> None:
        """Point a ``GraphLoader`` at this rank's share: its sub-batch of
        every step (``set_stack_rank``, on a loader built with
        ``device_stack = data × fsdp``; a loader sharded by samples,
        ``num_shards``, is this rank's already) and, with an edge axis,
        its slice of the edges (``set_placer``). Single-device: no-op."""
        if self.single_device:
            return
        c = self.config
        lead = c.data * c.fsdp
        stack, shards = getattr(loader, "device_stack", 1), getattr(loader, "num_shards", 1)
        if lead > 1:
            if stack == lead:
                loader.set_stack_rank(self.lead_rank)
            elif not (stack == 1 and shards == lead):
                raise ValueError(
                    f"the loader must split each batch into the mesh's {lead} sub-batches (device_stack={lead}) or "
                    f"shard the samples over them (num_shards={lead}); it has device_stack={stack}, "
                    f"num_shards={shards}"
                )
        if c.edge > 1:
            loader.set_placer(self.shard_batch)

    def shard_batch(self, batch):
        """This rank's part of its sub-batch: with an edge axis its slice
        of the edges (``edge_sharded.place_dp_edge_batch``), else the
        sub-batch as it is."""
        if self.single_device or self.config.edge == 1:
            return batch
        from hydragnn_tpu_torch.parallel.edge_sharded import place_dp_edge_batch

        return place_dp_edge_batch(self, batch)

    def shard_inference_batch(self, batch):
        """Serving takes one coalesced batch at a time: replicated, as it is."""
        return batch

    # -- state -------------------------------------------------------------

    def _fsdp_dim(self, shape) -> Optional[int]:
        """The dimension an fsdp-sharded tensor splits: the LARGEST one
        divisible by the fsdp width (ties: the lowest index)."""
        n = self.config.fsdp
        best = None
        for i, d in enumerate(shape):
            if d > 0 and d % n == 0:
                if best is None or d > shape[best]:
                    best = i
        return best

    def param_spec(self, x) -> Tuple[Optional[str], ...]:
        """The fsdp spec of one tensor, JAX's ``PartitionSpec`` entries as
        a tuple (``()`` when it cannot shard)."""
        shape = tuple(getattr(x, "shape", x))
        if self.config.fsdp <= 1 or len(shape) == 0:
            return ()
        dim = self._fsdp_dim(shape)
        if dim is None:
            return ()
        return tuple([None] * dim + [FSDP_AXIS])

    def _leaf_dim(self, shape, zero1_axis0: bool) -> Optional[int]:
        if zero1_axis0:
            n = self.config.data
            return 0 if len(shape) >= 1 and shape[0] > 0 and shape[0] % n == 0 else None
        spec = self.param_spec(shape)
        return len(spec) - 1 if spec else None

    def _map_section(self, prefix: str, leaves: Sequence[Tuple[str, Tuple[int, ...]]], report: List[str],
                     zero1: bool = False) -> List[Optional[int]]:
        """The split dimension of each ``(path, shape)`` leaf of one state
        section (None: replicated), recording the non-scalar leaves that
        cannot split into ``report``."""
        out = []
        for path, shape in leaves:
            dim = self._leaf_dim(shape, zero1)
            if dim is None and len(shape) >= 1 and (_numel(shape) > 1 or zero1):
                report.append(prefix + path)
            out.append(dim)
        return out

    @staticmethod
    def _transposed(model) -> set:
        """The parameters the JAX package holds transposed: every
        ``nn.Linear`` weight ([out, in] here, a flax kernel [in, out];
        ``convert.py``). The layout rules read the JAX axis order."""
        return {f"{name}.weight" if name else "weight" for name, m in model.named_modules()
                if isinstance(m, torch.nn.Linear)}

    @classmethod
    def _param_leaves(cls, model) -> List[Tuple[str, Tuple[int, ...]]]:
        """(path, shape in the JAX package's axis order) of each parameter."""
        flip = cls._transposed(model)
        return [(f"['{name}']", tuple(p.shape)[::-1] if name in flip else tuple(p.shape))
                for name, p in model.named_parameters()]

    @staticmethod
    def _opt_leaves(model, optimizer) -> List[Tuple[str, Tuple[int, ...], int]]:
        """(path, shape, parameter index) of every optimizer state tensor
        with the parameter's shape, in optax's slot names."""
        from hydragnn_tpu_torch.train.optimizer import SLOTS

        names = [n for n, _ in model.named_parameters()]
        shapes = [s for _, s in Partitioner._param_leaves(model)]
        out = []
        for slot, key in SLOTS[optimizer.kind].items():
            out += [(f".{slot}['{n}']", s, i) for i, (n, s) in enumerate(zip(names, shapes))]
        if optimizer.accum > 1:
            out += [(f".acc['{n}']", s, i) for i, (n, s) in enumerate(zip(names, shapes))]
        return out

    def _state_sharding_with_report(self, model, optimizer=None):
        """(param dims, opt dims or None, replicated paths) under this
        partitioner's layout."""
        c = self.config
        replicated: List[str] = []
        params = self._param_leaves(model)
        opt = self._opt_leaves(model, optimizer) if optimizer is not None else None
        if self.single_device:
            return [None] * len(params), None if opt is None else [None] * len(opt), replicated
        if c.fsdp > 1:
            pdims = self._map_section("params", params, replicated)
            odims = None if opt is None else self._map_section("opt_state", [(p, s) for p, s, _ in opt], replicated)
        elif c.zero1 and DATA_AXIS in self.axis_names:
            pdims = [None] * len(params)
            odims = None if opt is None else self._map_section("opt_state", [(p, s) for p, s, _ in opt], replicated,
                                                               zero1=True)
        else:
            pdims = [None] * len(params)
            odims = None if opt is None else [None] * len(opt)
        return pdims, odims, replicated

    def _warn_replicated(self, paths: List[str]) -> None:
        if not paths or self._warned_replicated or get_comm_size_and_rank()[1] != 0:
            return
        self._warned_replicated = True
        axis = FSDP_AXIS if self.config.fsdp > 1 else DATA_AXIS
        width = self.config.fsdp if self.config.fsdp > 1 else self.config.data
        shown = ", ".join(paths[:8]) + (", ..." if len(paths) > 8 else "")
        warnings.warn(
            f"Partitioner: {len(paths)} state leaf(ves) have no dimension "
            f"divisible by the {axis!r} axis width {width} and stay fully "
            f"REPLICATED on every device: {shown}. Recorded in the flight "
            "manifest as parallel.replicated_leaves.",
            RuntimeWarning,
            stacklevel=3,
        )

    def state_shards(self, model, optimizer):
        """One ``LeafShard`` (or None) per parameter: the slices the rule
        runs on. Under ZeRO-1 and FSDP a parameter's optimizer tensors
        split as the parameter's master does (they share its shape)."""
        from hydragnn_tpu_torch.parallel.sharded import LeafShard

        c = self.config
        pdims, odims, _ = self._state_sharding_with_report(model, optimizer)
        if c.fsdp > 1:
            axis, dims = FSDP_AXIS, pdims
        elif c.zero1 and DATA_AXIS in self.axis_names:
            axis = DATA_AXIS
            n = len(pdims)
            dims = odims[:n] if odims else [None] * n  # every slot of a parameter splits alike
        else:
            return [None] * len(pdims)
        d_, f_, e_ = self.coords
        # the copies of a slice differ in the coordinates off its axis
        width, index, replica = (c.fsdp, f_, d_ * c.edge + e_) if axis == FSDP_AXIS else (c.data, d_, f_ * c.edge + e_)
        group = self.group(axis)
        flip = self._transposed(model)
        # the JAX axis a rule picked, as this package's axis
        dims = [None if d is None else (1 - d if name in flip else d)
                for (name, _), d in zip(model.named_parameters(), dims)]
        return [None if d is None else LeafShard(d, width, index, group, replica) for d in dims]

    def broadcast_model(self, model) -> None:
        """Every rank starts from rank 0's parameters and statistics."""
        if self.single_device:
            return
        import torch.distributed as dist

        tensors = list(model.parameters()) + [b for b in model.buffers() if b.is_floating_point()]
        with torch.no_grad():
            flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
            dist.broadcast(flat, src=0)
            off = 0
            for t in tensors:
                t.copy_(flat[off:off + t.numel()].view_as(t))
                off += t.numel()

    def shard_init(self, model, optimizer):
        """Rank 0's model on every rank, SyncBatchNorm's group and the edge
        group set on the model, and the run's optimizer under this
        partitioner's layout (the optimizer itself single-device or
        replicated). Replicated-leaf fallbacks warn once, on rank 0."""
        if self.single_device:
            return optimizer
        self.mesh  # every rank builds the groups, in one order
        if getattr(model, "sharded_params", None) is not None:
            model.sharded_params.release()  # placed again: from whole parameters
        self.broadcast_model(model)
        if hasattr(model, "set_edge_group"):
            model.set_edge_group(self.edge_group)
        _, _, replicated = self._state_sharding_with_report(model, optimizer)
        self._replicated_leaves = replicated
        self._warn_replicated(replicated)
        from hydragnn_tpu_torch.parallel.sharded import place_state

        return place_state(model, optimizer, self.state_shards(model, optimizer), fsdp=self.config.fsdp > 1)

    # -- steps -------------------------------------------------------------

    def shard_train_step(self, model, optimizer, compute_dtype=None, remat: bool = False,
                         guard_nonfinite: bool = False):
        """The train step for this layout (``make_train_step``'s on a
        single device; the partitioned step, which returns the step's
        real graph count last, otherwise)."""
        from hydragnn_tpu_torch.train.state import make_train_step

        if self.single_device:
            return make_train_step(model, optimizer, compute_dtype=compute_dtype, remat=remat,
                                   guard_nonfinite=guard_nonfinite)
        if self.config.edge > 1 and compute_dtype is not None:
            raise ValueError(
                "the edge-sharded train step has no mixed-precision "
                "path; drop Training.mixed_precision or Parallel.edge"
            )
        from hydragnn_tpu_torch.parallel.sharded import make_sharded_train_step

        return make_sharded_train_step(model, optimizer, self.world_group, self.num_devices, self.config.edge,
                                       compute_dtype=compute_dtype, remat=remat, guard_nonfinite=guard_nonfinite)

    def shard_eval_step(self, model, with_outputs: bool = False):
        """``step(batch) -> (loss, tasks, outputs)`` single-device, and
        ``(loss, tasks, outputs, count)`` partitioned (``outputs``: this
        rank's rows)."""
        from hydragnn_tpu_torch.train.state import eval_step

        if self.single_device:
            return lambda batch: eval_step(model, batch)
        from hydragnn_tpu_torch.parallel.sharded import make_sharded_eval_step

        return make_sharded_eval_step(model, self.world_group, self.config.edge)

    def shard_stats_step(self, model):
        from hydragnn_tpu_torch.train.state import stats_step

        if self.single_device:
            return lambda batch: stats_step(model, batch)
        from hydragnn_tpu_torch.parallel.sharded import make_sharded_stats_step

        return make_sharded_stats_step(model, self.world_group, self.num_devices)

    # -- introspection -----------------------------------------------------

    def _section_summary(self, leaves: Sequence[Tuple[int, ...]], dims: Sequence[Optional[int]], itemsize: int,
                         width: int) -> Dict[str, Any]:
        total = per_dev = sharded = 0
        for shape, d in zip(leaves, dims):
            b = _numel(shape) * itemsize
            total += b
            if d is not None:
                per_dev += -(-b // width)
                sharded += 1
            else:
                per_dev += b
        return {"leaves": len(leaves), "sharded": sharded, "bytes_global": int(total),
                "bytes_per_device": int(per_dev)}

    def layout_fingerprint(self) -> Dict[str, Any]:
        """Compact, JSON-stable identity of the layout (the manifest's
        ``layout``, which a pod checkpoint's manifests and COMMIT stamp)."""
        c = self.config
        return {"data": int(c.data), "fsdp": int(c.fsdp), "edge": int(c.edge), "zero1": bool(c.zero1),
                "devices": None if self.single_device else int(self.num_devices),
                "hosts": get_comm_size_and_rank()[0]}

    def manifest(self, model=None, optimizer=None) -> Dict[str, Any]:
        """The flight record's ``parallel`` block: the mesh, the axis
        widths and, given the ``model`` (and its ``optimizer``), the
        parameter and optimizer-state summary (leaves, sharded leaves,
        bytes in all and on each rank) and the replicated-leaf list.
        The optimizer tensors counted are the ones of a parameter's shape
        (optax's moments; the accumulation's running mean), 4 bytes
        each. The bytes a rank reports are the ones it holds between
        steps (``sharded.held_bytes``): FSDP frees the whole parameters
        after each step (module docstring of ``sharded.py``)."""
        c = self.config
        world, rank = get_comm_size_and_rank()
        info: Dict[str, Any] = {
            "available": True,
            "single_device": self.single_device,
            "mesh": None if self.single_device else {
                "shape": dict(self.mesh_shape), "axis_names": list(self.axis_names), "devices": self.num_devices},
            "data": c.data,
            "fsdp": c.fsdp,
            "edge": c.edge,
            "zero1": bool(c.zero1),
            "multihost": self.multihost,
            "device_stack": self.device_stack,
            "process_index": rank,
            "process_count": world,
            "layout": self.layout_fingerprint(),
        }
        if model is not None:
            pdims, odims, replicated = self._state_sharding_with_report(model, optimizer)
            pshapes = [s for _, s in self._param_leaves(model)]
            width = c.fsdp if c.fsdp > 1 else c.data
            info["params"] = self._section_summary(pshapes, pdims, 4, width)
            if optimizer is not None:
                oshapes = [s for _, s, _ in self._opt_leaves(model, optimizer)]
                info["opt"] = self._section_summary(oshapes, odims, 4, width)
            info["replicated_leaves"] = list(replicated)
        return info


def parallel_manifest_summary(par: Dict[str, Any]) -> str:
    """One-line human rendering of a flight ``parallel`` block."""
    mesh = par.get("mesh")
    if not mesh:
        shape = "single-device"
    else:
        shape = "×".join(f"{k}{v}" for k, v in (mesh.get("shape") or {}).items())
    parts = [f"mesh={shape}", f"fsdp={par.get('fsdp', 1)}"]
    p = par.get("params")
    if p:
        parts.append(
            f"params {p['sharded']}/{p['leaves']} leaves sharded, "
            f"{p['bytes_per_device']}/{p['bytes_global']} B/device"
        )
    o = par.get("opt")
    if o:
        parts.append(
            f"opt {o['sharded']}/{o['leaves']} sharded, "
            f"{o['bytes_per_device']}/{o['bytes_global']} B/device"
        )
    reps = par.get("replicated_leaves")
    if reps:
        parts.append(f"replicated_leaves={len(reps)}")
    return " ".join(parts)
