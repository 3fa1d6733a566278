"""The fleet: N supervised replicas, one router, one metrics registry (the
port's counterpart of ``hydragnn_tpu/fleet/fleet.py``).

One :class:`Fleet` serves several models behind one admission front door,
composed from what exists:

  - replicas are :class:`~hydragnn_tpu_torch.serve.server.ModelServer`
    instances wrapped by :class:`~hydragnn_tpu_torch.fleet.replica.
    FleetReplica`. There is no executable cache (ROADMAP: out of scope;
    a CUDA graph cannot be kept across processes), so every replica
    captures its own graphs at its start, and the JAX fleet's
    ``exec_cache_dir`` has no counterpart here;
  - every replica owns its weights: the fleet keeps a model's weights as
    a host state dict and builds each replica's ``ServedModel`` with a
    module of its own, so a replica's reload changes no other replica's
    answers. (The JAX fleet hands one ``ServedModel`` to every replica
    and its reload rebinds the shared ``variables``, so one replica's
    reload switches them all: ROADMAP C7; ``docs/FLEET.md`` promises the
    one-at-a-time roll this fleet does);
  - each replica's metrics live on the fleet registry under
    ``fleet.<replica>.*`` (the ``ServeMetrics`` prefix), beside the
    router's aggregates the autoscaler reads;
  - scale-up serves the busiest model, scale-down drains the least-loaded
    replica (never orphaning a model);
  - :meth:`Fleet.rolling_reload` walks a model's replicas one at a time
    (router pause, drain, the server's own canaried ``reload()``, resume),
    so N-1 replicas serve throughout, and a failure aborts the roll with
    the remaining replicas on the old weights (a ``fleet_reload`` flight
    event each replica). A roll that completes becomes the model's
    weights, which later spawns serve. A model's roll, its spawns and its
    retirements take turns on the model's lock, so no replica joins or
    leaves a roll under way.

All replica servers share the fleet's flight recorder: one JSONL holds
every replica's ``run_start``, the scale decisions and the reloads.
Replicas on one card capture one graph at a time against the others'
replays (``serve/buckets.py:DEVICE_LOCK``).
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import Any, Dict, List, Optional, Sequence

import torch

from hydragnn_tpu_torch.fleet.replica import FleetReplica, ReplicaFailed, write_probe_textfile
from hydragnn_tpu_torch.fleet.router import FleetRouter, RouterConfig, TenantQuota
from hydragnn_tpu_torch.obs.flight import FlightRecorder
from hydragnn_tpu_torch.obs.registry import MetricsRegistry
from hydragnn_tpu_torch.serve.buckets import DEVICE_LOCK, build_bucket_ladder, build_module
from hydragnn_tpu_torch.serve.metrics import ServeMetrics
from hydragnn_tpu_torch.serve.registry import ServedModel
from hydragnn_tpu_torch.serve.server import ModelServer, ReloadFailed, ServeConfig
from hydragnn_tpu_torch.utils import syncdebug


def _host_state(state) -> Dict[str, torch.Tensor]:
    return {k: v.detach().to("cpu", copy=True) for k, v in state.items()}


@dataclasses.dataclass
class _ModelGroup:
    """One registered model: what a spawn needs to build its server. The
    weights are a host state dict, never a module a server holds."""

    name: str
    served_name: str
    cfg: Any  # the model config (``HydraModel.cfg``)
    nn_config: Optional[Dict[str, Any]]
    device: torch.device
    state: Dict[str, torch.Tensor]  # written under ``lock``
    reference_samples: Sequence
    serve_config: ServeConfig
    # held by a roll, and by a spawn or a retirement of one of the model's
    # replicas: a replica joins or leaves only between two rolls
    lock: Any = dataclasses.field(
        default_factory=lambda: syncdebug.maybe_wrap(threading.Lock(), "fleet._ModelGroup.lock"))


class Fleet:
    """Replica orchestration over one shared router and registry.

    ``registry`` defaults to a private :class:`MetricsRegistry`; pass a
    shared one to keep the fleet's metrics with a larger process's.
    """

    def __init__(
        self,
        registry: Optional[MetricsRegistry] = None,
        flight=None,
        router_config: Optional[RouterConfig] = None,
        quotas: Optional[Dict[str, TenantQuota]] = None,
    ):
        self.registry = registry if registry is not None else MetricsRegistry()
        self.flight = flight if flight is not None else FlightRecorder(None, enabled=False)
        self.router = FleetRouter(self.registry, flight=self.flight, quotas=quotas, config=router_config)
        self._lock = syncdebug.maybe_wrap(threading.Lock(), "fleet.Fleet._lock")
        self._models: Dict[str, _ModelGroup] = {}  # guarded by _lock
        self._next_replica = 0  # guarded by _lock

    # -- the model registry ------------------------------------------------

    def add_model(
        self,
        name: str,
        served: ServedModel,
        reference_samples: Sequence,
        serve_config: Optional[ServeConfig] = None,
        replicas: int = 1,
    ) -> List[FleetReplica]:
        """Register one model (its weights copied off ``served``, which no
        replica holds) and spawn its first replicas."""
        cfg = dataclasses.replace(
            serve_config or ServeConfig(),
            # the replicas' registries are the fleet's; its textfile would
            # not speak the probe contract, so probes go through
            # export_probes() instead
            prometheus_path=None,
        )
        group = _ModelGroup(name, served.name, served.cfg, served.nn_config, served.device,
                            _host_state(served.model.state_dict()), list(reference_samples), cfg)
        with self._lock:
            if name in self._models:
                raise ValueError(f"model {name!r} already registered")
            self._models[name] = group
        return [self._spawn(name) for _ in range(max(1, int(replicas)))]

    def models(self) -> List[str]:
        with self._lock:
            return sorted(self._models)

    # -- the replica lifecycle ---------------------------------------------

    def _spawn(self, model: str) -> FleetReplica:
        """Build, start and attach one replica of ``model``: a module of
        its own loaded with the model's weights, its metrics under
        ``fleet.<name>``, its graphs captured. Any failure raises
        :class:`ReplicaFailed`; the fleet and the controller survive it.
        It holds the model's lock from reading the weights to joining the
        router, so it waits out a roll and serves what the roll made."""
        with self._lock:
            group = self._models.get(model)
            rname = f"r{self._next_replica}"
            self._next_replica += 1
        if group is None:
            raise ReplicaFailed(f"unknown model {model!r}")
        with group.lock:
            return self._spawn_locked(group, rname)

    def _spawn_locked(self, group: _ModelGroup, rname: str) -> FleetReplica:
        model = group.name
        try:
            cfg = group.serve_config
            # the ladder is deterministic in (samples, config), so the
            # metrics can be sized before the server builds its own
            n_buckets = len(build_bucket_ladder(group.reference_samples, cfg.max_batch, num_buckets=cfg.num_buckets,
                                                node_multiple=cfg.node_multiple, edge_multiple=cfg.edge_multiple))
            metrics = ServeMetrics(n_buckets, latency_window=cfg.latency_window, registry=self.registry,
                                   prefix=f"fleet.{rname}")
            module = build_module(group.cfg, group.device, group.state)
            served = ServedModel(name=group.served_name, model=module, device=group.device,
                                 nn_config=group.nn_config)
            server = ModelServer(served, group.reference_samples, cfg, metrics=metrics, flight=self.flight)
            server.start()
        except Exception as exc:
            raise ReplicaFailed(f"spawning replica {rname} for model {model!r} failed: {exc!r}") from exc
        replica = FleetReplica(rname, model, server)
        self.router.attach(replica)
        return replica

    def replica_count(self) -> int:
        return len(self.router.replicas())

    def replicas(self) -> List[FleetReplica]:
        return self.router.replicas()

    def get_replica(self, name: str) -> Optional[FleetReplica]:
        for r in self.router.replicas():
            if r.name == name:
                return r
        return None

    def dead_replicas(self) -> List[str]:
        """The attached replicas that are no longer live (the controller's
        reap)."""
        return [r.name for r in self.router.replicas() if not r.live]

    def total_load(self) -> int:
        return self.router.total_load()

    # -- the controller's verbs --------------------------------------------

    def scale_up(self, reason: str = "manual") -> str:
        """Spawn one replica of the busiest model; returns its name."""
        with self._lock:
            names = sorted(self._models)
        if not names:
            raise ReplicaFailed("no model registered")
        loads = {n: 0 for n in names}
        for r in self.router.replicas():
            if r.model in loads:
                loads[r.model] += r.load()
        busiest = max(names, key=lambda n: loads[n])
        return self._spawn(busiest).name

    def scale_down(self, reason: str = "manual", timeout: Optional[float] = 30.0) -> str:
        """Retire the least-loaded replica whose model keeps another one,
        draining it first; returns its name."""
        replicas = self.router.replicas()
        per_model: Dict[str, int] = {}
        for r in replicas:
            per_model[r.model] = per_model.get(r.model, 0) + 1
        candidates = [r for r in replicas if per_model[r.model] > 1]
        if not candidates and len(per_model) == 1:
            candidates = replicas  # one model: min_replicas is the floor, not coverage
        if not candidates:
            raise ReplicaFailed("no replica can be retired without orphaning a model")
        victim = min(candidates, key=lambda r: r.load())
        with self._lock:
            group = self._models[victim.model]
        with group.lock:  # not out of a roll under way
            if self.router.detach(victim.name) is None:
                raise ReplicaFailed(f"replica {victim.name} left the fleet before it could be retired")
        victim.drain_stop(timeout)
        return victim.name

    def replace(self, name: str, reason: str = "dead_replica") -> str:
        """Reap one dead replica and spawn its replacement (the same
        model). The dead server is stopped to end its record only: its
        queue failed every request, typed, when it died."""
        dead = self.router.detach(name)
        if dead is None:
            raise ReplicaFailed(f"no attached replica named {name!r}")
        try:
            dead.server.stop(timeout=1.0)
        except Exception:
            pass  # dead already, and loudly so
        return self._spawn(dead.model).name

    # -- the rolling reload ------------------------------------------------

    def rolling_reload(
        self,
        model: str,
        checkpoint: Optional[str] = None,
        *,
        variables: Optional[Dict[str, Any]] = None,
        log_dir: Optional[str] = None,
        drain_timeout_s: float = 30.0,
    ) -> List[Dict[str, Any]]:
        """Reload every replica of ``model``, one at a time and in name
        order: the router stops placing on it, its in-flight work drains,
        its server's canaried ``reload()`` swaps its weights (rollback
        built in), and it rejoins placement, so N-1 replicas serve
        throughout. A replica that died, or a reload that failed, aborts
        the roll with the remaining replicas on the old weights and raises
        :class:`ReloadFailed`. A roll that completes becomes the model's
        weights for later spawns. It holds the model's lock throughout:
        a spawn or a retirement of the model's replicas waits for it."""
        with self._lock:
            group = self._models.get(model)
        if group is None:
            raise ReplicaFailed(f"no replicas serving model {model!r}")
        with group.lock:
            return self._roll_locked(group, checkpoint, variables, log_dir, drain_timeout_s)

    def _roll_locked(self, group: _ModelGroup, checkpoint, variables, log_dir, drain_timeout_s):
        model = group.name
        targets = [r for r in self.router.replicas() if r.model == model]
        if not targets:
            raise ReplicaFailed(f"no replicas serving model {model!r}")
        outcomes: List[Dict[str, Any]] = []
        for r in sorted(targets, key=lambda x: x.name):
            self.router.pause(r.name)
            r.drain(drain_timeout_s)
            if not r.live:
                # it died mid-roll (its queued futures failed typed when it
                # died): abort with every remaining replica on the old
                # weights; the controller's reap owns the corpse
                r.undrain()
                self.router.resume(r.name)
                self.flight.record("fleet_reload", model=model, replica=r.name, ok=False,
                                   error="replica died mid-roll", aborted_roll=True)
                raise ReloadFailed(f"rolling reload of {model!r} aborted: replica {r.name} died mid-roll; "
                                   "remaining replicas still serve the previous weights")
            try:
                info = r.server.reload(checkpoint, variables=variables, log_dir=log_dir)
            except ReloadFailed as exc:
                # the old weights still serve on this replica too
                r.undrain()
                self.router.resume(r.name)
                self.flight.record("fleet_reload", model=model, replica=r.name, ok=False, error=repr(exc)[-200:],
                                   aborted_roll=True)
                raise
            r.undrain()
            self.router.resume(r.name)
            outcomes.append({"replica": r.name, "ok": True, **info})
            self.flight.record("fleet_reload", model=model, replica=r.name, ok=True, swap_s=info.get("swap_s"))
        with DEVICE_LOCK.shared():
            state = _host_state(r.server.served.model.state_dict())
        group.state = state
        return outcomes

    # -- the request path --------------------------------------------------

    def submit(self, sample, tenant: str = "default", model: Optional[str] = None):
        return self.router.submit(sample, tenant=tenant, model=model)

    def predict(self, sample, tenant: str = "default", model: Optional[str] = None,
                timeout: Optional[float] = None):
        return self.router.predict(sample, tenant=tenant, model=model, timeout=timeout)

    # -- health and probes -------------------------------------------------

    def health(self) -> Dict[str, Any]:
        replicas = {r.name: r.health() for r in self.router.replicas()}
        return {
            "replicas": replicas,
            "replica_count": len(replicas),
            "ready_count": sum(1 for h in replicas.values() if h["ready"]),
            "live_count": sum(1 for h in replicas.values() if h["live"]),
            "total_load": self.total_load(),
            "models": self.models(),
        }

    def export_probes(self, directory: str) -> List[str]:
        """One probe textfile a replica (``<name>.prom``) and the router's
        ``router.prom`` (ready: some replica routable), under the standard
        gauge names: what ``tools/serve_probe.py --fleet`` aggregates."""
        os.makedirs(directory, exist_ok=True)
        paths: List[str] = []
        replicas = self.router.replicas()
        for r in replicas:
            p = os.path.join(directory, f"{r.name}.prom")
            r.export_probe(p)
            paths.append(p)
        router_path = os.path.join(directory, "router.prom")
        write_probe_textfile(router_path, live=any(r.live for r in replicas), ready=any(r.ready for r in replicas))
        paths.append(router_path)
        return paths

    # -- teardown ----------------------------------------------------------

    def stop(self, timeout: Optional[float] = 10.0) -> None:
        """Drain and stop every replica, each detached first so nothing
        new lands while it drains."""
        for r in self.router.replicas():
            self.router.detach(r.name)
            try:
                r.drain_stop(timeout)
            except Exception:
                pass  # teardown is best-effort; each server ends its own record

    def __enter__(self) -> "Fleet":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
