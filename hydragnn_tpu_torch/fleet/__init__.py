"""The autoscaling multi-tenant serving fleet (the port's counterpart of
``hydragnn_tpu/fleet/``, held to ``docs/FLEET.md``): N supervised
:class:`~hydragnn_tpu_torch.serve.server.ModelServer` replicas, each with
its own weights and CUDA graphs, behind one admission router with
per-tenant quotas and priority classes, scaled by a trigger-driven
controller and reloaded one replica at a time. A composition layer:
batching, buckets, canaried reloads, triggers and traces come from
``serve/`` and ``obs/`` unchanged."""

from hydragnn_tpu_torch.fleet.controller import ControllerConfig, FleetController
from hydragnn_tpu_torch.fleet.fleet import Fleet
from hydragnn_tpu_torch.fleet.replica import FleetReplica, ReplicaFailed, write_probe_textfile
from hydragnn_tpu_torch.fleet.router import FleetRouter, RouterConfig, TenantOverloaded, TenantQuota

__all__ = [
    "ControllerConfig",
    "Fleet",
    "FleetController",
    "FleetReplica",
    "FleetRouter",
    "ReplicaFailed",
    "RouterConfig",
    "TenantOverloaded",
    "TenantQuota",
    "write_probe_textfile",
]
