"""Exporters of the metrics registry: tensorboard, JSONL and the
Prometheus textfile.

The port's counterpart of ``hydragnn_tpu/obs/export.py``, with the same
metric names (``hydragnn_serve_ready`` among them), so the repository's
``tools/serve_probe.py`` reads the port's textfile unchanged:

  - tensorboard through ``utils/tensorboard.py:write_scalar_dict``;
  - JSONL: one snapshot line a call;
  - the Prometheus textfile-collector format, written to a sibling
    temporary file and renamed over the target (the collector may read
    at any moment and must never see half a file), with the process
    rank as a label.

Every exporter works on a snapshot taken under the registry's locks.
"""

from __future__ import annotations

import json
import os
import re
import time
from typing import Optional

from hydragnn_tpu_torch.obs.registry import Counter, Gauge, Histogram, MetricsRegistry

_PROM_BAD = re.compile(r"[^a-zA-Z0-9_:]")


def registry_to_tensorboard(writer, registry: MetricsRegistry, step: int, prefix: str = "obs") -> int:
    """Write a registry snapshot as scalar tags; returns how many."""
    from hydragnn_tpu_torch.utils.tensorboard import write_scalar_dict

    return write_scalar_dict(writer, registry.snapshot(), step, prefix=prefix)


def registry_to_jsonl(path: str, registry: MetricsRegistry, extra: Optional[dict] = None) -> None:
    """Append one line ``{"t", "rank", "metrics"}`` (and ``extra``'s
    keys) to ``path``."""
    line = {"t": round(time.time(), 3), "rank": registry.rank, "metrics": registry.snapshot()}
    if extra:
        line.update(extra)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(line) + "\n")


def prometheus_name(name: str, prefix: str = "hydragnn") -> str:
    """Dotted metric path -> a legal Prometheus metric name."""
    return _PROM_BAD.sub("_", f"{prefix}_{name.replace('.', '_')}")


def registry_to_prometheus_text(registry: MetricsRegistry, prefix: str = "hydragnn") -> str:
    """The registry in Prometheus exposition format: counters and gauges
    one sample each (a gauge also its ``_peak``), histograms as a
    summary (quantiles, ``_count``, ``_sum``)."""
    rank = registry.rank
    label = f'{{rank="{rank}"}}'
    lines = []
    for name in registry.names():
        metric = registry.get(name)
        pname = prometheus_name(name, prefix)
        if isinstance(metric, Histogram):
            snap = metric.snapshot()
            lines.append(f"# TYPE {pname} summary")
            for q in ("p50", "p95", "p99"):
                lines.append(f'{pname}{{rank="{rank}",quantile="0.{q[1:]}"}} {snap[q]}')
            lines.append(f"{pname}_count{label} {snap['count']}")
            lines.append(f"{pname}_sum{label} {snap['sum']}")
        elif isinstance(metric, Gauge):
            lines.append(f"# TYPE {pname} gauge")
            lines.append(f"{pname}{label} {metric.value}")
            lines.append(f"# TYPE {pname}_peak gauge")
            lines.append(f"{pname}_peak{label} {metric.peak}")
        elif isinstance(metric, Counter):
            lines.append(f"# TYPE {pname} counter")
            lines.append(f"{pname}{label} {metric.value}")
    return "\n".join(lines) + "\n"


def registry_to_prometheus(registry: MetricsRegistry, path: str, prefix: str = "hydragnn") -> None:
    """Write the textfile snapshot atomically (a sibling temporary file,
    then a rename over ``path``)."""
    text = registry_to_prometheus_text(registry, prefix)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)
