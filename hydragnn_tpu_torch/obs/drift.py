"""The drift reference window (the reference half of
``hydragnn_tpu/obs/drift.py``: ``build_reference`` and the helpers it
uses, copied).

The training loop stamps ``build_reference`` of the train split into its
``run_start`` manifest as ``stats``: per node-feature channel and per
head target, the mean, standard deviation, probe quantiles and a
histogram, over at most 512 samples. A serving run loads it as the
reference it compares live traffic against; the live half
(``DriftMonitor``, ``load_reference``) waits for ROADMAP A-6b.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np

REFERENCE_SCHEMA = 1

# probe quantiles of the reference window (and of the live sketches)
QUANTILE_PROBES = (0.05, 0.5, 0.95)

_EPS = 1e-4


def _value_stats(values: np.ndarray, *, bins: int, quantiles: Sequence[float]) -> Dict[str, Any]:
    v = np.asarray(values, dtype=np.float64).ravel()
    lo = float(v.min())
    hi = float(v.max())
    if not hi > lo:
        hi = lo + 1.0
    edges = np.linspace(lo, hi, bins + 1)
    counts, _ = np.histogram(v, bins=edges)
    total = max(1, int(counts.sum()))
    return {
        "mean": float(v.mean()),
        "std": float(v.std()),
        "quantiles": {str(q): float(np.quantile(v, q)) for q in quantiles},
        "edges": [float(x) for x in edges],
        "fracs": [float(c) / total for c in counts],
    }


def build_reference(
    samples: Sequence[Any],
    *,
    head_names: Sequence[str] = (),
    bins: int = 16,
    max_samples: int = 512,
    quantiles: Sequence[float] = QUANTILE_PROBES,
) -> Dict[str, Any]:
    """The drift reference window of the first ``max_samples`` training
    samples: per node-feature channel the stats of ``_value_stats``, per
    head the same over the training targets plus ``scale`` (the standard
    deviation, at least 1e-4)."""
    sub = list(samples)[: max(1, int(max_samples))]
    if not sub:
        raise ValueError("build_reference needs at least one sample")
    x = np.concatenate([np.asarray(s.x, dtype=np.float64) for s in sub], axis=0)
    if x.ndim == 1:
        x = x[:, None]
    channels = [_value_stats(x[:, c], bins=bins, quantiles=quantiles) for c in range(x.shape[1])]

    heads: Dict[str, Any] = {}
    names = list(head_names)
    if not names:
        names = sorted(set(sub[0].graph_targets.keys()) | set(sub[0].node_targets.keys()))
    for name in names:
        vals = []
        for s in sub:
            t = s.graph_targets.get(name)
            if t is None:
                t = s.node_targets.get(name)
            if t is not None:
                vals.append(np.asarray(t, dtype=np.float64).ravel())
        if not vals:
            continue
        stats = _value_stats(np.concatenate(vals), bins=bins, quantiles=quantiles)
        stats["scale"] = max(stats["std"], _EPS)
        heads[name] = stats

    return {
        "schema": REFERENCE_SCHEMA,
        "num_samples": len(sub),
        "num_rows": int(x.shape[0]),
        "quantile_probes": [float(q) for q in quantiles],
        "feature": {"channels": channels},
        "heads": heads,
    }
