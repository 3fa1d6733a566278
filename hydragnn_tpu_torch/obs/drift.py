"""Drift over served traffic: the reference window and the live
sketches (the port's copy of ``hydragnn_tpu/obs/drift.py``; numpy only,
the same arithmetic, so both packages give the same values).

The training loop stamps :func:`build_reference` of the train split
into its ``run_start`` manifest as ``stats``: per node-feature channel
and per head target, the mean, standard deviation, probe quantiles and
a histogram, over at most 512 samples. A serving run loads it with
:func:`load_reference` (``ServeConfig.drift_ref`` or
``HGTORCH_DRIFT_REF``: a training ``flight.jsonl``, the port's or the
JAX package's, or a bare stats JSON) into a :class:`DriftMonitor`,
which the server's dispatch thread feeds with each answered request's
host-side inputs and sliced predictions:

  - :class:`RunningMoments`: exact streaming mean and variance per
    channel (Chan's batch merge of Welford);
  - :class:`P2Quantile`: Jain and Chlamtac's P-square estimator of one
    quantile, fed a bounded row subsample of each request;
  - :func:`hist_counts`: histograms with underflow and overflow bins,
    so mass that leaves the reference's support is counted;
  - :func:`psi`: the population stability index of two bin-fraction
    vectors; the quantile shift is ``|live_q - ref_q| / ref_std``.

The seven gauges ``<prefix>.drift.{feature_psi, feature_qshift,
pred_psi, error_score, feature_rows, pred_rows, labeled_rows}`` live in
the server's registry; the ``feature_drift``, ``pred_drift`` and
``error_drift`` rules of ``obs/triggers.py`` read them. They stay 0.0
until ``min_count`` rows have been observed.
"""

from __future__ import annotations

import bisect
import json
import math
import os
from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np

from hydragnn_tpu_torch.obs.flight import read_flight_record

REFERENCE_SCHEMA = 1
DRIFT_REPORT_SCHEMA = 1

# Probe quantiles tracked by both the reference window and the live P²
# sketches; the quantile-shift distance compares them pairwise.
QUANTILE_PROBES = (0.05, 0.5, 0.95)

_EPS = 1e-4


class RunningMoments:
    """Exact streaming mean/variance per channel (Chan's parallel
    batch-merge of Welford), vectorised over a fixed channel count."""

    def __init__(self, num_channels: int):
        self.count = 0
        self.mean = np.zeros(num_channels, dtype=np.float64)
        self._m2 = np.zeros(num_channels, dtype=np.float64)

    def update(self, rows: np.ndarray) -> None:
        """Merge a batch of shape ``[n, channels]`` (or ``[n]`` for a
        single channel) into the running moments."""
        arr = np.asarray(rows, dtype=np.float64)
        if arr.ndim == 1:
            arr = arr[:, None]
        n = arr.shape[0]
        if n == 0:
            return
        mean_b = arr.mean(axis=0)
        m2_b = ((arr - mean_b) ** 2).sum(axis=0)
        if self.count == 0:
            self.count, self.mean, self._m2 = n, mean_b, m2_b
            return
        delta = mean_b - self.mean
        total = self.count + n
        self._m2 = self._m2 + m2_b + delta**2 * (self.count * n / total)
        self.mean = self.mean + delta * (n / total)
        self.count = total

    @property
    def variance(self) -> np.ndarray:
        if self.count < 2:
            return np.zeros_like(self.mean)
        return self._m2 / self.count

    @property
    def std(self) -> np.ndarray:
        return np.sqrt(self.variance)


class P2Quantile:
    """Jain & Chlamtac's P² estimator for one quantile of one stream.

    Five markers track (min, p/2, p, (1+p)/2, max); marker heights move
    by piecewise-parabolic interpolation as observations arrive.  Exact
    until 5 observations (sorted buffer), approximate after.
    """

    def __init__(self, p: float):
        if not 0.0 < p < 1.0:
            raise ValueError(f"quantile p must be in (0, 1), got {p}")
        self.p = float(p)
        self.count = 0
        self._q: List[float] = []  # marker heights
        self._n: List[float] = []  # marker positions (1-based)
        self._np: List[float] = []  # desired positions
        self._dn: List[float] = []  # desired-position increments

    def add(self, x: float) -> None:
        x = float(x)
        self.count += 1
        if self.count <= 5:
            bisect.insort(self._q, x)
            if self.count == 5:
                p = self.p
                self._n = [1.0, 2.0, 3.0, 4.0, 5.0]
                self._np = [1.0, 1 + 2 * p, 1 + 4 * p, 3 + 2 * p, 5.0]
                self._dn = [0.0, p / 2, p, (1 + p) / 2, 1.0]
            return
        q, n = self._q, self._n
        if x < q[0]:
            q[0] = x
            k = 0
        elif x >= q[4]:
            q[4] = x
            k = 3
        else:
            k = 3
            for i in range(1, 5):
                if x < q[i]:
                    k = i - 1
                    break
        for i in range(k + 1, 5):
            n[i] += 1.0
        for i in range(5):
            self._np[i] += self._dn[i]
        for i in range(1, 4):
            d = self._np[i] - n[i]
            if (d >= 1.0 and n[i + 1] - n[i] > 1.0) or (
                d <= -1.0 and n[i - 1] - n[i] < -1.0
            ):
                sign = 1.0 if d > 0 else -1.0
                cand = self._parabolic(i, sign)
                if not q[i - 1] < cand < q[i + 1]:
                    cand = self._linear(i, sign)
                q[i] = cand
                n[i] += sign

    def _parabolic(self, i: int, d: float) -> float:
        q, n = self._q, self._n
        return q[i] + d / (n[i + 1] - n[i - 1]) * (
            (n[i] - n[i - 1] + d) * (q[i + 1] - q[i]) / (n[i + 1] - n[i])
            + (n[i + 1] - n[i] - d) * (q[i] - q[i - 1]) / (n[i] - n[i - 1])
        )

    def _linear(self, i: int, d: float) -> float:
        q, n = self._q, self._n
        j = i + int(d)
        return q[i] + d * (q[j] - q[i]) / (n[j] - n[i])

    @property
    def value(self) -> float:
        if self.count == 0:
            return float("nan")
        if self.count <= 5:
            s = self._q
            idx = self.p * (len(s) - 1)
            lo = int(math.floor(idx))
            hi = min(lo + 1, len(s) - 1)
            return s[lo] + (s[hi] - s[lo]) * (idx - lo)
        return self._q[2]


def hist_counts(values: np.ndarray, edges: np.ndarray) -> np.ndarray:
    """Histogram ``values`` against ``edges`` with explicit underflow /
    overflow bins: returns ``len(edges) + 1`` counts where ``[0]`` is
    mass below ``edges[0]`` and ``[-1]`` is mass strictly above
    ``edges[-1]``.  Shifted traffic that leaves the reference support
    lands in the outer bins instead of vanishing.  Values exactly at
    the top edge stay in the last inner bin (np.histogram's closed
    right edge) — the reference fracs were built with that convention,
    and discrete features routinely put real mass exactly at the
    reference max, so the two sides MUST agree bin-for-bin."""
    v = np.asarray(values, dtype=np.float64).ravel()
    e = np.asarray(edges, dtype=np.float64)
    inner, _ = np.histogram(v, bins=e)
    under = int((v < e[0]).sum())
    over = int((v > e[-1]).sum())
    return np.concatenate([[under], inner.astype(np.int64), [over]])


def psi(ref_fracs: Sequence[float], cur_fracs: Sequence[float], eps: float = _EPS) -> float:
    """Population Stability Index between two bin-fraction vectors of
    equal length.  Both sides are eps-clipped and renormalised, so
    empty bins contribute boundedly instead of producing infinities."""
    r = np.clip(np.asarray(ref_fracs, dtype=np.float64), eps, None)
    c = np.clip(np.asarray(cur_fracs, dtype=np.float64), eps, None)
    r = r / r.sum()
    c = c / c.sum()
    return float(np.sum((c - r) * np.log(c / r)))


def _padded_ref_fracs(fracs: Sequence[float]) -> np.ndarray:
    """Reference fractions extended with empty under/overflow bins to
    match :func:`hist_counts` layout."""
    f = np.asarray(fracs, dtype=np.float64)
    return np.concatenate([[0.0], f, [0.0]])


def _value_stats(
    values: np.ndarray, *, bins: int, quantiles: Sequence[float]
) -> Dict[str, Any]:
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
    """Build the drift reference window from training samples.

    Per node-feature channel: mean/std, probe quantiles, and a
    ``bins``-bucket histogram (edges + fractions).  Per head: the same
    stats over the *training targets* — the best available stand-in
    for healthy prediction mass (a well-fit model's predictions track
    its targets), and the scale the error-drift track normalises by.
    Bounded to ``max_samples`` samples so manifest stamping stays
    cheap on large runs.
    """
    sub = list(samples)[: max(1, int(max_samples))]
    if not sub:
        raise ValueError("build_reference needs at least one sample")
    x = np.concatenate([np.asarray(s.x, dtype=np.float64) for s in sub], axis=0)
    if x.ndim == 1:
        x = x[:, None]
    channels = [
        _value_stats(x[:, c], bins=bins, quantiles=quantiles)
        for c in range(x.shape[1])
    ]

    heads: Dict[str, Any] = {}
    names = list(head_names)
    if not names:
        names = sorted(
            set(sub[0].graph_targets.keys()) | set(sub[0].node_targets.keys())
        )
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


def load_reference(path: str) -> Dict[str, Any]:
    """Load a drift reference window from ``path``: either a training
    ``flight.jsonl`` (the ``run_start.manifest["stats"]`` block) or a
    bare stats JSON file (e.g. one written by
    ``python -m hydragnn_tpu_torch.tools.drift_report --export-ref``)."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"drift reference not found: {path}")
    if path.endswith(".jsonl"):
        for event in read_flight_record(path):
            if event.get("kind") != "run_start":
                continue
            stats = (event.get("manifest") or {}).get("stats")
            if stats:
                return _check_reference(stats, path)
        raise ValueError(
            f"no run_start.manifest.stats block in flight record {path} "
            "(was the training run recorded before drift support?)"
        )
    with open(path) as f:
        return _check_reference(json.load(f), path)


def _check_reference(stats: Mapping[str, Any], origin: str) -> Dict[str, Any]:
    if int(stats.get("schema", -1)) != REFERENCE_SCHEMA:
        raise ValueError(
            f"drift reference {origin} has schema {stats.get('schema')!r}, "
            f"expected {REFERENCE_SCHEMA}"
        )
    channels = (stats.get("feature") or {}).get("channels") or []
    if not channels:
        raise ValueError(f"drift reference {origin} has no feature channels")
    return dict(stats)


class _HeadSketch:
    """Live sketch for one output head's prediction stream.

    Prediction drift is SELF-BASELINED: the first ``baseline_rows``
    live prediction values form a frozen baseline window (its own bin
    edges + fractions), and later traffic is PSI-compared against it.
    The training reference is deliberately NOT the pred baseline — the
    reference head stats describe the *label* distribution, and an
    imperfectly fit model would read as permanent "drift" on perfectly
    clean traffic.  Self-baselining makes ``pred_psi`` mean "the
    prediction distribution CHANGED during this serve session" (a bad
    weight reload, an upstream shift arriving mid-run) and stays quiet
    on a stable, merely-imperfect model.  Feature drift and the
    error-score scale still compare against the training reference.
    """

    def __init__(
        self,
        *,
        bins: int = 8,
        baseline_rows: int = 64,
        baseline_requests: int = 8,
    ):
        # Coarse bins on purpose: the PSI sampling noise between two
        # clean windows scales ~bins/rows, and a wholesale distribution
        # shift saturates even 8 bins.  The baseline must ALSO span
        # several requests — node-head slices deliver a whole graph's
        # rows at once, and one graph is not a traffic distribution.
        self.bins = int(bins)
        self.baseline_rows = max(2, int(baseline_rows))
        self.baseline_requests = max(1, int(baseline_requests))
        self._buffer: List[float] = []
        self._updates = 0
        self._live_updates = 0
        self.base_requests = 0
        self.edges: Optional[np.ndarray] = None
        self.base_fracs: Optional[np.ndarray] = None
        self.counts: Optional[np.ndarray] = None
        self.moments = RunningMoments(1)

    def update(self, values: np.ndarray) -> None:
        v = np.asarray(values, dtype=np.float64).ravel()
        if v.size == 0:
            return
        self.moments.update(v)
        if self.base_fracs is None:
            self._updates += 1
            self._buffer.extend(float(x) for x in v)
            if (
                len(self._buffer) >= self.baseline_rows
                and self._updates >= self.baseline_requests
            ):
                self._freeze_baseline()
            return
        self._live_updates += 1
        self.counts += hist_counts(v, self.edges)

    def _freeze_baseline(self) -> None:
        arr = np.asarray(self._buffer, dtype=np.float64)
        lo, hi = float(arr.min()), float(arr.max())
        if hi - lo < _EPS:
            # Degenerate (near-constant) baseline: widen so the inner
            # bins exist and any later movement lands in the outer bins.
            pad = max(abs(lo), 1.0) * 1e-3
            lo, hi = lo - pad, hi + pad
        self.edges = np.linspace(lo, hi, self.bins + 1)
        base = hist_counts(arr, self.edges).astype(np.float64)
        self.base_requests = self._updates
        self.base_fracs = base / base.sum()
        self.counts = np.zeros(len(self.edges) + 1, dtype=np.int64)
        self._buffer = []

    @property
    def count(self) -> int:
        """Total prediction rows observed (baseline + live)."""
        return self.moments.count

    @property
    def live_rows(self) -> int:
        """Rows observed AFTER the baseline window froze."""
        return 0 if self.counts is None else int(self.counts.sum())

    def psi(self) -> float:
        if self.base_fracs is None or self.live_rows == 0:
            return 0.0
        raw = psi(self.base_fracs, self.counts / self.live_rows)
        # Two finite windows of the SAME distribution still measure
        # E[PSI] ≈ (K-1)(1/n_base + 1/n_live) (first-order chi-square
        # bias) — subtract it so clean windows read ~0 while a real
        # shift (PSI in whole units) barely notices.  The effective
        # sample size is the REQUEST count, not the row count: a node
        # head's rows arrive one whole graph at a time and are strongly
        # correlated within it, so counting rows would understate the
        # noise floor ~nodes-per-graph-fold.
        k = len(self.base_fracs)
        noise = (k - 1) * (
            1.0 / max(self.base_requests, 1)
            + 1.0 / max(self._live_updates, 1)
        )
        return max(0.0, raw - noise)


class DriftMonitor:
    """Streaming drift state for one server, fed from host-side arrays.

    Not thread-safe by itself: the server calls :meth:`observe` from
    its single dispatch thread and reads the resulting gauges from the
    trigger engine via the (thread-safe) metrics registry.
    """

    def __init__(
        self,
        reference: Mapping[str, Any],
        registry: Any,
        *,
        prefix: str = "serve",
        min_count: int = 64,
        min_labeled: int = 8,
        quantile_rows: int = 8,
    ):
        self.reference = _check_reference(reference, "<inline>")
        self.prefix = prefix
        self.min_count = int(min_count)
        self.min_labeled = int(min_labeled)
        self.quantile_rows = max(1, int(quantile_rows))

        ref_channels = self.reference["feature"]["channels"]
        self.num_channels = len(ref_channels)
        self._ref_channels = ref_channels
        self._edges = [
            np.asarray(ch["edges"], dtype=np.float64) for ch in ref_channels
        ]
        self._ref_fracs = [
            _padded_ref_fracs(ch["fracs"]) for ch in ref_channels
        ]
        self._counts = [
            np.zeros(len(e) + 1, dtype=np.int64) for e in self._edges
        ]
        self.moments = RunningMoments(self.num_channels)
        probes = [float(q) for q in self.reference.get("quantile_probes", QUANTILE_PROBES)]
        self._probes = probes
        self._p2 = [
            {q: P2Quantile(q) for q in probes} for _ in range(self.num_channels)
        ]
        # Head sketches are created lazily per predicted head name (so
        # pred drift works even when the reference carries no head
        # stats); each one self-baselines on its first min_count rows.
        self._heads: Dict[str, _HeadSketch] = {}
        self._abs_err: Dict[str, RunningMoments] = {}

        g = registry.gauge
        self._g_feature_psi = g(f"{prefix}.drift.feature_psi")
        self._g_feature_qshift = g(f"{prefix}.drift.feature_qshift")
        self._g_pred_psi = g(f"{prefix}.drift.pred_psi")
        self._g_error_score = g(f"{prefix}.drift.error_score")
        self._g_feature_rows = g(f"{prefix}.drift.feature_rows")
        self._g_pred_rows = g(f"{prefix}.drift.pred_rows")
        self._g_labeled_rows = g(f"{prefix}.drift.labeled_rows")

    def reset(self) -> None:
        """Drop every live sketch and republish zeroed gauges, keeping
        the reference window.  Called by the retrain pilot after a
        successful canary + reload: the sketches accumulated the DRIFTED
        traffic, and without a reset the same rows would re-breach the
        threshold forever against the freshly recovered model.  Runs on
        the pilot's thread while the dispatch thread may be observing —
        callers quiesce the server (or accept one request's worth of
        interleaved updates, which the warm-up gate absorbs)."""
        self._counts = [
            np.zeros(len(e) + 1, dtype=np.int64) for e in self._edges
        ]
        self.moments = RunningMoments(self.num_channels)
        self._p2 = [
            {q: P2Quantile(q) for q in self._probes}
            for _ in range(self.num_channels)
        ]
        self._heads = {}
        self._abs_err = {}
        self._g_feature_psi.set(0.0)
        self._g_feature_qshift.set(0.0)
        self._g_pred_psi.set(0.0)
        self._g_error_score.set(0.0)
        self._publish()

    # -- ingest (dispatch thread; host-side numpy only) ---------------------

    def observe(
        self, x: np.ndarray, predictions: Mapping[str, np.ndarray]
    ) -> None:
        """Fold one request's featurized inputs ``x`` (``[n, channels]``)
        and its per-head prediction slices into the sketches, then
        republish the drift gauges."""
        rows = np.asarray(x, dtype=np.float64)
        if rows.ndim == 1:
            rows = rows[:, None]
        if rows.shape[1] != self.num_channels:
            raise ValueError(
                f"drift monitor built for {self.num_channels} feature "
                f"channels, got x with {rows.shape[1]}"
            )
        self.moments.update(rows)
        for c in range(self.num_channels):
            self._counts[c] += hist_counts(rows[:, c], self._edges[c])
        # P² marker updates are sequential per value: bound the cost per
        # request to quantile_rows rows, evenly strided over the graph.
        stride = max(1, rows.shape[0] // self.quantile_rows)
        for row in rows[::stride][: self.quantile_rows]:
            for c in range(self.num_channels):
                for est in self._p2[c].values():
                    est.add(row[c])
        for name, arr in predictions.items():
            sketch = self._heads.get(name)
            if sketch is None:
                sketch = self._heads[name] = _HeadSketch(
                    baseline_rows=self.min_count
                )
            sketch.update(np.asarray(arr))
        self._publish()

    def observe_labeled(
        self, head: str, prediction: np.ndarray, truth: np.ndarray
    ) -> None:
        """Error-drift track: fold one labelled (prediction, truth)
        pair — e.g. a spool entry whose ground truth arrived later —
        into the per-head absolute-error moments."""
        err = np.abs(
            np.asarray(prediction, dtype=np.float64).ravel()
            - np.asarray(truth, dtype=np.float64).ravel()
        )
        mom = self._abs_err.get(head)
        if mom is None:
            mom = self._abs_err[head] = RunningMoments(1)
        mom.update(err)
        self._publish()

    # -- distances -----------------------------------------------------------

    def feature_psi(self) -> List[float]:
        out = []
        for c in range(self.num_channels):
            total = int(self._counts[c].sum())
            if total == 0:
                out.append(0.0)
            else:
                out.append(psi(self._ref_fracs[c], self._counts[c] / total))
        return out

    def feature_qshift(self) -> List[float]:
        """Per channel: max over probe quantiles of
        ``|live_q - ref_q| / ref_std``."""
        out = []
        for c in range(self.num_channels):
            ref = self._ref_channels[c]
            scale = max(float(ref["std"]), _EPS)
            worst = 0.0
            for q in self._probes:
                est = self._p2[c][q]
                if est.count == 0:
                    continue
                ref_q = float(ref["quantiles"][str(q)])
                worst = max(worst, abs(est.value - ref_q) / scale)
            out.append(worst)
        return out

    def head_psi(self) -> Dict[str, float]:
        return {name: s.psi() for name, s in self._heads.items()}

    def error_scores(self) -> Dict[str, float]:
        """Per head with labelled data: live MAE over the reference
        target scale — ~O(noise/scale) when healthy, >> 1 when the
        model has gone wrong on shifted inputs."""
        out = {}
        for name, mom in self._abs_err.items():
            ref = (self.reference.get("heads") or {}).get(name) or {}
            scale = max(float(ref.get("scale", ref.get("std", 1.0)) or 1.0), _EPS)
            out[name] = float(mom.mean[0]) / scale
        return out

    # -- gauge publication ---------------------------------------------------

    @property
    def feature_rows(self) -> int:
        return self.moments.count

    @property
    def pred_rows(self) -> int:
        return sum(s.count for s in self._heads.values())

    @property
    def pred_live_rows(self) -> int:
        """Prediction rows observed after every head froze a baseline —
        the mass the pred PSI is actually computed over."""
        return sum(s.live_rows for s in self._heads.values())

    @property
    def labeled_rows(self) -> int:
        return sum(m.count for m in self._abs_err.values())

    def _publish(self) -> None:
        self._g_feature_rows.set(float(self.feature_rows))
        self._g_pred_rows.set(float(self.pred_rows))
        self._g_labeled_rows.set(float(self.labeled_rows))
        # Warm-up guard: stay at 0.0 below min_count rows so a freshly
        # started server cannot fire a drift trigger on sketch noise.
        if self.feature_rows >= self.min_count:
            self._g_feature_psi.set(max(self.feature_psi(), default=0.0))
            self._g_feature_qshift.set(max(self.feature_qshift(), default=0.0))
        # Per-head gate: a head contributes its PSI only once it has
        # min_count LIVE rows past its frozen baseline — a 3-row live
        # window against a 64-row baseline is pure sampling noise.
        stable = [
            s.psi()
            for s in self._heads.values()
            if s.live_rows >= self.min_count
        ]
        if stable:
            self._g_pred_psi.set(max(stable))
        if self.labeled_rows >= self.min_labeled:
            self._g_error_score.set(
                max(self.error_scores().values(), default=0.0)
            )

    # -- reporting -----------------------------------------------------------

    def report(self) -> Dict[str, Any]:
        """Full drift report: the incident-bundle sidecar and the
        ``hydragnn_tpu_torch.tools.drift_report`` payload."""
        per_channel = []
        psis = self.feature_psi()
        qshifts = self.feature_qshift()
        for c in range(self.num_channels):
            ref = self._ref_channels[c]
            per_channel.append(
                {
                    "channel": c,
                    "psi": psis[c],
                    "qshift": qshifts[c],
                    "mean": float(self.moments.mean[c]),
                    "std": float(self.moments.std[c]),
                    "ref_mean": float(ref["mean"]),
                    "ref_std": float(ref["std"]),
                    "quantiles": {
                        str(q): self._p2[c][q].value
                        for q in self._probes
                        if self._p2[c][q].count
                    },
                    "counts": [int(n) for n in self._counts[c]],
                }
            )
        heads = {}
        head_psis = self.head_psi()
        for name, sketch in self._heads.items():
            heads[name] = {
                "psi": head_psis[name],
                "mean": float(sketch.moments.mean[0]),
                "std": float(sketch.moments.std[0]),
                "rows": sketch.count,
                "live_rows": sketch.live_rows,
            }
        return {
            "schema": DRIFT_REPORT_SCHEMA,
            "min_count": self.min_count,
            "counts": {
                "feature_rows": self.feature_rows,
                "pred_rows": self.pred_rows,
                "labeled_rows": self.labeled_rows,
            },
            "feature": {
                "psi_max": max(psis, default=0.0),
                "qshift_max": max(qshifts, default=0.0),
                "channels": per_channel,
            },
            "heads": heads,
            "error": {"scores": self.error_scores()},
        }

    def summary(self) -> Dict[str, Any]:
        """Compact block for run_end / flight manifests."""
        return {
            "feature_rows": self.feature_rows,
            "pred_rows": self.pred_rows,
            "labeled_rows": self.labeled_rows,
            "feature_psi_max": max(self.feature_psi(), default=0.0),
            "pred_psi_max": max(self.head_psi().values(), default=0.0),
            "error_score_max": max(self.error_scores().values(), default=0.0),
        }


def validate_drift_report(report: Mapping[str, Any]) -> List[str]:
    """Schema check for a ``drift_report.json`` sidecar; returns a list
    of problems (empty == valid).  Used by
    ``hydragnn_tpu_torch.tools.drift_report --validate``."""
    problems: List[str] = []
    if int(report.get("schema", -1)) != DRIFT_REPORT_SCHEMA:
        problems.append(
            f"drift report schema {report.get('schema')!r} != {DRIFT_REPORT_SCHEMA}"
        )
    for key in ("counts", "feature", "heads", "error"):
        if key not in report:
            problems.append(f"drift report missing key {key!r}")
    feature = report.get("feature") or {}
    if "feature" in report:
        for key in ("psi_max", "qshift_max", "channels"):
            if key not in feature:
                problems.append(f"drift report feature block missing {key!r}")
    for i, ch in enumerate(feature.get("channels") or []):
        for key in ("channel", "psi", "mean", "ref_mean"):
            if key not in ch:
                problems.append(f"drift report channel[{i}] missing {key!r}")
    counts = report.get("counts") or {}
    if "counts" in report:
        for key in ("feature_rows", "pred_rows", "labeled_rows"):
            if key not in counts:
                problems.append(f"drift report counts block missing {key!r}")
    return problems
