"""Render and validate the served-traffic drift trail (the port's copy
of the JAX package's ``tools/drift_report.py``; it imports no JAX, so it
runs where the port runs).

The serving drift plane (``obs/drift.py``, ``obs/spool.py``) leaves the
``drift`` and ``spool_rotate`` events of a serve flight record, the
rotating spool shards on disk, and the ``drift_report.json`` a drift
incident bundle carries:

    python -m hydragnn_tpu_torch.tools.drift_report logs/serve/flight.jsonl
    python -m hydragnn_tpu_torch.tools.drift_report logs/serve/spool
    python -m hydragnn_tpu_torch.tools.drift_report .../i001-x/drift_report.json
    python -m hydragnn_tpu_torch.tools.drift_report --validate <any of these>
    python -m hydragnn_tpu_torch.tools.drift_report --export-ref \
        logs/train/flight.jsonl --out ref.json

A ``*.jsonl`` path is a flight record, a ``*.json`` path a drift report,
a directory a spool root. ``--validate`` exits 1 when a shard manifest
or a drift report fails its schema, or a flight record is neither a
drift-armed serving record nor a training record with the
``run_start.manifest.stats`` reference.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

import numpy as np

from hydragnn_tpu_torch.data.container import ContainerDataset
from hydragnn_tpu_torch.obs.drift import load_reference, validate_drift_report
from hydragnn_tpu_torch.obs.flight import read_flight_record
from hydragnn_tpu_torch.obs.spool import list_shards, read_shard_manifest, validate_spool_manifest

_SPARK = "▁▂▃▄▅▆▇█"


def sparkline(values: List[float]) -> str:
    """Eight-level unicode trend strip; constant series render flat."""
    vals = [float(v) for v in values]
    if not vals:
        return ""
    lo, hi = min(vals), max(vals)
    if hi - lo <= 0:
        return _SPARK[0] * len(vals)
    return "".join(
        _SPARK[min(len(_SPARK) - 1, int((v - lo) / (hi - lo) * len(_SPARK)))]
        for v in vals
    )


def _fmt(v: Any) -> str:
    if isinstance(v, float):
        return f"{v:.4g}"
    return str(v)


# -- flight-record view -------------------------------------------------------


def render_flight(path: str) -> str:
    """The drift story one serve flight record tells: armed config,
    breach events, rotation cadence, end-of-run sketch summary."""
    events = read_flight_record(path)
    lines = [f"== drift trail: {path} =="]
    start = next((e for e in events if e.get("kind") == "run_start"), {})
    man = start.get("manifest") or {}
    spool, drift = man.get("spool") or {}, man.get("drift") or {}
    lines.append(
        f"  spool: {'on' if spool.get('enabled') else 'off'}"
        + (
            f" dir={spool.get('dir')} 1/{spool.get('sample_every')}"
            f" max={spool.get('max_mb')}MB"
            if spool.get("enabled")
            else ""
        )
    )
    if drift.get("armed"):
        th = drift.get("thresholds") or {}
        lines.append(
            f"  drift: armed ref={drift.get('ref')}"
            f" channels={drift.get('channels')}"
            f" thresholds={{{', '.join(f'{k}={v}' for k, v in sorted(th.items()))}}}"
        )
    else:
        lines.append("  drift: not armed")
    rotations = [e for e in events if e.get("kind") == "spool_rotate"]
    if rotations:
        lines.append(
            f"  rotations: {len(rotations)}  samples/shard "
            + sparkline([e.get("samples", 0) for e in rotations])
            + f"  last={rotations[-1].get('shard')}"
        )
    breaches = [e for e in events if e.get("kind") == "drift"]
    lines.append(f"  breaches: {len(breaches)}")
    for e in breaches:
        window = e.get("spool_window") or {}
        lines.append(
            f"    [{e.get('rule_kind')}] {e.get('rule')}:"
            f" observed {_fmt(e.get('observed'))}"
            f" vs threshold {_fmt(e.get('threshold'))}"
            f" spool={window.get('dir') or '<off>'}"
        )
    end = next(
        (e for e in reversed(events) if e.get("kind") == "run_end"), {}
    )
    for block in ("spool", "drift"):
        data = end.get(block)
        if isinstance(data, dict):
            lines.append(
                f"  run_end {block}: "
                + " ".join(f"{k}={_fmt(v)}" for k, v in sorted(data.items()))
            )
    return "\n".join(lines)


# -- spool view ---------------------------------------------------------------


def _manifest(shard: str) -> Optional[dict]:
    try:
        return read_shard_manifest(shard)
    except (OSError, ValueError):
        return None


def _shard_feature_means(shard: str) -> Optional[float]:
    """Mean of x over one shard: the per-shard trend point."""
    try:
        ds = ContainerDataset(shard)
        vals = [float(np.asarray(s.x).mean()) for s in ds.samples()]
        return sum(vals) / len(vals) if vals else None
    except Exception:
        return None


def render_spool(root: str, *, trend: bool = True) -> str:
    """Shard table (chronological) + tenant breakdown + per-shard
    feature-mean sparkline — how the spooled traffic moved over time."""
    shards = list_shards(root)
    lines = [f"== request spool: {root} ({len(shards)} shard(s)) =="]
    if not shards:
        return "\n".join(lines + ["  (empty)"])
    tenants: Dict[str, int] = {}
    fps = set()
    for shard in shards:
        man = _manifest(shard) or {}
        for t in man.get("tenants") or []:
            tenants[t] = tenants.get(t, 0) + man.get("num_samples", 0)
        fps.add(man.get("model_fingerprint", "?"))
        seq = man.get("seq_range") or ["?", "?"]
        lines.append(
            f"  {os.path.basename(shard)}: {man.get('num_samples', '?')} samples"
            f"  seq [{seq[0]}..{seq[-1]}]"
            f"  tenants={','.join(man.get('tenants') or ['?'])}"
        )
    lines.append(
        "  tenants: "
        + " ".join(f"{t}={n}" for t, n in sorted(tenants.items()))
    )
    lines.append(f"  model fingerprints: {len(fps)}")
    if trend:
        means = [_shard_feature_means(s) for s in shards]
        known = [m for m in means if m is not None]
        if known:
            lines.append(
                "  feature mean/shard: "
                + sparkline(known)
                + f"  [{_fmt(min(known))} .. {_fmt(max(known))}]"
            )
    return "\n".join(lines)


# -- drift-report sidecar view ------------------------------------------------


def render_report(path: str) -> str:
    """Per-channel / per-head tables for one ``drift_report.json``."""
    with open(path) as f:
        report = json.load(f)
    lines = [f"== drift report: {path} =="]
    trig = report.get("trigger") or {}
    if trig:
        lines.append(
            f"  trigger: {trig.get('rule')} ({trig.get('kind')})"
            f" observed {_fmt(trig.get('observed'))}"
            f" vs threshold {_fmt(trig.get('threshold'))}"
        )
    counts = report.get("counts") or {}
    lines.append(
        "  rows: " + " ".join(f"{k}={v}" for k, v in sorted(counts.items()))
    )
    feature = report.get("feature") or {}
    lines.append(
        f"  feature psi_max={_fmt(feature.get('psi_max'))}"
        f" qshift_max={_fmt(feature.get('qshift_max'))}"
    )
    for ch in feature.get("channels") or []:
        lines.append(
            f"    ch{ch.get('channel')}: psi={_fmt(ch.get('psi'))}"
            f" qshift={_fmt(ch.get('qshift'))}"
            f" mean {_fmt(ch.get('mean'))} (ref {_fmt(ch.get('ref_mean'))})"
            f" std {_fmt(ch.get('std'))} (ref {_fmt(ch.get('ref_std'))})"
        )
        cnt = ch.get("counts") or []
        if cnt:
            lines.append("      live bins: " + sparkline(cnt))
    heads = report.get("heads") or {}
    for name, h in sorted(heads.items()):
        lines.append(
            f"    head {name}: psi={_fmt(h.get('psi'))}"
            f" mean={_fmt(h.get('mean'))} rows={h.get('rows')}"
        )
    scores = (report.get("error") or {}).get("scores") or {}
    if scores:
        lines.append(
            "  error scores: "
            + " ".join(f"{k}={_fmt(v)}" for k, v in sorted(scores.items()))
        )
    window = report.get("spool_window") or {}
    if window:
        lines.append(
            f"  spool window: dir={window.get('dir')}"
            f" shards={len(window.get('shards') or [])}"
            f" last={window.get('last_shard')}"
        )
    return "\n".join(lines)


# -- validation ---------------------------------------------------------------


def validate_path(path: str) -> List[str]:
    """Problems for one argument (empty == valid), dispatched by shape
    exactly like rendering."""
    problems: List[str] = []
    if os.path.isdir(path):
        shards = list_shards(path)
        if not shards:
            problems.append(f"{path}: no spool shards")
        for shard in shards:
            man = _manifest(shard)
            if man is None:
                problems.append(f"{shard}: missing/unreadable spool manifest")
                continue
            problems.extend(f"{shard}: {p}" for p in validate_spool_manifest(man))
    elif path.endswith(".jsonl"):
        # A flight record passes if it is usable by the drift plane:
        # either a TRAINING flight carrying the reference stats block,
        # or a serve flight whose manifest shows the plane was armed.
        events = read_flight_record(path)
        start = next((e for e in events if e.get("kind") == "run_start"), {})
        man = start.get("manifest") or {}
        armed = bool(
            (man.get("drift") or {}).get("armed")
            or (man.get("spool") or {}).get("enabled")
        )
        if not armed:
            try:
                load_reference(path)
            except (OSError, ValueError) as exc:
                problems.append(f"{path}: {exc}")
    else:
        try:
            with open(path) as f:
                report = json.load(f)
        except (OSError, ValueError) as exc:
            problems.append(f"{path}: unreadable ({exc})")
        else:
            problems.extend(f"{path}: {p}" for p in validate_drift_report(report))
    return problems


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument(
        "paths", nargs="+",
        help="serve flight.jsonl, spool dir, or drift_report.json",
    )
    p.add_argument(
        "--validate", action="store_true",
        help="schema-check instead of rendering; exit 1 on problems",
    )
    p.add_argument(
        "--export-ref", action="store_true",
        help="extract the training reference window from a flight "
        "record and write it as bare stats JSON (see --out)",
    )
    p.add_argument("--out", help="output path for --export-ref")
    p.add_argument(
        "--no-trend", action="store_true",
        help="skip the per-shard feature trend (avoids loading shards)",
    )
    args = p.parse_args(argv)

    if args.export_ref:
        if not args.out:
            p.error("--export-ref requires --out")
        ref = load_reference(args.paths[0])
        with open(args.out, "w") as f:
            json.dump(ref, f, indent=1, sort_keys=True)
        print(f"wrote reference ({ref.get('num_rows')} rows) to {args.out}")
        return 0

    rc = 0
    for path in args.paths:
        if args.validate:
            problems = validate_path(path)
            if problems:
                rc = 1
                print(f"{path}: INVALID ({len(problems)} problem(s))")
                for prob in problems:
                    print(f"  - {prob}")
            else:
                print(f"{path}: OK")
        elif os.path.isdir(path):
            print(render_spool(path, trend=not args.no_trend))
        elif path.endswith(".jsonl"):
            print(render_flight(path))
        else:
            print(render_report(path))
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
