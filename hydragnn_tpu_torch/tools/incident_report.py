"""Render and validate incident bundles (the port's copy of the JAX
package's ``tools/incident_report.py``; it imports no JAX, so it runs
where the port runs).

A trigger that fires (``obs/triggers.py``) writes a bundle under
``<log dir>/incidents/<id>/`` (a server's under
``<log_dir>/serve/incidents/``):

    python -m hydragnn_tpu_torch.tools.incident_report logs/run/incidents
    python -m hydragnn_tpu_torch.tools.incident_report logs/run/incidents/i001-...
    python -m hydragnn_tpu_torch.tools.incident_report --validate logs/run/incidents

A directory holding ``incident_manifest.json`` is one bundle; any other
directory is scanned as an incidents root. ``--validate`` exits 1 when a
bundle fails the manifest schema or names files it does not hold; a
bundle without a manifest renders and validates as the run that died
mid-capture it is.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

from hydragnn_tpu_torch.obs.triggers import INCIDENT_MANIFEST, list_incidents, validate_incident_bundle


def _load_manifest(bundle_dir: str) -> Optional[dict]:
    path = os.path.join(bundle_dir, INCIDENT_MANIFEST)
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _fmt_t(t) -> str:
    if not isinstance(t, (int, float)):
        return "?"
    import datetime

    return datetime.datetime.fromtimestamp(t).strftime("%Y-%m-%d %H:%M:%S")


def render_bundle(bundle_dir: str) -> str:
    """One bundle's story as text: verdict, capture, evidence files."""
    lines: List[str] = [f"== incident {os.path.basename(bundle_dir)} =="]
    man = _load_manifest(bundle_dir)
    if man is None:
        lines.append(
            "  NO MANIFEST — the run died mid-capture; whatever sidecars"
        )
        lines.append("  landed before the crash are below:")
        for name in sorted(os.listdir(bundle_dir)):
            lines.append(f"    {name}")
        return "\n".join(lines)
    trig = man.get("trigger") or {}
    lines.append(
        f"  rule: {man.get('rule')} ({man.get('kind')})"
        f"  status: {man.get('status')}"
    )
    lines.append(f"  fired: {_fmt_t(trig.get('fired_t'))}")
    obs, thr = trig.get("observed"), trig.get("threshold")
    metric = trig.get("metric")
    if trig.get("injected"):
        lines.append(f"  verdict: INJECTED ({metric}, threshold {thr})")
    else:
        lines.append(f"  verdict: {metric} observed {obs} vs threshold {thr}")
    for k, v in sorted((trig.get("detail") or {}).items()):
        lines.append(f"    {k}: {v}")
    prof = man.get("profile") or {}
    lines.append(
        f"  profile: captured={prof.get('captured')} "
        f"steps={prof.get('steps')} duration_s={prof.get('duration_s')} "
        f"nonempty={prof.get('nonempty')}"
    )
    lines.append("  files:")
    for label, rel in sorted((man.get("files") or {}).items()):
        path = os.path.join(bundle_dir, str(rel))
        try:
            size = os.path.getsize(path)
        except OSError:
            size = "MISSING"
        lines.append(f"    {label}: {rel} ({size} bytes)")
    hyg = _read_json(os.path.join(bundle_dir, "chip_hygiene.json"))
    if hyg is not None and hyg.get("available"):
        lines.append(
            f"  chip hygiene: compute processes on the card "
            f"{len(hyg.get('compute_apps') or [])} (own pid {hyg.get('own_pid')})"
        )
    mem = _read_json(os.path.join(bundle_dir, "memory.json"))
    if mem is not None and mem.get("available"):
        lines.append(
            f"  device memory: in_use={mem.get('bytes_in_use')} "
            f"peak={mem.get('peak_bytes_in_use')} limit={mem.get('bytes_limit')}"
        )
    return "\n".join(lines)


def _read_json(path: str) -> Optional[dict]:
    try:
        with open(path) as f:
            data = json.load(f)
        return data if isinstance(data, dict) else None
    except (OSError, ValueError):
        return None


def _resolve_bundles(arg: str) -> List[str]:
    """A bundle dir is its own result; any other dir is an incidents
    root (possibly empty)."""
    if os.path.exists(os.path.join(arg, INCIDENT_MANIFEST)):
        return [arg]
    return list_incidents(arg)


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument(
        "paths", nargs="+",
        help="incident bundle dir(s) or incidents/ root dir(s)",
    )
    p.add_argument(
        "--validate",
        action="store_true",
        help="schema-check bundles instead of rendering; exit 1 on problems",
    )
    args = p.parse_args(argv)

    bundles: List[str] = []
    for arg in args.paths:
        found = _resolve_bundles(arg)
        if not found:
            print(f"{arg}: no incident bundles")
        bundles.extend(found)

    rc = 0
    for bundle in bundles:
        if args.validate:
            problems = validate_incident_bundle(bundle)
            if problems:
                rc = 1
                print(f"{bundle}: INVALID ({len(problems)} problem(s))")
                for prob in problems:
                    print(f"  - {prob}")
            else:
                print(f"{bundle}: OK")
        else:
            print(render_bundle(bundle))
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
