"""The port imports nothing of JAX: a fresh interpreter imports every
module of ``hydragnn_tpu_torch`` (and ``chip_smoke.py``'s imports), then
finds no ``jax``, ``flax``, ``optax`` or ``hydragnn_tpu`` (the exact
package, not the prefix) in ``sys.modules``. The walk covers the
serving path's ``obs/`` and ``resilience/`` subpackages, the lock-order
witness and the supervise CLI."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
import hydragnn_tpu_torch
names = [m.name for m in pkgutil.walk_packages(hydragnn_tpu_torch.__path__, "hydragnn_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import ast
with open("chip_smoke.py") as f:
    tree = ast.parse(f.read())
for node in ast.walk(tree):
    if isinstance(node, ast.Import):
        for a in node.names:
            importlib.import_module(a.name)
    elif isinstance(node, ast.ImportFrom) and node.level == 0:
        importlib.import_module(node.module)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "hydragnn_tpu"))
print(len(names), "modules")
print("WALKED", " ".join(names))
print("BAD", bad)
"""


def test_port_imports_no_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, env=env, capture_output=True, text=True, timeout=240
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert int(lines[0].split()[0]) >= 20  # every module was walked
    assert lines[-1] == "BAD []", proc.stdout
    walked = set(lines[1].split()[1:])
    for mod in ("obs.registry", "obs.export", "obs.flight", "obs.trace", "resilience.inject",
                "resilience.watchdog", "resilience.supervisor", "serve.supervise", "serve.buckets",
                "resilience.preempt", "resilience.hooks", "utils.syncdebug", "tools.supervise",
                "pilot.journal", "pilot.pilot", "pilot.tune", "fleet.replica", "fleet.router",
                "fleet.controller", "fleet.fleet"):
        assert f"hydragnn_tpu_torch.{mod}" in walked, mod
