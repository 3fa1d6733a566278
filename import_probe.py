"""Where a fresh process's ``import torch`` spends its time on this machine.

    python3 import_probe.py

Prints, one JSON line each: whether the environment forbids writing
bytecode (``PYTHONDONTWRITEBYTECODE``) and how many of torch's sources
have a ``.pyc`` beside them; then the wall of ``import torch`` in fresh
interpreters, three one after another and four at once, first as the
environment has it, then with the flag dropped and ``PYTHONPYCACHEPREFIX``
at a temporary directory (the first of those writes the cache, the rest
read it): the setting ``chip_smoke.py`` gives its children. Imports no
JAX; the timings are of the host that runs it.
"""

from __future__ import annotations

import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time


def bytecode_state() -> dict:
    import torch

    root = os.path.dirname(torch.__file__)
    fresh = stale = missing = 0
    for dirpath, _, files in os.walk(root):
        for f in files:
            if not f.endswith(".py"):
                continue
            src = os.path.join(dirpath, f)
            pyc = importlib.util.cache_from_source(src)
            if not os.path.exists(pyc):
                missing += 1
            elif os.path.getmtime(pyc) < os.path.getmtime(src):
                stale += 1
            else:
                fresh += 1
    return {"torch": torch.__version__, "torch_dir": root, "dont_write_bytecode_env": os.environ.get(
        "PYTHONDONTWRITEBYTECODE"), "pycache_prefix_env": os.environ.get("PYTHONPYCACHEPREFIX"),
        "py_files": fresh + stale + missing, "pyc_fresh": fresh, "pyc_stale": stale, "pyc_missing": missing,
        "torch_dir_writable": os.access(root, os.W_OK)}


def timed_imports(env: dict, n: int, at_once: bool) -> list:
    cmd = [sys.executable, "-c", "import torch"]
    if at_once:
        t0 = time.perf_counter()
        procs = [subprocess.Popen(cmd, env=env) for _ in range(n)]
        if any(p.wait() for p in procs):
            raise SystemExit("import_probe: an import failed")
        return [round(time.perf_counter() - t0, 2)]
    walls = []
    for _ in range(n):
        t0 = time.perf_counter()
        subprocess.run(cmd, env=env, check=True)
        walls.append(round(time.perf_counter() - t0, 2))
    return walls


def main() -> None:
    print(json.dumps({"import_probe": "bytecode", **bytecode_state()}), flush=True)
    as_is = dict(os.environ)
    print(json.dumps({"import_probe": "as_is", "one_after_another_s": timed_imports(as_is, 3, False),
                      "four_at_once_s": timed_imports(as_is, 4, True)[0]}), flush=True)
    cache = tempfile.mkdtemp(prefix="import_probe_pyc_")
    try:
        cached = {k: v for k, v in os.environ.items() if k != "PYTHONDONTWRITEBYTECODE"}
        cached["PYTHONPYCACHEPREFIX"] = cache
        walls = timed_imports(cached, 3, False)
        n_pyc = sum(f.endswith(".pyc") for _, _, fs in os.walk(cache) for f in fs)
        print(json.dumps({"import_probe": "cached_prefix", "one_after_another_s": walls,
                          "four_at_once_s": timed_imports(cached, 4, True)[0], "pyc_written": n_pyc}), flush=True)
    finally:
        shutil.rmtree(cache, ignore_errors=True)


if __name__ == "__main__":
    main()
