"""Build and load the port's CUDA kernels (nvcc + ctypes).

Each kernel source under ``ops/csrc/`` has a plain C interface. At its
first use in a process it is compiled with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v

into ``ops/build/`` (listed in ``.gitignore``), named by a hash of the
source and the flags, and loaded with ``ctypes``. A library already
built from the same source is reused. A failed build raises: there is
no fallback to the plain PyTorch version for a CUDA tensor.

Nothing is built when this module is imported: the CPU tests import
every module on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Tuple

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
# name -> (library, compiler log); guarded by _lock
_loaded: Dict[str, Tuple[ctypes.CDLL, str]] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under PyTorch's
    ``CUDA_HOME``; raises when neither exists."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("hydragnn_tpu_torch: nvcc not found; cannot build the CUDA kernels")


def load_library(source: str) -> Tuple[ctypes.CDLL, str]:
    """Build (once) and load ``csrc/<source>``; returns the library and
    the compiler's log (ptxas registers and shared memory per kernel)."""
    with _lock:
        if source in _loaded:
            return _loaded[source]
        src = os.path.join(CSRC_DIR, source)
        with open(src, "rb") as f:
            digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        stem = os.path.splitext(source)[0]
        lib_path = os.path.join(BUILD_DIR, f"lib{stem}_{digest}.so")
        log_path = lib_path + ".log"
        if not os.path.exists(lib_path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{lib_path}.{os.getpid()}.tmp"
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, src]
            proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(
                    f"hydragnn_tpu_torch: nvcc failed on {source} "
                    f"(exit {proc.returncode}):\n{log}"
                )
            with open(log_path, "w") as f:
                f.write(log)
            os.replace(tmp, lib_path)
        with open(log_path) as f:
            log = f.read()
        lib = ctypes.CDLL(lib_path)
        _loaded[source] = (lib, log)
        return lib, log
