"""Build and load the port's CUDA kernels (nvcc + ctypes).

Each kernel source under ``ops/csrc/`` has a plain C interface. At its
first use in a process it is compiled with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v

into ``ops/build/`` (listed in ``.gitignore``), named by a hash of the
source, the shared headers (``csrc/*.cuh``) and the flags, and loaded
with ``ctypes``. A library already built from the same sources is
reused. :func:`build_all` starts one ``nvcc`` per source, all at once.
A failed build raises: there is no fallback to the plain PyTorch
version for a CUDA tensor.

Nothing is built when this module is imported: the CPU tests import
every module on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Optional, Sequence, Tuple

import torch

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


class LaunchCount:
    """Thread-safe count of kernel launches (the dispatch thread adds,
    callers read and reset); a wrapper that names its input's type also
    counts the launches of each type (``by_dtype``)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._n = 0
        self._by: Dict[torch.dtype, int] = {}

    def add(self, dtype: Optional[torch.dtype] = None) -> None:
        with self._lock:
            self._n += 1
            if dtype is not None:
                self._by[dtype] = self._by.get(dtype, 0) + 1

    def reset(self) -> None:
        with self._lock:
            self._n = 0
            self._by = {}

    @property
    def value(self) -> int:
        with self._lock:
            return self._n

    @property
    def by_dtype(self) -> Dict[torch.dtype, int]:
        with self._lock:
            return dict(self._by)


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


def _lib_path(source: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [os.path.join(CSRC_DIR, source)] + sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(f.read())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{h.hexdigest()[:16]}.so")


def build_all(sources: Sequence[str]) -> Dict[str, str]:
    """Build (once) and load every ``csrc/<source>``, one ``nvcc`` per
    source running at the same time; returns each source's compiler log
    (ptxas registers, spills and shared memory per kernel)."""
    with _lock:
        todo = [s for s in dict.fromkeys(sources) if s not in _loaded]
        procs = {}
        for source in todo:
            lib_path = _lib_path(source)
            if not os.path.exists(lib_path):
                os.makedirs(BUILD_DIR, exist_ok=True)
                tmp = f"{lib_path}.{os.getpid()}.tmp"
                cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, source)]
                procs[source] = (subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
                ), tmp)
        failed = []
        for source, (proc, tmp) in procs.items():
            log = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(f"nvcc failed on {source} (exit {proc.returncode}):\n{log}")
                continue
            with open(_lib_path(source) + ".log", "w") as f:
                f.write(log)
            os.replace(tmp, _lib_path(source))
        if failed:
            raise RuntimeError("hydragnn_tpu_torch: " + "\n".join(failed))
        for source in todo:
            lib_path = _lib_path(source)
            with open(lib_path + ".log") as f:
                log = f.read()
            _loaded[source] = (ctypes.CDLL(lib_path), log)
        return {s: _loaded[s][1] for s in sources}


def bind(source: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry point ``symbol`` of ``csrc/<source>``, built (once)
    and typed (every pointer and the stream as ``c_void_p``, or ctypes
    cuts them to 32 bits); it returns a ``cudaError_t`` as ``int``."""
    build_all([source])
    with _lock:
        fn = getattr(_loaded[source][0], symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check_launch(name: str, rc: int) -> None:
    """Raise when the C entry point reports a CUDA error (a launch the
    card refused never runs, and a later synchronise does not say so)."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def cuda_args(name: str, *tensors) -> torch.device:
    """Common checks before a launch: every tensor given (None skipped)
    is contiguous and on the same CUDA device; returns that device."""
    dev = None
    for t in tensors:
        if t is None:
            continue
        if t.device.type != "cuda":
            raise ValueError(f"{name}: tensor on {t.device}, expected a CUDA device")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: every tensor must be contiguous")
    return dev


def stream_of(dev: torch.device) -> int:
    """The raw handle of PyTorch's current stream on ``dev``."""
    return torch.cuda.current_stream(dev).cuda_stream


FLOAT_CODE = {torch.float32: 0, torch.bfloat16: 1}
