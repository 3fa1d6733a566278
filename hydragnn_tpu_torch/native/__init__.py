"""Native (C++) host core: builds libhgc.so on first use, ctypes-binds it.

The port's own loader of the repository's ``native/hgc.cpp`` and
``native/radius.cpp`` (the same sources the JAX package binds). They
are compiled with ``g++`` into ``hydragnn_tpu_torch/native/build/``
(gitignored) at the first call that needs them, into a temporary name
renamed into place, so concurrent processes race safely.

The library provides the container read hot path (mmap, threaded batched
row-gather, node-local shm copy) — the stand-in for the ADIOS2 C++
engine the reference depends on (SURVEY.md §2.9) — and the threaded
cell-list radius search. A pure-numpy fallback keeps every feature
working where a compiler is unavailable; ``HAVE_NATIVE`` reports which
path is active (read it as ``hydragnn_tpu_torch.native.HAVE_NATIVE``
after a call, or after ``_load()``). This is host code: no device kernel
lives here.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from typing import Optional

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRCS = [
    os.path.join(_REPO_ROOT, "native", "hgc.cpp"),
    os.path.join(_REPO_ROOT, "native", "radius.cpp"),
]
_BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")

# memoized: a racing _load() builds an equivalent CDLL and either store wins
_lib: Optional[ctypes.CDLL] = None
# one-way latch: a failed build is not retried on every call (hot path)
_LOAD_FAILED = False
# one-way latch, set after _lib
HAVE_NATIVE = False


def _build_library() -> Optional[str]:
    so_path = os.path.join(_BUILD_DIR, "libhgc.so")
    if os.path.exists(so_path) and all(
        os.path.getmtime(so_path) >= os.path.getmtime(src) for src in _SRCS
    ):
        return so_path
    os.makedirs(_BUILD_DIR, exist_ok=True)
    # Build into a temp name + atomic rename: concurrent processes (pytest
    # workers, multi-process training) race to compile safely.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = [
        "g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
        "-Werror=return-type",  # missing return in C++ is silent UB
        *_SRCS, "-o", tmp,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, so_path)
        return so_path
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired, OSError):
        if os.path.exists(tmp):
            os.unlink(tmp)
        return None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _LOAD_FAILED, HAVE_NATIVE
    if _lib is not None:
        return _lib
    if _LOAD_FAILED:
        return None
    so_path = _build_library()
    if so_path is None:
        _LOAD_FAILED = True
        return None
    try:
        lib = ctypes.CDLL(so_path)
    except OSError:
        _LOAD_FAILED = True
        return None
    lib.hgc_mmap.restype = ctypes.c_void_p
    lib.hgc_mmap.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64)]
    lib.hgc_munmap.restype = None
    lib.hgc_munmap.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.hgc_gather.restype = None
    lib.hgc_gather.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int,
    ]
    lib.hgc_copy_file.restype = ctypes.c_int
    lib.hgc_copy_file.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.rg_pairs.restype = ctypes.c_int64
    lib.rg_pairs.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ctypes.c_double,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int,
    ]
    _lib = lib
    HAVE_NATIVE = True
    return lib


def native_radius_pairs(src_pos, dst_pos, r):
    """All (src, dst, dist) pairs with dist <= r via the C++ cell-list
    kernel; returns None when the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    src = np.ascontiguousarray(src_pos, dtype=np.float64)
    dst = np.ascontiguousarray(dst_pos, dtype=np.float64)
    n_src, n_dst = src.shape[0], dst.shape[0]
    capacity = max(1024, n_dst * 48)
    for _ in range(2):
        s = np.empty(capacity, dtype=np.int64)
        t = np.empty(capacity, dtype=np.int64)
        d = np.empty(capacity, dtype=np.float64)
        total = _rg_pairs_raw(lib, src, dst, n_src, n_dst, r, s, t, d, capacity)
        if total < 0:
            return None  # dense grid unsuited (outliers/sparse cloud)
        if total <= capacity:
            return s[:total], t[:total], d[:total]
        capacity = int(total)
    raise RuntimeError("rg_pairs capacity retry failed")  # pragma: no cover


def _rg_pairs_raw(lib, src, dst, n_src, n_dst, r, s, t, d, capacity):
    return lib.rg_pairs(
            src.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            ctypes.c_int64(n_src),
            dst.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            ctypes.c_int64(n_dst),
            ctypes.c_double(float(r)),
            s.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            t.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            d.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            ctypes.c_int64(capacity),
            ctypes.c_int(0),
        )


class MappedFile:
    """A read-only mmap of one field file (native when available, else
    np.memmap). Exposes ``.view(dtype, row_shape)`` as a numpy array over
    the mapping (zero-copy) and threaded ``gather`` into a packed buffer."""

    def __init__(self, path: str):
        self.path = path
        self._native_base = None
        self._size = os.path.getsize(path)
        if self._size == 0:
            # legitimately empty field (e.g. no sample has edges): mmap of
            # a 0-byte file is invalid, an empty view is fine
            self._np = np.zeros(0, dtype=np.uint8)
            return
        lib = _load()
        if lib is not None:
            size = ctypes.c_int64(0)
            base = lib.hgc_mmap(path.encode(), ctypes.byref(size))
            if base:
                self._native_base = base
                self._size = size.value
        if self._native_base is None:
            self._np = np.memmap(path, dtype=np.uint8, mode="r")
            self._size = self._np.shape[0]
        else:
            # numpy view over the native mapping for zero-copy reads
            buf = (ctypes.c_char * self._size).from_address(self._native_base)
            self._np = np.frombuffer(buf, dtype=np.uint8)

    @property
    def nbytes(self) -> int:
        return self._size

    def view(self, dtype, row_shape) -> np.ndarray:
        itemsize = np.dtype(dtype).itemsize
        row_elems = int(np.prod(row_shape)) if row_shape else 1
        n_rows = self._size // (itemsize * row_elems)
        return self._np[: n_rows * itemsize * row_elems].view(dtype).reshape(
            (n_rows,) + tuple(row_shape)
        )

    def gather(
        self,
        row_bytes: int,
        src_off: np.ndarray,
        cnt: np.ndarray,
        out_off: np.ndarray,
        out: np.ndarray,
        n_threads: int = 0,
    ) -> None:
        """Copy ragged row ranges into ``out`` (uint8, C-contiguous)."""
        lib = _load()
        n = len(src_off)
        if lib is not None and self._native_base is not None:
            so = np.ascontiguousarray(src_off, dtype=np.int64)
            ct = np.ascontiguousarray(cnt, dtype=np.int64)
            oo = np.ascontiguousarray(out_off, dtype=np.int64)
            lib.hgc_gather(
                ctypes.c_void_p(self._native_base),
                ctypes.c_int64(row_bytes),
                so.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                ct.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                oo.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                ctypes.c_int64(n),
                out.ctypes.data_as(ctypes.c_void_p),
                ctypes.c_int(n_threads),
            )
            return
        flat = self._np
        for k in range(n):
            s = src_off[k] * row_bytes
            d = out_off[k] * row_bytes
            nb = cnt[k] * row_bytes
            out.reshape(-1)[d : d + nb] = flat[s : s + nb]

    def close(self) -> None:
        lib = _lib
        if self._native_base is not None and lib is not None:
            self._np = None
            lib.hgc_munmap(ctypes.c_void_p(self._native_base), ctypes.c_int64(self._size))
            self._native_base = None


def copy_to_shm(src_path: str, shm_dir: str) -> str:
    """One-copy node-local preload: copy ``src_path`` into ``shm_dir``
    (typically under /dev/shm) with an atomic rename so exactly one
    process on the host does the copy and peers reuse it (the
    AdiosDataset shmem mode, reference adiosdataset.py:266-314).

    An existing copy is reused only when size matches AND it is at least
    as new as the source — a regenerated dataset with identical sizes must
    not serve stale bytes."""
    os.makedirs(shm_dir, exist_ok=True)
    dst = os.path.join(shm_dir, os.path.basename(src_path))
    if (
        os.path.exists(dst)
        and os.path.getsize(dst) == os.path.getsize(src_path)
        and os.path.getmtime(dst) >= os.path.getmtime(src_path)
    ):
        return dst
    fd, tmp = tempfile.mkstemp(dir=shm_dir)
    os.close(fd)
    lib = _load()
    ok = False
    if lib is not None:
        ok = lib.hgc_copy_file(src_path.encode(), tmp.encode()) == 0
    if not ok:
        import shutil

        shutil.copyfile(src_path, tmp)
    os.replace(tmp, dst)
    return dst
