"""The sampled served-request spool, in HGC container shards (the
port's copy of ``hydragnn_tpu/obs/spool.py``).

Every ``sample_every``-th answered request is captured: its inputs, its
per-head predictions, trace id, tenant, admission sequence, the model's
structural fingerprint and a timestamp, appended to rotating container
shards (``data/container.py``). A shard is a container, so it loads
through ``ContainerDataset`` and ``GraphLoader`` unchanged: predictions
are stored as the ``gt_<head>`` / ``nt_<head>`` target fields, so a
shard reads as a labelled dataset with the predictions as pseudo-labels.
The inputs round-trip bit for bit through the writer direct
featurization uses, so a spooled shard batches as the requests did.

  - **Atomic finalization**: a shard is written into a dot-prefixed
    temporary directory and ``os.replace``'d to ``shard-NNNNNN``; a
    crash leaves only a dot-directory, which readers skip and the next
    spool sweeps.
  - **Bounded disk**: shards rotate at ``shard_mb`` of buffered payload
    and the oldest finalized shards are evicted once the spool exceeds
    ``max_mb``, except pinned ones (an open drift incident or a retrain
    holds them).
  - **Flight evidence**: each rotation records a ``spool_rotate`` event.

Offers arrive on the server's dispatch thread and ``finalize`` on the
stopping thread; one lock guards the mutable state. The on-disk layout
and the manifest are the JAX package's, so either package reads the
other's shards.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np

from hydragnn_tpu_torch.data.container import ContainerDataset, ContainerWriter
from hydragnn_tpu_torch.data.dataset import GraphSample
from hydragnn_tpu_torch.utils import syncdebug

SPOOL_SCHEMA = 1
SHARD_PREFIX = "shard-"
SHARD_MANIFEST = "spool_manifest.json"


def _entry_to_sample(
    g: Mapping[str, Any],
    result: Mapping[str, np.ndarray],
    head_kinds: Mapping[str, str],
    meta: Dict[str, Any],
):
    """Reassemble a request dict + sliced result into a GraphSample the
    container writer serializes exactly like direct featurization (the
    writer owns all dtype normalization, so both paths agree bit-for-
    bit on x/pos/edge_index/edge_attr)."""
    graph_targets: Dict[str, np.ndarray] = {}
    node_targets: Dict[str, np.ndarray] = {}
    for name, arr in result.items():
        a = np.asarray(arr)
        if head_kinds.get(name, "graph") == "graph":
            graph_targets[name] = a.reshape(-1)
        else:
            node_targets[name] = a if a.ndim > 1 else a.reshape(-1, 1)
    return GraphSample(
        x=np.asarray(g["x"]),
        pos=np.asarray(g["pos"]) if g.get("pos") is not None else None,
        edge_index=np.stack(
            [np.asarray(g["senders"]), np.asarray(g["receivers"])]
        ),
        edge_attr=(
            np.asarray(g["edge_attr"]) if g.get("edge_attr") is not None else None
        ),
        graph_targets=graph_targets,
        node_targets=node_targets,
        meta=meta,
    )


def _entry_bytes(sample) -> int:
    total = sample.x.nbytes
    for arr in (sample.pos, sample.edge_index, sample.edge_attr):
        if arr is not None:
            total += np.asarray(arr).nbytes
    for d in (sample.graph_targets, sample.node_targets):
        for v in d.values():
            total += np.asarray(v).nbytes
    total += len(json.dumps(sample.meta)) if sample.meta else 0
    return total


class RequestSpool:
    """Rotating, sampled, size-bounded HGC spool for one server."""

    def __init__(
        self,
        root: str,
        *,
        sample_every: int = 8,
        max_mb: float = 64.0,
        shard_mb: float = 1.0,
        model_fingerprint: str = "",
        head_kinds: Optional[Mapping[str, str]] = None,
        flight=None,
    ):
        if sample_every < 1:
            raise ValueError(f"sample_every must be >= 1, got {sample_every}")
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self.sample_every = int(sample_every)
        self.max_bytes = int(max(0.001, float(max_mb)) * 1024 * 1024)
        self.shard_bytes = int(max(0.01, float(shard_mb)) * 1024 * 1024)
        self.model_fingerprint = model_fingerprint
        self.head_kinds = dict(head_kinds or {})
        self.flight = flight
        self._lock = syncdebug.maybe_wrap(threading.Lock(), "spool.RequestSpool._lock")  # guards every field below
        self._seen = 0
        self._pending: List[Any] = []
        self._pending_bytes = 0
        self._spooled = 0
        self._rotations = 0
        self._evicted = 0
        self._overhead_s = 0.0
        self._last_window: Dict[str, Any] = {}
        self._pins: Dict[str, int] = {}
        # crash sweep: an interrupted finalization leaves a dot-dir; no
        # reader consumes those, so reclaim the space up front
        for name in os.listdir(self.root):
            if name.startswith("."):
                shutil.rmtree(os.path.join(self.root, name), ignore_errors=True)
        self._next_shard = 1 + max(
            [int(n[len(SHARD_PREFIX):]) for n in self._shard_names()] or [0]
        )

    # -- ingest (dispatch thread) -------------------------------------------

    def offer(
        self,
        g: Mapping[str, Any],
        result: Mapping[str, np.ndarray],
        *,
        trace: Optional[str] = None,
        tenant: str = "default",
        seq: int = -1,
    ) -> bool:
        """Consider one answered request; spool it if it is the Nth.
        Returns whether the request was captured."""
        t0 = time.perf_counter()
        with self._lock:
            self._seen += 1
            if (self._seen - 1) % self.sample_every != 0:
                return False
            sample = _entry_to_sample(
                g,
                result,
                self.head_kinds,
                {
                    "spool": {
                        "schema": SPOOL_SCHEMA,
                        "trace": trace,
                        "tenant": tenant,
                        "seq": int(seq),
                        "t": time.time(),
                        "model_fingerprint": self.model_fingerprint,
                    }
                },
            )
            self._pending.append(sample)
            self._pending_bytes += _entry_bytes(sample)
            self._spooled += 1
            if self._pending_bytes >= self.shard_bytes:
                self._rotate_locked()
            self._overhead_s += time.perf_counter() - t0
        return True

    # -- rotation / retention ------------------------------------------------

    def _shard_names(self) -> List[str]:
        return sorted(
            n
            for n in os.listdir(self.root)
            if n.startswith(SHARD_PREFIX)
            and os.path.isdir(os.path.join(self.root, n))
        )

    def _shard_size(self, name: str) -> int:
        d = os.path.join(self.root, name)
        return sum(
            os.path.getsize(os.path.join(d, f))
            for f in os.listdir(d)
            if os.path.isfile(os.path.join(d, f))
        )

    def _rotate_locked(self) -> Optional[str]:
        """Finalize the pending buffer as one shard, atomically, then
        LRU-evict past the disk bound. Caller holds the lock."""
        if not self._pending:
            return None
        name = f"{SHARD_PREFIX}{self._next_shard:06d}"
        self._next_shard += 1
        tmp = os.path.join(self.root, f".{name}.tmp-{os.getpid()}")
        writer = ContainerWriter(tmp)
        writer.add(self._pending)
        writer.add_global("spool_schema", SPOOL_SCHEMA)
        writer.add_global("model_fingerprint", self.model_fingerprint)
        writer.add_global("sample_every", self.sample_every)
        writer.save()
        entries = self._pending
        manifest = {
            "schema": SPOOL_SCHEMA,
            "shard": name,
            "num_samples": len(entries),
            "model_fingerprint": self.model_fingerprint,
            "sample_every": self.sample_every,
            "tenants": sorted(
                {s.meta["spool"]["tenant"] for s in entries}
            ),
            "seq_range": [
                min(s.meta["spool"]["seq"] for s in entries),
                max(s.meta["spool"]["seq"] for s in entries),
            ],
            "t_range": [
                min(s.meta["spool"]["t"] for s in entries),
                max(s.meta["spool"]["t"] for s in entries),
            ],
            "traces": [s.meta["spool"]["trace"] for s in entries],
        }
        with open(os.path.join(tmp, SHARD_MANIFEST), "w") as f:
            json.dump(manifest, f, indent=1)
        final = os.path.join(self.root, name)
        os.replace(tmp, final)  # atomic: readers only ever see whole shards
        self._pending = []
        self._pending_bytes = 0
        self._rotations += 1

        shards = self._shard_names()
        sizes = {n: self._shard_size(n) for n in shards}
        evicted = []
        # Eviction candidates: everything but the newest shard, minus
        # pinned shards (an open drift incident or a running retrain
        # holds a reference — evicting under it would dangle the
        # bundle's spool pointer / the fine-tune's input set).
        evictable = [
            n for n in shards[:-1] if self._pins.get(n, 0) == 0
        ]
        while evictable and sum(sizes.values()) > self.max_bytes:
            oldest = evictable.pop(0)  # LRU == lowest shard number
            shards.remove(oldest)
            shutil.rmtree(os.path.join(self.root, oldest), ignore_errors=True)
            sizes.pop(oldest)
            evicted.append(oldest)
            self._evicted += 1
        self._last_window = {
            "dir": self.root,
            "shards": shards[-4:],
            "last_shard": name if name in shards else shards[-1] if shards else None,
            "seq_range": manifest["seq_range"],
            "tenants": manifest["tenants"],
        }
        if self.flight is not None:
            self.flight.record(
                "spool_rotate",
                shard=name,
                samples=len(entries),
                bytes=sizes.get(name, 0),
                total_bytes=sum(sizes.values()),
                shards=len(shards),
                evicted=evicted,
            )
        return name

    # -- lifecycle -----------------------------------------------------------

    def flush_pending(self) -> Optional[str]:
        """Finalize whatever is buffered as a (possibly small) shard."""
        with self._lock:
            return self._rotate_locked()

    def finalize(self) -> Dict[str, Any]:
        """Flush and return the summary block stamped into run_end."""
        with self._lock:
            self._rotate_locked()
            shards = self._shard_names()
            total = sum(self._shard_size(n) for n in shards)
            return {
                "dir": self.root,
                "seen": self._seen,
                "spooled": self._spooled,
                "sample_every": self.sample_every,
                "shards": len(shards),
                "rotations": self._rotations,
                "evicted": self._evicted,
                "bytes": total,
                "pinned": len(self._pins),
                "overhead_s": round(self._overhead_s, 6),
            }

    # -- pinning -------------------------------------------------------------

    def pin(self, shards: Sequence[str]) -> List[str]:
        """Ref-count-pin shards against LRU eviction.  Accepts shard
        basenames or paths; returns the basenames actually pinned
        (shards that no longer exist are skipped, not errors — the
        caller learns what survives).  Each ``pin`` must be balanced by
        one ``unpin`` of the returned names."""
        with self._lock:
            existing = set(self._shard_names())
            pinned = []
            for s in shards:
                name = os.path.basename(os.path.normpath(str(s)))
                if name in existing:
                    self._pins[name] = self._pins.get(name, 0) + 1
                    pinned.append(name)
            return pinned

    def unpin(self, shards: Sequence[str]) -> None:
        """Release one pin reference per shard; eviction resumes once a
        shard's count reaches zero.  Over-unpinning is a no-op."""
        with self._lock:
            for s in shards:
                name = os.path.basename(os.path.normpath(str(s)))
                n = self._pins.get(name, 0)
                if n <= 1:
                    self._pins.pop(name, None)
                else:
                    self._pins[name] = n - 1

    def pinned(self) -> Dict[str, int]:
        """Current pin counts by shard basename (copy)."""
        with self._lock:
            return dict(self._pins)

    # -- introspection -------------------------------------------------------

    @property
    def overhead_s(self) -> float:
        with self._lock:
            return self._overhead_s

    def window(self) -> Dict[str, Any]:
        """Pointer to the most recent spool window — attached to drift
        incidents so the bundle says WHERE the offending traffic is."""
        with self._lock:
            if self._last_window:
                return dict(self._last_window)
            return {
                "dir": self.root,
                "shards": self._shard_names()[-4:],
                "pending": len(self._pending),
            }


# -- readers -----------------------------------------------------------------


def list_shards(root: str) -> List[str]:
    """Finalized shard directories under a spool root, oldest first
    (dot-prefixed in-progress/crashed temp dirs are invisible)."""
    if not os.path.isdir(root):
        return []
    return [
        os.path.join(root, n)
        for n in sorted(os.listdir(root))
        if n.startswith(SHARD_PREFIX) and os.path.isdir(os.path.join(root, n))
    ]


def read_spool(root: str) -> List[Any]:
    """Load every spooled sample (oldest shard first) back through the
    standard container reader — the loader round-trip in one call."""
    out: List[Any] = []
    for shard in list_shards(root):
        out.extend(ContainerDataset(shard).samples())
    return out


def read_shard_manifest(shard_dir: str) -> Dict[str, Any]:
    with open(os.path.join(shard_dir, SHARD_MANIFEST)) as f:
        return json.load(f)


def validate_spool_manifest(manifest: Mapping[str, Any]) -> List[str]:
    """Schema check for a shard's ``spool_manifest.json`` (``hydragnn_tpu_torch.tools.drift_report
    --validate``); returns problems."""
    problems: List[str] = []
    if int(manifest.get("schema", -1)) != SPOOL_SCHEMA:
        problems.append(
            f"spool manifest schema {manifest.get('schema')!r} != {SPOOL_SCHEMA}"
        )
    for key in ("shard", "num_samples", "model_fingerprint", "sample_every",
                "tenants", "seq_range", "t_range"):
        if key not in manifest:
            problems.append(f"spool manifest missing key {key!r}")
    if "num_samples" in manifest and int(manifest["num_samples"]) < 1:
        problems.append("spool manifest num_samples < 1")
    seq_range = manifest.get("seq_range")
    if isinstance(seq_range, (list, tuple)) and len(seq_range) != 2:
        problems.append("spool manifest seq_range is not a [lo, hi] pair")
    return problems
