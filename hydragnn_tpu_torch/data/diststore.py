"""A distributed in-memory sample store (the port's counterpart of
``hydragnn_tpu/data/diststore.py``, the reference's DDStore).

Every process owns a shard of the samples and serves it over plain TCP
from a background thread; ``get(global_idx)`` returns any sample from
whichever rank owns it. The training plane's collectives are untouched:
the store is the data plane of a pod without a shared filesystem. The
servers' addresses are exchanged once through
``torch.distributed.all_gather_object`` over the default group (the JAX
package's ``multihost_utils.process_allgather``); remote fetches are
kept in an LRU cache; a single process answers from its own list.

Wire protocol (little-endian), the JAX package's: a request is an int64
local sample index; the answer an int64 payload length (-1: no such
index) and the pickled field dict. Pickle is safe here: the peers are
the run's own processes. No module of the port imports this one.

The address a peer is reached at: ``HGTORCH_DISTSTORE_ADDR`` when set;
else ``127.0.0.1`` when the group's rendezvous (``MASTER_ADDR``) is on
this machine; else the local address of the route toward the rendezvous
host, or the host name's address.
"""

from __future__ import annotations

import io
import os
import pickle
import socket
import struct
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import numpy as np

from hydragnn_tpu_torch.data.dataset import GraphSample
from hydragnn_tpu_torch.utils import syncdebug


def _pack_sample(s: GraphSample) -> bytes:
    fields = {
        "x": s.x,
        "pos": s.pos,
        "edge_index": s.edge_index,
        "edge_attr": s.edge_attr,
        "graph_y": s.graph_y,
        "graph_targets": s.graph_targets,
        "node_targets": s.node_targets,
        "meta": s.meta,
    }
    buf = io.BytesIO()
    pickle.dump(fields, buf, protocol=pickle.HIGHEST_PROTOCOL)
    return buf.getvalue()


def _unpack_sample(data: bytes) -> GraphSample:
    fields = pickle.loads(data)
    return GraphSample(
        x=fields["x"],
        pos=fields.get("pos"),
        edge_index=fields.get("edge_index"),
        edge_attr=fields.get("edge_attr"),
        graph_y=fields.get("graph_y"),
        graph_targets=fields.get("graph_targets") or {},
        node_targets=fields.get("node_targets") or {},
        meta=fields.get("meta") or {},
    )


def _local_addr() -> str:
    """The address the other ranks reach this one at (module docstring)."""
    addr = os.environ.get("HGTORCH_DISTSTORE_ADDR")
    if addr:
        return addr
    master = os.environ.get("MASTER_ADDR", "")
    if master in ("", "localhost") or master.startswith("127."):
        return "127.0.0.1"
    try:
        # a connected UDP socket sends nothing: it asks the kernel which
        # local address routes to the rendezvous host
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            s.connect((master, 1))
            ip = s.getsockname()[0]
        if not ip.startswith("127."):
            return ip
    except OSError:
        pass
    return socket.gethostbyname(socket.gethostname())


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    while n > 0:
        c = sock.recv(min(n, 1 << 20))
        if not c:
            raise ConnectionError("peer closed")
        chunks.append(c)
        n -= len(c)
    return b"".join(chunks)


def _group():
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return dist
    except (ImportError, RuntimeError):
        pass
    return None


class DistSampleStore:
    """Own a shard, serve it, fetch anyone's.

    Args:
      local_samples: this process's shard.
      global_counts: the shard sizes of every process, in rank order.
        None: gathered from the group (a single process: its own count).
      cache_size: the LRU cache's capacity for remote fetches.

    ``rank`` and ``nproc`` are the default ``torch.distributed`` group's
    (0 and 1 without one). With peers, every rank builds its store
    together (the address exchange is a collective)."""

    def __init__(self, local_samples: Sequence[GraphSample], global_counts: Optional[Sequence[int]] = None,
                 cache_size: int = 4096):
        dist = _group()
        self.rank = int(dist.get_rank()) if dist is not None else 0
        self.nproc = int(dist.get_world_size()) if dist is not None else 1
        self._local_samples = list(local_samples)
        # only peers need the shard pickled; one process answers from its list
        self._local = [_pack_sample(s) for s in local_samples] if self.nproc > 1 else []

        if global_counts is None:
            if self.nproc > 1:
                counts: List[Optional[int]] = [None] * self.nproc
                dist.all_gather_object(counts, len(local_samples))
                global_counts = [int(c) for c in counts]
            else:
                global_counts = [len(local_samples)]
        self.counts = np.asarray(global_counts, dtype=np.int64)
        self.starts = np.concatenate([[0], np.cumsum(self.counts)])
        self.total = int(self.counts.sum())

        self._cache: "OrderedDict[int, bytes]" = OrderedDict()  # guarded by _lock
        self._cache_size = cache_size
        # set once here before the accept thread starts; close() only closes it
        self._server: Optional[socket.socket] = None
        # filled once here (before any fetch), read-only after
        self._peers: List[tuple] = []
        self._conns: Dict[int, socket.socket] = {}  # guarded by _lock
        self._lock = syncdebug.maybe_wrap(threading.Lock(), "diststore.DistSampleStore._lock")
        if self.nproc > 1:
            self._start_server()
            self._exchange_addresses()

    # ---- serving ----

    def _start_server(self) -> None:
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind(("0.0.0.0", 0))
        srv.listen(64)
        self._server = srv
        threading.Thread(target=self._serve_loop, daemon=True).start()

    def _serve_loop(self) -> None:
        while True:
            try:
                conn, _ = self._server.accept()
            except OSError:
                return
            threading.Thread(target=self._serve_conn, args=(conn,), daemon=True).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            while True:
                (local_idx,) = struct.unpack("<q", _recv_exact(conn, 8))
                if local_idx < 0 or local_idx >= len(self._local):
                    conn.sendall(struct.pack("<q", -1))
                    continue
                payload = self._local[local_idx]
                conn.sendall(struct.pack("<q", len(payload)) + payload)
        except (ConnectionError, OSError):
            pass
        finally:
            conn.close()

    def _exchange_addresses(self) -> None:
        mine = (_local_addr(), int(self._server.getsockname()[1]))
        peers: List[Optional[tuple]] = [None] * self.nproc
        _group().all_gather_object(peers, mine)
        self._peers.extend((str(ip), int(port)) for ip, port in peers)

    # ---- fetching ----

    def owner_of(self, global_idx: int) -> int:
        return int(np.searchsorted(self.starts, global_idx, side="right") - 1)

    def __len__(self) -> int:
        return self.total

    def get(self, global_idx: int) -> GraphSample:
        if not 0 <= global_idx < self.total:
            raise IndexError(global_idx)
        owner = self.owner_of(global_idx)
        local_idx = global_idx - int(self.starts[owner])
        if owner == self.rank:
            return self._local_samples[local_idx]
        with self._lock:
            if global_idx in self._cache:
                self._cache.move_to_end(global_idx)
                return _unpack_sample(self._cache[global_idx])
        data = self._fetch_remote(owner, local_idx)
        with self._lock:
            self._cache[global_idx] = data
            while len(self._cache) > self._cache_size:
                self._cache.popitem(last=False)
        return _unpack_sample(data)

    def __getitem__(self, idx: int) -> GraphSample:
        return self.get(idx)

    def _fetch_remote(self, owner: int, local_idx: int) -> bytes:
        with self._lock:
            conn = self._conns.get(owner)
        if conn is None:
            conn = socket.create_connection(self._peers[owner], timeout=60)
            with self._lock:
                self._conns[owner] = conn
        with self._lock:
            conn.sendall(struct.pack("<q", local_idx))
            (length,) = struct.unpack("<q", _recv_exact(conn, 8))
            if length < 0:
                raise IndexError(f"remote index {local_idx} rejected by rank {owner}")
            return _recv_exact(conn, length)

    def close(self) -> None:
        if self._server is not None:
            try:
                self._server.close()
            except OSError:
                pass
        # take the connections out under the lock, close them outside it: a
        # concurrent fetch either kept its connection (and gets the
        # ConnectionError it handles) or caches a fresh one
        with self._lock:
            conns = list(self._conns.values())
            self._conns.clear()
        for c in conns:
            try:
                c.close()
            except OSError:
                pass
