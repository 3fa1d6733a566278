"""Host-side radius-graph construction (numpy; no periodic images yet).

The port's copy of ``hydragnn_tpu/data/radius_graph.py``: the same
candidate pairs and the same ``_cap_and_sort``, so the edges come out
receiver-major and identical to the JAX package's for the same
positions. Edge convention matches PyG: each directed edge
(sender j -> receiver i) with distance(j, i) <= r; no self-loops unless
requested.

Not yet ported: the ctypes binding to ``native/radius.cpp`` (the numpy
cell list below is the same function, slower on large graphs) and the
periodic radius graph ``radius_graph_pbc`` (ROADMAP A1/A8).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def radius_graph(
    pos: np.ndarray,
    r: float,
    max_num_neighbors: Optional[int] = None,
    loop: bool = False,
) -> np.ndarray:
    """Edges within radius ``r``; returns edge_index [2, E] int64
    (row 0 = senders, row 1 = receivers), receiver-major sorted.

    ``max_num_neighbors`` caps incoming edges per receiver, keeping the
    *nearest* ones."""
    pos = np.asarray(pos, dtype=np.float64)
    if pos.shape[0] == 0:
        return np.zeros((2, 0), dtype=np.int64)
    senders, receivers, dists = _candidate_pairs(pos, pos, r)
    if not loop:
        keep = senders != receivers
        senders, receivers, dists = senders[keep], receivers[keep], dists[keep]
    return _cap_and_sort(senders, receivers, dists, max_num_neighbors)


def edge_lengths(pos: np.ndarray, edge_index: np.ndarray) -> np.ndarray:
    """[E, 1] Euclidean edge lengths."""
    pos = np.asarray(pos, dtype=np.float64)
    d = pos[edge_index[1]] - pos[edge_index[0]]
    return np.linalg.norm(d, axis=1, keepdims=True).astype(np.float32)


def _candidate_pairs(
    src_pos: np.ndarray, dst_pos: np.ndarray, r: float
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """All (src, dst, dist) pairs with dist <= r: brute force for tiny
    inputs, else a uniform cell grid of cell size r (neighbours of a dst
    point lie in the 27 surrounding cells)."""
    n_src, n_dst = src_pos.shape[0], dst_pos.shape[0]
    if n_src * n_dst <= 4096:
        diff = src_pos[:, None, :] - dst_pos[None, :, :]
        dist = np.sqrt((diff * diff).sum(-1))
        s, t = np.nonzero(dist <= r)
        return s.astype(np.int64), t.astype(np.int64), dist[s, t]

    origin = np.minimum(src_pos.min(0), dst_pos.min(0))
    inv = 1.0 / max(r, 1e-12)
    src_cell = np.floor((src_pos - origin) * inv).astype(np.int64)
    dst_cell = np.floor((dst_pos - origin) * inv).astype(np.int64)
    extent = max(int(src_cell.max()), int(dst_cell.max())) + 3
    skey = (src_cell[:, 0] * extent + src_cell[:, 1]) * extent + src_cell[:, 2]
    order = np.argsort(skey, kind="stable")
    skey_sorted = skey[order]

    out_s, out_t, out_d = [], [], []
    for i in (-1, 0, 1):
        for j in (-1, 0, 1):
            for k in (-1, 0, 1):
                qkey = (
                    (dst_cell[:, 0] + i) * extent + (dst_cell[:, 1] + j)
                ) * extent + (dst_cell[:, 2] + k)
                lo = np.searchsorted(skey_sorted, qkey, side="left")
                hi = np.searchsorted(skey_sorted, qkey, side="right")
                counts = hi - lo
                if counts.sum() == 0:
                    continue
                t_idx = np.repeat(np.arange(n_dst, dtype=np.int64), counts)
                s_idx = order[
                    np.concatenate(
                        [np.arange(a, b, dtype=np.int64) for a, b in zip(lo, hi) if b > a]
                    )
                ]
                d = np.linalg.norm(src_pos[s_idx] - dst_pos[t_idx], axis=1)
                keep = d <= r
                out_s.append(s_idx[keep])
                out_t.append(t_idx[keep])
                out_d.append(d[keep])
    if not out_s:
        empty = np.zeros(0, dtype=np.int64)
        return empty, empty.copy(), np.zeros(0, dtype=np.float64)
    return np.concatenate(out_s), np.concatenate(out_t), np.concatenate(out_d)


def _cap_and_sort(
    senders: np.ndarray,
    receivers: np.ndarray,
    dists: np.ndarray,
    max_num_neighbors: Optional[int],
) -> np.ndarray:
    """Sort edges receiver-major (then by distance) and cap per-receiver
    in-degree at the nearest ``max_num_neighbors``."""
    order = np.lexsort((dists, receivers))
    senders, receivers, dists = senders[order], receivers[order], dists[order]
    if max_num_neighbors is not None and receivers.size:
        starts = np.searchsorted(receivers, receivers, side="left")
        rank = np.arange(receivers.size) - starts
        keep = rank < max_num_neighbors
        senders, receivers = senders[keep], receivers[keep]
    return np.stack([senders, receivers]).astype(np.int64)
