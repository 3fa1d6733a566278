"""Host-side radius-graph construction (cell list, optional PBC).

The port's copy of ``hydragnn_tpu/data/radius_graph.py``: the same
candidate pairs (the threaded C++ cell list of ``native/radius.cpp``
through ``hydragnn_tpu_torch.native``, with the numpy cell list as its
fallback), the same periodic image shifts and the same
``_cap_and_sort``, so the edges come out receiver-major and identical to
the JAX package's for the same positions. Edge convention matches PyG:
each directed edge (sender j -> receiver i) with distance(j, i) <= r; no
self-loops unless requested.
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


def radius_graph_pbc(
    pos: np.ndarray,
    r: float,
    cell: np.ndarray,
    pbc: Tuple[bool, bool, bool] = (True, True, True),
    max_num_neighbors: Optional[int] = None,
    loop: bool = False,
) -> np.ndarray:
    """Periodic radius graph via explicit image shifts (the supercell
    method, ase.neighborlist semantics as the reference's
    ``RadiusGraphPBC``, hydragnn/preprocess/utils.py:131-171): a pair can
    contribute several edges through different periodic images, and an
    atom can neighbour its own image (i == j with a nonzero shift)."""
    pos = np.asarray(pos, dtype=np.float64)
    cell = np.asarray(cell, dtype=np.float64).reshape(3, 3)
    if pos.shape[0] == 0:
        return np.zeros((2, 0), dtype=np.int64)

    # cell repeats in each periodic direction so every image within r is
    # covered (the distance between lattice planes)
    recip = np.linalg.inv(cell).T
    heights = 1.0 / np.maximum(np.linalg.norm(recip, axis=1), 1e-30)
    reps = [int(np.ceil(r / heights[k])) if pbc[k] else 0 for k in range(3)]
    shifts = [
        np.array([i, j, k], dtype=np.float64) @ cell
        for i in range(-reps[0], reps[0] + 1)
        for j in range(-reps[1], reps[1] + 1)
        for k in range(-reps[2], reps[2] + 1)
    ]

    all_s, all_r, all_d = [], [], []
    for shift in shifts:
        s, t, d = _candidate_pairs(pos + shift, pos, r)
        if not np.any(shift) and not loop:
            keep = s != t
            s, t, d = s[keep], t[keep], d[keep]
        all_s.append(s)
        all_r.append(t)
        all_d.append(d)
    return _cap_and_sort(
        np.concatenate(all_s), np.concatenate(all_r), np.concatenate(all_d), max_num_neighbors
    )


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
    point lie in the 27 surrounding cells). The grid runs in the native
    library; the numpy grid below is its fallback (no compiler, or a
    point cloud too sparse for a dense grid)."""
    n_src, n_dst = src_pos.shape[0], dst_pos.shape[0]
    if n_src * n_dst <= 4096:
        diff = src_pos[:, None, :] - dst_pos[None, :, :]
        dist = np.sqrt((diff * diff).sum(-1))
        s, t = np.nonzero(dist <= r)
        return s.astype(np.int64), t.astype(np.int64), dist[s, t]

    from hydragnn_tpu_torch import native

    found = native.native_radius_pairs(src_pos, dst_pos, r)
    if found is not None:
        return found

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
