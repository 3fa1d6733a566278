"""Statically-padded graph batches of torch tensors.

The port's counterpart of ``hydragnn_tpu/graph/batch.py``. A batch is
built on the host with numpy, padded to a static
``(num_nodes, num_edges, num_graphs)`` plan with explicit masks, and
moved to a device with :meth:`GraphBatch.to`:

  - one *padding graph* slot absorbs all padding nodes/edges,
  - padding edges point at a padding node (``tot_nodes``), so masked
    segment reductions stay clean,
  - edges are canonicalized receiver-major (stable sort), which the
    CSR kernels (``ops/pna_aggregate.py``, ``ops/segment_sum.py``)
    require,
  - ``run_align=K`` pads every receiver's run to a multiple of K with
    masked self-loops, so each K-group of edge slots has one receiver
    (or is batch tail) — the layout the training path pre-reduces over
    (``ops/gather_stats.py``),
  - ``sender_win`` holds the per-node-block edge windows of the senders
    (``ops/segment_sum_local.py``),
  - ``dense_slots=D`` adds the dense slot map: each node's real edges in
    D slots (``dense_senders``, ``dense_mask``, ``dense_edge_attr``,
    ``dense_sender_perm``, ``dense_sender_win``),
  - targets are a dict-of-heads.

Every field is emitted with the JAX package's values
(``tests/test_torch_batch.py``, ``tests/test_torch_loader.py`` and
``tests/test_torch_conv_stacks.py`` hold them equal). The conv stacks
that aggregate over the CSR edges never read the dense map; PNA's dense
branch is its one consumer. ``pad_batch`` grows a batch to larger static
shapes (the edge-sharded placement rounds the edge pad up with it).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from hydragnn_tpu_torch.ops.segment_sum_local import local_block_rows

# default node-block target of the window plans (the JAX package's BN)
WIN_BLOCK_ROWS = 128


def _round_up(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple


def _block_windows(
    ids: np.ndarray, perm: np.ndarray, num_rows: int, target_rows: Optional[int] = None
) -> np.ndarray:
    """Per-node-block edge-position windows [2, n_blocks] int32: every
    position p with ``ids[p] // B == i`` lies in ``[win[0, i], win[1, i])``,
    where B = ``local_block_rows(num_rows, n_blocks)`` — the block size
    rides the window's shape. ``perm`` is a stable argsort of ``ids``;
    ``target_rows`` sizes the blocks (default 128). Empty blocks get
    ``lo == hi == 0``."""
    t = target_rows or WIN_BLOCK_ROWS
    n_blocks = max(1, (max(num_rows, 1) + t - 1) // t)
    b_eff = local_block_rows(num_rows, n_blocks)
    lo = np.zeros(n_blocks, dtype=np.int64)
    hi = np.zeros(n_blocks, dtype=np.int64)
    if ids.size:
        sblk = ids[perm] // b_eff  # sorted ids -> sorted block ids
        starts = np.searchsorted(sblk, np.arange(n_blocks), side="left")
        ends = np.searchsorted(sblk, np.arange(n_blocks), side="right")
        ne = ends > starts
        if ne.any():
            # nonempty block segments tile the sorted array contiguously,
            # so reduceat over their starts reduces exactly [start, end)
            lo[ne] = np.minimum.reduceat(perm, starts[ne])
            hi[ne] = np.maximum.reduceat(perm, starts[ne]) + 1
    return np.stack([lo, hi]).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class GraphBatch:
    """A fixed-shape batch of graphs.

    Attributes (all torch tensors; shapes after padding):
      nodes: [N, F] f32 node features.
      senders / receivers: [E] int32 edge endpoints (sender -> receiver);
        receivers sorted ascending.
      node_graph: [N] int32 graph id of each node.
      n_node / n_edge: [G] int32 per-graph counts (padding slots 0).
      node_mask / edge_mask / graph_mask: bool, True for real entries.
      edge_attr: [E, De] f32 or None; pos: [N, 3] f32 or None.
      graph_targets: {name: [G, d]}; node_targets: {name: [N, d]}.
      sender_perm: [E] int32, stable argsort of senders.
      in_degree: [N] f32 count of REAL incoming edges (0 on padding rows).
      edge_occupancy: [] int32, index after the last slot that can hold
        a real edge.
      n_real_nodes: [] int32 real node count.
      sender_win: [2, n_blocks] int32 sender windows (``_block_windows``).
      run_align: int K > 1 for the run-aligned layout, else 0. Masked
        edges may then target REAL nodes (always as self-loops), so
        every consumer applies ``edge_mask``.
      dense_senders: [N, D] int32, node n's real senders in its first
        deg(n) slots (the padding sentinel after them);
        dense_mask: [N, D] bool; dense_edge_attr: [N, D, De] or None;
        dense_sender_perm: [N·D] int32, stable argsort of the flat
        dense senders; dense_sender_win: their window plan. All None
        without ``dense_slots``.
    """

    nodes: torch.Tensor
    senders: torch.Tensor
    receivers: torch.Tensor
    node_graph: torch.Tensor
    n_node: torch.Tensor
    n_edge: torch.Tensor
    node_mask: torch.Tensor
    edge_mask: torch.Tensor
    graph_mask: torch.Tensor
    edge_attr: Optional[torch.Tensor] = None
    pos: Optional[torch.Tensor] = None
    graph_targets: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    node_targets: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    sender_perm: Optional[torch.Tensor] = None
    in_degree: Optional[torch.Tensor] = None
    edge_occupancy: Optional[torch.Tensor] = None
    n_real_nodes: Optional[torch.Tensor] = None
    sender_win: Optional[torch.Tensor] = None
    run_align: int = 0
    dense_senders: Optional[torch.Tensor] = None
    dense_mask: Optional[torch.Tensor] = None
    dense_edge_attr: Optional[torch.Tensor] = None
    dense_sender_perm: Optional[torch.Tensor] = None
    dense_sender_win: Optional[torch.Tensor] = None

    @property
    def num_nodes(self) -> int:
        return self.nodes.shape[0]

    @property
    def num_edges(self) -> int:
        return self.senders.shape[0]

    @property
    def num_graphs(self) -> int:
        return self.n_node.shape[0]

    def _map(self, fn) -> "GraphBatch":
        def move(v):
            if isinstance(v, dict):
                return {k: fn(t) for k, t in v.items()}
            if isinstance(v, torch.Tensor):
                return fn(v)
            return v

        return dataclasses.replace(
            self, **{f.name: move(getattr(self, f.name)) for f in dataclasses.fields(self)}
        )

    def to(self, device, non_blocking: bool = False) -> "GraphBatch":
        """The same batch with every tensor on ``device``; from pinned
        host memory, ``non_blocking`` makes the copy asynchronous."""
        return self._map(lambda t: t.to(device, non_blocking=non_blocking))

    def pin_memory(self) -> "GraphBatch":
        """The same host batch in page-locked memory."""
        return self._map(lambda t: t.pin_memory())


def batch_graphs(
    graphs: Sequence[Dict[str, Any]],
    n_node_pad: Optional[int] = None,
    n_edge_pad: Optional[int] = None,
    n_graph_pad: Optional[int] = None,
    node_multiple: int = 16,
    edge_multiple: int = 8,
    run_align: int = 0,
    win_block_rows: Optional[int] = None,
    dense_slots: Optional[int] = None,
) -> GraphBatch:
    """Concatenate single graphs and pad to static shapes (host, numpy).

    Each graph is a dict with ``x`` [n, F], ``senders``/``receivers``
    [e] (or ``edge_index`` [2, e]), optional ``edge_attr``, ``pos``,
    ``graph_targets`` {name: [d]} and ``node_targets`` {name: [n, d]}.
    ``run_align=K`` (K > 1) emits the run-aligned layout (module
    docstring); ``n_edge_pad`` must then be a multiple of K and hold the
    aligned edge count. ``win_block_rows`` sizes the sender windows'
    node blocks (it must not depend on the batch). ``dense_slots=D``
    emits the dense slot map (module docstring); it excludes
    ``run_align``. Returns CPU tensors; call ``.to(device)`` for the
    card."""
    if not graphs:
        raise ValueError("graphs must be non-empty")
    n_graphs = len(graphs)
    tot_nodes = sum(int(np.asarray(g["x"]).shape[0]) for g in graphs)
    tot_edges = sum(_num_edges(g) for g in graphs)

    for key in ("edge_attr", "pos"):
        present = [g.get(key) is not None for g in graphs]
        if any(present) and not all(present):
            raise ValueError(f"field '{key}' present on some graphs but not others")
    gt_names = sorted(graphs[0].get("graph_targets", {}).keys())
    nt_names = sorted(graphs[0].get("node_targets", {}).keys())
    for g in graphs:
        if sorted(g.get("graph_targets", {}).keys()) != gt_names:
            raise ValueError("graph_targets keys differ across graphs")
        if sorted(g.get("node_targets", {}).keys()) != nt_names:
            raise ValueError("node_targets keys differ across graphs")

    if n_graph_pad is None:
        n_graph_pad = n_graphs + 1
    if n_node_pad is None:
        n_node_pad = _round_up(tot_nodes + 1, node_multiple)
    if n_edge_pad is None:
        n_edge_pad = max(_round_up(tot_edges + 1, edge_multiple), 1)
    if n_graph_pad <= n_graphs:
        raise ValueError(
            f"n_graph_pad={n_graph_pad} must exceed num real graphs {n_graphs} "
            "(one slot is reserved for the padding graph)"
        )
    if n_node_pad <= tot_nodes or n_edge_pad < tot_edges:
        raise ValueError(
            f"padded sizes (nodes {n_node_pad}, edges {n_edge_pad}) too small "
            f"for real totals (nodes {tot_nodes}, edges {tot_edges})"
        )

    feat_dim = _as_2d(graphs[0]["x"]).shape[1]
    nodes = np.zeros((n_node_pad, feat_dim), dtype=np.float32)
    senders = np.full((n_edge_pad,), tot_nodes, dtype=np.int32)
    receivers = np.full((n_edge_pad,), tot_nodes, dtype=np.int32)
    node_graph = np.full((n_node_pad,), n_graphs, dtype=np.int32)
    n_node = np.zeros((n_graph_pad,), dtype=np.int32)
    n_edge = np.zeros((n_graph_pad,), dtype=np.int32)
    node_mask = np.zeros((n_node_pad,), dtype=bool)
    edge_mask = np.zeros((n_edge_pad,), dtype=bool)
    graph_mask = np.zeros((n_graph_pad,), dtype=bool)

    has_edge_attr = graphs[0].get("edge_attr") is not None
    has_pos = graphs[0].get("pos") is not None
    edge_attr = pos = None
    if has_edge_attr:
        de = _as_2d(graphs[0]["edge_attr"]).shape[1]
        edge_attr = np.zeros((n_edge_pad, de), dtype=np.float32)
    if has_pos:
        pos = np.zeros((n_node_pad, np.asarray(graphs[0]["pos"]).shape[-1]), dtype=np.float32)

    g_targets: Dict[str, list] = {}
    n_targets: Dict[str, np.ndarray] = {}
    for name in nt_names:
        d = _as_2d(graphs[0]["node_targets"][name]).shape[1]
        n_targets[name] = np.zeros((n_node_pad, d), dtype=np.float32)

    node_off = edge_off = 0
    for gi, g in enumerate(graphs):
        x = _as_2d(g["x"])
        n, e = x.shape[0], _num_edges(g)
        s, r = _edge_endpoints(g)
        nodes[node_off : node_off + n] = x
        senders[edge_off : edge_off + e] = s + node_off
        receivers[edge_off : edge_off + e] = r + node_off
        node_graph[node_off : node_off + n] = gi
        n_node[gi], n_edge[gi] = n, e
        node_mask[node_off : node_off + n] = True
        edge_mask[edge_off : edge_off + e] = True
        graph_mask[gi] = True
        if has_edge_attr:
            edge_attr[edge_off : edge_off + e] = _as_2d(g["edge_attr"])
        if has_pos:
            pos[node_off : node_off + n] = np.asarray(g["pos"], dtype=np.float32)
        for name in gt_names:
            g_targets.setdefault(name, []).append(
                np.asarray(g["graph_targets"][name], dtype=np.float32).reshape(-1)
            )
        for name in nt_names:
            n_targets[name][node_off : node_off + n] = _as_2d(g["node_targets"][name])
        node_off += n
        edge_off += e

    graph_targets = {}
    for name, rows in g_targets.items():
        arr = np.zeros((n_graph_pad, rows[0].shape[0]), dtype=np.float32)
        arr[:n_graphs] = np.stack(rows)
        graph_targets[name] = arr

    # canonical receiver-major edge order (stable; the padding sentinel
    # tail stays last): the CSR kernel's sorted contract
    if not np.all(receivers[:-1] <= receivers[1:]):
        perm = np.argsort(receivers, kind="stable")
        senders = senders[perm]
        receivers = receivers[perm]
        edge_mask = edge_mask[perm]
        if has_edge_attr:
            edge_attr = edge_attr[perm]

    edge_occ = tot_edges
    if run_align and run_align > 1:
        if dense_slots:
            raise ValueError("run_align and dense_slots are mutually exclusive")
        k = int(run_align)
        if n_edge_pad % k:
            raise ValueError(f"n_edge_pad={n_edge_pad} not a multiple of run_align={k}")
        # real edges occupy [0, tot_edges), receiver-major; re-lay each
        # run on a K-aligned start, the pad slots masked self-loops at
        # their node (receivers stay sorted, senders stay local, and a
        # masked self-loop cannot reach any masked aggregation); the tail
        # keeps the padding-node sentinel
        deg = np.bincount(receivers[:tot_edges], minlength=n_node_pad)
        adeg = ((deg + k - 1) // k) * k * (deg > 0)
        total = int(adeg.sum())
        if total > n_edge_pad:
            raise ValueError(
                f"run_align={k} needs {total} edge slots > n_edge_pad={n_edge_pad}; size "
                "the pad from the aligned per-sample counts (data/loader.py:"
                "_aligned_edge_counts — GraphLoader does this)"
            )
        rs = np.zeros(n_node_pad + 1, dtype=np.int64)
        rs[1:] = np.cumsum(adeg)
        row_ptr = np.zeros(n_node_pad + 1, dtype=np.int64)
        row_ptr[1:] = np.cumsum(deg)
        r = receivers[:tot_edges]
        new_pos = rs[r] + (np.arange(tot_edges) - row_ptr[r])
        new_recv = np.full(n_edge_pad, tot_nodes, dtype=np.int32)
        new_recv[:total] = np.repeat(np.arange(n_node_pad, dtype=np.int32), adeg)
        new_send = new_recv.copy()
        new_mask = np.zeros(n_edge_pad, dtype=bool)
        new_send[new_pos] = senders[:tot_edges]
        new_mask[new_pos] = True
        if has_edge_attr:
            new_ea = np.zeros_like(edge_attr)
            new_ea[new_pos] = edge_attr[:tot_edges]
            edge_attr = new_ea
        senders, receivers, edge_mask = new_send, new_recv, new_mask
        edge_occ = total

    dense_senders = dense_mask = dense_edge_attr = dense_sender_perm = dense_sender_win = None
    if dense_slots is not None and dense_slots > 0:
        # receiver-major and only padding edges masked, so node n's real
        # edges fill the contiguous range [row_ptr[n], row_ptr[n] + deg[n])
        deg = np.bincount(receivers[edge_mask], minlength=n_node_pad)
        dmax = int(deg.max(initial=0))
        if dmax > dense_slots:
            raise ValueError(f"dense_slots={dense_slots} < batch max in-degree {dmax}")
        row_ptr = np.zeros(n_node_pad, dtype=np.int64)
        row_ptr[1:] = np.cumsum(deg)[:-1]
        slot = np.arange(dense_slots, dtype=np.int64)[None, :]
        dense_mask = slot < deg[:, None]
        # empty slots point at the last edge slot (a padding edge)
        dense_edge_pos = np.where(dense_mask, row_ptr[:, None] + slot, n_edge_pad - 1).astype(np.int32)
        dense_senders = senders[dense_edge_pos]
        if has_edge_attr:
            dense_edge_attr = edge_attr[dense_edge_pos]
        dense_sender_perm = np.argsort(dense_senders.reshape(-1), kind="stable").astype(np.int32)
        dense_sender_win = _block_windows(
            dense_senders.reshape(-1), dense_sender_perm, n_node_pad, win_block_rows
        )

    sender_perm = np.argsort(senders, kind="stable").astype(np.int32)
    # REAL edges per receiver (run_align's masked self-loops excluded)
    in_degree = np.bincount(receivers[edge_mask], minlength=n_node_pad).astype(np.float32)
    sender_win = _block_windows(senders, sender_perm, n_node_pad, win_block_rows)

    def maybe(a):
        return None if a is None else torch.from_numpy(a)

    t = torch.from_numpy
    return GraphBatch(
        nodes=t(nodes),
        senders=t(senders),
        receivers=t(receivers),
        node_graph=t(node_graph),
        n_node=t(n_node),
        n_edge=t(n_edge),
        node_mask=t(node_mask),
        edge_mask=t(edge_mask),
        graph_mask=t(graph_mask),
        edge_attr=t(edge_attr) if edge_attr is not None else None,
        pos=t(pos) if pos is not None else None,
        graph_targets={k: t(v) for k, v in graph_targets.items()},
        node_targets={k: t(v) for k, v in n_targets.items()},
        sender_perm=t(sender_perm),
        in_degree=t(in_degree),
        edge_occupancy=torch.tensor(edge_occ, dtype=torch.int32),
        n_real_nodes=torch.tensor(tot_nodes, dtype=torch.int32),
        sender_win=t(sender_win),
        run_align=int(run_align) if run_align and run_align > 1 else 0,
        dense_senders=maybe(dense_senders),
        dense_mask=maybe(dense_mask),
        dense_edge_attr=maybe(dense_edge_attr),
        dense_sender_perm=maybe(dense_sender_perm),
        dense_sender_win=maybe(dense_sender_win),
    )


def _as_2d(a) -> np.ndarray:
    a = np.asarray(a, dtype=np.float32)
    return a[:, None] if a.ndim == 1 else a


def _num_edges(g: Dict[str, Any]) -> int:
    if "senders" in g:
        return int(np.asarray(g["senders"]).shape[0])
    return int(np.asarray(g["edge_index"]).shape[1])


def _edge_endpoints(g: Dict[str, Any]):
    if "senders" in g:
        return np.asarray(g["senders"]), np.asarray(g["receivers"])
    ei = np.asarray(g["edge_index"])
    return ei[0], ei[1]


def pad_batch(batch: GraphBatch, n_node: int, n_edge: int, n_graph: int) -> GraphBatch:
    """Pad an existing batch up to larger static shapes (the JAX
    package's ``pad_batch``): new padding nodes and edges point at a
    padding slot (the first new one, or the batch's reserved last one),
    the senders' sort order and window plans extend without a re-sort
    (the new edges sort last), ``in_degree`` gains zeros. A node growth
    rebuilds the window plans on the host at their block granularity."""
    from hydragnn_tpu_torch.ops.segment_sum_local import local_block_rows

    dn, de, dg = n_node - batch.num_nodes, n_edge - batch.num_edges, n_graph - batch.num_graphs
    if dn < 0 or de < 0 or dg < 0:
        raise ValueError("target shape smaller than current batch")
    if batch.run_align and n_edge % batch.run_align:
        raise ValueError(
            f"n_edge={n_edge} must stay a multiple of run_align="
            f"{batch.run_align} (the model reshapes edges into K-groups)"
        )
    if dn == de == dg == 0:
        return batch

    def pad0(a, amount, value=0):
        if a is None:
            return None
        fill = torch.full((amount,) + tuple(a.shape[1:]), value, dtype=a.dtype, device=a.device)
        return torch.cat([a, fill])

    if dg > 0:
        pad_graph_id = batch.num_graphs
    else:
        if bool(batch.graph_mask[-1]):
            raise ValueError("cannot pad nodes: batch has no padding graph slot")
        pad_graph_id = batch.num_graphs - 1
    if dn > 0:
        pad_node_id = batch.num_nodes
    else:
        if bool(batch.node_mask[-1]):
            raise ValueError("cannot pad edges: batch has no padding node slot")
        pad_node_id = batch.num_nodes - 1
    sender_perm = batch.sender_perm
    if sender_perm is not None:
        sender_perm = torch.cat([sender_perm, torch.arange(batch.num_edges, n_edge, dtype=sender_perm.dtype,
                                                           device=sender_perm.device)])
    in_degree = pad0(batch.in_degree, dn)
    dense_sender_perm = batch.dense_sender_perm
    if dense_sender_perm is not None and batch.dense_senders is not None:
        old_flat = batch.dense_senders.numel()
        new_flat = old_flat + dn * batch.dense_senders.shape[1]
        dense_sender_perm = torch.cat([dense_sender_perm, torch.arange(old_flat, new_flat,
                                                                       dtype=dense_sender_perm.dtype)])

    def extend_win(win, n_appended, old_len, new_len):
        # no node growth: the blocks stay; only the padding node's block
        # widens to the appended tail
        if win is None or n_appended <= 0:
            return win
        b = pad_node_id // local_block_rows(batch.num_nodes, win.shape[1])
        win = win.clone()
        lo = old_len if int(win[0, b]) == int(win[1, b]) else min(int(win[0, b]), old_len)
        win[0, b], win[1, b] = lo, new_len
        return win

    senders = pad0(batch.senders, de, pad_node_id)
    dense_senders = pad0(batch.dense_senders, dn, pad_node_id)
    if dn > 0:
        sender_win = None
        if batch.sender_win is not None and sender_perm is not None:
            target = local_block_rows(batch.num_nodes, batch.sender_win.shape[1])
            sender_win = torch.from_numpy(_block_windows(senders.numpy(), sender_perm.numpy(), n_node, target))
        dense_sender_win = None
        if batch.dense_sender_win is not None and dense_senders is not None and dense_sender_perm is not None:
            target = local_block_rows(batch.num_nodes, batch.dense_sender_win.shape[1])
            dense_sender_win = torch.from_numpy(_block_windows(dense_senders.reshape(-1).numpy(),
                                                               dense_sender_perm.numpy(), n_node, target))
    else:
        sender_win = extend_win(batch.sender_win, de, batch.num_edges, n_edge)
        dense_sender_win = batch.dense_sender_win
        if dense_sender_win is not None and batch.dense_senders is not None:
            k = batch.dense_senders.numel()
            dense_sender_win = extend_win(dense_sender_win, dn * batch.dense_senders.shape[1], k,
                                          k + dn * batch.dense_senders.shape[1])
    return dataclasses.replace(
        batch,
        nodes=pad0(batch.nodes, dn),
        senders=senders,
        receivers=pad0(batch.receivers, de, pad_node_id),
        node_graph=pad0(batch.node_graph, dn, pad_graph_id),
        n_node=pad0(batch.n_node, dg),
        n_edge=pad0(batch.n_edge, dg),
        node_mask=pad0(batch.node_mask, dn, False),
        edge_mask=pad0(batch.edge_mask, de, False),
        graph_mask=pad0(batch.graph_mask, dg, False),
        edge_attr=pad0(batch.edge_attr, de),
        pos=pad0(batch.pos, dn),
        graph_targets={k: pad0(v, dg) for k, v in batch.graph_targets.items()},
        node_targets={k: pad0(v, dn) for k, v in batch.node_targets.items()},
        dense_senders=dense_senders,
        dense_mask=pad0(batch.dense_mask, dn, False),
        dense_edge_attr=pad0(batch.dense_edge_attr, dn),
        sender_perm=sender_perm,
        in_degree=in_degree,
        dense_sender_perm=dense_sender_perm,
        sender_win=sender_win,
        dense_sender_win=dense_sender_win,
    )


def mask_out(batch: GraphBatch) -> GraphBatch:
    """The batch turned into pure padding (the JAX loader's ``_mask_out``):
    every mask False and count zero, the edges repointed at the last node
    slot (always a padding slot), the occupancy and real node count 0,
    the senders' sort order the identity, ``in_degree`` 0, and the window
    plans' padding-node block covering every slot."""
    from hydragnn_tpu_torch.ops.segment_sum_local import local_block_rows

    pad_slot = batch.num_nodes - 1
    upd: Dict[str, Any] = {}
    if batch.dense_mask is not None:
        upd["dense_mask"] = torch.zeros_like(batch.dense_mask)
        upd["dense_senders"] = torch.full_like(batch.dense_senders, pad_slot)
        if batch.dense_sender_perm is not None:
            upd["dense_sender_perm"] = torch.arange(batch.dense_senders.numel(), dtype=torch.int32)
        if batch.dense_sender_win is not None:
            w = torch.zeros_like(batch.dense_sender_win)
            w[1, pad_slot // local_block_rows(batch.num_nodes, w.shape[1])] = batch.dense_senders.numel()
            upd["dense_sender_win"] = w
    if batch.edge_occupancy is not None:
        upd["edge_occupancy"] = torch.zeros((), dtype=torch.int32)
    if batch.n_real_nodes is not None:
        upd["n_real_nodes"] = torch.zeros((), dtype=torch.int32)
    if batch.sender_perm is not None:
        upd["sender_perm"] = torch.arange(batch.num_edges, dtype=torch.int32)
    if batch.in_degree is not None:
        upd["in_degree"] = torch.zeros(batch.num_nodes, dtype=torch.float32)
    if batch.sender_win is not None:
        w = torch.zeros_like(batch.sender_win)
        w[1, pad_slot // local_block_rows(batch.num_nodes, w.shape[1])] = batch.num_edges
        upd["sender_win"] = w
    return dataclasses.replace(
        batch,
        senders=torch.full_like(batch.senders, pad_slot),
        receivers=torch.full_like(batch.receivers, pad_slot),
        node_mask=torch.zeros_like(batch.node_mask),
        edge_mask=torch.zeros_like(batch.edge_mask),
        graph_mask=torch.zeros_like(batch.graph_mask),
        n_node=torch.zeros_like(batch.n_node),
        n_edge=torch.zeros_like(batch.n_edge),
        **upd,
    )
