"""HGC: sharded binary graph container — the ADIOS2-equivalent store.

Same schema as the reference's ADIOS design (reference:
hydragnn/utils/adiosdataset.py:79-179): each field of every sample is
concatenated along its ragged axis into ONE global array per field, with
per-sample ``count`` index arrays (offsets = exclusive cumsum) and global
attributes (ndata, minmax tables). On-disk layout under ``<path>/``:

    meta.json            schema: ndata, fields {dtype, row_shape}, attrs
    <field>.bin          the concatenated global array (C-order rows)
    <field>.cnt          int64[ndata] per-sample row counts

Field names: ``x``, ``pos``, ``edge_index`` (stored row-ragged as [e, 2]),
``edge_attr``, ``graph_y``, ``gt_<head>``/``nt_<head>`` target dicts.

Read modes (reference AdiosDataset modes, adiosdataset.py:263-368):
  - ``mmap``    zero-copy memory-mapped reads (out-of-core; page cache
                shares physical pages across processes on a host),
  - ``preload`` load everything into RAM up front,
  - ``shm``     one-copy preload into /dev/shm per node, then mmap from
                there (parallel-filesystem-friendly).

The read hot path (batched ragged row-gather) and the shm copy run in the
native C++ core (``hydragnn_tpu_torch.native``, libhgc.so) with a numpy
fallback.

The port's copy of ``hydragnn_tpu/data/container.py``: the on-disk schema
is the same byte for byte, so a container either package writes opens in
the other. Several processes write one container together as the JAX
package's do: each process its own byte range (``ContainerWriter``).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from hydragnn_tpu_torch.data.dataset import GraphSample
from hydragnn_tpu_torch.native import MappedFile, copy_to_shm
from hydragnn_tpu_torch.parallel.mesh import barrier


def _field_arrays(sample: GraphSample) -> Dict[str, np.ndarray]:
    """Decompose a GraphSample into named row-ragged 2-D arrays."""
    out: Dict[str, np.ndarray] = {"x": np.asarray(sample.x, dtype=np.float32)}
    if sample.pos is not None:
        out["pos"] = np.asarray(sample.pos, dtype=np.float32)
    if sample.edge_index is not None:
        out["edge_index"] = np.ascontiguousarray(
            np.asarray(sample.edge_index, dtype=np.int32).T
        )  # [e, 2]: ragged axis first
    if sample.edge_attr is not None:
        out["edge_attr"] = np.asarray(sample.edge_attr, dtype=np.float32)
    if sample.graph_y is not None:
        out["graph_y"] = np.asarray(sample.graph_y, dtype=np.float32).reshape(1, -1)
    for name, v in sample.graph_targets.items():
        out[f"gt_{name}"] = np.asarray(v, dtype=np.float32).reshape(1, -1)
    for name, v in sample.node_targets.items():
        out[f"nt_{name}"] = np.asarray(v, dtype=np.float32)
    # meta (e.g. PBC cell, composition id) rides along as ragged JSON bytes
    # — dropping it would break downstream PBC edge building
    # (data/ingest.py requires meta['cell']).
    meta_bytes = json.dumps(_jsonable_meta(sample.meta)).encode() if sample.meta else b""
    out["meta"] = np.frombuffer(meta_bytes, dtype=np.uint8).reshape(-1, 1).copy()
    # zero-width fields (e.g. graph_y with no configured graph features)
    # carry no data and would mmap empty .bin files
    return {k: v for k, v in out.items() if int(np.prod(v.shape[1:])) > 0 or v.ndim == 1}


def _jsonable_meta(meta: Dict[str, Any]) -> Dict[str, Any]:
    out = {}
    for k, v in meta.items():
        if isinstance(v, np.ndarray):
            out[k] = v.tolist()
        elif isinstance(v, (np.integer, np.floating)):
            out[k] = v.item()
        else:
            out[k] = v
    return out


def _world_and_rank():
    """(processes, rank) of an initialised ``torch.distributed`` group,
    (1, 0) without one."""
    from hydragnn_tpu_torch.parallel.mesh import get_comm_size_and_rank

    return get_comm_size_and_rank()


def _all_gather_object(obj) -> list:
    import torch.distributed as dist

    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


class ContainerWriter:
    """Writes a sample list (this process's shard) into an HGC container.

    Single process: trivial. In an initialised ``torch.distributed``
    group of several processes every process calls ``save()`` with its
    own shard, in rank order of the samples: the schema fingerprints,
    the sample counts and each field's per-sample row counts are
    gathered (``all_gather_object``), rank 0 sizes each ``.bin`` and
    writes the whole count index, a barrier, then each process writes
    its own byte range (the JAX package's multi-process branch). The
    files are the bytes one process writes from all the shards in order.
    """

    def __init__(self, path: str):
        self.path = path
        self.samples: List[GraphSample] = []
        self.attrs: Dict[str, Any] = {}

    def add(self, samples: Sequence[GraphSample]) -> None:
        self.samples.extend(samples)

    def add_global(self, name: str, value) -> None:
        self.attrs[name] = np.asarray(value).tolist() if hasattr(value, "tolist") else value

    def save(self) -> None:
        nproc, rank = _world_and_rank()
        os.makedirs(self.path, exist_ok=True)

        per_sample = [_field_arrays(s) for s in self.samples]
        if not per_sample:
            # an empty shard cannot learn the schema, and skipping its
            # collectives would deadlock peers mid-save
            raise ValueError("save() needs at least one sample")
        field_names = sorted(per_sample[0].keys())
        for i, fa in enumerate(per_sample):
            if sorted(fa.keys()) != field_names:
                raise ValueError(
                    f"sample {i} has fields {sorted(fa.keys())}, "
                    f"expected {field_names} (schema must be homogeneous)"
                )
        if nproc > 1:
            import hashlib

            # every field's per-sample row counts, with the schema's
            # fingerprint: one gather for the whole save
            fp = hashlib.sha1(",".join(field_names).encode()).hexdigest()
            local = {fname: [int(fa[fname].shape[0]) for fa in per_sample] for fname in field_names}
            gathered = _all_gather_object((fp, local))
            if any(g[0] != fp for g in gathered):
                raise ValueError("field schema differs across processes")
            all_counts = [g[1] for g in gathered]
        else:
            all_counts = [{fname: [int(fa[fname].shape[0]) for fa in per_sample] for fname in field_names}]
        ndata = sum(len(c[field_names[0]]) for c in all_counts)

        meta: Dict[str, Any] = {
            "ndata": ndata,
            "keys": field_names,
            "attrs": self.attrs,
            "fields": {},
        }
        for fname in field_names:
            arrays = [fa[fname] for fa in per_sample]
            row_shape = arrays[0].shape[1:]
            dtype = arrays[0].dtype
            concat = np.concatenate(arrays, axis=0)
            rows = [sum(c[fname]) for c in all_counts]
            total_rows = int(sum(rows))
            row_start = int(sum(rows[:rank]))
            row_elems = int(np.prod(row_shape)) if row_shape else 1
            if total_rows * row_elems == 0:
                # nothing to store (e.g. no sample carries meta); an empty
                # .bin cannot be mmapped, so omit the field entirely
                continue
            bin_path = os.path.join(self.path, f"{fname}.bin")
            cnt_path = os.path.join(self.path, f"{fname}.cnt")
            if nproc == 1:
                with open(bin_path, "wb") as f:
                    f.write(np.ascontiguousarray(concat).tobytes())
            else:
                if rank == 0:
                    with open(bin_path, "wb") as f:
                        f.truncate(total_rows * row_elems * dtype.itemsize)
                barrier(f"hgc_alloc_{fname}")
                if concat.shape[0] > 0:
                    with open(bin_path, "r+b") as f:
                        f.seek(row_start * row_elems * dtype.itemsize)
                        f.write(np.ascontiguousarray(concat).tobytes())
            if rank == 0:
                np.asarray([n for c in all_counts for n in c[fname]], dtype=np.int64).tofile(cnt_path)
            meta["fields"][fname] = {
                "dtype": dtype.name,
                "row_shape": list(row_shape),
                "total_rows": total_rows,
            }
        if rank == 0:
            with open(os.path.join(self.path, "meta.json"), "w") as f:
                json.dump(meta, f)
        if nproc > 1:
            barrier("hgc_meta")


class ContainerDataset:
    """Reads an HGC container; ``get(i)`` returns a GraphSample.

    Modes: ``mmap`` (default, out-of-core), ``preload`` (all in RAM),
    ``shm`` (node-local /dev/shm preload + mmap). ``fetch_rows`` exposes
    the threaded native batched gather for bulk loading.
    """

    def __init__(self, path: str, mode: str = "mmap", shm_dir: Optional[str] = None):
        if mode not in ("mmap", "preload", "shm"):
            raise ValueError(f"unknown mode {mode}")
        self.path = path
        self.mode = mode
        with open(os.path.join(path, "meta.json")) as f:
            self.meta = json.load(f)
        self.ndata: int = int(self.meta["ndata"])
        self.attrs: Dict[str, Any] = self.meta.get("attrs", {})
        self.fields: Dict[str, Dict[str, Any]] = self.meta["fields"]

        self._maps: Dict[str, MappedFile] = {}
        self._views: Dict[str, np.ndarray] = {}
        self._counts: Dict[str, np.ndarray] = {}
        self._offsets: Dict[str, np.ndarray] = {}
        # key the default shm dir on the full path, not the basename —
        # distinct containers named alike must not shadow each other
        import hashlib

        path_key = hashlib.sha1(os.path.abspath(path).encode()).hexdigest()[:12]
        shm_target = shm_dir or os.path.join(
            "/dev/shm",
            f"hgc_{os.path.basename(os.path.normpath(path))}_{path_key}",
        )
        for fname, info in self.fields.items():
            bin_path = os.path.join(path, f"{fname}.bin")
            cnt_path = os.path.join(path, f"{fname}.cnt")
            if mode == "shm":
                bin_path = copy_to_shm(bin_path, shm_target)
            cnt = np.fromfile(cnt_path, dtype=np.int64)
            self._counts[fname] = cnt
            self._offsets[fname] = np.concatenate([[0], np.cumsum(cnt)])
            mf = MappedFile(bin_path)
            self._maps[fname] = mf
            view = mf.view(np.dtype(info["dtype"]), tuple(info["row_shape"]))
            if mode == "preload":
                view = np.array(view)  # materialize in RAM
            self._views[fname] = view

    def __len__(self) -> int:
        return self.ndata

    def field_rows(self, fname: str, idx: int) -> np.ndarray:
        off = self._offsets[fname]
        return self._views[fname][off[idx] : off[idx + 1]]

    def _assemble(self, rows) -> GraphSample:
        """Build one GraphSample from a ``rows(fname) -> ndarray``
        accessor (shared by the per-sample and bulk read paths)."""
        sample = GraphSample(x=np.array(rows("x")))
        if "pos" in self._views:
            sample.pos = np.array(rows("pos"))
        if "edge_index" in self._views:
            sample.edge_index = np.ascontiguousarray(rows("edge_index").T)
        if "edge_attr" in self._views:
            sample.edge_attr = np.array(rows("edge_attr"))
        if "graph_y" in self._views:
            sample.graph_y = np.array(rows("graph_y")).reshape(-1)
        for fname in self._views:
            if fname.startswith("gt_"):
                sample.graph_targets[fname[3:]] = np.array(rows(fname)).reshape(-1)
            elif fname.startswith("nt_"):
                sample.node_targets[fname[3:]] = np.array(rows(fname))
        if "meta" in self._views:
            raw = np.array(rows("meta")).reshape(-1).tobytes()
            if raw:
                sample.meta = json.loads(raw.decode())
                # PBC cells round-trip as arrays (ingest requires them)
                if "cell" in sample.meta:
                    sample.meta["cell"] = np.asarray(sample.meta["cell"])
        return sample

    def get(self, idx: int) -> GraphSample:
        if not 0 <= idx < self.ndata:
            raise IndexError(idx)
        return self._assemble(lambda f: self.field_rows(f, idx))

    def __getitem__(self, idx: int) -> GraphSample:
        return self.get(idx)

    def samples(self, indices: Optional[Sequence[int]] = None) -> List[GraphSample]:
        if indices is None:
            indices = range(self.ndata)
        return [self.get(i) for i in indices]

    def fetch_samples(self, indices: Sequence[int]) -> List[GraphSample]:
        """Materialize an index list with ONE bulk read per field — the
        reference AdiosDataset's experimental bulk preflight/populate
        loader (reference: hydragnn/utils/adiosdataset.py:389-437), here
        backed by the native threaded ragged gather (hgc_gather) instead
        of per-sample reads: each field's rows for ALL requested samples
        arrive in a single packed buffer, then slice into GraphSamples."""
        idx = [int(i) for i in indices]
        for i in idx:
            if not 0 <= i < self.ndata:
                raise IndexError(i)
        packed: Dict[str, np.ndarray] = {}
        offs: Dict[str, np.ndarray] = {}
        for fname in self._views:
            rows, cnt = self.fetch_rows(fname, idx)
            packed[fname] = rows
            offs[fname] = np.concatenate([[0], np.cumsum(cnt)])
        out: List[GraphSample] = []
        for k in range(len(idx)):
            out.append(
                self._assemble(
                    lambda f, k=k: packed[f][offs[f][k] : offs[f][k + 1]]
                )
            )
        return out

    def fetch_rows(self, fname: str, indices: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
        """Bulk ragged gather via the native threaded core: returns
        (packed rows [sum(cnt), *row_shape], per-sample counts)."""
        info = self.fields[fname]
        dtype = np.dtype(info["dtype"])
        row_shape = tuple(info["row_shape"])
        row_elems = int(np.prod(row_shape)) if row_shape else 1
        row_bytes = row_elems * dtype.itemsize
        idx = np.asarray(indices, dtype=np.int64)
        cnt = self._counts[fname][idx]
        src_off = self._offsets[fname][idx]
        out_off = np.concatenate([[0], np.cumsum(cnt)[:-1]])
        total = int(cnt.sum())
        if self.mode == "preload":
            packed = np.concatenate(
                [self._views[fname][s : s + c] for s, c in zip(src_off, cnt)], axis=0
            ) if total else np.zeros((0,) + row_shape, dtype)
            return packed, cnt
        out = np.empty(total * row_bytes, dtype=np.uint8)
        self._maps[fname].gather(row_bytes, src_off, cnt, out_off, out)
        return out.view(dtype).reshape((total,) + row_shape), cnt

    def minmax(self) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
        g = self.attrs.get("minmax_graph_feature")
        n = self.attrs.get("minmax_node_feature")
        return (
            np.asarray(g) if g is not None else None,
            np.asarray(n) if n is not None else None,
        )

    def close(self) -> None:
        for mf in self._maps.values():
            mf.close()
        self._maps.clear()
        self._views.clear()
