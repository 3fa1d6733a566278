"""One-shot importer for existing HydraGNN datasets.

Existing HydraGNN deployments hold their preprocessed datasets in one of
two on-disk formats (reference: hydragnn/utils/pickledataset.py:12-146
sharded-pickle layout; hydragnn/utils/adiosdataset.py:79-179 ADIOS2
schema). This module reads the sharded-pickle layout WITHOUT torch or
torch_geometric being importable as packages in their reference form —
the pickles contain torch_geometric ``Data`` objects, which are
reconstructed through a tolerant unpickler that stubs every
``torch_geometric.*`` class and then walks the captured state for the
tensor payload — and converts it into an HGC container
(:mod:`hydragnn_tpu_torch.data.container`), the native dataset format
here. The port's copy of ``hydragnn_tpu/data/import_reference.py``.

Layout read (pickledataset.py):
  <basedir>/<label>-meta.pkl   5 sequential pickles: minmax_node_feature,
                               minmax_graph_feature, ntotal, use_subdir,
                               nmax_persubdir
  <basedir>/<label>-<k>.pkl    one pickled PyG Data per sample
                               (under <k // nmax_persubdir>/ subdirs when
                               use_subdir)

The ADIOS2 format (group arrays + per-variable concatenated payloads
with ragged offsets) is read by the JAX package's
``data/adios_reference.py``, which the port has not taken over yet
(ROADMAP A-3): the CLI below refuses ``.bp`` inputs.
``tools/export_adios_to_pickle.py`` is a standalone adios2+numpy script
that emits the sharded-pickle layout this module consumes.

The reference's ragged ``data.y`` + ``y_loc`` offset table (written by
serialized_dataset_loader.py:262-303) is unpacked into the dict-of-heads
``GraphSample`` layout when present; otherwise ``y`` is kept as the
graph-level target vector.
"""

from __future__ import annotations

import io
import os
import pickle
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from hydragnn_tpu_torch.data.dataset import GraphSample


class _Stub:
    """Stand-in for any unimportable class found in a reference pickle:
    captures constructor args and state without executing any foreign
    code (also a safety property — reference pickles are untrusted, and
    the allowlist below means no arbitrary class is ever instantiated)."""

    _args: tuple = ()
    _state: Any = None

    def __init__(self, *args, **kwargs):
        self._args = args

    def __setstate__(self, state):
        self._state = state

    # PyG BaseStorage pickles may invoke __setitem__-style protocols on
    # append-capable reductions; accept and record them.
    def append(self, item):
        self._args = self._args + (item,)

    def extend(self, items):
        self._args = self._args + tuple(items)


def _safe_storage_from_bytes(b):
    """Replacement for ``torch.storage._load_from_bytes``, whose stock
    implementation calls ``torch.load(weights_only=False)`` — a full
    unrestricted unpickle of attacker-controlled bytes. Storage payloads
    load fine under the restricted loader."""
    import torch

    return torch.load(io.BytesIO(b), weights_only=True)


# Exact (module, name) pairs a reference pickle legitimately needs to
# rebuild tensor/array payloads. Everything else — including builtins
# (builtins.eval/exec resolve through find_class!) and the rest of the
# torch/numpy module trees — maps to _Stub. Names resolved lazily so a
# pickle can't force-import anything beyond torch/numpy themselves.
_SAFE_TORCH_NAMES = frozenset(
    # dtypes (pickled as torch.<name> attribute lookups)
    """float16 float32 float64 bfloat16 complex64 complex128
       int8 int16 int32 int64 uint8 uint16 uint32 uint64 bool""".split()
) | frozenset(
    # shape + legacy typed-storage holders (plain data containers)
    """Size FloatStorage DoubleStorage HalfStorage BFloat16Storage
       LongStorage IntStorage ShortStorage CharStorage ByteStorage
       BoolStorage""".split()
)

_SAFE_GLOBALS = {
    ("torch._utils", "_rebuild_tensor_v2"): None,
    ("torch._utils", "_rebuild_tensor"): None,
    ("torch.storage", "_load_from_bytes"): lambda: _safe_storage_from_bytes,
    ("numpy", "ndarray"): None,
    ("numpy", "dtype"): None,
    ("numpy.core.multiarray", "_reconstruct"): None,
    ("numpy._core.multiarray", "_reconstruct"): None,
    ("numpy.core.multiarray", "scalar"): None,
    ("numpy._core.multiarray", "scalar"): None,
    ("numpy.core.numeric", "_frombuffer"): None,
    ("numpy._core.numeric", "_frombuffer"): None,
    ("_codecs", "encode"): None,  # numpy latin-1 buffer round-trip
    ("collections", "OrderedDict"): None,
}


class _TolerantUnpickler(pickle.Unpickler):
    """Unpickler that rebuilds tensor/array payloads through an exact
    (module, name) allowlist and maps every other global
    (torch_geometric.*, mpi4py leftovers, builtins, ...) to _Stub.

    Nothing outside the allowlist is ever resolved, let alone executed —
    foreign state is captured structurally; torch storage bytes load via
    ``weights_only=True``. That makes loading a foreign pickle no more
    dangerous than parsing it."""

    def find_class(self, module: str, name: str):
        if module == "torch" and name in _SAFE_TORCH_NAMES:
            return super().find_class(module, name)
        hit = _SAFE_GLOBALS.get((module, name), _Stub)
        if hit is None:
            return super().find_class(module, name)
        if hit is _Stub:
            return _Stub
        return hit()


def _load_pickle_stream(path: str, count: int) -> list:
    out = []
    with open(path, "rb") as f:
        for _ in range(count):
            out.append(_TolerantUnpickler(f).load())
    return out


def _to_numpy(v) -> Optional[np.ndarray]:
    """torch.Tensor / ndarray / scalar -> ndarray, else None."""
    if v is None:
        return None
    if isinstance(v, np.ndarray):
        return v
    if hasattr(v, "detach") and hasattr(v, "numpy"):  # torch.Tensor
        try:
            return v.detach().cpu().numpy()
        except Exception:
            return None
    if isinstance(v, (int, float)):
        return np.asarray([v], dtype=np.float32)
    return None


def _tensor_mapping(obj, depth: int = 0) -> Dict[str, np.ndarray]:
    """Walk a stubbed object graph for the innermost dict holding the
    tensor payload (PyG Data stores it at Data.__dict__['_store']
    ._mapping across 2.x versions; older versions keep tensors directly
    in __dict__). Returns {key: ndarray}."""
    if depth > 6:
        return {}
    found: Dict[str, np.ndarray] = {}
    state = None
    if isinstance(obj, dict):
        state = obj
    elif isinstance(obj, _Stub):
        state = obj._state if isinstance(obj._state, dict) else None
        if state is None and obj._args and isinstance(obj._args[-1], dict):
            state = obj._args[-1]
    if state is None:
        return {}
    for k, v in state.items():
        if not isinstance(k, str):
            continue
        arr = _to_numpy(v)
        if arr is not None:
            found[k.lstrip("_")] = arr
        elif isinstance(v, (dict, _Stub)):
            inner = _tensor_mapping(v, depth + 1)
            # deeper mappings win only for keys not already present
            for ik, iv in inner.items():
                found.setdefault(ik, iv)
    return found


def _unpack_y(
    fields: Dict[str, np.ndarray],
    head_types: Optional[Sequence[str]] = None,
    head_names: Optional[Sequence[str]] = None,
) -> Dict[str, Any]:
    """Split the reference's packed ``y`` + ``y_loc`` into the
    dict-of-heads layout (update_predicted_values packing:
    serialized_dataset_loader.py:262-303 — head h occupies rows
    [y_loc[h], y_loc[h+1]), node heads store num_nodes x dim
    row-major)."""
    y = fields.get("y")
    y_loc = fields.get("y_loc")
    n_nodes = fields["x"].shape[0]
    out: Dict[str, Any] = {"graph_targets": {}, "node_targets": {}, "graph_y": None}
    if y is None:
        return out
    y = y.reshape(-1).astype(np.float32)
    if y_loc is None:
        out["graph_y"] = y
        return out
    y_loc = y_loc.reshape(-1).astype(np.int64)
    n_heads = y_loc.shape[0] - 1
    for h in range(n_heads):
        seg = y[y_loc[h] : y_loc[h + 1]]
        name = (
            head_names[h]
            if head_names is not None and h < len(head_names)
            else f"head{h}"
        )
        if head_types is not None and h < len(head_types):
            htype = head_types[h]
        elif seg.shape[0] % n_nodes == 0 and seg.shape[0] >= n_nodes:
            # A graph head whose dim happens to be a multiple of
            # num_nodes is indistinguishable from a node head here, and
            # silent misinference reshapes (= corrupts) targets. This
            # used to be a warning; an importer that keeps going on a
            # coin-flip classification writes a permanently wrong
            # container, so it is a hard error with an escape hatch.
            raise ValueError(
                f"head {h} ({name!r}): length {seg.shape[0]} divides "
                f"num_nodes={n_nodes}, so it could be a node head "
                f"([{n_nodes}, {seg.shape[0] // n_nodes}]) or a "
                f"graph-level head of dim {seg.shape[0]} — ambiguous. "
                "Pass head_types=['graph'|'node', ...] (CLI: repeat "
                "--head-type in y_loc order) to pin every head "
                "explicitly."
            )
        else:
            htype = "graph"
        if htype == "node":
            out["node_targets"][name] = seg.reshape(n_nodes, -1)
        else:
            out["graph_targets"][name] = seg
    return out


def data_object_to_sample(
    obj,
    head_types: Optional[Sequence[str]] = None,
    head_names: Optional[Sequence[str]] = None,
) -> GraphSample:
    """Stubbed PyG ``Data`` -> :class:`GraphSample`."""
    fields = _tensor_mapping(obj)
    if "x" not in fields:
        raise ValueError(
            f"no 'x' tensor found in pickled object (keys: {sorted(fields)})"
        )
    x = fields["x"].astype(np.float32)
    x = x[:, None] if x.ndim == 1 else x
    ei = fields.get("edge_index")
    heads = _unpack_y(fields, head_types, head_names)
    ea = fields.get("edge_attr")
    if ea is not None:
        ea = ea.astype(np.float32)
        ea = ea[:, None] if ea.ndim == 1 else ea
    return GraphSample(
        x=x,
        pos=None if fields.get("pos") is None else fields["pos"].astype(np.float32),
        edge_index=None if ei is None else ei.astype(np.int32),
        edge_attr=ea,
        graph_y=heads["graph_y"],
        graph_targets=heads["graph_targets"],
        node_targets=heads["node_targets"],
    )


class ReferencePickleReader:
    """Reader for the reference sharded-pickle layout."""

    def __init__(self, basedir: str, label: str):
        meta_path = os.path.join(basedir, f"{label}-meta.pkl")
        if not os.path.exists(meta_path):
            raise FileNotFoundError(
                f"{meta_path} not found — expected the reference layout "
                "written by hydragnn/utils/pickledataset.py:SimplePickleWriter"
            )
        (
            self.minmax_node_feature,
            self.minmax_graph_feature,
            self.ntotal,
            self.use_subdir,
            self.nmax_persubdir,
        ) = _load_pickle_stream(meta_path, 5)
        self.basedir = basedir
        self.label = label

    def __len__(self) -> int:
        return int(self.ntotal)

    def _path(self, k: int) -> str:
        fname = f"{self.label}-{k}.pkl"
        if self.use_subdir:
            return os.path.join(self.basedir, str(k // self.nmax_persubdir), fname)
        return os.path.join(self.basedir, fname)

    def read(
        self,
        k: int,
        head_types: Optional[Sequence[str]] = None,
        head_names: Optional[Sequence[str]] = None,
    ) -> GraphSample:
        with open(self._path(k), "rb") as f:
            obj = _TolerantUnpickler(f).load()
        return data_object_to_sample(obj, head_types, head_names)

    def samples(
        self,
        head_types: Optional[Sequence[str]] = None,
        head_names: Optional[Sequence[str]] = None,
    ) -> List[GraphSample]:
        return [self.read(k, head_types, head_names) for k in range(len(self))]


class ReferenceMonolithicReader:
    """Reader for the reference's MONOLITHIC pickle layouts — one file
    holding 3 sequential pickles (minmax_node_feature,
    minmax_graph_feature, list-of-Data):

    - ``SerializedDataset`` (hydragnn/utils/serializeddataset.py:10-87):
      ``<basedir>/<datasetname>-<label>.pkl``, or per-rank
      ``<datasetname>-<label>-<rank>.pkl`` when written distributed;
    - the legacy ``run_training`` path's
      ``serialized_dataset/<name>[_split].pkl`` files
      (hydragnn/preprocess/raw_dataset_loader.py) — same 3-object body.

    Given one ``.pkl`` path, rank-sharded siblings
    (``<stem>-<rank>.pkl``) are discovered and concatenated in rank
    order automatically."""

    def __init__(self, path: str):
        stem = path[: -len(".pkl")] if path.endswith(".pkl") else path
        if os.path.isfile(path):
            self.paths = [path]
        else:
            # a dist write leaves only <stem>-0.pkl, <stem>-1.pkl, ...;
            # accept the base name and concatenate the rank set
            shards: List[str] = []
            r = 0
            while os.path.exists(f"{stem}-{r}.pkl"):
                shards.append(f"{stem}-{r}.pkl")
                r += 1
            if not shards:
                raise FileNotFoundError(path)
            self.paths = shards
        self.minmax_node_feature = None
        self.minmax_graph_feature = None
        self._objects: List[Any] = []
        for p in self.paths:
            mm_node, mm_graph, objs = _load_pickle_stream(p, 3)
            if self.minmax_node_feature is None:
                self.minmax_node_feature = mm_node
                self.minmax_graph_feature = mm_graph
            if isinstance(objs, _Stub):
                # list subclasses pickle their items through append/extend
                objs = list(objs._args)
            if not isinstance(objs, (list, tuple)):
                raise ValueError(
                    f"{p}: third pickle object is {type(objs).__name__}, "
                    "expected the list of Data samples"
                )
            self._objects.extend(objs)

    def __len__(self) -> int:
        return len(self._objects)

    def samples(
        self,
        head_types: Optional[Sequence[str]] = None,
        head_names: Optional[Sequence[str]] = None,
    ) -> List[GraphSample]:
        return [
            data_object_to_sample(o, head_types, head_names)
            for o in self._objects
        ]


def import_monolithic_dataset(
    path: str,
    out_path: str,
    head_types: Optional[Sequence[str]] = None,
    head_names: Optional[Sequence[str]] = None,
) -> int:
    """Convert one reference monolithic-pickle dataset (single file or
    rank-sharded set) into an HGC container. Returns the sample count."""
    from hydragnn_tpu_torch.data.container import ContainerWriter

    reader = ReferenceMonolithicReader(path)
    writer = ContainerWriter(out_path)
    writer.add(reader.samples(head_types, head_names))
    for name, val in (
        ("minmax_node_feature", reader.minmax_node_feature),
        ("minmax_graph_feature", reader.minmax_graph_feature),
    ):
        arr = _to_numpy(val)
        if arr is not None:
            writer.add_global(name, arr)
    writer.save()
    return len(reader)


def import_pickle_dataset(
    basedir: str,
    label: str,
    out_path: str,
    head_types: Optional[Sequence[str]] = None,
    head_names: Optional[Sequence[str]] = None,
) -> int:
    """Convert one reference pickle dataset (``<basedir>/<label>-*.pkl``)
    into an HGC container at ``out_path``. Returns the sample count.

    The reference minmax metadata rides along as container globals so
    downstream normalization (data/ingest.py) can reuse it."""
    from hydragnn_tpu_torch.data.container import ContainerWriter

    reader = ReferencePickleReader(basedir, label)
    writer = ContainerWriter(out_path)
    writer.add(reader.samples(head_types, head_names))
    for name, val in (
        ("minmax_node_feature", reader.minmax_node_feature),
        ("minmax_graph_feature", reader.minmax_graph_feature),
    ):
        arr = _to_numpy(val)
        if arr is not None:
            writer.add_global(name, arr)
    writer.save()
    return len(reader)


def looks_like_adios(path: str) -> bool:
    """True when ``path`` is plausibly an ADIOS2 BP file or directory (a
    ``.bp`` name, or a directory holding ``md.idx``/``md.0``). A path
    that does not exist is never ADIOS."""
    if not os.path.exists(path):
        return False
    if path.rstrip("/").endswith(".bp"):
        return True
    if os.path.isdir(path):
        return bool({"md.idx", "md.0"} & set(os.listdir(path)))
    return False


def main(argv: Optional[Sequence[str]] = None) -> None:
    import argparse

    p = argparse.ArgumentParser(
        description="Convert a reference HydraGNN dataset (sharded-pickle "
        "directory or monolithic pickle) into an HGC container."
    )
    p.add_argument(
        "source",
        help="sharded-pickle directory holding <label>-meta.pkl, or a "
        "monolithic SerializedDataset .pkl file (rank-sharded sets: "
        "pass the base name)",
    )
    p.add_argument(
        "label",
        nargs="?",
        default="total",
        help="dataset label (e.g. 'trainset', 'total'); unused for "
        "monolithic .pkl inputs (the file IS the split)",
    )
    p.add_argument("out", help="output .hgc container path")
    p.add_argument(
        "--head-type",
        action="append",
        choices=["graph", "node"],
        help="per-head type, in y_loc order (repeat; inferred if omitted)",
    )
    p.add_argument(
        "--head-name", action="append", help="per-head name, in y_loc order"
    )
    args = p.parse_args(argv)
    if looks_like_adios(args.source):
        raise NotImplementedError(
            "reading ADIOS2 .bp datasets is not ported yet (ROADMAP A-3); "
            "export them with tools/export_adios_to_pickle.py first"
        )
    elif args.source.endswith(".pkl") or os.path.isfile(args.source):
        n = import_monolithic_dataset(
            args.source, args.out, args.head_type, args.head_name
        )
    else:
        n = import_pickle_dataset(
            args.source, args.label, args.out, args.head_type, args.head_name
        )
    print(f"imported {n} samples -> {args.out}")


if __name__ == "__main__":
    main()
