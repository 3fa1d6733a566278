"""JAX package variables -> the port's ``state_dict``.

``variables_from_flax`` takes the JAX package's ``{"params": ...,
"batch_stats": ...}`` tree of a ``HydraModel`` (nested dicts of numpy
arrays; convert jax arrays with ``np.asarray`` first) and returns the
``state_dict`` of the port's ``HydraModel`` with the same weights.
Layouts: a flax ``Dense`` kernel is [in, out] and becomes
``nn.Linear.weight`` [out, in]; ``PNAConv.pre_kernel`` keeps flax's
[2·fin, fin] layout and is copied as it is, as do GIN's scalar ``eps``
and MFC's stacked ``w_l``/``w_r`` [D+1, fin, out] and ``b_l``
[D+1, out]. A conv's ``Dense_j`` is PNA's post-layer ``post`` in a PNA
conv (one that holds ``pre_kernel``) and ``dense_j`` in every other
(GIN, SAGE, SchNet, CGCNN). Every leaf of the input must be consumed
exactly once, or this raises.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, Mapping):
            out.update(_flatten(val, path))
        else:
            out[path] = np.asarray(val)
    return out


def _dense_index(name: str) -> int:
    if not name.startswith("Dense_"):
        raise KeyError(f"unexpected flax module {name!r}")
    return int(name.split("_", 1)[1])


_CONV_ARRAYS = ("pre_kernel", "pre_bias", "eps", "w_l", "b_l", "w_r")


def _torch_name(path: str, pna_convs: frozenset = frozenset()) -> str:
    """Port parameter/buffer name for one flax leaf path; ``pna_convs``
    holds the indices of the PNA convs."""
    parts = path.split("/")
    coll, mod = parts[0], parts[1]
    if coll == "batch_stats":
        i = int(mod.split("_")[1])  # MaskedBatchNorm_{i}
        return f"norms.{i}." + {"mean": "running_mean", "var": "running_var"}[parts[2]]
    if mod.startswith("MaskedBatchNorm_"):
        i = int(mod.split("_")[1])
        return f"norms.{i}." + {"scale": "weight", "bias": "bias"}[parts[2]]
    if mod.startswith("conv_"):
        i = int(mod.split("_")[1])
        if parts[2] in _CONV_ARRAYS and len(parts) == 3:
            return f"convs.{i}.{parts[2]}"
        j = _dense_index(parts[2])
        sub = "post" if i in pna_convs else f"dense_{j}"
        if i in pna_convs and j != 0:
            raise KeyError(f"no port counterpart for flax leaf {path!r}")
        return f"convs.{i}.{sub}." + {"kernel": "weight", "bias": "bias"}[parts[3]]
    leaf = {"kernel": "weight", "bias": "bias"}[parts[3]]
    if mod == "graph_shared":
        return f"graph_shared.layers.{_dense_index(parts[2])}.{leaf}"
    for kind in ("graph_head_", "node_head_"):
        if mod.startswith(kind):
            ihead = int(mod[len(kind):])
            return f"heads.{ihead}.layers.{_dense_index(parts[2])}.{leaf}"
    raise KeyError(f"no port counterpart for flax leaf {path!r}")


def variables_from_flax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` holding the weights of ``variables``."""
    flat = _flatten(variables)
    pna_convs = frozenset(
        int(p.split("/")[1].split("_")[1]) for p in flat
        if p.startswith("params/conv_") and p.endswith("/pre_kernel")
    )
    out: Dict[str, torch.Tensor] = {}
    for path, arr in flat.items():
        name = _torch_name(path, pna_convs)
        if name in out:
            raise ValueError(f"two flax leaves map to {name!r} (second: {path!r})")
        if path.endswith("/kernel"):
            arr = arr.T  # flax Dense [in, out] -> nn.Linear [out, in]
        # np.array, not np.ascontiguousarray: that one turns a 0-d leaf (eps) into [1]
        out[name] = torch.tensor(np.array(arr, dtype=np.float32))
    return out
