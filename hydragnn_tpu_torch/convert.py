"""JAX package variables -> the port's ``state_dict``.

``variables_from_flax`` takes the JAX package's ``{"params": ...,
"batch_stats": ...}`` tree of a ``HydraModel`` (nested dicts of numpy
arrays; convert jax arrays with ``np.asarray`` first) and returns the
``state_dict`` of the port's ``HydraModel`` with the same weights.
Layouts: a flax ``Dense`` kernel is [in, out] and becomes
``nn.Linear.weight`` [out, in]; ``PNAConv.pre_kernel`` keeps flax's
[2·fin, fin] ([3·fin, fin] with edge features) layout and is copied as
it is, as do GIN's scalar ``eps``, MFC's stacked ``w_l``/``w_r``
[D+1, fin, out] and ``b_l`` [D+1, out], and ``PerNodeMLP``'s ``w_i``
[num_nodes, in, out] and ``b_i`` [num_nodes, out].

Flax names submodules by creation order, which the names here follow:
  - a PNA conv (one that holds ``pre_kernel``) creates its edge
    projection before its post-layer: with edge features ``Dense_0`` is
    ``edge_proj`` and ``Dense_1`` is ``post``, without them ``Dense_0``
    is ``post``. A GAT conv (one that holds ``att``) creates its source
    transform first: ``Dense_0`` is ``x_l`` and ``Dense_1`` is ``x_r``;
    its ``att`` and ``bias`` are copied as they are. Every other conv's
    ``Dense_j`` is ``dense_j``.
  - a ``conv`` node head's convs are unnamed (``PNAConv_k``,
    ``GINConv_k``, ...: k counts them over the heads in order) and its
    BatchNorms continue the encoder's numbering (``MaskedBatchNorm_k``
    for k >= the number of encoder layers). Mapping them needs the
    model's ``ModelConfig`` (``cfg``): which heads are ``conv`` node
    heads, and how many convs each has.

Every leaf of the input must be consumed exactly once, or this raises.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

_CONV_ARRAYS = ("pre_kernel", "pre_bias", "eps", "w_l", "b_l", "w_r", "att", "bias")
_AUTO_CONV = re.compile(r"^[A-Za-z0-9]*Conv_(\d+)$")


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, Mapping):
            out.update(_flatten(val, path))
        else:
            out[path] = np.asarray(val)
    return out


def _index(name: str, prefix: str) -> int:
    if not name.startswith(prefix) or not name[len(prefix):].isdigit():
        raise KeyError(f"unexpected flax module {name!r}")
    return int(name[len(prefix):])


def _module_map(flat: Dict[str, np.ndarray], cfg) -> Tuple[Dict[str, str], Dict[str, Tuple[str, Optional[Tuple[str, ...]]]]]:
    """(flax BatchNorm module -> port prefix, flax conv module -> (port
    prefix, the port names of its ``Dense_j`` in order, None for
    ``dense_j``))."""
    mods = {p.split("/")[1] for p in flat}
    n_enc = sum(1 for m in mods if re.fullmatch(r"conv_\d+", m))
    if not n_enc:  # a tree of BatchNorm statistics alone
        n_enc = cfg.num_conv_layers if cfg is not None else sum(1 for m in mods if m.startswith("MaskedBatchNorm_"))
    convs: Dict[str, str] = {f"conv_{i}": f"convs.{i}" for i in range(n_enc)}
    norms: Dict[str, str] = {f"MaskedBatchNorm_{i}": f"norms.{i}" for i in range(n_enc)}
    auto = sorted((m for m in mods if _AUTO_CONV.match(m)), key=lambda m: int(_AUTO_CONV.match(m).group(1)))
    slots: List[str] = []
    if cfg is not None and cfg.node_head_type == "conv":
        slots = [
            f"heads.{ihead}.{{kind}}.{j}"
            for ihead, typ in enumerate(cfg.output_type) if typ == "node"
            for j in range(cfg.node_num_headlayers + 1)
        ]
    if auto and len(slots) != len(auto):
        raise ValueError(f"variables_from_flax: {len(auto)} head convs for {len(slots)} in cfg")
    for k, slot in enumerate(slots):
        norms[f"MaskedBatchNorm_{n_enc + k}"] = slot.format(kind="norms")
    for k, mod in enumerate(auto):
        if int(_AUTO_CONV.match(mod).group(1)) != k:
            raise KeyError(f"unexpected flax module {mod!r}")
        convs[mod] = slots[k].format(kind="convs")
    subs: Dict[str, Optional[Tuple[str, ...]]] = {}
    for m in convs:
        if f"params/{m}/pre_kernel" in flat:  # PNA
            subs[m] = ("edge_proj", "post") if f"params/{m}/Dense_1/kernel" in flat else ("post",)
        elif f"params/{m}/att" in flat:  # GAT
            subs[m] = ("x_l", "x_r")
        else:
            subs[m] = None
    return norms, {m: (convs[m], subs[m]) for m in convs}


def _torch_name(path: str, norms: Dict[str, str], convs: Dict[str, Tuple[str, Optional[Tuple[str, ...]]]]) -> str:
    """Port parameter/buffer name for one flax leaf path."""
    parts = path.split("/")
    coll, mod = parts[0], parts[1]
    if mod.startswith("MaskedBatchNorm_"):
        if mod not in norms:
            raise KeyError(f"no port counterpart for flax leaf {path!r}")
        if coll == "batch_stats":
            return f"{norms[mod]}." + {"mean": "running_mean", "var": "running_var"}[parts[2]]
        return f"{norms[mod]}." + {"scale": "weight", "bias": "bias"}[parts[2]]
    if mod in convs:
        prefix, subs = convs[mod]
        if parts[2] in _CONV_ARRAYS and len(parts) == 3:
            return f"{prefix}.{parts[2]}"
        j = _index(parts[2], "Dense_")
        if subs is None:
            sub = f"dense_{j}"
        elif j < len(subs):
            sub = subs[j]
        else:
            raise KeyError(f"no port counterpart for flax leaf {path!r}")
        return f"{prefix}.{sub}." + {"kernel": "weight", "bias": "bias"}[parts[3]]
    if mod.startswith("node_head_") and len(parts) == 3 and re.fullmatch(r"[wb]_\d+", parts[2]):
        return f"heads.{_index(mod, 'node_head_')}.{parts[2]}"  # PerNodeMLP
    leaf = {"kernel": "weight", "bias": "bias"}[parts[3]]
    if mod == "graph_shared":
        return f"graph_shared.layers.{_index(parts[2], 'Dense_')}.{leaf}"
    for kind in ("graph_head_", "node_head_"):
        if mod.startswith(kind):
            return f"heads.{_index(mod, kind)}.layers.{_index(parts[2], 'Dense_')}.{leaf}"
    raise KeyError(f"no port counterpart for flax leaf {path!r}")


def variables_from_flax(variables: Mapping[str, Any], cfg: Optional[Any] = None) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` holding the weights of ``variables``;
    ``cfg`` (the model's ``ModelConfig``) is needed only for ``conv``
    node heads."""
    flat = _flatten(variables)
    norms, convs = _module_map(flat, cfg)
    out: Dict[str, torch.Tensor] = {}
    for path, arr in flat.items():
        name = _torch_name(path, norms, convs)
        if name in out:
            raise ValueError(f"two flax leaves map to {name!r} (second: {path!r})")
        if path.endswith("/kernel"):
            arr = arr.T  # flax Dense [in, out] -> nn.Linear [out, in]
        # np.array, not np.ascontiguousarray: that one turns a 0-d leaf (eps) into [1]
        out[name] = torch.tensor(np.array(arr, dtype=np.float32))
    return out
