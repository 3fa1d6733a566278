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


# ---- the JAX package's checkpoints -------------------------------------
#
# ``hydragnn_tpu/utils/checkpoint.py:save_model`` writes the TrainState
# (step, params, batch_stats, opt_state, rng) with flax's
# ``serialization.to_bytes``: msgpack maps of str keys (namedtuples by
# field name, tuples by position "0", "1", ...) whose array leaves are
# msgpack ext type 1 holding a msgpack array (shape, dtype name, C-order
# bytes). The decoder below reads that subset with no msgpack package.

_BF16 = object()  # dtype name "bfloat16": numpy has no such dtype


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: truncated data")
        out = bytes(self.data[self.pos:self.pos + n])
        self.pos += n
        return out

    def uint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big")


def _unpack(r: _Reader):
    b = r.uint(1)
    if b <= 0x7F:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return _unpack_map(r, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return [_unpack(r) for _ in range(b & 0x0F)]
    if 0xA0 <= b <= 0xBF:
        return r.take(b & 0x1F).decode()
    fixed = {0xC0: None, 0xC2: False, 0xC3: True}
    if b in fixed:
        return fixed[b]
    if b in (0xC4, 0xC5, 0xC6):  # bin 8/16/32
        return r.take(r.uint({0xC4: 1, 0xC5: 2, 0xC6: 4}[b]))
    if b in (0xC7, 0xC8, 0xC9):  # ext 8/16/32
        n = r.uint({0xC7: 1, 0xC8: 2, 0xC9: 4}[b])
        return _ext(int.from_bytes(r.take(1), "big", signed=True), r.take(n))
    if b == 0xCA:
        return float(np.frombuffer(r.take(4), ">f4")[0])
    if b == 0xCB:
        return float(np.frombuffer(r.take(8), ">f8")[0])
    if 0xCC <= b <= 0xCF:  # uint 8-64
        return r.uint(1 << (b - 0xCC))
    if 0xD0 <= b <= 0xD3:  # int 8-64
        return int.from_bytes(r.take(1 << (b - 0xD0)), "big", signed=True)
    if 0xD4 <= b <= 0xD8:  # fixext 1-16
        code = int.from_bytes(r.take(1), "big", signed=True)
        return _ext(code, r.take(1 << (b - 0xD4)))
    if b in (0xD9, 0xDA, 0xDB):  # str 8/16/32
        return r.take(r.uint({0xD9: 1, 0xDA: 2, 0xDB: 4}[b])).decode()
    if b in (0xDC, 0xDD):  # array 16/32
        return [_unpack(r) for _ in range(r.uint(2 if b == 0xDC else 4))]
    if b in (0xDE, 0xDF):  # map 16/32
        return _unpack_map(r, r.uint(2 if b == 0xDE else 4))
    raise ValueError(f"msgpack: unsupported type byte 0x{b:02x}")


def _unpack_map(r: _Reader, n: int) -> Dict[Any, Any]:
    out = {}
    for _ in range(n):
        key = _unpack(r)
        out[key] = _unpack(r)
    return out


def _ext(code: int, payload: bytes):
    if code not in (1, 3):  # flax's ndarray and numpy scalar
        raise ValueError(f"msgpack: unsupported ext type {code}")
    shape, dtype, buf = msgpack_unpackb(payload)
    dtype = dtype.decode() if isinstance(dtype, bytes) else dtype
    if dtype == "bfloat16":  # the high half of float32
        raw = np.frombuffer(buf, "<u2").astype(np.uint32) << 16
        arr = raw.view(np.float32).reshape(shape)
    else:
        arr = np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape)
    return arr[()] if code == 3 else arr


def msgpack_unpackb(data: bytes):
    """Decode one msgpack object (the subset flax writes: maps, arrays,
    str, bin, nil, bools, ints, floats, and ext types 1 and 3 = numpy
    arrays and scalars, bfloat16 widened to float32)."""
    r = _Reader(data)
    out = _unpack(r)
    if r.pos != len(r.data):
        raise ValueError("msgpack: trailing bytes")
    return out


def _unchunk(tree):
    """flax's chunked form of an array above 2**30 bytes, joined back."""
    if isinstance(tree, dict):
        if tree.get("__msgpack_chunked_array__"):
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def read_flax_checkpoint(path: str) -> Dict[str, Any]:
    """The state dict of a checkpoint the JAX package's ``save_model``
    wrote (``<log_dir>/<run>/<run>.mp``): nested dicts of numpy arrays."""
    with open(path, "rb") as f:
        return _unchunk(msgpack_unpackb(f.read()))


def _find(tree, keys: Tuple[str, ...]):
    """The first dict under ``tree`` (depth first) that holds ``keys``."""
    if isinstance(tree, dict):
        if all(k in tree for k in keys):
            return tree
        for v in tree.values():
            found = _find(v, keys)
            if found is not None:
                return found
    return None


def load_jax_checkpoint(path: str, model: torch.nn.Module, optimizer=None) -> int:
    """Restore a JAX package checkpoint into the port: the parameters and
    BatchNorm statistics into ``model`` (strict, through
    ``variables_from_flax``), and, when given, the optimizer's rule state
    (AdamW's ``mu``, ``nu`` and count, or the slots of the optimizer's
    kind), its gradient accumulation and learning rate and the step into
    ``optimizer`` (``train/optimizer.py:Optimizer``). Returns the step."""
    from hydragnn_tpu_torch.train.optimizer import COUNT, SLOTS, set_learning_rate

    state = read_flax_checkpoint(path)
    cfg = getattr(model, "cfg", None)
    variables = {"params": state["params"]}
    if state.get("batch_stats"):
        variables["batch_stats"] = state["batch_stats"]
    dev = next(model.parameters()).device
    model.load_state_dict({k: v.to(dev) for k, v in variables_from_flax(variables, cfg).items()}, strict=True)
    step = int(np.asarray(state["step"]))
    if optimizer is None:
        return step
    opt = state["opt_state"]
    names = [n for n, _ in model.named_parameters()]
    params = dict(model.named_parameters())

    def per_param(tree) -> Dict[str, torch.Tensor]:
        return variables_from_flax({"params": tree}, cfg)

    if "acc_grads" in opt:  # optax.MultiSteps
        if optimizer.accum == 1:
            raise ValueError("the JAX checkpoint accumulates gradients; this optimizer does not")
        for name, t in per_param(opt["acc_grads"]).items():
            optimizer.state[params[name]]["acc"].copy_(t)
        optimizer.shared["mini_step"].fill_(int(np.asarray(opt["mini_step"])))
        optimizer.shared["gradient_step"].fill_(int(np.asarray(opt["gradient_step"])))
        opt = opt["inner_opt_state"]
    elif optimizer.accum > 1:
        raise ValueError("this optimizer accumulates gradients; the JAX checkpoint does not")
    slots = SLOTS[optimizer.kind]
    if slots:
        rule = _find(opt["inner_state"], tuple(slots))
        if rule is None:
            raise ValueError(f"the JAX checkpoint holds no {optimizer.kind} state {tuple(slots)}")
        for slot, key in slots.items():
            values = per_param(rule[slot])
            if set(values) != set(names):
                raise ValueError(f"{slot}: the JAX checkpoint's parameters differ from the model's")
            for name, t in values.items():
                optimizer.state[params[name]][key].copy_(t)
        key = COUNT.get(optimizer.kind)
        if key is not None and "count" in rule:  # optax's Adadelta keeps none
            for p in params.values():
                optimizer.state[p][key].fill_(int(np.asarray(rule["count"])))
    set_learning_rate(optimizer, float(np.asarray(opt["hyperparams"]["learning_rate"])))
    optimizer.steps.fill_(step)
    return step
