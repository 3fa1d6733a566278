"""Checkpoints and resume in the port's own format (the counterpart of
``hydragnn_tpu/utils/checkpoint.py``'s msgpack backend).

``save_model`` writes ``<path>/<log_name>/<log_name>.pt`` atomically (a
temporary file, then a rename) with ``torch.save``: the model's state
dict (parameters and BatchNorm running statistics), the optimizer's
(every state tensor, its step count and learning rate), the dropout
generator's state and the loader epoch. With ``keep_last = K``
(``Training.checkpoint_keep_last``) it also keeps the K newest
step-versioned copies ``<log_name>.step<N>.pt``, each with a
``.sha256`` sidecar, pruned beyond K.

``load_existing_model`` validates before it restores: the latest file
first, then each retained version, newest first; a file that fails its
sha256 sidecar (or, without one, fails to load) is skipped with a
``RuntimeWarning`` naming it, and only when every candidate fails does
the restore raise. The JSON meta sidecar ``<log_name>.meta.json``
(``save_train_meta``) carries the loop's own state for an exact resume
(epoch, optimizer step, scheduler and early-stop counters, history),
stamped with ``CHECKPOINT_FORMAT_VERSION``; a newer stamp is refused
with ``CheckpointFormatError``.

A pod run (``resilience/podckpt.py``) also cuts per-host generation
shards under ``<path>/<log_name>/podckpt/``; ``load_existing_model``
tries them first, newest committed generation first, re-sharding onto
the target's layout, and reconciles the meta sidecar to the generation
that committed (``reconcile_pod_meta``); only when none restores does it
fall back, with a warning, to the single files.

Reading the JAX package's checkpoints is ``convert.py:load_jax_checkpoint``.
"""

from __future__ import annotations

import glob
import hashlib
import io
import json
import os
import re
import warnings
from typing import Any, Dict, List, Optional, Tuple

import torch

#: The meta sidecar's format generation, as the JAX package stamps it
#: (absent = 1, accepted; newer than this build = refused).
CHECKPOINT_FORMAT_VERSION = 2


class CheckpointFormatError(RuntimeError):
    """The checkpoint was written by a newer format than this build reads."""


def checkpoint_path(log_name: str, path: str = "./logs/") -> str:
    return os.path.join(path, log_name, f"{log_name}.pt")


def _versioned_path(log_name: str, path: str, step: int) -> str:
    return os.path.join(path, log_name, f"{log_name}.step{step:010d}.pt")


def _meta_path(log_name: str, path: str) -> str:
    return os.path.join(path, log_name, f"{log_name}.meta.json")


def _sha256_hex(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _atomic_write(final_path: str, data: bytes) -> None:
    tmp = f"{final_path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, final_path)


def list_versioned_checkpoints(log_name: str, path: str = "./logs/") -> List[Tuple[int, str]]:
    """The retained versions, newest first, as ``[(step, path)]``."""
    pat = re.compile(re.escape(log_name) + r"\.step(\d+)\.pt$")
    out = []
    for p in glob.glob(os.path.join(path, log_name, f"{log_name}.step*.pt")):
        m = pat.search(os.path.basename(p))
        if m:
            out.append((int(m.group(1)), p))
    return sorted(out, reverse=True)


def _load_bytes(data: bytes, device) -> Dict[str, Any]:
    return torch.load(io.BytesIO(data), map_location=device, weights_only=True)


def validate_checkpoint_file(ckpt_path: str) -> bool:
    """The file's sha256 sidecar matches when there is one; else the file
    loads. A missing file is not valid."""
    try:
        with open(ckpt_path, "rb") as f:
            data = f.read()
    except OSError:
        return False
    sidecar = ckpt_path + ".sha256"
    if os.path.exists(sidecar):
        try:
            with open(sidecar) as f:
                return _sha256_hex(data) == f.read().strip()
        except OSError:
            return False
    try:
        _load_bytes(data, "cpu")
        return True
    except Exception:  # a torn or foreign file: whatever the unpickler raises
        return False


def _prune_versions(log_name: str, path: str, keep_last: int) -> None:
    for _, p in list_versioned_checkpoints(log_name, path)[keep_last:]:
        for victim in (p, p + ".sha256"):
            try:
                os.remove(victim)
            except FileNotFoundError:
                pass


def save_model(
    model: torch.nn.Module,
    log_name: str,
    path: str = "./logs/",
    optimizer: Optional[torch.optim.Optimizer] = None,
    epoch: int = 0,
    keep_last: Optional[int] = None,
) -> str:
    """Write the checkpoint (module docstring); returns the latest file's
    path. Versions are named by the optimizer's step count.

    In a group of processes every rank calls it: a sharded optimizer's
    state is gathered whole on every rank (``parallel/sharded.py``), rank
    0 alone writes the files, and every rank leaves once they are
    written, so the file is the one a single process writes and
    ``load_existing_model``, ``serve_model`` and ``convert.py`` read it
    unchanged."""
    from hydragnn_tpu_torch.parallel.mesh import barrier, get_comm_size_and_rank

    target = checkpoint_path(log_name, path)
    dev = next(model.parameters()).device
    uses_dropout = getattr(model, "uses_dropout", False)
    state = {
        "model": {k: v.detach().cpu() for k, v in model.state_dict().items()},
        "optimizer": None if optimizer is None else optimizer.state_dict(),
        "epoch": int(epoch),
        "dropout": model.dropout_generator(dev).get_state() if uses_dropout else None,
    }
    if get_comm_size_and_rank()[1] != 0:
        barrier("checkpoint_written")
        return target
    os.makedirs(os.path.dirname(target), exist_ok=True)
    buf = io.BytesIO()
    torch.save(state, buf)
    data = buf.getvalue()
    if keep_last:
        step = int(optimizer.steps) if optimizer is not None else 0
        vp = _versioned_path(log_name, path, step)
        _atomic_write(vp, data)
        _atomic_write(vp + ".sha256", _sha256_hex(data).encode())
        _prune_versions(log_name, path, int(keep_last))
    # HGTORCH_INJECT_KILL_CHECKPOINT: the K-th save tears the latest file
    # and SIGKILLs the process; load_existing_model's validation recovers
    # from it
    from hydragnn_tpu_torch.resilience.inject import maybe_kill_checkpoint

    maybe_kill_checkpoint(target, data)
    _atomic_write(target, data)
    barrier("checkpoint_written")
    return target


def _apply(state: Dict[str, Any], model: torch.nn.Module, optimizer: Optional[torch.optim.Optimizer]) -> int:
    model.load_state_dict(state["model"], strict=True)
    if optimizer is not None and state["optimizer"] is not None:
        optimizer.load_state_dict(state["optimizer"])
    if state.get("dropout") is not None and getattr(model, "uses_dropout", False):
        # a generator's state is a CPU byte tensor whatever its device
        model.dropout_generator(next(model.parameters()).device).set_state(state["dropout"].cpu())
    return int(state["epoch"])


def load_existing_model(
    model: torch.nn.Module,
    log_name: str,
    path: str = "./logs/",
    optimizer: Optional[torch.optim.Optimizer] = None,
) -> int:
    """Restore the run's newest valid checkpoint into ``model`` (strict)
    and, when given, ``optimizer``; returns its loader epoch. A pod run's
    committed generations come first (module docstring). Raises
    ``FileNotFoundError`` when the run has no checkpoint and
    ``ValueError`` when every candidate fails validation."""
    _check_meta_format(log_name, path)
    run_dir = os.path.join(path, log_name)
    if os.path.isdir(os.path.join(run_dir, "podckpt")):
        from hydragnn_tpu_torch.resilience import podckpt

        epoch, info = podckpt.restore_pod_checkpoint(model, run_dir, optimizer=optimizer)
        if info is not None:
            reconcile_pod_meta(log_name, path, info)
            return epoch
    dev = next(model.parameters()).device
    latest = checkpoint_path(log_name, path)
    versioned = [p for _, p in list_versioned_checkpoints(log_name, path)]
    if not versioned:
        with open(latest, "rb") as f:
            return _apply(_load_bytes(f.read(), dev), model, optimizer)
    rejected = []
    for p in [latest] + versioned:
        if not validate_checkpoint_file(p):
            rejected.append(p)
            continue
        with open(p, "rb") as f:
            data = f.read()
        try:
            epoch = _apply(_load_bytes(data, dev), model, optimizer)
        except Exception:  # loads but does not fit this model: the next candidate
            rejected.append(p)
            continue
        if rejected:
            warnings.warn(
                f"checkpoint integrity: rejected {rejected} (truncated/corrupt); "
                f"restored the previous valid checkpoint {p}",
                RuntimeWarning,
                stacklevel=2,
            )
        return epoch
    raise ValueError(
        f"no valid checkpoint for run {log_name!r} under {path!r}: "
        f"all candidates failed integrity validation: {rejected}"
    )


def checkpoint_exists(log_name: str, path: str = "./logs/") -> bool:
    if os.path.exists(checkpoint_path(log_name, path)) or list_versioned_checkpoints(log_name, path):
        return True
    if os.path.isdir(os.path.join(path, log_name, "podckpt")):
        from hydragnn_tpu_torch.resilience import podckpt

        return bool(podckpt.list_committed_generations(os.path.join(path, log_name)))
    return False


def reconcile_pod_meta(log_name: str, path: str, info: Dict[str, Any]) -> None:
    """Make the meta sidecar agree with the pod generation that committed.
    A host can write the meta of epoch N and die before generation N
    commits (the COMMIT is always last), and a resume would then skip
    epoch N on generation N-1's weights. So the sidecar follows the
    COMMIT: its epoch the committed generation, its history cut to it,
    its early-stop flag cleared."""
    gen = int(info["gen"])
    meta = load_train_meta(log_name, path) or {}
    if int(meta.get("epoch", -1)) == gen and meta.get("early_stopped") is not True:
        return
    meta["epoch"] = gen
    if info.get("step") is not None:
        meta["step"] = int(info["step"])
    meta["early_stopped"] = False
    history = meta.get("history")
    if isinstance(history, dict):
        meta["history"] = {k: (v[:gen] if isinstance(v, list) else v) for k, v in history.items()}
    save_train_meta(meta, log_name, path)


def save_train_meta(meta: Dict[str, Any], log_name: str, path: str = "./logs/") -> None:
    """The loop-state sidecar, stamped with the format version."""
    meta = dict(meta)
    meta.setdefault("format_version", CHECKPOINT_FORMAT_VERSION)
    os.makedirs(os.path.join(path, log_name), exist_ok=True)
    _atomic_write(_meta_path(log_name, path), json.dumps(meta).encode())


def load_train_meta(log_name: str, path: str = "./logs/") -> Optional[Dict[str, Any]]:
    p = _meta_path(log_name, path)
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return json.load(f)


def _check_meta_format(log_name: str, path: str) -> None:
    meta = load_train_meta(log_name, path)
    fv = (meta or {}).get("format_version")
    if fv is not None and int(fv) > CHECKPOINT_FORMAT_VERSION:
        raise CheckpointFormatError(
            f"checkpoint meta for run {log_name!r} was written by format_version {fv}; "
            f"this build understands <= {CHECKPOINT_FORMAT_VERSION}"
        )


def load_existing_model_config(
    model: torch.nn.Module,
    training_config: Dict[str, Any],
    path: str = "./logs/",
    optimizer: Optional[torch.optim.Optimizer] = None,
) -> None:
    """``Training.continue = 1``: restore ``Training.startfrom``'s
    checkpoint into ``model`` and ``optimizer``."""
    if training_config.get("continue") == 1:
        if "startfrom" not in training_config:
            raise ValueError("Training.continue=1 requires Training.startfrom")
        load_existing_model(model, training_config["startfrom"], path, optimizer=optimizer)
