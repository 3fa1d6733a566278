"""Pod checkpoints with a generation commit protocol, and the pod's
filesystem coordination (preemption signals, bounded barriers, liveness
heartbeats): the port's counterpart of ``hydragnn_tpu/resilience/podckpt.py``.

The single-file checkpoint (``utils/checkpoint.py``) gathers the whole
state on rank 0: on a pod that is slow (every FSDP or ZeRO-1 slice
gathered) and fragile (a host dying mid-save tears the only copy). Here
every host writes its own shard, and "which checkpoint is complete?" is
a one-file question:

  <run_dir>/podckpt/
    ckpt.gen<N>.host<k>.pt              host k's leaves (``torch.save``)
    ckpt.gen<N>.host<k>.pt.sha256       its digest
    ckpt.gen<N>.host<k>.manifest.json   leaf paths, shapes, slices, layout
    gen<N>.COMMIT                       written by host 0 LAST, once every
                                        host's manifest is there and valid

The writes go in that order (payload, digest, manifest; the COMMIT last),
each to a pid-unique temporary file and renamed. A generation without its
COMMIT is torn and never restored; the restore walks the committed
generations newest first, checks every shard's digest, and falls back a
generation (with a ``RuntimeWarning``) on any mismatch. A manifest and a
COMMIT carry ``format_version`` (``CHECKPOINT_FORMAT_VERSION``, 2); a
newer one is refused with ``CheckpointFormatError``.

The leaves are the port's checkpoint (``utils/checkpoint.py``), flat
under '/'-joined keys: ``model/<state-dict key>``, ``optimizer/...``
(the optimizer's state dict: its rule's per-parameter state and groups,
its shared state and step count), ``dropout`` (the dropout generator's
state) and ``epoch`` (the loader epoch); exact resume needs all of them.
A tensor a ``parallel/sharded.py:LeafShard`` splits (FSDP's parameters
and state, ZeRO-1's state) is written as this rank's slice, with its
index ranges, by the slice's replica 0 alone: no rank gathers to save.
Every other leaf is dealt round-robin over the sorted keys, so each has
one owner. The manifests' slices let a generation cut under one layout
restore onto another (fewer hosts, one process): the leaves are
reassembled whole on the host and loaded as a single-file checkpoint
is, which re-shards them onto the target's layout.

Coordination lives next door:

  <run_dir>/podsync/
    heartbeat.host<k>.json      the host's liveness beat (t, epoch, step)
    preempt.host<k>.json        "I was SIGTERMed; cut generation G"
    barrier.<name>.host<k>      bounded-wait rendezvous markers

Any shared filesystem carries it; a pod without one exchanges samples
through ``data/diststore.py``. Knobs: ``HGTORCH_POD_CKPT`` (the loop
cuts generations on a pod, default on), ``HGTORCH_POD_COMMIT_TIMEOUT_S``
(120), ``HGTORCH_POD_BARRIER_TIMEOUT_S`` (60), ``HGTORCH_POD_HEARTBEAT_S``
(1), ``HGTORCH_POD_LOST_AFTER_S`` (0: loss detection off) and
``HGTORCH_POD_KEEP_GENS`` (3).
"""

from __future__ import annotations

import io
import json
import os
import time
import warnings
from typing import Any, Dict, List, Optional, Tuple

import torch

from hydragnn_tpu_torch.obs.registry import env_number
from hydragnn_tpu_torch.resilience.inject import (
    maybe_pod_barrier_stall,
    maybe_pod_kill_host,
    maybe_pod_lost_heartbeat,
    maybe_pod_torn_shard,
)
from hydragnn_tpu_torch.utils.checkpoint import (
    CHECKPOINT_FORMAT_VERSION,
    CheckpointFormatError,
    _apply,
    _atomic_write,
    _sha256_hex,
)

POD_DIR = "podckpt"
SYNC_DIR = "podsync"


class PodShardError(RuntimeError):
    """A generation failed validation (a missing, torn or corrupt shard,
    a leaf not wholly covered, a schema the target does not have). The
    restore falls back a generation on it."""


# -- paths -----------------------------------------------------------------


def pod_dir(run_dir: str) -> str:
    return os.path.join(run_dir, POD_DIR)


def sync_dir(run_dir: str) -> str:
    return os.path.join(run_dir, SYNC_DIR)


def _shard_path(run_dir: str, gen: int, host: int) -> str:
    return os.path.join(pod_dir(run_dir), f"ckpt.gen{gen}.host{host}.pt")


def _manifest_path(run_dir: str, gen: int, host: int) -> str:
    return os.path.join(pod_dir(run_dir), f"ckpt.gen{gen}.host{host}.manifest.json")


def _commit_path(run_dir: str, gen: int) -> str:
    return os.path.join(pod_dir(run_dir), f"gen{gen}.COMMIT")


# -- leaf flattening -------------------------------------------------------


def _persistent_buffers(model: torch.nn.Module) -> List[Tuple[str, torch.Tensor]]:
    """The buffers a state dict holds (``named_buffers`` less the
    non-persistent ones), read without the state-dict hooks."""
    out = []
    for prefix, mod in model.named_modules():
        for name, b in mod._buffers.items():
            if b is not None and name not in mod._non_persistent_buffers_set:
                out.append((f"{prefix}.{name}" if prefix else name, b))
    return out


def _walk(node: Any, prefix: str, out: Dict[str, Any]) -> None:
    if isinstance(node, dict) and node:
        for key in sorted(node, key=str):
            _walk(node[key], f"{prefix}/{key}", out)
    else:
        out[prefix] = node


def flatten_state(model: torch.nn.Module, optimizer=None, epoch: int = 0) -> Dict[str, Tuple[Any, Any]]:
    """The checkpoint as ``{"a/b/c": (leaf, shard)}`` (module docstring):
    ``shard`` is the ``LeafShard`` whose slice ``leaf`` is, else None.
    Reads the live tensors, never the gathering state-dict hooks, so a
    sharded rank reads its slices alone."""
    store = getattr(model, "sharded_params", None)
    shards = {id(p): sh for p, sh in store.pairs} if store is not None else {}
    flat: Dict[str, Tuple[Any, Any]] = {}
    for name, p in model.named_parameters():
        sh = shards.get(id(p))
        flat[f"model/{name}"] = ((store.slices[id(p)] if sh is not None else p).detach(), sh)
    for name, b in _persistent_buffers(model):
        flat[f"model/{name}"] = (b.detach(), None)
    dev = next(model.parameters()).device
    flat["epoch"] = (int(epoch), None)
    flat["dropout"] = (model.dropout_generator(dev).get_state() if getattr(model, "uses_dropout", False) else None,
                       None)
    if optimizer is not None:
        rule_shard = getattr(optimizer, "_rule_shard", None)
        # a sharded optimizer's own rule holds its slices; its state_dict() would gather them
        sd = optimizer.inner.state_dict() if rule_shard is not None else optimizer.state_dict()
        leaves: Dict[str, Any] = {}
        _walk(sd, "optimizer", leaves)
        for path, val in leaves.items():
            sh = None
            parts = path.split("/")
            if rule_shard is not None and parts[1:3] == ["rule", "state"] and isinstance(val, torch.Tensor):
                sh = rule_shard(int(parts[3]), val)
            flat[path] = (val, sh)
    return flat


def _host_copy(val: Any) -> Any:
    """A tensor as a contiguous host copy of its own (a view would save
    its whole storage); anything else as it is."""
    if isinstance(val, torch.Tensor):
        return val.detach().to("cpu", copy=True).contiguous()
    return val


def _leaf_meta(val: Any) -> Tuple[List[int], str]:
    if isinstance(val, torch.Tensor):
        return [int(d) for d in val.shape], str(val.dtype).replace("torch.", "")
    return [], type(val).__name__


# -- save ------------------------------------------------------------------


def save_pod_shard(model: torch.nn.Module, run_dir: str, *, gen: int, host: int, hosts: int,
                   step: Optional[int] = None, layout: Optional[dict] = None, optimizer=None,
                   epoch: int = 0) -> dict:
    """Write host ``host``'s shard of generation ``gen``: the payload,
    its sha256 sidecar, then its manifest, in that order (a crash between
    them leaves a shard without a manifest, on which the commit's wait
    times out, never a manifest naming missing bytes). Returns the
    manifest. Sliced leaves come from their replica 0 with their index
    ranges; whole leaves are dealt round-robin (module docstring)."""
    flat = flatten_state(model, optimizer, epoch)
    payload: Dict[str, Any] = {}
    entries: List[dict] = []
    for i, path in enumerate(sorted(flat)):
        val, sh = flat[path]
        if sh is not None:
            if sh.replica != 0:
                continue
            shape = [int(d) for d in val.shape]
            size = shape[sh.dim]
            slices = [[0, d] for d in shape]
            slices[sh.dim] = [sh.index * size, (sh.index + 1) * size]
            shape[sh.dim] = size * sh.width
        else:
            if i % hosts != host:
                continue
            shape, slices = _leaf_meta(val)[0], None
        key = str(len(payload))
        payload[key] = _host_copy(val)
        entries.append({"path": path, "key": key, "shape": shape, "dtype": _leaf_meta(val)[1], "slices": slices})
    os.makedirs(pod_dir(run_dir), exist_ok=True)
    buf = io.BytesIO()
    torch.save(payload, buf)
    data = buf.getvalue()
    sha = _sha256_hex(data)
    if maybe_pod_torn_shard(host, gen):
        # the sidecar keeps the good digest, the payload is torn: the
        # restore must reject it by its digest
        data = data[: max(len(data) // 2, 1)]
    shard_path = _shard_path(run_dir, gen, host)
    _atomic_write(shard_path, data)
    _atomic_write(shard_path + ".sha256", sha.encode())
    # HGTORCH_INJECT_POD_KILL_HOST: the shard's bytes are there and the
    # manifest never lands, so the generation can never commit
    maybe_pod_kill_host(host, gen)
    manifest = {
        "format_version": CHECKPOINT_FORMAT_VERSION,
        "gen": int(gen),
        "step": None if step is None else int(step),
        "host": int(host),
        "hosts": int(hosts),
        "layout": layout,
        "shard": os.path.basename(shard_path),
        "sha256": sha,
        "leaves": entries,
        "t": time.time(),
    }
    _atomic_write(_manifest_path(run_dir, gen, host), json.dumps(manifest, sort_keys=True).encode())
    return manifest


def _validate_host_shard(run_dir: str, gen: int, host: int) -> Optional[str]:
    """None when host ``host``'s shard of ``gen`` is whole, else a short
    reason naming the bad file."""
    mp = _manifest_path(run_dir, gen, host)
    try:
        with open(mp) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as exc:
        return f"manifest {os.path.basename(mp)} unreadable ({exc})"
    sp = _shard_path(run_dir, gen, host)
    try:
        with open(sp, "rb") as f:
            data = f.read()
    except OSError:
        return f"shard {os.path.basename(sp)} missing"
    if _sha256_hex(data) != manifest.get("sha256"):
        return f"shard {os.path.basename(sp)} sha256 mismatch (torn write)"
    return None


def commit_generation(run_dir: str, gen: int, hosts: int, *, timeout_s: Optional[float] = None,
                      poll_s: float = 0.05, signaler: Optional["PodSignaler"] = None, step: Optional[int] = None,
                      layout: Optional[dict] = None) -> dict:
    """Host 0's half of the protocol: wait, bounded, until every host's
    manifest is there and its shard valid, then write ``gen<N>.COMMIT``
    (last). Never raises and never hangs: on a timeout, a bad shard, or a
    peer the ``signaler`` declares lost it returns ``committed: False``
    with the evidence, and the caller decides. Other hosts never call it:
    they write their shard and go on, so hosts simulated one after
    another still commit."""
    if timeout_s is None:
        timeout_s = env_number("HGTORCH_POD_COMMIT_TIMEOUT_S", 120.0)
    deadline = time.monotonic() + float(timeout_s)
    t0 = time.monotonic()
    while True:
        missing = [k for k in range(hosts) if not os.path.exists(_manifest_path(run_dir, gen, k))]
        if not missing:
            break
        lost = sorted(set(missing) & set(signaler.lost_hosts())) if signaler else []
        if lost:
            return {"committed": False, "gen": int(gen), "missing": missing, "lost": lost, "bad": [],
                    "waited_s": round(time.monotonic() - t0, 3)}
        if time.monotonic() > deadline:
            return {"committed": False, "gen": int(gen), "missing": missing, "lost": [], "bad": [], "timeout": True,
                    "waited_s": round(time.monotonic() - t0, 3)}
        time.sleep(poll_s)
    bad = [reason for reason in (_validate_host_shard(run_dir, gen, k) for k in range(hosts)) if reason is not None]
    if step is None or layout is None:
        # the COMMIT carries the generation's step and layout; host 0's
        # manifest has them when the caller did not pass them
        try:
            with open(_manifest_path(run_dir, gen, 0)) as f:
                m0 = json.load(f)
            step = m0.get("step") if step is None else step
            layout = m0.get("layout") if layout is None else layout
        except (OSError, ValueError):
            pass
    if bad:
        return {"committed": False, "gen": int(gen), "missing": [], "lost": [], "bad": bad,
                "waited_s": round(time.monotonic() - t0, 3)}
    _atomic_write(
        _commit_path(run_dir, gen),
        json.dumps({"format_version": CHECKPOINT_FORMAT_VERSION, "gen": int(gen),
                    "step": None if step is None else int(step), "hosts": int(hosts), "layout": layout,
                    "t": time.time()}, sort_keys=True).encode(),
    )
    return {"committed": True, "gen": int(gen), "hosts": int(hosts), "waited_s": round(time.monotonic() - t0, 3)}


# -- discovery / restore ---------------------------------------------------


def list_committed_generations(run_dir: str) -> List[int]:
    """The generations with a COMMIT marker, ascending. Shards without
    their marker are torn and never listed."""
    try:
        names = os.listdir(pod_dir(run_dir))
    except OSError:
        return []
    gens = []
    for name in names:
        if name.startswith("gen") and name.endswith(".COMMIT"):
            try:
                gens.append(int(name[len("gen"):-len(".COMMIT")]))
            except ValueError:
                continue
    return sorted(gens)


def read_commit(run_dir: str, gen: int) -> dict:
    """The COMMIT record of ``gen``. Raises :class:`PodShardError` on a
    missing or unreadable marker and ``CheckpointFormatError`` on a
    ``format_version`` newer than this build reads."""
    try:
        with open(_commit_path(run_dir, gen)) as f:
            commit = json.load(f)
    except (OSError, ValueError) as exc:
        raise PodShardError(f"generation {gen} has no readable COMMIT marker ({exc})") from exc
    fv = commit.get("format_version")
    if fv is not None and int(fv) > CHECKPOINT_FORMAT_VERSION:
        raise CheckpointFormatError(
            f"pod checkpoint generation {gen} was written by format_version {fv}; "
            f"this build understands <= {CHECKPOINT_FORMAT_VERSION}"
        )
    return commit


def load_generation(run_dir: str, gen: int) -> Tuple[Dict[str, Any], dict]:
    """Generation ``gen``'s leaves, reassembled whole on the host from
    every host's shard and manifest (the reader needs neither the
    writers' host count nor their layout), and its COMMIT record. Raises
    :class:`PodShardError` naming the first bad shard."""
    commit = read_commit(run_dir, gen)
    flat: Dict[str, Any] = {}
    partial: Dict[str, Tuple[torch.Tensor, int]] = {}
    for k in range(int(commit["hosts"])):
        reason = _validate_host_shard(run_dir, gen, k)
        if reason is not None:
            raise PodShardError(f"generation {gen}: {reason}")
        with open(_manifest_path(run_dir, gen, k)) as f:
            manifest = json.load(f)
        with open(_shard_path(run_dir, gen, k), "rb") as f:
            try:
                payload = torch.load(io.BytesIO(f.read()), map_location="cpu", weights_only=True)
            except Exception as exc:  # whatever the unpickler raises on foreign bytes
                raise PodShardError(f"generation {gen}: shard ckpt.gen{gen}.host{k}.pt unparseable ({exc})") from exc
        for entry in manifest.get("leaves", []):
            val = payload[entry["key"]]
            if entry["slices"] is None:
                flat[entry["path"]] = val
                continue
            buf, covered = partial.get(entry["path"], (None, 0))
            if buf is None:
                buf = torch.zeros(tuple(entry["shape"]), dtype=val.dtype)
            buf[tuple(slice(s, e) for s, e in entry["slices"])] = val
            partial[entry["path"]] = (buf, covered + int(val.numel()))
    for path, (buf, covered) in partial.items():
        if covered < buf.numel():
            raise PodShardError(
                f"generation {gen}: leaf {path} has incomplete shard coverage ({covered}/{buf.numel()} elements)"
            )
        flat[path] = buf
    return flat, commit


def _unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    nested: Dict[str, Any] = {}
    for path, leaf in flat.items():
        keys: List[Any] = path.split("/")
        if keys[:3] == ["optimizer", "rule", "state"] and len(keys) > 3:
            keys[3] = int(keys[3])  # the rule's state is keyed by parameter index
        node = nested
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = leaf
    return nested


def _flat_into_state(model: torch.nn.Module, optimizer, flat: Dict[str, Any]) -> int:
    """Load ``flat`` into ``model`` (strict) and ``optimizer``; returns the
    loader epoch. The load re-shards onto the model's own layout."""
    target = {f"model/{n}" for n, _ in model.named_parameters()} | {f"model/{n}" for n, _ in _persistent_buffers(model)}
    got = {k for k in flat if k.startswith("model/")}
    missing, extra = sorted(target - got), sorted(got - target)
    if missing or extra or "epoch" not in flat:
        raise PodShardError(f"leaf schema mismatch: missing={missing[:4]} extra={extra[:4]} "
                            "(checkpoint and target model disagree)")
    nested = _unflatten(flat)
    state = {"model": nested["model"], "optimizer": nested.get("optimizer"), "epoch": nested["epoch"],
             "dropout": nested.get("dropout")}
    try:
        return _apply(state, model, optimizer)
    except (RuntimeError, KeyError, ValueError) as exc:
        raise PodShardError(f"the generation does not load into the target ({exc})") from exc


# written once by the restoring thread before the loop starts, read once by it
_LAST_RESTORE_INFO: Optional[dict] = None


def consume_last_restore_info() -> Optional[dict]:
    """The lineage of this process's last pod restore (``gen``, ``step``,
    ``hosts``, ``layout``, ``fallbacks``), handed out once: the train
    loop stamps it into its manifest as ``pod_resume``."""
    global _LAST_RESTORE_INFO
    info, _LAST_RESTORE_INFO = _LAST_RESTORE_INFO, None
    return info


def restore_pod_checkpoint(model: torch.nn.Module, run_dir: str, optimizer=None) -> Tuple[Optional[int], Optional[dict]]:
    """Restore the newest valid committed generation into ``model`` and
    ``optimizer`` (in place), falling back a generation at a time past
    torn, missing or corrupt shards with a ``RuntimeWarning`` naming the
    bad one. Returns ``(loader epoch, info)``; ``(None, None)`` when
    nothing was restorable (the caller goes on to the single-file
    checkpoints). A newer ``format_version`` raises
    ``CheckpointFormatError``: an upgrade refusal never falls back."""
    gens = list_committed_generations(run_dir)
    if not gens:
        return None, None
    fallbacks: List[dict] = []
    for gen in reversed(gens):
        try:
            flat, commit = load_generation(run_dir, gen)
            epoch = _flat_into_state(model, optimizer, flat)
        except PodShardError as exc:
            warnings.warn(f"pod checkpoint generation {gen} rejected: {exc}; falling back to the previous "
                          "committed generation", RuntimeWarning, stacklevel=2)
            fallbacks.append({"gen": int(gen), "error": str(exc)})
            continue
        info = {"gen": int(gen), "step": commit.get("step"), "hosts": commit.get("hosts"),
                "layout": commit.get("layout"), "fallbacks": fallbacks}
        global _LAST_RESTORE_INFO
        _LAST_RESTORE_INFO = dict(info)
        return epoch, info
    warnings.warn(f"all {len(gens)} committed pod generations under {run_dir} failed validation; falling through "
                  "to the single-file checkpoint chain", RuntimeWarning, stacklevel=2)
    return None, None


def latest_commit_info(run_dir: str) -> Optional[dict]:
    """The newest readable COMMIT record, or None."""
    for gen in reversed(list_committed_generations(run_dir)):
        try:
            return read_commit(run_dir, gen)
        except (PodShardError, CheckpointFormatError):
            continue
    return None


def prune_generations(run_dir: str, keep_last: Optional[int] = None) -> None:
    """Drop the committed generations older than the newest ``keep_last``
    (``HGTORCH_POD_KEEP_GENS``): the COMMIT marker first, then the shards,
    so a reader racing the prune sees an uncommitted generation, never a
    committed one with missing bytes. Uncommitted shards newer than the
    newest commit are left alone: they may be a commit in flight."""
    if keep_last is None:
        keep_last = int(env_number("HGTORCH_POD_KEEP_GENS", 3))
    gens = list_committed_generations(run_dir)
    d = pod_dir(run_dir)
    for gen in gens[: max(0, len(gens) - int(keep_last))]:
        victims = [_commit_path(run_dir, gen)]
        victims += [os.path.join(d, n) for n in os.listdir(d) if n.startswith(f"ckpt.gen{gen}.host")]
        for victim in victims:
            try:
                os.remove(victim)
            except OSError:
                pass


# -- coordination ----------------------------------------------------------


def pod_barrier(run_dir: str, name: str, host: int, hosts: int, *, timeout_s: Optional[float] = None,
                poll_s: float = 0.05) -> Tuple[bool, List[int]]:
    """Bounded-wait rendezvous: write this host's marker, poll for the
    peers', and after ``timeout_s`` (``HGTORCH_POD_BARRIER_TIMEOUT_S``) go
    on anyway, returning ``(False, missing_hosts)`` for the caller to
    record: a pod degrades to evidence, never to a hang."""
    maybe_pod_barrier_stall(host)
    if timeout_s is None:
        timeout_s = env_number("HGTORCH_POD_BARRIER_TIMEOUT_S", 60.0)
    d = sync_dir(run_dir)
    os.makedirs(d, exist_ok=True)
    _atomic_write(os.path.join(d, f"barrier.{name}.host{host}"), json.dumps({"t": time.time()}).encode())
    deadline = time.monotonic() + float(timeout_s)
    while True:
        missing = [k for k in range(hosts) if not os.path.exists(os.path.join(d, f"barrier.{name}.host{k}"))]
        if not missing:
            return True, []
        if time.monotonic() > deadline:
            return False, missing
        time.sleep(poll_s)


class PodSignaler:
    """One host's side of the pod's filesystem coordination: liveness
    heartbeats, coordinated-preemption signals and the lost-host view.

    Loss detection is armed only when ``HGTORCH_POD_LOST_AFTER_S > 0``
    (default off: hosts simulated one after another leave stale beats by
    design). Armed, a peer whose newest beat (before its first, this
    signaler's start) is older than the threshold is lost;
    ``undeclared_lost`` hands each lost host out once, so its
    ``host_lost`` flight event fires once however many sites poll. Only
    the host's main thread (where CPython runs signal handlers too)
    touches it; the peers talk through atomic file replaces."""

    def __init__(self, run_dir: str, host: int, hosts: int):
        self.run_dir = run_dir
        self.host = int(host)
        self.hosts = int(hosts)
        self.heartbeat_s = env_number("HGTORCH_POD_HEARTBEAT_S", 1.0)
        self.lost_after_s = env_number("HGTORCH_POD_LOST_AFTER_S", 0.0)
        self._t0 = time.time()
        self._last_beat = 0.0
        self._epoch: Optional[int] = None
        self._declared: set = set()
        try:
            os.makedirs(sync_dir(run_dir), exist_ok=True)
            # a previous attempt's preempt signal would preempt the
            # restarted run at once: clear this host's own
            os.remove(self._preempt_path(self.host))
        except OSError:
            pass

    def _beat_path(self, host: int) -> str:
        return os.path.join(sync_dir(self.run_dir), f"heartbeat.host{host}.json")

    def _preempt_path(self, host: int) -> str:
        return os.path.join(sync_dir(self.run_dir), f"preempt.host{host}.json")

    def heartbeat(self, *, epoch: Optional[int] = None, step: Optional[int] = None, force: bool = False) -> None:
        """Write this host's beat (at most one a ``heartbeat_s``). Under
        the LOST_HEARTBEAT injection the host goes silent from the
        injected epoch on: alive, but beatless."""
        if epoch is not None:
            self._epoch = int(epoch)
        if maybe_pod_lost_heartbeat(self.host, self._epoch):
            return
        now = time.time()
        if not force and now - self._last_beat < self.heartbeat_s:
            return
        self._last_beat = now
        try:
            _atomic_write(self._beat_path(self.host), json.dumps(
                {"t": now, "host": self.host, "epoch": self._epoch, "step": None if step is None else int(step)}
            ).encode())
        except OSError:
            pass

    def peer_heartbeats(self) -> Dict[int, dict]:
        out: Dict[int, dict] = {}
        for k in range(self.hosts):
            try:
                with open(self._beat_path(k)) as f:
                    out[k] = json.load(f)
            except (OSError, ValueError):
                continue
        return out

    def lost_hosts(self) -> List[int]:
        """The peers whose liveness lapsed past ``lost_after_s`` (none
        while detection is off). A beat older than this signaler's start
        counts as absent: it is a previous attempt's, and a restarted pod
        gives every peer the whole threshold for its first beat."""
        if self.lost_after_s <= 0:
            return []
        now = time.time()
        beats = self.peer_heartbeats()
        lost = []
        for k in range(self.hosts):
            if k == self.host:
                continue
            beat_t = float(beats.get(k, {}).get("t", 0.0))
            if now - (beat_t if beat_t >= self._t0 else self._t0) > self.lost_after_s:
                lost.append(k)
        return lost

    def undeclared_lost(self) -> List[int]:
        """The lost hosts not handed out before."""
        return self.mark_declared(self.lost_hosts())

    def mark_declared(self, hosts) -> List[int]:
        """``hosts`` less the ones declared before, now all declared: the
        commit path, which learns of lost peers from ``commit_generation``,
        shares the one-event-a-host dedupe."""
        fresh = sorted(int(k) for k in set(hosts) if int(k) not in self._declared)
        self._declared.update(fresh)
        return fresh

    def post_preempt(self, gen: int, signum: int = 15) -> None:
        """Announce "this host was preempted; cut generation >= gen" to
        the pod. Called from the SIGTERM handler: it never raises."""
        try:
            os.makedirs(sync_dir(self.run_dir), exist_ok=True)
            _atomic_write(self._preempt_path(self.host), json.dumps(
                {"gen": int(gen), "host": self.host, "signum": int(signum), "t": time.time()}
            ).encode())
        except OSError:
            pass

    def preempt_request(self) -> Optional[dict]:
        """The pod's preemption request, if any: the posting with the
        highest generation wins, so every host cuts the same one. A
        posting older than this signaler's start is a previous attempt's
        and counts as absent, as a stale heartbeat does: each host clears
        only its own at its start, and a restarted peer that read another
        host's old posting before that host cleared it would preempt the
        new attempt at once (ROADMAP C10; the JAX package reads it)."""
        best: Optional[dict] = None
        for k in range(self.hosts):
            try:
                with open(self._preempt_path(k)) as f:
                    req = json.load(f)
            except (OSError, ValueError):
                continue
            if float(req.get("t", 0.0)) < self._t0:
                continue
            if best is None or int(req.get("gen", 0)) > int(best.get("gen", 0)):
                best = req
        return best
