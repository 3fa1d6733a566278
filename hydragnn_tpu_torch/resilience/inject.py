"""Env-gated deterministic fault injection (the port's counterpart of
``hydragnn_tpu/resilience/inject.py``), with the JAX package's spec
grammar under the port's ``HGTORCH_`` prefix. Every hook is a no-op
unless its variable is set, and the restart supervisor strips every name
of :data:`INJECTIONS` from restarted children, so an injected fault
fires once a supervised run.

Training faults (step numbers are process-local dispatch counts, 0-based,
counted by ``resilience/hooks.py:TrainHooks``, so an injection is
deterministic whatever the resume state):

  =================================  ==========================================
  HGTORCH_INJECT_NAN_STEP=N[:M]      train steps N..N+M-1 (M=1) get a new
                                     batch whose node features are NaN
  HGTORCH_INJECT_SIGTERM_STEP=N      SIGTERM to itself before train step N
  HGTORCH_INJECT_SIGTERM_EPOCH=E     SIGTERM to itself at the start of epoch E
  HGTORCH_INJECT_KILL_CHECKPOINT=K   during the K-th (1-indexed) checkpoint
                                     save of the process: the latest file is
                                     written TRUNCATED in place (a torn write
                                     on a filesystem without atomic replace)
                                     and the process SIGKILLs itself
  HGTORCH_INJECT_STALL_LOADER=B:S    the loader sleeps S seconds (default
                                     3600) before building batch B of an
                                     epoch (drives the hang watchdog)
  HGTORCH_INJECT_TRIGGER=<rule>      the SLO rule of that name force-fires
                                     at its engine's next evaluation, once
                                     a process (``obs/triggers.py``)
  HGTORCH_INJECT_LOCK_ORDER=A,B      the lock-order witness's one-shot
                                     self-test (``utils/syncdebug.py``)
  =================================  ==========================================

Serving faults (request numbers are the server's admission sequence,
0-based, so an injection follows its request through batch coalescing and
the retry-as-singles poison hunt):

  =====================================  ======================================
  HGTORCH_INJECT_SERVE_RAISE=N           the forward raises for any batch
                                         holding request N (a poison request)
  HGTORCH_INJECT_SERVE_NAN=N             the forward's outputs are NaN for any
                                         batch holding request N
  HGTORCH_INJECT_SERVE_WEDGE=N:S         the dispatch thread sleeps S seconds
                                         (default 5) in the batch holding
                                         request N, once a process (a wedged
                                         dispatch: drives the watchdog)
  HGTORCH_INJECT_SERVE_KILL_DISPATCH=K   the K-th (1-indexed) dispatched batch
                                         raises outside request isolation,
                                         killing the dispatch thread (drives
                                         the dispatch supervisor's restart)
  HGTORCH_INJECT_SERVE_TORN_RELOAD=1     ModelServer.reload turns the
                                         candidate weights to NaN before the
                                         canary (which must refuse them)
  HGTORCH_INJECT_DRIFT=SHIFT             every admitted request's node features
                                         shift by SHIFT (a float) at admission,
                                         so the drift sketches and the model
                                         both see it (drives the feature_drift
                                         rule and the spool; ``obs/drift.py``)
  =====================================  ======================================

Retrain-pilot faults (``pilot/``), one a stage of the loop, each proving
that the loop degrades to "the old weights keep serving":

  =====================================  ======================================
  HGTORCH_INJECT_PILOT_TRAIN_CRASH=N     the fine-tune child exits 70 before
                                         training (the restart supervisor
                                         strips it from the retried child, so
                                         N=1 means one crash, then a clean run)
  HGTORCH_INJECT_PILOT_HUNG_TUNE=S       the fine-tune sleeps S seconds before
                                         any work (the wall-clock runner kills
                                         it and the supervisor classifies it
                                         hung/79)
  HGTORCH_INJECT_PILOT_CANARY_REGRESS=1  the pilot's canary inflates the
                                         candidate's scores, so the gate
                                         rejects it (cooldown, never a reload)
  HGTORCH_INJECT_PILOT_TORN_RELOAD=1     the pilot truncates the candidate's
                                         checkpoint pointer between its canary
                                         and the reload (the reload path's own
                                         validating loader must reject it)
  =====================================  ======================================

Pod faults (``resilience/podckpt.py``, ``obs/podview.py``), each tied
to a (host, generation-like) pair so exactly one host misbehaves at one
point (host indices are ``obs/podview.py:host_identity``'s):

  =====================================  ======================================
  HGTORCH_INJECT_POD_KILL_HOST=H:G       host H SIGKILLs itself in its
                                         generation-G pod checkpoint save,
                                         AFTER its shard bytes land and BEFORE
                                         its manifest: generation G can never
                                         commit (a torn generation)
  HGTORCH_INJECT_POD_TORN_SHARD=H:G      host H writes its generation-G shard
                                         truncated while its sha256 sidecar
                                         holds the good digest: the restore
                                         must reject it and fall back a
                                         generation
  HGTORCH_INJECT_POD_LOST_HEARTBEAT=H:E  host H writes no heartbeat from epoch
                                         E on (alive but silent, as a wedged
                                         host looks from outside: drives the
                                         host_lost detection)
  HGTORCH_INJECT_POD_BARRIER_STALL=H:S   host H sleeps S seconds (default 5)
                                         before it enters a pod_barrier, once
                                         a process: its peers must time out,
                                         go on and record it
  HGTORCH_INJECT_STRAGGLER=H:MS          host H sleeps MS milliseconds in every
                                         train step (``obs/spans.py``): a
                                         straggler for the step_skew rule
  =====================================  ======================================
"""

from __future__ import annotations

import dataclasses
import os
import signal
import threading
import time
from typing import Dict, List, Optional, Tuple

INJECT_PREFIX = "HGTORCH_INJECT_"

#: Every injection of the port, by name: what ``active_injections`` reads
#: and ``strip_injection_env`` drops (the role of the JAX package's knob
#: registry, ``hydragnn_tpu/utils/knobs.py``).
INJECTIONS = (
    "HGTORCH_INJECT_NAN_STEP",
    "HGTORCH_INJECT_SIGTERM_STEP",
    "HGTORCH_INJECT_SIGTERM_EPOCH",
    "HGTORCH_INJECT_KILL_CHECKPOINT",
    "HGTORCH_INJECT_STALL_LOADER",
    "HGTORCH_INJECT_TRIGGER",
    "HGTORCH_INJECT_LOCK_ORDER",
    "HGTORCH_INJECT_SERVE_RAISE",
    "HGTORCH_INJECT_SERVE_NAN",
    "HGTORCH_INJECT_SERVE_WEDGE",
    "HGTORCH_INJECT_SERVE_KILL_DISPATCH",
    "HGTORCH_INJECT_SERVE_TORN_RELOAD",
    "HGTORCH_INJECT_DRIFT",
    "HGTORCH_INJECT_PILOT_TRAIN_CRASH",
    "HGTORCH_INJECT_PILOT_HUNG_TUNE",
    "HGTORCH_INJECT_PILOT_CANARY_REGRESS",
    "HGTORCH_INJECT_PILOT_TORN_RELOAD",
    "HGTORCH_INJECT_POD_KILL_HOST",
    "HGTORCH_INJECT_POD_TORN_SHARD",
    "HGTORCH_INJECT_POD_LOST_HEARTBEAT",
    "HGTORCH_INJECT_POD_BARRIER_STALL",
    "HGTORCH_INJECT_STRAGGLER",
)


def _spec(name: str) -> Optional[str]:
    v = os.environ.get(name)
    return v if v else None


def _two_ints(spec: str, default_second: int) -> Tuple[int, int]:
    parts = spec.split(":")
    b = int(parts[1]) if len(parts) > 1 and parts[1] else default_second
    return int(parts[0]), b


def active_injections(env: Optional[Dict[str, str]] = None, include_serve: bool = False) -> List[str]:
    """The names of :data:`INJECTIONS` set (non-empty) in the environment,
    or in ``env``, sorted. ``include_serve=False`` leaves out the serving
    family: what the dispatch resolution asks (a training injection is
    step-indexed and needs the per-step path)."""
    src = os.environ if env is None else env
    return sorted(
        k for k in INJECTIONS
        if src.get(k) and (include_serve or not k.startswith("HGTORCH_INJECT_SERVE"))
    )


def maybe_nan_batch(batch, step: int):
    """A NEW batch whose node features are NaN when ``step`` is inside
    the injected window, else ``batch`` itself. The given batch is never
    written: resident batches and pinned staging buffers are reused
    across epochs."""
    spec = _spec("HGTORCH_INJECT_NAN_STEP")
    if spec is None:
        return batch
    start, count = _two_ints(spec, 1)
    if not start <= step < start + count:
        return batch
    import torch

    return dataclasses.replace(batch, nodes=torch.full_like(batch.nodes, float("nan")))


def maybe_sigterm(step: Optional[int] = None, epoch: Optional[int] = None) -> None:
    """SIGTERM to this process at the injected step or epoch boundary."""
    if step is not None:
        spec = _spec("HGTORCH_INJECT_SIGTERM_STEP")
        if spec is not None and step == int(spec):
            os.kill(os.getpid(), signal.SIGTERM)
    if epoch is not None:
        spec = _spec("HGTORCH_INJECT_SIGTERM_EPOCH")
        if spec is not None and epoch == int(spec):
            os.kill(os.getpid(), signal.SIGTERM)


# checkpoint saves of this process; only the thread that writes
# checkpoints (the train loop's) counts them
_CHECKPOINT_SAVES = 0


def maybe_kill_checkpoint(path: str, data: bytes) -> None:
    """During the K-th checkpoint save: leave ``path`` TRUNCATED (half the
    payload, written in place, bypassing the temporary file and the
    atomic rename, as a filesystem that tears writes on power loss would)
    and SIGKILL the process. The restart must reject the torn file and
    restore the previous good one."""
    spec = _spec("HGTORCH_INJECT_KILL_CHECKPOINT")
    if spec is None:
        return
    global _CHECKPOINT_SAVES
    _CHECKPOINT_SAVES += 1
    if _CHECKPOINT_SAVES != int(spec):
        return
    with open(path, "wb") as f:
        f.write(data[: max(len(data) // 2, 1)])
        f.flush()
        os.fsync(f.fileno())
    os.kill(os.getpid(), signal.SIGKILL)


def maybe_stall_loader(batch_index: int) -> None:
    """Sleep before the loader builds the injected batch of an epoch."""
    spec = _spec("HGTORCH_INJECT_STALL_LOADER")
    if spec is None:
        return
    b, seconds = _two_ints(spec, 3600)
    if batch_index == b:
        time.sleep(seconds)


def maybe_serve_raise(seqs) -> None:
    """Raise inside the serving forward when the batch holds the
    injected request."""
    spec = _spec("HGTORCH_INJECT_SERVE_RAISE")
    if spec is not None and int(spec) in seqs:
        raise RuntimeError(f"injected serve fault: raise-in-forward at request {int(spec)}")


def maybe_serve_nan(outputs, seqs):
    """The forward's outputs as NaN when the batch holds the injected
    request (silent corruption the finite check must catch)."""
    spec = _spec("HGTORCH_INJECT_SERVE_NAN")
    if spec is None or int(spec) not in seqs:
        return outputs
    import numpy as np

    return [np.full_like(np.asarray(o), np.nan) for o in outputs]


class _Latch:
    """A one-way flag set at most once a process."""

    def __init__(self):
        self._lock = threading.Lock()
        self.fired = False  # guarded by _lock for the check-and-set

    def take(self) -> bool:
        with self._lock:
            if self.fired:
                return False
            self.fired = True
            return True

    def reset(self) -> None:
        with self._lock:
            self.fired = False


SERVE_WEDGE = _Latch()
TRIGGER = _Latch()


def injected_trigger(known_rules=None) -> Optional[str]:
    """The rule name ``HGTORCH_INJECT_TRIGGER`` gives, once a process
    (``TRIGGER``). A name outside ``known_rules`` is left for the engine
    that knows it."""
    spec = _spec("HGTORCH_INJECT_TRIGGER")
    if spec is None or (known_rules is not None and spec not in known_rules):
        return None
    return spec if TRIGGER.take() else None


def maybe_serve_wedge(seqs) -> None:
    """Sleep in the serving forward of the batch holding the injected
    request; once a process (``SERVE_WEDGE``)."""
    spec = _spec("HGTORCH_INJECT_SERVE_WEDGE")
    if spec is None:
        return
    n, seconds = _two_ints(spec, 5)
    if n in seqs and SERVE_WEDGE.take():
        time.sleep(seconds)


def maybe_serve_kill_dispatch(batch_count: int) -> None:
    """Raise outside the request isolation at the K-th dispatched batch:
    the dispatch thread dies and its supervisor must restart it."""
    spec = _spec("HGTORCH_INJECT_SERVE_KILL_DISPATCH")
    if spec is not None and batch_count == int(spec):
        raise RuntimeError(f"injected serve fault: dispatch thread killed at batch {batch_count}")


def maybe_drift_shift(x):
    """The request's node features plus the injected shift (``x +
    SHIFT``), or ``x`` unchanged when none is set. Every request shifts
    alike, so the sketches see a clean displacement."""
    spec = _spec("HGTORCH_INJECT_DRIFT")
    if spec is None:
        return x
    import numpy as np

    return np.asarray(x) + float(spec)


def serve_torn_reload() -> bool:
    """Whether ``ModelServer.reload`` corrupts the candidate weights
    before the canary."""
    return _spec("HGTORCH_INJECT_SERVE_TORN_RELOAD") is not None


def pilot_train_crashes() -> int:
    """How many fine-tune attempts crash before one runs (0: none). The
    supervisor strips the variable from a restarted child, so a child
    reads N only on the first attempt."""
    spec = _spec("HGTORCH_INJECT_PILOT_TRAIN_CRASH")
    return int(spec) if spec is not None else 0


def maybe_pilot_hang() -> None:
    """Sleep the injected seconds before the fine-tune does any work: the
    supervisor's wall clock, not the in-process watchdog, must end it."""
    spec = _spec("HGTORCH_INJECT_PILOT_HUNG_TUNE")
    if spec is not None:
        time.sleep(float(spec))


def pilot_canary_regress() -> bool:
    """Whether the pilot's canary inflates the candidate's scores."""
    return _spec("HGTORCH_INJECT_PILOT_CANARY_REGRESS") is not None


def pilot_torn_reload() -> bool:
    """Whether the pilot tears the candidate's checkpoint between its
    canary and the reload."""
    return _spec("HGTORCH_INJECT_PILOT_TORN_RELOAD") is not None


def maybe_pod_kill_host(host: int, gen) -> None:
    """SIGKILL this process when it is the injected host saving the
    injected generation. Called between the shard write and the manifest
    write, so the death always leaves a torn generation."""
    spec = _spec("HGTORCH_INJECT_POD_KILL_HOST")
    if spec is None or gen is None:
        return
    h, g = _two_ints(spec, 1)
    if int(host) == h and int(gen) == g:
        os.kill(os.getpid(), signal.SIGKILL)


def maybe_pod_torn_shard(host: int, gen) -> bool:
    """Whether the injected host writes its injected generation's shard
    truncated while the sha256 sidecar keeps the good digest."""
    spec = _spec("HGTORCH_INJECT_POD_TORN_SHARD")
    if spec is None or gen is None:
        return False
    h, g = _two_ints(spec, 1)
    return int(host) == h and int(gen) == g


def maybe_pod_lost_heartbeat(host: int, epoch) -> bool:
    """Whether the injected host writes no heartbeat (from the injected
    epoch on). It trains on; only its liveness signal stops, so its peers
    must declare it lost on evidence, not on an exit code."""
    spec = _spec("HGTORCH_INJECT_POD_LOST_HEARTBEAT")
    if spec is None or epoch is None:
        return False
    h, e = _two_ints(spec, 0)
    return int(host) == h and int(epoch) >= e


POD_BARRIER_STALL = _Latch()


def maybe_pod_barrier_stall(host: int) -> None:
    """Sleep the injected host before it enters a ``pod_barrier``, once a
    process (``POD_BARRIER_STALL``): its peers must time out, go on and
    record the missing host rather than hang."""
    spec = _spec("HGTORCH_INJECT_POD_BARRIER_STALL")
    if spec is None:
        return
    h, seconds = _two_ints(spec, 5)
    if int(host) == h and POD_BARRIER_STALL.take():
        time.sleep(seconds)


def strip_injection_env(env: dict) -> dict:
    """A copy of ``env`` without the injections: every name of
    :data:`INJECTIONS` set there (``active_injections``), and any other
    ``HGTORCH_INJECT_*`` name as a backstop, so a restarted process does
    not fire an injected fault again."""
    drop = set(active_injections(env=env, include_serve=True))
    return {k: v for k, v in env.items() if k not in drop and not k.startswith(INJECT_PREFIX)}
