"""Env-gated deterministic fault injection, the serving part.

The port's counterpart of the serve half of
``hydragnn_tpu/resilience/inject.py``, with the JAX package's spec
grammar under the port's ``HGTORCH_`` prefix. Every hook is a no-op
unless its variable is set. Request numbers are the server's admission
sequence (0-based), so an injection follows its request through batch
coalescing and the retry-as-singles poison hunt.

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
  HGTORCH_INJECT_TRIGGER=<rule>          the SLO rule of that name force-fires
                                         at its engine's next evaluation, once
                                         a process (``obs/triggers.py``)
  HGTORCH_INJECT_DRIFT=SHIFT             every admitted request's node features
                                         shift by SHIFT (a float) at admission,
                                         so the drift sketches and the model
                                         both see it (drives the feature_drift
                                         rule and the spool; ``obs/drift.py``)
  =====================================  ======================================

The other training injections and the pod ones wait for ROADMAP A-7.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional, Tuple

INJECT_PREFIX = "HGTORCH_INJECT_"


def _spec(name: str) -> Optional[str]:
    v = os.environ.get(name)
    return v if v else None


def _two_ints(spec: str, default_second: int) -> Tuple[int, int]:
    parts = spec.split(":")
    b = int(parts[1]) if len(parts) > 1 and parts[1] else default_second
    return int(parts[0]), b


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


def strip_injection_env(env: dict) -> dict:
    """A copy of ``env`` without any ``HGTORCH_INJECT_*`` variable (the
    table above, ``HGTORCH_INJECT_DRIFT`` among them), so a restarted
    process does not fire an injected fault again."""
    return {k: v for k, v in env.items() if not k.startswith(INJECT_PREFIX)}
