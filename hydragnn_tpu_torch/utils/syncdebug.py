"""Runtime lock-order witness (``HGTORCH_LOCK_DEBUG=1``; the port's
counterpart of ``hydragnn_tpu/utils/syncdebug.py``).

Every declared lock of the port is made through :func:`maybe_wrap`. With
the knob off (the default) that returns the raw lock, so production pays
nothing. With ``HGTORCH_LOCK_DEBUG=1`` each lock is wrapped in a
:class:`WitnessLock` that records each thread's acquisition order into a
process-wide order graph. An acquisition that contradicts the graph
(taking A while holding B when A -> B is already on record) is a
deadlock in the making: the witness writes every thread's stack into the
flight record as a ``lock_order`` event (``obs/flight.py``), prints a
warning and CARRIES ON: a witness that deadlocked or raised on the serve
path would be worse than the bug it hunts.

The witness here runs OBSERVED-ONLY: the JAX package also seeds the
graph with its static lock-order analysis (``hydragnn_tpu/lint/``), which
the port does not have, so an inversion fires once both orders have been
seen at run time.

``HGTORCH_INJECT_LOCK_ORDER="<lockA>,<lockB>"`` is the one-shot
self-test: once both named locks exist, the witness books an A -> B
acquisition followed by the B -> A inversion (bookkeeping only; no real
lock is taken, so the injection cannot deadlock), which drives the whole
violation path.

A lock's identity is its NAME (``<modstem>.<Class>.<attr>``, the JAX
package's scheme), not its instance: all Counters share one node, the
standard lockdep coarsening.
"""

from __future__ import annotations

import os
import sys
import threading
import traceback
import weakref
from typing import Dict, List, Optional, Set, Tuple

_ENABLED: Optional[bool] = None  # written once, None -> bool
_STATE_LOCK = threading.Lock()
# order edges seen: name -> set of successors (guarded by _STATE_LOCK, as
# are the four below)
_ORDER: Dict[str, Set[str]] = {}
_REGISTERED: Set[str] = set()
_SEEN_EDGES: Set[Tuple[str, str]] = set()
_VIOLATIONS: List[dict] = []
_FLIGHTS: List = []
_INJECT_FIRED = False
_TLS = threading.local()


def enabled() -> bool:
    """Whether the witness is on: ``HGTORCH_LOCK_DEBUG`` read once and
    kept (wrap decisions must hold for the process's life)."""
    global _ENABLED
    if _ENABLED is None:
        raw = os.environ.get("HGTORCH_LOCK_DEBUG", "").strip().lower()
        _ENABLED = bool(raw) and raw not in ("0", "false", "off", "no")
    return _ENABLED


def maybe_wrap(lock, name: str):
    """``lock`` in a :class:`WitnessLock` under ``name`` when the witness
    is on, ``lock`` itself otherwise."""
    if not enabled():
        return lock
    _register(name)
    return WitnessLock(lock, name)


def register_flight(recorder) -> None:
    """Point the witness at a flight recorder (held weakly), so a
    violation lands in the run's event log. ``FlightRecorder`` calls this
    when it opens its file; a no-op while the witness is off."""
    if not enabled():
        return
    with _STATE_LOCK:
        _FLIGHTS.append(weakref.ref(recorder))


def violations() -> List[dict]:
    """The violations recorded so far (copies)."""
    with _STATE_LOCK:
        return [dict(v) for v in _VIOLATIONS]


def reset() -> None:
    """Forget all of the witness's state, the enable decision included:
    for tests only."""
    global _ENABLED, _INJECT_FIRED
    with _STATE_LOCK:
        _ENABLED = None
        _ORDER.clear()
        _REGISTERED.clear()
        _SEEN_EDGES.clear()
        _VIOLATIONS.clear()
        _FLIGHTS.clear()
        _INJECT_FIRED = False
    _TLS.held = []


# -- internals ---------------------------------------------------------------


def _held() -> List[str]:
    held = getattr(_TLS, "held", None)
    if held is None:
        held = _TLS.held = []
    return held


def _register(name: str) -> None:
    with _STATE_LOCK:
        first = name not in _REGISTERED
        _REGISTERED.add(name)
    if first:
        _maybe_inject()


def _path_exists_locked(src: str, dst: str) -> bool:
    """Is ``dst`` reachable from ``src`` in ``_ORDER``? The caller holds
    ``_STATE_LOCK``."""
    stack, seen = [src], {src}
    while stack:
        u = stack.pop()
        if u == dst:
            return True
        for v in _ORDER.get(u, ()):
            if v not in seen:
                seen.add(v)
                stack.append(v)
    return False


def _note_acquire(name: str, injected: bool = False) -> None:
    held = _held()
    for h in held:
        if h == name:
            continue  # re-entrant (RLock) or a sibling of the same name
        if (h, name) in _SEEN_EDGES:
            continue  # known and checked (a stale read only re-checks below)
        with _STATE_LOCK:
            if (h, name) in _SEEN_EDGES:
                continue
            conflict = _path_exists_locked(name, h)
            _ORDER.setdefault(h, set()).add(name)
            _SEEN_EDGES.add((h, name))
        if conflict:
            _violation(h, name, injected)
    held.append(name)


def _note_release(name: str) -> None:
    held = _held()
    # the most recent acquisition of this name (Python allows any release order)
    for i in range(len(held) - 1, -1, -1):
        if held[i] == name:
            del held[i]
            return


def _all_thread_stacks() -> Dict[str, List[str]]:
    names = {t.ident: t.name for t in threading.enumerate()}
    out: Dict[str, List[str]] = {}
    for ident, frame in sys._current_frames().items():
        label = f"{names.get(ident, 'unknown')}({ident})"
        out[label] = [line.rstrip("\n") for line in traceback.format_stack(frame)[-12:]]
    return out


def _violation(held_name: str, acquiring: str, injected: bool) -> None:
    """An order inversion: a ``lock_order`` flight event with every
    thread's stack, a warning, and on; it never raises or blocks."""
    event = {
        "locks": [held_name, acquiring],
        "edge": f"{held_name}->{acquiring}",
        "conflict": f"{acquiring}->{held_name}",
        "thread": threading.current_thread().name,
        "injected": bool(injected),
        "stacks": _all_thread_stacks(),
    }
    with _STATE_LOCK:
        _VIOLATIONS.append(event)
        flights = [ref() for ref in _FLIGHTS]
    try:
        print(
            f"syncdebug: LOCK-ORDER VIOLATION: acquiring {acquiring!r} while holding {held_name!r} contradicts "
            f"the known order {acquiring} -> {held_name}" + (" [injected self-test]" if injected else ""),
            file=sys.stderr,
        )
    except Exception:
        pass
    for flight in flights:
        if flight is None:
            continue
        try:
            flight.record("lock_order", **event)
        except Exception:
            pass  # a witness must never take the run down


def _maybe_inject() -> None:
    """``HGTORCH_INJECT_LOCK_ORDER="A,B"``, once: when both locks are
    registered, book A -> B and then the B -> A inversion."""
    global _INJECT_FIRED
    spec = os.environ.get("HGTORCH_INJECT_LOCK_ORDER", "")
    if "," not in spec:
        return
    a, b = (s.strip() for s in spec.split(",", 1))
    with _STATE_LOCK:
        if _INJECT_FIRED or a not in _REGISTERED or b not in _REGISTERED:
            return
        _INJECT_FIRED = True
    _note_acquire(a, injected=True)
    _note_acquire(b, injected=True)
    _note_release(b)
    _note_release(a)
    _note_acquire(b, injected=True)
    _note_acquire(a, injected=True)  # fires: a -> b is on record
    _note_release(a)
    _note_release(b)


class WitnessLock:
    """An order-witnessing wrapper of a ``Lock``, ``RLock`` or
    ``Condition``: the context-manager and acquire/release protocol, and
    a Condition's ``wait``/``wait_for``, which take the lock off the held
    stack while they wait (the wait releases it) and book it again on
    return. Everything else is delegated."""

    __slots__ = ("_inner", "_name")

    def __init__(self, inner, name: str):
        self._inner = inner
        self._name = name

    def acquire(self, *args, **kwargs):
        got = self._inner.acquire(*args, **kwargs)
        if got is not False:
            _note_acquire(self._name)
        return got

    def release(self) -> None:
        self._inner.release()
        _note_release(self._name)

    def __enter__(self):
        self._inner.__enter__()
        _note_acquire(self._name)
        return self

    def __exit__(self, *exc):
        _note_release(self._name)
        return self._inner.__exit__(*exc)

    def locked(self) -> bool:
        return self._inner.locked()

    def wait(self, timeout=None):
        _note_release(self._name)
        try:
            return self._inner.wait(timeout)
        finally:
            _note_acquire(self._name)

    def wait_for(self, predicate, timeout=None):
        _note_release(self._name)
        try:
            return self._inner.wait_for(predicate, timeout)
        finally:
            _note_acquire(self._name)

    def __getattr__(self, attr):
        return getattr(self._inner, attr)

    def __repr__(self) -> str:
        return f"WitnessLock({self._name!r}, {self._inner!r})"
