"""One fleet replica: a supervised :class:`ModelServer` with the lifecycle
the fleet needs around it (the port's counterpart of
``hydragnn_tpu/fleet/replica.py``).

A replica IS a ModelServer (the same bucket ladder, dispatch supervisor
and health), plus:

  - **its own weights and graphs**: the fleet builds each replica's
    ``ServedModel`` with a module of its own, and the server captures its
    own CUDA graphs at ``start()`` (the port has no executable cache: a
    graph cannot be kept across processes, ROADMAP);
  - **in-flight accounting**: the router places on :meth:`load` (queued
    and executing requests) and retirement waits on it: a drained replica
    has no unresolved future;
  - **drain-then-stop retirement**: :meth:`drain_stop` stops admitting,
    waits for the in-flight work, then stops the server, so a scale-down
    fails no request;
  - **probe export**: :meth:`export_probe` writes a textfile with the
    standard ``hydragnn_serve_ready``/``hydragnn_serve_live`` gauges, so
    ``tools/serve_probe.py`` (and its ``--fleet`` mode) probes a replica
    as it probes a server. The replica's registry metrics are prefixed
    ``fleet.<name>.*`` in the shared fleet registry, which would render
    as ``hydragnn_fleet_<name>_ready``, not the probe contract; hence
    this writer.

Health comes from ``ModelServer.health()`` unchanged: a replica whose
dispatch supervisor gave up reports ``live=False``, and the fleet
controller reaps and replaces it.
"""

from __future__ import annotations

import os
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, Optional

from hydragnn_tpu_torch.serve.batcher import ServerClosed
from hydragnn_tpu_torch.serve.server import ModelServer
from hydragnn_tpu_torch.utils import syncdebug


class ReplicaFailed(RuntimeError):
    """Spawning or retiring a replica failed; the fleet survives (the
    controller records the failure and keeps its bounds)."""


class FleetReplica:
    """Lifecycle around one started or starting ModelServer.

    States: ``starting`` (built, graphs capturing) -> ``ready`` (serving)
    -> ``draining`` (no new admissions, in-flight work finishing) ->
    ``stopped``. A replica whose server died shows ``live=False`` in any
    state: the state tracks intent, health tracks reality.
    """

    def __init__(self, name: str, model: str, server: ModelServer):
        self.name = name
        self.model = model
        self.server = server
        self._lock = syncdebug.maybe_wrap(threading.Condition(), "fleet.FleetReplica._lock")
        self._inflight = 0  # the three below are guarded by _lock
        self._draining = False
        self._stopped = False
        self.spawned_t = time.monotonic()

    # -- request path (the router's) ---------------------------------------

    def submit(self, sample: Any, seq: int = -1, tenant: str = "default") -> Future:
        """Admit one request on this replica's server, counted in flight
        until its future resolves (the drain barrier). ``tenant`` rides on
        to the server's spool."""
        with self._lock:
            if self._draining or self._stopped:
                raise ServerClosed(f"replica {self.name} is {'draining' if self._draining else 'stopped'}")
            self._inflight += 1
        try:
            fut = self.server.submit(sample, tenant=tenant)
        except BaseException:
            self._dec_inflight()
            raise
        fut.add_done_callback(lambda _f: self._dec_inflight())
        return fut

    def _dec_inflight(self) -> None:
        with self._lock:
            self._inflight = max(0, self._inflight - 1)
            if self._inflight == 0:
                self._lock.notify_all()

    def load(self) -> int:
        """Unresolved requests on this replica (queued and executing): the
        router's placement signal."""
        with self._lock:
            return self._inflight

    def queue_depth(self) -> int:
        return self.server.queue_depth()

    # -- health ------------------------------------------------------------

    def health(self) -> Dict[str, Any]:
        h = self.server.health()
        h["replica"] = self.name
        h["model"] = self.model
        h["state"] = self.state
        h["inflight"] = self.load()
        return h

    @property
    def live(self) -> bool:
        return bool(self.server.health()["live"])

    @property
    def ready(self) -> bool:
        """Routable: the server is ready and the fleet is not retiring or
        pausing this replica."""
        with self._lock:
            if self._draining or self._stopped:
                return False
        return bool(self.server.health()["ready"])

    @property
    def state(self) -> str:
        with self._lock:
            if self._stopped:
                return "stopped"
            if self._draining:
                return "draining"
        return "ready" if self.server.health()["ready"] else "starting"

    # -- retirement --------------------------------------------------------

    def drain(self, timeout: Optional[float] = 30.0) -> bool:
        """Stop admitting and wait for every in-flight request; False on
        timeout (the caller decides whether to stop anyway)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            self._draining = True
            while self._inflight > 0:
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return False
                self._lock.wait(timeout=remaining)
        return True

    def undrain(self) -> None:
        """Re-open admissions (a rolling reload resumes a paused replica;
        a stopped replica stays stopped)."""
        with self._lock:
            if not self._stopped:
                self._draining = False

    def drain_stop(self, timeout: Optional[float] = 30.0) -> bool:
        """Drain, then stop the server (which flushes its queue and ends
        its flight record); returns whether the drain completed."""
        drained = self.drain(timeout)
        with self._lock:
            self._stopped = True
        self.server.stop()
        return drained

    def kill(self) -> None:
        """A simulated abrupt death (chaos and test hook): the dispatch
        supervisor marked as given up and every queued request failed with
        the typed dispatch error, the state of a replica whose supervisor
        gave up, which the controller's reap keys on."""
        sup = self.server._supervisor
        if sup is not None:
            sup.failed = True
        self.server._on_dispatch_giveup(ReplicaFailed(f"replica {self.name} killed"))

    # -- probe export ------------------------------------------------------

    def export_probe(self, path: str) -> None:
        """This replica's probe textfile with the standard gauge names,
        written atomically."""
        h = self.server.health()
        ready = h["ready"]
        with self._lock:
            ready = ready and not (self._draining or self._stopped)
        write_probe_textfile(path, live=h["live"], ready=ready)


def write_probe_textfile(path: str, *, live: bool, ready: bool) -> None:
    """The two gauges ``serve_probe`` parses, under the standard names
    whatever the writer's registry prefix; an atomic rename, so a probe
    never reads a half-written file."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    body = (
        "# TYPE hydragnn_serve_live gauge\n"
        f"hydragnn_serve_live {1 if live else 0}\n"
        "# TYPE hydragnn_serve_ready gauge\n"
        f"hydragnn_serve_ready {1 if ready else 0}\n"
    )
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    with open(tmp, "w") as f:
        f.write(body)
    os.replace(tmp, path)
