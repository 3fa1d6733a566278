"""Preemption handling and the process exit-code contract (the port's
counterpart of ``hydragnn_tpu/resilience/preempt.py``).

A preemptible machine gets a SIGTERM and a short grace window before the
evictor sends SIGKILL. :class:`PreemptionHandler` turns that signal into
a graceful-stop flag the train loop reads at batch granularity; the loop
then writes a final checkpoint and meta pair, records ``preempt`` and
``run_end{status:"preempted"}`` flight events, and raises
:class:`TrainingPreempted`. :func:`run_guard` maps the typed exceptions
onto the exit codes the restart supervisor
(:mod:`hydragnn_tpu_torch.resilience.supervisor`) classifies.

Exit codes follow sysexits where one fits (75 = EX_TEMPFAIL: a retry is
reasonable; 78 = EX_CONFIG: a retry is pointless):

  ===========================  ====  =========================================
  EXIT_OK                         0  run completed
  EXIT_PREEMPTED                 75  graceful SIGTERM/SIGINT stop, resumable
  EXIT_ROLLBACK_EXHAUSTED        76  non-finite sentry gave up (data/model bug)
  EXIT_CONFIG_ERROR              78  config/shape error: fail fast
  EXIT_HUNG                      79  hang watchdog aborted the process
  anything else / signal exits       crash: retried with backoff
  ===========================  ====  =========================================

On a card the handler's flag waits for the main thread: CPython runs a
signal handler between bytecodes, so a blocking CUDA call (a ``.item()``,
a ``synchronize``, the epoch's loss read) delays it until the call
returns, and the loop sees it at its next batch. The checkpoint is
written by the loop, never from the handler.

In a pod (``resilience/podckpt.py``) the handler also posts the
generation it will cut to the peers through its ``signaler``, so every
host cuts the same one; :class:`PodHostLost` (a peer declared lost)
exits with the preemption's code.
"""

from __future__ import annotations

import contextlib
import os
import signal
import sys
import threading
import traceback
from typing import Optional

from hydragnn_tpu_torch.resilience.sentry import NonFiniteRollbackExhausted
from hydragnn_tpu_torch.resilience.watchdog import EXIT_HUNG

EXIT_OK = 0
EXIT_PREEMPTED = 75
EXIT_ROLLBACK_EXHAUSTED = NonFiniteRollbackExhausted.exit_code
EXIT_CONFIG_ERROR = 78


class TrainingPreempted(Exception):
    """The run was stopped by SIGTERM/SIGINT after writing a resumable
    checkpoint; running the same config again resumes it."""

    exit_code = EXIT_PREEMPTED

    def __init__(self, signum: int, epoch: int):
        self.signum = int(signum)
        self.epoch = int(epoch)
        try:
            name = signal.Signals(signum).name
        except ValueError:
            name = str(signum)
        super().__init__(
            f"training preempted by {name} at epoch {epoch}; checkpoint written, resume with the same config"
        )


class PodHostLost(Exception):
    """A peer host of the pod was declared lost from the heartbeat view
    (``resilience/podckpt.py:PodSignaler``), typically mid-commit, where
    waiting longer cannot help. Exits with the preemption's code: the run
    resumes from the last committed generation, and the pod supervisor
    restarts it at once rather than spend its crash backoff."""

    exit_code = EXIT_PREEMPTED

    def __init__(self, lost, epoch: int):
        self.lost = sorted(int(h) for h in lost)
        self.epoch = int(epoch)
        super().__init__(
            f"pod host(s) {self.lost} declared lost at epoch {epoch}; restart from the last committed generation"
        )


class PreemptionHandler:
    """Installable SIGTERM/SIGINT -> graceful-stop flag.

    The signal handler only sets an event and arms a hard-exit timer of
    ``grace_s`` seconds: when the graceful path (finish the batch, write
    the checkpoint, flush the flight record) overruns the window the
    evictor would enforce anyway, the process exits with
    :data:`EXIT_PREEMPTED` rather than die to the SIGKILL with no
    checkpoint.

    Installation is best-effort: off the main thread ``signal.signal``
    raises and the handler stays inert (``available`` False).
    ``uninstall`` restores the previous handlers and cancels the timer;
    a process that outlives the run must call it (the train loop does on
    every exit path), or the timer ends it ``grace_s`` after the signal.
    """

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT), grace_s: float = 30.0, hard_exit: bool = True):
        self.grace_s = float(grace_s)
        self.hard_exit = bool(hard_exit)
        # written only by the signal handler, which CPython runs on the main thread
        self.signum: Optional[int] = None
        self.available = False
        self._signals = tuple(signals)
        self._stop = threading.Event()
        # the pod's coordination (resilience/podckpt.py): with a
        # PodSignaler attached and proposed_gen kept current by the loop,
        # SIGTERM announces the generation this host will cut to its peers
        self.signaler = None
        self.proposed_gen = 0
        self._old: dict = {}
        self._timer: Optional[threading.Timer] = None

    def install(self) -> "PreemptionHandler":
        try:
            for sig in self._signals:
                self._old[sig] = signal.signal(sig, self._handle)
            self.available = True
        except ValueError:
            # not the main thread: restore whatever was set
            self.uninstall()
            self.available = False
        return self

    def uninstall(self) -> None:
        for sig, old in self._old.items():
            try:
                signal.signal(sig, old)
            except ValueError:
                pass
        self._old.clear()
        self.available = False
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None

    def _handle(self, signum, frame) -> None:
        self.signum = signum
        self._stop.set()
        if self.signaler is not None:
            self.signaler.post_preempt(self.proposed_gen, signum)  # never raises
        if self.hard_exit and self._timer is None:
            t = threading.Timer(self.grace_s, self._force_exit)
            t.daemon = True
            t.start()
            self._timer = t

    def _force_exit(self) -> None:
        # the timer thread, after the grace window: a plain write, then
        # an immediate exit (the evictor's SIGKILL is due any moment)
        try:
            os.write(2, f"PreemptionHandler: grace window ({self.grace_s}s) exceeded; hard-exiting\n".encode())
        except OSError:
            pass
        os._exit(EXIT_PREEMPTED)

    def should_stop(self) -> bool:
        return self._stop.is_set()

    def __enter__(self) -> "PreemptionHandler":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()


@contextlib.contextmanager
def run_guard():
    """Map the typed training exceptions onto the supervisor's exit-code
    contract; wrap a training script's ``run_training`` call::

        with run_guard():
            run_training(cfg, samples=samples)

    ``ValueError``, ``KeyError``, ``TypeError`` and ``FileNotFoundError``
    are config errors (a mis-built config or dataset path: deterministic,
    so the supervisor fails fast), as is a ``CheckpointFormatError``.
    Every other exception propagates as the crash the supervisor
    retries."""
    try:
        yield
    except TrainingPreempted as exc:
        raise SystemExit(exc.exit_code)
    except PodHostLost as exc:
        print(f"run_guard: {exc}", file=sys.stderr)
        raise SystemExit(exc.exit_code)
    except NonFiniteRollbackExhausted as exc:
        print(f"run_guard: {exc}", file=sys.stderr)
        raise SystemExit(exc.exit_code)
    except RuntimeError as exc:
        from hydragnn_tpu_torch.utils.checkpoint import CheckpointFormatError

        if isinstance(exc, CheckpointFormatError):
            # an upgrade refusal is deterministic: a retry cannot help
            traceback.print_exc()
            print("run_guard: checkpoint format refusal (fail-fast)", file=sys.stderr)
            raise SystemExit(EXIT_CONFIG_ERROR)
        raise
    except (ValueError, KeyError, TypeError, FileNotFoundError):
        traceback.print_exc()
        print("run_guard: classified as config error (fail-fast)", file=sys.stderr)
        raise SystemExit(EXIT_CONFIG_ERROR)


def auto_resume_config(training: dict, log_name: str, log_dir: str) -> bool:
    """The supervisor's resume: under ``HGTORCH_AUTO_RESUME=1`` (set for
    every restarted child) and when the run's checkpoint exists, the
    config becomes ``Training.continue=1``/``startfrom=<log_name>`` so the
    restarted process goes on instead of starting over. Returns True when
    the config was changed."""
    if os.environ.get("HGTORCH_AUTO_RESUME") != "1":
        return False
    from hydragnn_tpu_torch.utils.checkpoint import checkpoint_exists

    if not checkpoint_exists(log_name, log_dir):
        return False
    training["continue"] = 1
    training.setdefault("startfrom", log_name)
    return True
