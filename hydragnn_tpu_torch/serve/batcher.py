"""Deadline micro-batcher: coalesce single-graph requests into bucket
batches, with explicit backpressure.

The port's counterpart of ``hydragnn_tpu/serve/batcher.py``. A bucket
flushes the moment it holds ``max_batch`` requests or when its oldest
request has waited ``max_delay_s``, whichever comes first. The queue is
bounded across all buckets: ``put`` raises :class:`Overloaded` rather
than buffering without limit. It moves (item, Future) pairs between
threads; the server owns execution.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Any, List, Optional, Tuple

from hydragnn_tpu_torch.utils import syncdebug


class Overloaded(RuntimeError):
    """The request queue is full — explicit load-shedding signal."""


class ServerClosed(RuntimeError):
    """Submission after close()/stop()."""


@dataclasses.dataclass
class PendingRequest:
    item: Any
    future: Future
    t_enqueue: float  # time.monotonic() at admission
    bucket: int
    seq: int = -1  # the server's admission sequence number
    trace: Any = None  # obs/trace.py RequestTrace (None when tracing is off)
    tenant: str = "default"  # the admitting tenant


class MicroBatchQueue:
    """Thread-safe bounded multi-bucket queue with deadline coalescing.

    Producers call :meth:`put` from any thread; one consumer loops on
    :meth:`take_batch`, which blocks until some bucket is flushable and
    returns ``(bucket_index, requests, reason)`` with reason ``"full"``,
    ``"deadline"`` or ``"drain"``, or ``None`` once closed and drained."""

    def __init__(self, num_buckets: int, max_batch: int, max_delay_s: float, max_pending: int):
        if num_buckets < 1:
            raise ValueError("num_buckets must be >= 1")
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if max_pending < 1:
            raise ValueError("max_pending must be >= 1")
        self._max_batch = max_batch
        self._max_delay_s = float(max_delay_s)
        self._max_pending = max_pending
        self._cv = syncdebug.maybe_wrap(threading.Condition(), "batcher.MicroBatchQueue._cv")
        # guarded by _cv
        self._pending: List[deque] = [deque() for _ in range(num_buckets)]
        self._count = 0
        self._closed = False

    def put(self, bucket: int, item: Any, seq: int = -1, trace: Any = None, tenant: str = "default") -> Future:
        """Admit one request into ``bucket``'s lane; returns its Future.
        Raises Overloaded at capacity and ServerClosed after close()."""
        fut: Future = Future()
        with self._cv:
            if self._closed:
                raise ServerClosed("serving queue is closed")
            if self._count >= self._max_pending:
                raise Overloaded(
                    f"serving queue full ({self._count}/{self._max_pending} pending)"
                )
            self._pending[bucket].append(
                PendingRequest(item, fut, time.monotonic(), bucket, seq, trace, tenant)
            )
            self._count += 1
            self._cv.notify_all()
        return fut

    def depth(self) -> int:
        with self._cv:
            return self._count

    def oldest_age_s(self) -> float:
        """Seconds the oldest queued request has waited, across all
        buckets (each lane's head is its oldest); 0.0 when empty."""
        with self._cv:
            heads = [dq[0].t_enqueue for dq in self._pending if dq]
        return max(time.monotonic() - min(heads), 0.0) if heads else 0.0

    def take_batch(self) -> Optional[Tuple[int, List[PendingRequest], str]]:
        with self._cv:
            while True:
                # full buckets flush first, fullest first
                best_full = None
                for i, dq in enumerate(self._pending):
                    if len(dq) >= self._max_batch and (
                        best_full is None or len(dq) > len(self._pending[best_full])
                    ):
                        best_full = i
                if best_full is not None:
                    return best_full, self._pop(best_full), "drain" if self._closed else "full"
                if self._closed:
                    for i, dq in enumerate(self._pending):
                        if dq:
                            return i, self._pop(i), "drain"
                    return None
                # then the bucket whose oldest request's deadline is soonest
                now = time.monotonic()
                soonest, soonest_t = None, None
                for i, dq in enumerate(self._pending):
                    if dq:
                        t = dq[0].t_enqueue + self._max_delay_s
                        if soonest_t is None or t < soonest_t:
                            soonest, soonest_t = i, t
                if soonest is not None and soonest_t <= now:
                    return soonest, self._pop(soonest), "deadline"
                self._cv.wait(timeout=None if soonest_t is None else max(soonest_t - now, 0.0))

    def _pop(self, bucket: int) -> List[PendingRequest]:
        # caller holds _cv
        dq = self._pending[bucket]
        out = [dq.popleft() for _ in range(min(len(dq), self._max_batch))]
        self._count -= len(out)
        self._cv.notify_all()
        return out

    def close(self) -> None:
        """Stop admitting; take_batch drains what is queued, then returns
        None. Idempotent."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def cancel_pending(self, exc: BaseException) -> int:
        """Fail every queued request with ``exc``; returns how many."""
        drained: List[PendingRequest] = []
        with self._cv:
            for dq in self._pending:
                while dq:
                    drained.append(dq.popleft())
            self._count = 0
            self._cv.notify_all()
        # resolve outside the lock: done-callbacks run on this thread
        for req in drained:
            req.future.set_exception(exc)
        return len(drained)
