"""Host-side step spans: where does a train step's wall time go?

The port's counterpart of ``hydragnn_tpu/obs/spans.py``. Each epoch's
steps are split into

  - **data wait**: the time the loop blocks on the loader (batching and
    host-to-device copies the prefetch thread did not hide);
  - **dispatch**: the time inside the step call before it returns (the
    card runs asynchronously: launching the kernels);
  - **device wait**, sampled: for ``sample_steps`` steps after the first
    ``skip_first`` the step is fenced with ``torch.cuda.synchronize`` and
    the wait past dispatch is recorded. Only those steps pay the sync.

The fence runs inside ``trace_annotation("obs.sampled_sync_step")``, so
a profile shows which steps were fenced, and is skipped while a profiler
capture holds the slot (``utils/profile.py``): the fence would serialise
the very steps being traced. Each sampled step also goes to the
``Tracer`` (``obs/trace.py``) as a one-span trace keyed (epoch, step).

The port launches the fixed-membership epoch step by step, so both
dispatch modes decompose; the loop adds the mode's name. Disabled spans
(``StepSpans.disabled()``) add no per-step work: ``timed_iter`` returns
its argument and ``step`` is a direct call.
"""

from __future__ import annotations

import time
from typing import Any, Iterable, Iterator, Optional

import torch


class StepSpans:
    """Per-epoch span accumulator of the loop's steps:

        spans.epoch_start(epoch)
        for batch in spans.timed_iter(loader):
            out = spans.step(train_step, batch)
        record = spans.epoch_snapshot()

    ``device`` is the run's device; the fence is a no-op off the card."""

    def __init__(self, sample_steps: int = 3, skip_first: int = 1, tracer=None, device=None):
        self.sample_steps = sample_steps
        self.skip_first = skip_first
        self.enabled = True
        self.epoch = -1
        self.tracer = tracer
        dev = torch.device(device) if device is not None else None
        self._cuda = dev if dev is not None and dev.type == "cuda" else None
        # HGTORCH_INJECT_STRAGGLER="HOST:MS": on the named pod host every
        # step sleeps MS first, so its host_epoch summary runs long and
        # host 0's SkewMonitor has a real skew to see (obs/podview.py)
        from hydragnn_tpu_torch.obs import podview

        spec = podview.straggler_spec()
        self._straggle_s = spec[1] if spec is not None and spec[0] == podview.host_identity()[0] else 0.0
        self._reset()

    @staticmethod
    def disabled() -> "_NullSpans":
        return _NULL_SPANS

    def _reset(self) -> None:
        self.steps = 0
        self.data_wait_s = 0.0
        self.dispatch_s = 0.0
        self.first_step_s = 0.0
        self.sampled = 0
        self.device_wait_s = 0.0
        self.sync_step_s = 0.0

    def epoch_start(self, epoch: int) -> None:
        self.epoch = epoch
        self._reset()

    def timed_iter(self, iterable: Iterable) -> Iterator:
        """Yield from ``iterable``, adding the time blocked on each next
        item to the data wait; closes the iterator when abandoned."""
        it = iter(iterable)
        try:
            while True:
                t0 = time.perf_counter()
                try:
                    item = next(it)
                except StopIteration:
                    return
                self.data_wait_s += time.perf_counter() - t0
                yield item
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()

    def _fence(self) -> None:
        if self._cuda is not None:
            torch.cuda.synchronize(self._cuda)

    def step(self, fn, *args) -> Any:
        """Run one step, recording its dispatch time; inside the sampling
        window (and with no capture live), fence it and record the wait."""
        from hydragnn_tpu_torch.utils.profile import capture_active, trace_annotation

        t0 = time.perf_counter()
        if self._straggle_s:
            time.sleep(self._straggle_s)
        sampling = self.skip_first <= self.steps < self.skip_first + self.sample_steps and not capture_active()
        if sampling:
            with trace_annotation("obs.sampled_sync_step"):
                out = fn(*args)
                t1 = time.perf_counter()
                self._fence()
            t2 = time.perf_counter()
            self.dispatch_s += t1 - t0
            self.device_wait_s += t2 - t1
            self.sync_step_s += t2 - t0
            self.sampled += 1
            if self.tracer is not None:
                tr = self.tracer.begin(seq=self.steps, epoch=self.epoch)
                if tr is not None:
                    now = time.time()
                    tr.add_span("train.sampled_step", now - (t2 - t0), now, epoch=self.epoch, step=self.steps,
                                dispatch_ms=round((t1 - t0) * 1e3, 3), device_wait_ms=round((t2 - t1) * 1e3, 3))
                    self.tracer.finish(tr)
        else:
            out = fn(*args)
            dt = time.perf_counter() - t0
            self.dispatch_s += dt
            if self.steps == 0:
                self.first_step_s = dt
        self.steps += 1
        return out

    def epoch_snapshot(self) -> dict:
        """One epoch's breakdown for the flight record: seconds for the
        epoch's totals, milliseconds for the sampled steps' means."""
        from hydragnn_tpu_torch.obs.podview import host_identity

        n = self.sampled
        host, hosts = host_identity()
        return {
            "steps": self.steps,
            "process_index": host,
            "process_count": hosts,
            "data_wait_s": round(self.data_wait_s, 6),
            "dispatch_s": round(self.dispatch_s, 6),
            "first_step_s": round(self.first_step_s, 6),
            "sampled_steps": n,
            "device_wait_ms_mean": round(self.device_wait_s / n * 1e3, 3) if n else None,
            "sync_step_ms_mean": round(self.sync_step_s / n * 1e3, 3) if n else None,
        }


class _NullSpans(StepSpans):
    """Telemetry-off spans: every hook is free (``timed_iter`` is the
    identity, ``step`` a direct call) and the snapshot is None."""

    def __init__(self):
        super().__init__(sample_steps=0)
        self.enabled = False

    def epoch_start(self, epoch: int) -> None:
        self.epoch = epoch

    def timed_iter(self, iterable: Iterable) -> Iterable:
        return iterable

    def step(self, fn, *args) -> Any:
        return fn(*args)

    def epoch_snapshot(self) -> Optional[dict]:
        return None


_NULL_SPANS = _NullSpans()
