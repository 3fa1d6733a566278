"""ModelServer: the batched online-inference front end.

The port's counterpart of the core of ``hydragnn_tpu/serve/server.py``.
Requests (single prepared graphs) -> bucket router (``buckets.py``) ->
deadline micro-batcher (``batcher.py``) -> one dispatch thread that pads
the coalesced batch to the bucket's plan, moves it to the device, runs
the model and slices per-request results out of the padded outputs.

  - A graph over every routing cap but within the largest bucket's pad
    plan dispatches at once as a batch of one on that bucket.
  - A graph over even that takes the eager path at its own natural pad
    (``eager_fallback``), else fails with :class:`Oversize`.
  - A full queue rejects with :class:`Overloaded`.
  - A request whose forward raises or whose outputs are not finite
    (``check_finite``) fails only its own future with
    :class:`RequestFailed`; a failing multi-request batch is re-run as
    singles once to find the poison.

The dispatch thread sets the server's CUDA device before it runs
anything, so every kernel launches on that device's current stream.

Waiting for later slices (ROADMAP A10-A12): the restart supervisor and
hang watchdog, hot reload and its canary, the spool, drift, triggers,
fault injection and the persistent executable cache.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from hydragnn_tpu_torch.graph.batch import batch_graphs
from hydragnn_tpu_torch.serve.batcher import (
    MicroBatchQueue,
    Overloaded,
    PendingRequest,
    ServerClosed,
)
from hydragnn_tpu_torch.serve.buckets import Bucket, build_bucket_ladder, route
from hydragnn_tpu_torch.serve.metrics import ServeMetrics
from hydragnn_tpu_torch.serve.registry import ServedModel


class Oversize(RuntimeError):
    """Request exceeds every bucket and the eager fallback is disabled."""


class RequestFailed(RuntimeError):
    """One request's forward raised or produced non-finite outputs.
    ``reason`` is ``"exception"``, ``"nonfinite"`` or ``"dispatch"``."""

    def __init__(self, message: str, seq: int = -1, reason: str = "exception"):
        super().__init__(message)
        self.seq = seq
        self.reason = reason


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Knobs of the serving path (the JAX package's defaults).

    max_batch: graphs coalesced per device dispatch.
    num_buckets: pad-plan ladder size (before dedup of identical plans).
    max_delay_ms: deadline before a partial batch flushes.
    max_pending: bounded queue across all buckets (then Overloaded).
    eager_fallback: natural-pad path for graphs beyond every plan.
    check_finite: fail requests whose outputs are not all finite.
    """

    max_batch: int = 8
    num_buckets: int = 3
    max_delay_ms: float = 5.0
    max_pending: int = 256
    node_multiple: int = 16
    edge_multiple: int = 8
    eager_fallback: bool = True
    latency_window: int = 2048
    check_finite: bool = True


def request_to_dict(sample: Any) -> Dict[str, Any]:
    """Normalize a request (GraphSample or graph dict) to the dict form
    ``batch_graphs`` consumes, without targets."""
    if isinstance(sample, dict):
        g = dict(sample)
        if "senders" not in g:
            ei = g.pop("edge_index", None)
            if ei is None:
                raise ValueError("request dict needs 'senders'/'receivers' or 'edge_index'")
            ei = np.asarray(ei)
            g["senders"], g["receivers"] = ei[0], ei[1]
    else:
        if getattr(sample, "edge_index", None) is None:
            raise ValueError("request sample has no edge_index (no edges built)")
        g = {"x": sample.x, "senders": sample.edge_index[0], "receivers": sample.edge_index[1]}
        if getattr(sample, "pos", None) is not None:
            g["pos"] = sample.pos
        if getattr(sample, "edge_attr", None) is not None:
            g["edge_attr"] = sample.edge_attr
    g.pop("graph_targets", None)
    g.pop("node_targets", None)
    return g


def _dict_sizes(g: Dict[str, Any]) -> tuple:
    return int(np.asarray(g["x"]).shape[0]), int(np.asarray(g["senders"]).shape[0])


def _result_finite(result: Dict[str, np.ndarray]) -> bool:
    return all(np.all(np.isfinite(v)) for v in result.values())


class ModelServer:
    """Batched online inference over one :class:`ServedModel`.

    ``reference_samples`` (the prepared dataset) size the bucket ladder
    and fix the request field spec every request must match."""

    def __init__(
        self,
        served: ServedModel,
        reference_samples: Sequence,
        config: Optional[ServeConfig] = None,
    ):
        if not reference_samples:
            raise ValueError("reference_samples must be non-empty (sizes the buckets)")
        self.served = served
        self.device = served.device
        self.config = config or ServeConfig()
        self.reference_samples = list(reference_samples)
        self.buckets: List[Bucket] = build_bucket_ladder(
            self.reference_samples,
            self.config.max_batch,
            num_buckets=self.config.num_buckets,
            node_multiple=self.config.node_multiple,
            edge_multiple=self.config.edge_multiple,
        )
        self.metrics = ServeMetrics(len(self.buckets), latency_window=self.config.latency_window)
        ref = request_to_dict(self.reference_samples[0])
        ref_x = np.asarray(ref["x"])
        self._spec = {
            "feat_dim": int(ref_x.shape[1]) if ref_x.ndim > 1 else 1,
            "has_pos": "pos" in ref,
            "has_edge_attr": "edge_attr" in ref,
        }
        self._queue = MicroBatchQueue(
            len(self.buckets),
            self.config.max_batch,
            self.config.max_delay_ms / 1e3,
            self.config.max_pending,
        )
        self._seq = itertools.count()
        self._thread: Optional[threading.Thread] = None
        self._started = False
        self._stopped = False

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "ModelServer":
        if self._started:
            return self
        if self._stopped:
            raise ServerClosed("server was stopped; build a new one")
        self._thread = threading.Thread(target=self._run, name="hgtorch-serve-dispatch", daemon=True)
        self._started = True
        self._thread.start()
        return self

    def stop(self, timeout: Optional[float] = 10.0) -> None:
        """Stop admitting, drain what is queued, join the dispatch thread."""
        self._stopped = True
        self._queue.close()
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise RuntimeError("serve dispatch thread did not stop in time")
        self._started = False

    def __enter__(self) -> "ModelServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- request path ------------------------------------------------------

    def submit(self, sample: Any) -> Future:
        """Admit one graph; returns a Future resolving to
        ``{head_name: np.ndarray}`` (graph heads [d]; node heads
        [n_nodes, d]). Raises Overloaded, or ServerClosed after stop()."""
        if self._stopped:
            raise ServerClosed("server is stopped; submissions are rejected")
        if not self._started:
            raise RuntimeError("server not started (call start())")
        g = self._validated(request_to_dict(sample))
        n, e = _dict_sizes(g)
        seq = next(self._seq)
        bucket = route(self.buckets, n, e)
        if bucket is None:
            return self._submit_oversize(g, n, e, seq)
        self.metrics.record_request(bucket.index)
        try:
            return self._queue.put(bucket.index, g, seq=seq)
        except Overloaded:
            self.metrics.record_reject()
            raise

    def predict(self, sample: Any, timeout: Optional[float] = None) -> Dict[str, np.ndarray]:
        return self.submit(sample).result(timeout)

    def predict_many(
        self, samples: Sequence[Any], timeout: Optional[float] = None
    ) -> List[Dict[str, np.ndarray]]:
        futures = [self.submit(s) for s in samples]
        return [f.result(timeout) for f in futures]

    def metrics_snapshot(self) -> dict:
        return self.metrics.snapshot()

    # -- oversize ----------------------------------------------------------

    def _submit_oversize(self, g: Dict[str, Any], n: int, e: int, seq: int) -> Future:
        self.metrics.record_request(None)
        fut: Future = Future()
        largest = self.buckets[-1]
        if largest.fits_totals(n, e, 1):
            # over the routing caps but within the biggest plan alone
            self.metrics.record_oversize("largest_bucket")
            req = PendingRequest(g, fut, time.monotonic(), largest.index, seq)
            self._execute_bucket(largest.index, [req], reason="oversize")
            return fut
        if not self.config.eager_fallback:
            self.metrics.record_error()
            fut.set_exception(
                Oversize(
                    f"graph ({n} nodes, {e} edges) exceeds the largest bucket plan "
                    f"{largest.node_pad}/{largest.edge_pad} and eager_fallback is disabled"
                )
            )
            return fut
        self.metrics.record_oversize("eager")
        t0 = time.monotonic()
        req = PendingRequest(g, fut, t0, -1, seq)
        try:
            batch = batch_graphs(
                [g],
                node_multiple=self.config.node_multiple,
                edge_multiple=self.config.edge_multiple,
            )
            outputs = self._forward(batch)
            result = self._slice_result(outputs, 0, 0, n)
        except Exception as exc:
            self._quarantine(req, "exception", exc)
            return fut
        if self.config.check_finite and not _result_finite(result):
            self._quarantine(req, "nonfinite", None)
            return fut
        fut.set_result(result)
        self.metrics.observe_latency(time.monotonic() - t0)
        return fut

    # -- dispatch ----------------------------------------------------------

    def _run(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        while True:
            got = self._queue.take_batch()
            if got is None:
                return
            bucket_index, requests, reason = got
            try:
                self._execute_bucket(bucket_index, requests, reason)
            except Exception as exc:
                # request failures are isolated inside _execute_bucket;
                # anything reaching here fails the batch in hand, and the
                # loop carries on with the next one
                self.metrics.record_error(len(requests))
                for r in requests:
                    if not r.future.done():
                        r.future.set_exception(
                            RequestFailed(
                                f"dispatch failed with this batch in hand: {exc!r}",
                                seq=r.seq,
                                reason="dispatch",
                            )
                        )

    def _forward(self, batch) -> List[np.ndarray]:
        """One device forward; returns host float32 outputs."""
        self.metrics.record_forward()
        outputs = self.served.forward(batch.to(self.device))
        return [o.float().cpu().numpy() for o in outputs]

    def _execute_bucket(
        self,
        bucket_index: int,
        requests: List[PendingRequest],
        reason: str,
        singles_retry: bool = True,
    ) -> None:
        bucket = self.buckets[bucket_index]
        try:
            batch = batch_graphs(
                [r.item for r in requests],
                n_node_pad=bucket.node_pad,
                n_edge_pad=bucket.edge_pad,
                n_graph_pad=bucket.graph_pad,
            )
            outputs = self._forward(batch)
        except Exception as exc:
            self._isolate_failure(bucket_index, requests, "exception", exc, singles_retry)
            return
        self.metrics.record_batch(bucket_index, len(requests), reason)
        t_done = time.monotonic()
        node_offset = 0
        poisoned: List[PendingRequest] = []
        for gi, r in enumerate(requests):
            n, _ = _dict_sizes(r.item)
            result = self._slice_result(outputs, gi, node_offset, n)
            node_offset += n
            if self.config.check_finite and not _result_finite(result):
                poisoned.append(r)
                continue
            if not r.future.done():
                r.future.set_result(result)
                self.metrics.observe_latency(t_done - r.t_enqueue)
        if poisoned:
            self._isolate_failure(bucket_index, poisoned, "nonfinite", None, singles_retry)

    def _isolate_failure(self, bucket_index, requests, kind, exc, singles_retry) -> None:
        if len(requests) > 1 and singles_retry:
            self.metrics.record_poison_retry(len(requests))
            for r in requests:
                self._execute_bucket(bucket_index, [r], "retry_single", singles_retry=False)
            return
        for r in requests:
            self._quarantine(r, kind, exc)

    def _quarantine(self, r: PendingRequest, kind: str, exc: Optional[BaseException]) -> None:
        self.metrics.record_quarantine()
        self.metrics.record_error()
        detail = repr(exc) if exc is not None else "non-finite outputs"
        if not r.future.done():
            r.future.set_exception(
                RequestFailed(
                    f"request seq={r.seq} quarantined ({kind}): {detail}",
                    seq=r.seq,
                    reason=kind,
                )
            )

    def _slice_result(self, outputs, graph_index: int, node_offset: int, num_nodes: int):
        cfg = self.served.cfg
        result: Dict[str, np.ndarray] = {}
        for ihead in range(cfg.num_heads):
            out = outputs[ihead]
            if cfg.output_type[ihead] == "graph":
                result[cfg.output_names[ihead]] = out[graph_index]
            else:
                result[cfg.output_names[ihead]] = out[node_offset : node_offset + num_nodes]
        return result

    def _validated(self, g: Dict[str, Any]) -> Dict[str, Any]:
        """Enforce the field spec at admission, not inside the executor."""
        spec = self._spec
        x = np.asarray(g["x"])
        feat = x.shape[1] if x.ndim > 1 else 1
        if feat != spec["feat_dim"]:
            raise ValueError(f"request feature width {feat} != model's {spec['feat_dim']}")
        for key, flag in (("pos", "has_pos"), ("edge_attr", "has_edge_attr")):
            if (key in g) != spec[flag]:
                raise ValueError(
                    f"request '{key}' presence does not match the serving spec "
                    f"(expected {'present' if spec[flag] else 'absent'})"
                )
        return g
