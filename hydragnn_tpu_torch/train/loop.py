"""Epoch driver: train, validate and test with plateau LR and early stop
(the port's counterpart of ``hydragnn_tpu/train/loop.py:train_validate_test``).

Semantics kept from the JAX package:

  - **Dispatch.** ``Training.scan_epoch`` true/false wins; unset, the
    epoch trains on fixed-membership batches resident on the device
    (``GraphLoader.device_batches``, the JAX package's whole-epoch scan
    over ``stacked_device_batches``: the same batches in the same order,
    step for step), unless a training fault injection, a hang watchdog
    or a ``Profile`` section asks for per-step streaming, or the split
    does not fit on the device (then it streams, and says why). The port
    launches the fixed epoch step by step; ``history["dispatch_mode"]``
    says which mode ran and why (printed at verbosity > 0).
  - losses are averaged weighted by each batch's real graph count
    (``graph_mask``), so padding never dilutes them; per-batch losses
    stay on the device and are read once per epoch;
  - ``ReduceLROnPlateau(factor=0.5, patience=5, min_lr=1e-5,
    threshold=1e-4)`` steps on the validation loss;
  - ``EarlyStopping(patience=10)`` when ``Training.EarlyStopping`` is set;
  - ``Training.mixed_precision`` and ``remat`` (``train/state.py``);
  - **the non-finite guard** (``Training.nonfinite_guard``, on by
    default): a bad batch is skipped on the device; an epoch that ends on
    ``nonfinite_patience`` consecutive bad steps rolls back to the last
    good checkpoint at lr × ``nonfinite_rollback_lr_factor``, and past
    ``nonfinite_max_rollbacks`` raises ``NonFiniteRollbackExhausted``;
  - **checkpoints**: every ``checkpoint_every`` epochs, the model file
    (``checkpoint_keep_last`` versions) and the meta sidecar;
    ``Training.continue``/``startfrom`` resumes from the meta's epoch
    with its scheduler, stopper and history (the caller restores the
    weights), re-derives the epoch from the weights' step when the two
    disagree, and makes an early-stopped run's resume a no-op;
  - after the last epoch, unless ``Training.bn_recalibration`` is false,
    two batch-statistics passes over the train split re-estimate the
    BatchNorm running statistics with the final parameters;
  - **records**, as the JAX loop writes them: one ``metrics.jsonl`` line
    an epoch in ``<log_dir>/<log_name>/`` (appended, so a resumed run
    goes on from its last line; the per-task losses keyed by head name),
    tensorboard scalars (``utils/tensorboard.py``), the peak device
    memory after epoch 0, the ``train_validate_test`` timer, and the
    ``Profile`` section's epoch-gated trace (``utils/profile.py``,
    stepped once per train batch);
  - **plots** (``postprocess/visualizer.py``) when asked for: the test
    split's node-count histogram and, with ``plot_init_solution``, the
    untrained model's parity scatter at setup; with
    ``plot_hist_solution`` the error histograms each epoch; the final
    scatter, density, per-head and history figures after training.

**Telemetry** (``hydragnn_tpu_torch/obs``, the JAX loop's; all of it
inert under ``HGTORCH_TELEMETRY=0``): rank 0 writes the flight record
``<log_dir>/<log_name>/flight.jsonl`` (schema v2: a ``run_start``
manifest with the resolved config, pad plans, dispatch mode, head
names, the hardware ledger's cost and the drift reference window; an
``epoch`` event an epoch with the losses keyed by head name, the step
spans, the compile monitor's block, the per-head diagnostics and
MAE/RMSE and the hardware record; ``resumed``, ``rollback``,
``incident``, ``profile_trace``; ``error`` and ``run_end``). The step
spans (``obs/spans.py``) decompose both dispatch modes;
``Training.diagnostics`` (default true; ``HGTORCH_DIAGNOSTICS=0``
forces it off) samples the per-head gradient diagnostics every
``diag_every`` steps (0: once an epoch) and keeps the hardware ledger;
``Training.slo_triggers`` evaluates the three training rules at each
epoch's end and opens incident bundles under ``incidents/``;
``Training.prometheus_dir`` writes ``train.prom`` each epoch. None of it
changes what the run trains: the history and the parameters are bit
for bit those of a run with telemetry off.

**Resilience** (``hydragnn_tpu_torch/resilience``, the JAX loop's
wiring): unless ``Training.preempt_handler`` is false the loop installs a
``PreemptionHandler`` (SIGTERM/SIGINT; hard exit 75 after
``Training.preempt_grace_s``, default 30 s); a stop seen at an epoch's
start, after a per-step epoch that stopped mid-way (the resumed run
re-runs it) or after an epoch's evaluation writes the checkpoint and
meta pair, records ``preempt`` and ``run_end{status: preempted}`` and
raises ``TrainingPreempted`` (``run_guard`` maps it to exit 75).
``Training.watchdog_stall_s`` or ``HGTORCH_WATCHDOG_S`` above 0 starts a
``HangWatchdog`` (exit 79, ``run_end{status: hung}``), beaten once a batch
and in the BatchNorm recalibration passes. ``TrainHooks`` carries both
and the step-indexed ``HGTORCH_INJECT_*`` faults through the per-step
loop. The fixed epoch, the counterpart of the JAX package's one-dispatch
scan, runs no per-step hook: a signal there is seen at the epoch's
boundaries. Every exit path tears the hooks down (the handler's timer
cancelled, the watchdog stopped).

**The pod** (``obs/podview.py``, ``resilience/podckpt.py``, the JAX
loop's planes): on a run of several hosts (the ranks of a
``torch.distributed`` group, or simulated hosts through
``HGTORCH_PODVIEW_HOST``/``_HOSTS``) every host writes its own flight
shard (``flight.host<k>.jsonl``, ``train.host<k>.prom``) and a
``host_epoch`` summary an epoch; host 0's ``SkewMonitor`` records its
``podview`` verdicts and feeds the ``step_skew`` and ``host_stall`` rules
(``Training.podview_skew_threshold``); ``run_end`` carries the plane's
``overhead_frac``. Each host cuts a pod generation beside every
checkpoint (``HGTORCH_POD_CKPT``, default on) and host 0 commits it; the
hosts beat a heartbeat at each epoch boundary (a peer silent past
``HGTORCH_POD_LOST_AFTER_S`` is ``host_lost``); a SIGTERM is posted to
the peers, which cut the same generation at the epoch's end; a commit
that fails records a ``PodCommitFailed`` error and, on a lost peer,
raises ``PodHostLost`` (exit 75). A run restored from a pod generation
records ``pod_resume`` and its lineage in the manifest.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from hydragnn_tpu_torch.models.base import HydraModel
from hydragnn_tpu_torch.obs import (
    CompileMonitor,
    FlightRecorder,
    StepSpans,
    get_registry,
    telemetry_enabled,
)
from hydragnn_tpu_torch.obs import podview
from hydragnn_tpu_torch.obs.registry import env_flag, env_number, process_count
from hydragnn_tpu_torch.postprocess.visualizer import Visualizer
from hydragnn_tpu_torch.resilience import (
    HangWatchdog,
    NonFiniteRollbackExhausted,
    NonFiniteSentry,
    PodHostLost,
    PreemptionHandler,
    TrainHooks,
    TrainingPreempted,
)
from hydragnn_tpu_torch.resilience.inject import active_injections
from hydragnn_tpu_torch.train.optimizer import current_learning_rate, set_learning_rate
from hydragnn_tpu_torch.train.state import eval_step
from hydragnn_tpu_torch.utils import checkpoint as ckpt
from hydragnn_tpu_torch.utils.print_utils import print_peak_memory, process_index
from hydragnn_tpu_torch.utils.profile import Profiler
from hydragnn_tpu_torch.utils.tensorboard import get_summary_writer, write_scalar_dict
from hydragnn_tpu_torch.utils.time_utils import Timer, timers_snapshot

# the per-epoch history the meta sidecar carries (the JAX package's keys)
EPOCH_KEYS = ("train_loss", "val_loss", "test_loss", "train_tasks", "val_tasks", "test_tasks", "lr")


def _named_tasks(names: Sequence[str], values) -> Dict[str, float]:
    """Per-task losses keyed by head name."""
    return {n: float(v) for n, v in zip(names, np.asarray(values).reshape(-1))}


class EarlyStopping:
    """Patience counter on the validation loss."""

    def __init__(self, patience: int = 10, min_delta: float = 0.0):
        self.patience = patience
        self.min_delta = min_delta
        self.count = 0
        self.min_loss = float("inf")

    def __call__(self, val_loss: float) -> bool:
        if val_loss < self.min_loss:
            self.min_loss = val_loss
            self.count = 0
        elif val_loss > self.min_loss + self.min_delta:
            self.count += 1
            if self.count >= self.patience:
                return True
        return False


class ReduceLROnPlateau:
    """Torch-semantics plateau scheduler on the optimizer's learning rate."""

    def __init__(self, factor: float = 0.5, patience: int = 5, min_lr: float = 1e-5, threshold: float = 1e-4):
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.threshold = threshold
        self.best = float("inf")
        self.num_bad_epochs = 0

    def step(self, optimizer: torch.optim.Optimizer, val_loss: float) -> None:
        if val_loss < self.best * (1.0 - self.threshold):
            self.best = val_loss
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            self.num_bad_epochs = 0
            set_learning_rate(optimizer, max(current_learning_rate(optimizer) * self.factor, self.min_lr))


class _MetricAccum:
    """Per-batch (loss, tasks, real graph count) kept on the device; one
    read at ``finalize``. A guarded step's bad flag zeroes its count."""

    def __init__(self):
        self._losses: List[torch.Tensor] = []
        self._tasks: List[torch.Tensor] = []
        self._counts: List[torch.Tensor] = []

    def add(self, loss: torch.Tensor, tasks: torch.Tensor, graph_mask: torch.Tensor,
            bad: Optional[torch.Tensor] = None, count: Optional[torch.Tensor] = None) -> None:
        """``count``: the step's real graphs when it is not this batch's
        own (a partitioned step's, over every rank)."""
        count = graph_mask.sum().float() if count is None else count
        self._losses.append(loss)
        self._tasks.append(tasks)
        self._counts.append(count if bad is None else count * (1.0 - bad))

    def finalize(self) -> Tuple[float, np.ndarray]:
        if not self._counts:
            return 0.0, np.zeros(0, np.float32)
        counts = torch.stack(self._counts)
        total = max(float(counts.sum()), 1.0)
        loss = float((torch.stack(self._losses) * counts).sum()) / total
        tasks = (torch.stack(self._tasks) * counts[:, None]).sum(0).cpu().numpy() / total
        return loss, tasks


def _device_of(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def _timed(batches, timing: Optional[Dict[str, float]]):
    """Yield from ``batches``, adding the time spent waiting for each
    batch to ``timing["data_wait_s"]``."""
    it = iter(batches)
    try:
        while True:
            t0 = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                return
            if timing is not None:
                timing["data_wait_s"] = timing.get("data_wait_s", 0.0) + time.perf_counter() - t0
            yield batch
    finally:
        close = getattr(it, "close", None)
        if close is not None:
            close()  # ends an abandoned loader's prefetch thread now


def _epoch_batches(loader, epoch: int, fixed: bool):
    if fixed:
        resident = loader.device_batches(epoch)
        return (resident[i] for i in loader.epoch_order(epoch))
    return loader


def train_epoch(loader, model: HydraModel, step_fn, epoch: int = 0, fixed: bool = False,
                sentry: Optional[NonFiniteSentry] = None,
                timing: Optional[Dict[str, float]] = None, profiler=None, spans=None, diag=None,
                incidents=None, hooks: Optional[TrainHooks] = None,
                partitioned: bool = False) -> Tuple[float, np.ndarray]:
    """One training epoch of ``step_fn`` (``make_train_step``; guarded when
    ``sentry`` is given) over the loader's streamed batches, or over its
    resident fixed-membership batches in the epoch's order (``fixed``);
    ``profiler`` (``utils/profile.py``) is stepped after each batch.
    ``hooks`` (``resilience/hooks.py``), on the streamed path only: the
    epoch stops before a batch once a preemption is flagged, and
    ``before_step`` beats the watchdog and fires the step's injections.
    Telemetry: ``spans`` (``obs/spans.py``) times each step, ``diag``
    (``obs/introspect.py:HeadDiagnostics``) samples before a step, and
    ``incidents`` (``obs/triggers.py:IncidentRecorder``) is ticked after
    one. A ``partitioned`` step (``Partitioner.shard_train_step``) returns
    the whole step's real graph count last, which weighs its loss."""
    dev = _device_of(model)
    acc = _MetricAccum()
    if spans is None:
        spans = StepSpans.disabled()
    if fixed:
        hooks = None  # one dispatch an epoch in the JAX package: no per-step hook
    for batch in spans.timed_iter(_timed(_epoch_batches(loader, epoch, fixed), timing)):
        if hooks is not None and hooks.preempted:
            break
        batch = batch.to(dev, non_blocking=True)
        if hooks is not None:
            batch = hooks.before_step(batch)
        if diag is not None:
            diag.maybe_sample(batch)
        if sentry is not None:
            out = spans.step(step_fn, batch, sentry.consec)
            loss, tasks, consec, bad = out[:4]
            sentry.observe(consec, bad)
            acc.add(loss, tasks, batch.graph_mask, bad, count=out[4] if partitioned else None)
        else:
            out = spans.step(step_fn, batch)
            acc.add(out[0], out[1], batch.graph_mask, count=out[2] if partitioned else None)
        if profiler is not None:
            profiler.step()
        if incidents is not None:
            incidents.tick()
    return acc.finalize()


def _eval(model, step, batch):
    """(loss, tasks, outputs, count or None) of the plain eval step or of
    a partitioned one (``Partitioner.shard_eval_step``)."""
    if step is None:
        return eval_step(model, batch) + (None,)
    out = step(batch)
    return out if len(out) == 4 else tuple(out) + (None,)


def evaluate_epoch(loader, model: HydraModel, batches=None, step=None) -> Tuple[float, np.ndarray]:
    """The weighted loss over ``loader`` (or over ``batches``, its
    resident batches) with the running statistics; ``step`` is the run's
    eval step (default ``train/state.py:eval_step``)."""
    dev = _device_of(model)
    acc = _MetricAccum()
    for batch in (loader if batches is None else batches):
        batch = batch.to(dev, non_blocking=True)
        loss, tasks, _, count = _eval(model, step, batch)
        acc.add(loss, tasks, batch.graph_mask, count=count)
    return acc.finalize()


def test_epoch(
    loader, model: HydraModel, return_samples: bool = True, step=None
) -> Tuple[float, np.ndarray, List[np.ndarray], List[np.ndarray]]:
    """Full test pass; with ``return_samples`` also the per-head (true,
    predicted) values over the real (unpadded) rows (a partitioned
    ``step``'s: this rank's rows, the loss over every rank's)."""
    cfg = model.cfg
    dev = _device_of(model)
    acc = _MetricAccum()
    trues: List[List[np.ndarray]] = [[] for _ in range(cfg.num_heads)]
    preds: List[List[np.ndarray]] = [[] for _ in range(cfg.num_heads)]
    for host in loader:
        batch = host.to(dev, non_blocking=True)
        loss, tasks, outputs, count = _eval(model, step, batch)
        acc.add(loss, tasks, batch.graph_mask, count=count)
        if not return_samples:
            continue
        host = host.to("cpu")
        for ihead, name in enumerate(cfg.output_names):
            if cfg.output_type[ihead] == "graph":
                mask, target = host.graph_mask, host.graph_targets[name]
            else:
                mask, target = host.node_mask, host.node_targets[name]
            trues[ihead].append(target[mask].numpy())
            preds[ihead].append(outputs[ihead].float().cpu()[mask].numpy())
    loss, tasks = acc.finalize()
    true_values = [np.concatenate(t) if t else np.zeros((0, 1)) for t in trues]
    pred_values = [np.concatenate(p) if p else np.zeros((0, 1)) for p in preds]
    return loss, tasks, true_values, pred_values


def _watchdog_knob() -> float:
    """``HGTORCH_WATCHDOG_S``: the hang watchdog's stall seconds when the
    config sets none (0: off)."""
    raw = os.environ.get("HGTORCH_WATCHDOG_S", "").strip()
    if not raw:
        return 0.0
    try:
        return float(raw)
    except ValueError:
        raise ValueError(f"HGTORCH_WATCHDOG_S must be a number, got {raw!r}") from None


def _fixed_auto_eligible(loader, partitioner=None) -> Tuple[bool, str]:
    """Is the fixed-membership epoch the right default for ``loader``?
    Only on a single device: ``partitioner.single_device`` is the
    topology signal (the JAX package's ``_scan_auto_eligible``)."""
    if not hasattr(loader, "device_batches") or not hasattr(loader, "shuffle"):
        return False, "loader cannot stack device-resident batches"
    if partitioner is not None and not partitioner.single_device:
        return False, "partitioner mesh is multi-device"
    if process_count() > 1:
        return False, "multi-process run"
    try:
        if len(loader) < 1:
            return False, "empty loader"
    except TypeError:
        return False, "unsized loader"
    injections = active_injections(include_serve=False)
    if injections:
        # the injections are step-indexed: they need the per-step path
        return False, f"fault injection active ({injections[0]})"
    if _watchdog_knob() > 0:
        # the watchdog beats once a batch; a whole-epoch dispatch would read as a stall
        return False, "hang watchdog active"
    return True, "single-device run + device-resident fixed-membership batches"


def resolve_dispatch(training: Dict[str, Any], config: Dict[str, Any], train_loader,
                     partitioner=None) -> Dict[str, Any]:
    """The JAX package's dispatch resolution (``loop.py:470-499, 563-595``):
    ``{"mode": "fixed_epoch" | "per_step", "auto": bool, "reason": str}``.
    In auto mode it builds the train split's resident batches, and falls
    back to streaming when that fails (the split does not fit)."""
    scan_cfg = training.get("scan_epoch")
    if scan_cfg is None:
        fixed, reason = _fixed_auto_eligible(train_loader, partitioner)
        if fixed and "Profile" in config:
            fixed, reason = False, "per-step profiler configured"
        if fixed and float(training.get("watchdog_stall_s", 0) or 0) > 0:
            fixed, reason = False, "hang watchdog active"
        if fixed:
            try:
                train_loader.device_batches(0)
            except RuntimeError as exc:  # torch.cuda.OutOfMemoryError among them
                fixed, reason = False, f"stacking failed: {type(exc).__name__}"
                if torch.cuda.is_available():
                    torch.cuda.empty_cache()
    elif scan_cfg:
        fixed, reason = True, "Training.scan_epoch=true"
    else:
        fixed, reason = False, "Training.scan_epoch=false"
    return {"mode": "fixed_epoch" if fixed else "per_step", "auto": scan_cfg is None, "reason": reason}


def _resume_meta(training, num_epoch, steps, steps_per_epoch, log_name, log_dir, verbosity):
    """The meta sidecar of ``Training.startfrom``, repaired when its step
    disagrees with the restored weights' (a crash between the weight and
    meta writes): the epoch re-derived from the weights' step, the
    history cut to it, the counters reset, and the sidecar rewritten."""
    meta = ckpt.load_train_meta(training["startfrom"], log_dir)
    if meta is None:
        return None
    meta_step = meta.get("step")
    if meta_step is not None and int(meta_step) != steps:
        derived = min(num_epoch, steps // max(steps_per_epoch, 1))
        if verbosity > 0:
            print(f"WARNING: checkpoint meta (step {meta_step}) does not match restored weights (step {steps}); "
                  f"resuming from epoch {derived} derived from the weights, not meta epoch {meta['epoch']}",
                  flush=True)
        hist = meta.get("history", {})
        for k, v in hist.items():
            v = v[:derived]
            while v and len(v) < derived:
                v.append(v[-1])  # unknown epochs: carry the last
            hist[k] = v
        meta = {
            "epoch": derived, "step": steps, "early_stopped": False,
            "scheduler": {"best": float("inf"), "num_bad_epochs": 0},
            "stopper": {"count": 0, "min_loss": float("inf")},
            "history": hist,
        }
        ckpt.save_train_meta(meta, training["startfrom"], log_dir)
        if log_name != training["startfrom"]:
            ckpt.save_train_meta(meta, log_name, log_dir)
    return meta


def _example_batch(loader):
    """The loader's first batch of its first membership, built without
    drawing an epoch from it (the shuffle and the prefetch thread are
    untouched), or None where the loader cannot build one."""
    make = getattr(loader, "make_batch", None)
    samples = getattr(loader, "samples", None)
    if make is None or not samples:
        return None
    return make(np.arange(min(int(loader.batch_size), len(samples))))


def _loader_plan(loader) -> Dict[str, Any]:
    return {
        "num_batches": len(loader),
        "num_samples": len(loader.samples) if hasattr(loader, "samples") else None,
        "batch_size": getattr(loader, "batch_size", None),
        "pad_nodes": getattr(loader, "pad_nodes", None),
        "pad_edges": getattr(loader, "pad_edges", None),
        "pad_graphs": getattr(loader, "pad_graphs", None),
    }


def _train_rules(training: Dict[str, Any], monitor=None, signaler=None):
    """The training loop's three SLO rules, thresholds from ``Training``;
    with host 0's skew ``monitor`` the pod's ``step_skew``
    (``Training.podview_skew_threshold``, else the monitor's) and
    ``host_stall`` (``HGTORCH_PODVIEW_STALL_S``, 120 s); with an armed
    liveness ``signaler`` the ``host_lost`` rule."""
    from hydragnn_tpu_torch.obs.triggers import TriggerRule

    rules = [
        TriggerRule("train_nonfinite_burst", "nonfinite_burst", "train.nonfinite_skipped",
                    float(training.get("slo_nonfinite_burst", 1))),
        TriggerRule("train_loss_spike", "loss_spike", "train_loss", float(training.get("slo_loss_spike_factor", 3.0))),
        TriggerRule("train_mfu_drop", "mfu_drop", "mfu", float(training.get("slo_mfu_drop_factor", 0.5))),
    ]
    if monitor is not None:
        rules.append(TriggerRule("podview_step_skew", "step_skew", "podview.skew_frac",
                                 float(training.get("podview_skew_threshold") or monitor.threshold)))
        rules.append(TriggerRule("podview_host_stall", "host_stall", "podview.stall_age_s",
                                 env_number("HGTORCH_PODVIEW_STALL_S", 120.0)))
    if signaler is not None and signaler.lost_after_s > 0:
        # a peer silent past HGTORCH_POD_LOST_AFTER_S sets podview.lost_hosts
        rules.append(TriggerRule("podview_host_lost", "host_lost", "podview.lost_hosts", 0.5))
    return rules


def train_validate_test(
    model: HydraModel,
    optimizer,
    train_loader,
    val_loader,
    test_loader,
    config: Dict[str, Any],
    verbosity: int = 0,
    log_name: str = "run",
    log_dir: str = "./logs/",
    create_plots: bool = False,
    plot_init_solution: bool = False,
    plot_hist_solution: bool = False,
    flight=None,
    run_config: Optional[Dict[str, Any]] = None,
    manifest_extra: Optional[Dict[str, Any]] = None,
    partitioner=None,
) -> Dict[str, Any]:
    """Train for ``Training.num_epoch`` epochs (module docstring);
    ``config`` is the ``NeuralNetwork`` section. The model and optimizer
    are trained in place (a ``continue`` run restores them first,
    ``utils/checkpoint.py:load_existing_model_config``). Returns the
    history: the per-epoch ``EPOCH_KEYS`` (with a resumed run's earlier
    epochs), and for this run's epochs ``dispatch_mode``, ``data_wait_s``
    and ``train_wall_s`` (host clock), ``nonfinite_skipped`` and the
    epochs it ``rollbacks``'d.

    Telemetry: ``flight`` is a caller's ``FlightRecorder`` (the loop
    makes and closes its own otherwise), ``run_config`` the full
    resolved config for the manifest (default: this ``NeuralNetwork``
    section), ``manifest_extra`` keys merged into the manifest.

    ``partitioner`` (``parallel/partitioner.py``) is the run's layout:
    its train, eval and statistics steps run the epochs, the fixed epoch
    is chosen only when it says ``single_device``, and its ``manifest``
    is the record's ``parallel`` block. Every rank runs this loop in
    step; rank 0 alone writes the records and the checkpoint files."""
    training = config["Training"]
    num_epoch = int(training["num_epoch"])
    stopper = (
        EarlyStopping(patience=int(training.get("patience", 10)))
        if training.get("EarlyStopping", False)
        else None
    )
    scheduler = ReduceLROnPlateau()
    names: Sequence[str] = model.cfg.output_names
    dev = _device_of(model)
    for loader in (train_loader, val_loader, test_loader):
        if hasattr(loader, "set_device"):
            loader.set_device(dev)

    if partitioner is None:
        from hydragnn_tpu_torch.parallel.partitioner import Partitioner

        partitioner = Partitioner()
    partitioned = not partitioner.single_device
    dispatch = resolve_dispatch(training, config, train_loader, partitioner)
    fixed = dispatch["mode"] == "fixed_epoch"
    val_resident = None
    if fixed and hasattr(val_loader, "device_batches"):
        try:
            val_resident = val_loader.device_batches(0)
        except RuntimeError:
            if not dispatch["auto"]:
                raise
    if verbosity > 0:
        print(f"dispatch: {dispatch['mode']} ({'auto' if dispatch['auto'] else 'config'}: {dispatch['reason']})",
              flush=True)
    guard = bool(training.get("nonfinite_guard", True))
    compute_dtype = torch.bfloat16 if training.get("mixed_precision") else None
    step_fn = partitioner.shard_train_step(
        model, optimizer,
        compute_dtype=compute_dtype,
        remat=bool(training.get("remat", False)),
        guard_nonfinite=guard,
    )
    eval_fn = partitioner.shard_eval_step(model) if partitioned else None
    stats_fn = partitioner.shard_stats_step(model)
    sentry = (
        NonFiniteSentry(
            patience=int(training.get("nonfinite_patience", 16)),
            max_rollbacks=int(training.get("nonfinite_max_rollbacks", 2)),
            lr_factor=float(training.get("nonfinite_rollback_lr_factor", 0.5)),
            device=dev,
        )
        if guard
        else None
    )

    history: Dict[str, Any] = {k: [] for k in EPOCH_KEYS}
    ckpt_every = int(training.get("checkpoint_every", 0))
    keep_last = int(training.get("checkpoint_keep_last", 3))
    start_epoch = 0
    resumed_from = None
    if training.get("continue") == 1:
        if "startfrom" not in training:
            raise ValueError("Training.continue=1 requires Training.startfrom")
        meta = _resume_meta(training, num_epoch, int(optimizer.steps), len(train_loader), log_name, log_dir,
                            verbosity)
        if meta is not None:
            start_epoch = num_epoch if meta.get("early_stopped") else int(meta["epoch"])
            resumed_from = start_epoch
            scheduler.best = float(meta["scheduler"]["best"])
            scheduler.num_bad_epochs = int(meta["scheduler"]["num_bad_epochs"])
            if stopper is not None and "stopper" in meta:
                stopper.count = int(meta["stopper"]["count"])
                stopper.min_loss = float(meta["stopper"]["min_loss"])
            history = {k: meta["history"].get(k, []) for k in EPOCH_KEYS}
    history.update(dispatch_mode=dispatch, data_wait_s=[], train_wall_s=[], nonfinite_skipped=[], rollbacks=[])

    # telemetry, made after the resume handling (a config error there
    # leaves no flight file): the flight record on rank 0, the step spans,
    # the compile monitor, the trigger engine and incidents, the per-head
    # diagnostics and the hardware ledger (module docstring)
    telemetry_on = telemetry_enabled()
    rank0 = process_index() == 0
    # the pod (module docstring): each host its own flight shard, host
    # 0's skew monitor, and on several hosts the liveness and commit plane
    pv_host, pv_hosts = podview.host_identity()
    pv_on = telemetry_on and podview.podview_enabled()
    pv_run_id = podview.resolve_run_id(log_name)
    run_dir = os.path.join(log_dir, log_name)
    pv_cost = {"s": 0.0, "t0": time.perf_counter()}
    own_flight = flight is None
    if flight is None:
        flight = FlightRecorder(podview.host_flight_path(run_dir, pv_host)
                                if telemetry_on and (pv_host == 0 or pv_on) else None,
                                enabled=telemetry_on, host=pv_host if pv_on else None)
    pv_monitor = (podview.SkewMonitor(run_dir, host=pv_host, hosts=pv_hosts, run_id=pv_run_id,
                                      registry=get_registry())
                  if pv_on and pv_host == 0 else None)
    pv_signaler = None
    pod_ckpt_on = False
    if pv_on and pv_hosts > 1:
        from hydragnn_tpu_torch.resilience.podckpt import PodSignaler

        pv_signaler = PodSignaler(run_dir, host=pv_host, hosts=pv_hosts)
        pod_ckpt_on = env_flag("HGTORCH_POD_CKPT")
    spans = StepSpans(device=dev) if telemetry_on else StepSpans.disabled()
    cmon = CompileMonitor().start() if telemetry_on else None
    trig_engine = incidents = None
    if telemetry_on:
        from hydragnn_tpu_torch.obs.trace import Tracer

        spans.tracer = Tracer(flight=flight)
    if telemetry_on and bool(training.get("slo_triggers", False)):
        from hydragnn_tpu_torch.obs.triggers import IncidentRecorder, TriggerEngine

        trig_engine = TriggerEngine(_train_rules(training, pv_monitor, pv_signaler), registry=get_registry())
        trig_engine.baseline_counters()
        if rank0:
            incidents = IncidentRecorder(os.path.join(log_dir, log_name, "incidents"), registry=get_registry(),
                                         flight_path=flight.path, device=dev, podview=pv_monitor)
    # resilience (module docstring): the preemption handler, the hang
    # watchdog, and the hooks that carry them and the sentry
    preempt = (
        PreemptionHandler(grace_s=float(training.get("preempt_grace_s", 30.0))).install()
        if training.get("preempt_handler", True)
        else None
    )
    stall_s = float(training.get("watchdog_stall_s", 0) or _watchdog_knob() or 0)
    watchdog = HangWatchdog(stall_s, flight=flight).start() if stall_s > 0 else None
    hooks = TrainHooks(preempt=preempt, sentry=sentry, watchdog=watchdog)
    if preempt is not None and pv_signaler is not None:
        # a SIGTERM on this host announces the generation it will cut to
        # the pod (proposed_gen is kept current at each epoch's start)
        preempt.signaler = pv_signaler

    def abort_telemetry(exc: BaseException, epochs: int) -> None:
        """A crashed run still leaves a readable record: the ``error``
        event and ``run_end{status: failed}``, then the re-raise."""
        hooks.teardown()
        if incidents is not None:
            incidents.finalize()
        if pv_monitor is not None:
            pv_monitor.close()
        flight.error(exc)
        flight.end_run(status="failed", epochs=epochs,
                       triggers=trig_engine.summary(incidents.capture_s if incidents else 0.0)
                       if trig_engine is not None else None)
        if cmon is not None:
            cmon.stop()
        if own_flight:
            flight.close()

    def declare_lost(lost, epoch_now: int) -> None:
        """One ``host_lost`` event a newly lost peer, and the
        ``podview.lost_host(s)`` gauges the ``host_lost`` rule reads."""
        fresh = pv_signaler.mark_declared(lost)
        if not fresh:
            return
        reg = get_registry()
        reg.gauge("podview.lost_hosts").set(float(len(set(pv_signaler.lost_hosts()) | set(lost))))
        for h in fresh:
            reg.gauge("podview.lost_host").set(float(h))
            flight.record("host_lost", host=int(h), epoch=int(epoch_now), lost_after_s=pv_signaler.lost_after_s)

    def pod_checkpoint(gen: int) -> None:
        """One generation cut (``resilience/podckpt.py``): every host its
        shard, sidecar and manifest; host 0 waits for the peers'
        manifests, checks them and writes ``gen<N>.COMMIT`` last. Before
        the meta, so a commit that dies on a lost peer leaves the meta of
        the last committed generation."""
        from hydragnn_tpu_torch.resilience import podckpt

        pv_signaler.heartbeat(epoch=gen, force=True)
        podckpt.save_pod_shard(model, run_dir, gen=gen, host=pv_host, hosts=pv_hosts, step=int(optimizer.steps),
                               layout=parallel_block.get("layout"), optimizer=optimizer, epoch=gen)
        if pv_host != 0:
            # host 0 alone waits at the commit: hosts simulated one after
            # another would deadlock on a wait of their own
            return
        commit = podckpt.commit_generation(run_dir, gen, pv_hosts, signaler=pv_signaler)
        if commit.get("committed"):
            podckpt.prune_generations(run_dir)
            return
        # the failed commit is evidence; a lost peer also ends the run with
        # the exit the supervisor restarts from the last committed one
        flight.record("error", error=f"pod generation {gen} failed to commit: lost={commit.get('lost')} "
                                     f"bad={commit.get('bad')} timeout={commit.get('timeout')}",
                      error_type="PodCommitFailed")
        lost = commit.get("lost") or []
        if lost:
            declare_lost(lost, gen)
            raise PodHostLost(lost, gen)

    def pod_epoch(epoch: int, train_wall: float, span_snap, hw, nonfinite) -> None:
        """This host's ``host_epoch`` summary into its shard and, on host 0,
        every host's folded into the skew gauges (before the trigger rules,
        which then see this epoch's skew); then the pod's liveness at the
        boundary: this host's beat, and a ``host_lost`` a peer silent too
        long."""
        t0 = time.perf_counter()
        snap = span_snap or {}
        summary = {"hosts": pv_hosts, "epoch_s": round(train_wall, 6), "data_wait_s": snap.get("data_wait_s"),
                   "dispatch_s": snap.get("dispatch_s"), "steps": snap.get("steps", len(train_loader)),
                   "nonfinite_skipped": (nonfinite or {}).get("skipped", 0),
                   "mfu": hw.get("mfu") if hw is not None else None}
        flight.record("host_epoch", epoch=epoch, host=pv_host, run_id=pv_run_id, **summary)
        if pv_monitor is not None:
            skew = pv_monitor.observe_epoch(epoch, dict(summary, epoch=epoch))
            if skew is not None:
                flight.record("podview", **skew)
        pv_cost["s"] += time.perf_counter() - t0
        if pv_signaler is not None:
            pv_signaler.heartbeat(epoch=epoch + 1, force=True)
            lost_now = pv_signaler.lost_hosts()
            if lost_now:
                declare_lost(lost_now, epoch + 1)  # once a host, however often polled

    def write_checkpoint(epoch_next: int, early_stopped: bool) -> None:
        ckpt.save_model(model, log_name, log_dir, optimizer=optimizer, epoch=epoch_next, keep_last=keep_last)
        if pod_ckpt_on:
            pod_checkpoint(epoch_next)
        if process_index() != 0:
            return
        ckpt.save_train_meta(
            {
                "epoch": epoch_next,
                "step": int(optimizer.steps),  # ties the sidecar to the weights written with it
                "early_stopped": early_stopped,
                "scheduler": {"best": scheduler.best, "num_bad_epochs": scheduler.num_bad_epochs},
                "stopper": {"count": stopper.count if stopper else 0,
                            "min_loss": stopper.min_loss if stopper else float("inf")},
                "history": {k: history[k] for k in EPOCH_KEYS},
            },
            log_name, log_dir,
        )

    def preempt_exit(epoch: int, coordinated_from: Optional[int] = None) -> None:
        """A graceful stop inside the handler's grace window: the
        checkpoint and meta pair for ``epoch``, the ``preempt`` event,
        ``run_end{status: preempted}``, the telemetry closed, then
        ``TrainingPreempted`` (exit 75 under ``run_guard``).
        ``coordinated_from``: the peer whose announcement this cut
        follows, rather than this host's own signal."""
        signum = preempt.signum if preempt is not None and preempt.signum is not None else 0
        write_checkpoint(epoch, early_stopped=False)
        flight.record("preempt", signal=signum, epoch=epoch, step=int(optimizer.steps),
                      **({"coordinated_from": int(coordinated_from)} if coordinated_from is not None else {}))
        if incidents is not None:
            incidents.finalize()
        if pv_monitor is not None:
            pv_monitor.close()
        flight.end_run(status="preempted", epochs=epoch - start_epoch)
        if cmon is not None:
            cmon.stop()
        if own_flight:
            flight.close()
        writer.flush()
        hooks.teardown()
        raise TrainingPreempted(signum, epoch)

    def rollback(epoch: int, consec_end: int) -> None:
        """Restore the last good checkpoint at a reduced learning rate, or
        give up when the budget is spent or there is nothing to restore."""
        exists = ckpt.checkpoint_exists(log_name, log_dir)
        if sentry.exhausted or not exists:
            raise NonFiniteRollbackExhausted(
                f"epoch {epoch} ended with {consec_end} consecutive non-finite steps; rollbacks used "
                f"{sentry.rollbacks}/{sentry.max_rollbacks}"
                + ("" if exists else " and no checkpoint exists to roll back to")
            )
        ckpt.load_existing_model(model, log_name, log_dir, optimizer=optimizer)
        lr = max(current_learning_rate(optimizer) * sentry.lr_factor, 1e-8)
        set_learning_rate(optimizer, lr)
        sentry.on_rollback()
        history["rollbacks"].append(epoch)
        flight.record("rollback", epoch=epoch, consec=consec_end, rollbacks=sentry.rollbacks, lr=lr)
        if verbosity > 0:
            print(f"non-finite sentry: epoch {epoch} ended with {consec_end} consecutive bad steps; rolled back "
                  f"to the last good checkpoint (lr -> {lr:g})", flush=True)

    # from here on a failure still ends the record (error, run_end failed)
    try:
        introspect_on = (telemetry_on and bool(training.get("diagnostics", True))
                         and env_flag("HGTORCH_DIAGNOSTICS"))
        diag = ledger = None
        if introspect_on:
            from hydragnn_tpu_torch.obs.introspect import (
                HardwareLedger,
                HeadDiagnostics,
                conv_traffic_model,
                make_diagnostics_step,
                pad_waste_from_batch,
            )

            diag = HeadDiagnostics(make_diagnostics_step(model, optimizer, compute_dtype,
                                                         group=partitioner.world_group), head_names=names,
                                   every=int(training.get("diag_every", 0)) or max(len(train_loader), 1))
            example = _example_batch(train_loader)
            if example is None:
                ledger = HardwareLedger.disabled(reason="example_batch_unavailable")
            else:
                ledger = HardwareLedger.from_model(model, example, compute_dtype)
                waste = pad_waste_from_batch(example)
                ledger.set_conv_traffic(waste, conv_traffic_model(
                    waste["node_pad"], waste["edge_pad"], model.cfg.hidden_dim, model.cfg.num_conv_layers,
                    real_edges=waste["real_edges_mean"]))

        # the Profile section's epoch-gated trace
        profiler = None
        if "Profile" in config:
            profiler = Profiler(os.path.join(log_dir, log_name, "profile"), config["Profile"], dev)
            if not profiler.enable:
                profiler = None
        metrics_path = None
        if rank0:
            os.makedirs(os.path.join(log_dir, log_name), exist_ok=True)
            metrics_path = os.path.join(log_dir, log_name, "metrics.jsonl")
        visualizer = None
        if create_plots and rank0:
            visualizer = Visualizer(log_name, num_heads=model.cfg.num_heads, head_names=names, log_dir=log_dir)
        nodes_per_graph = None
        if visualizer is not None and hasattr(test_loader, "samples"):
            nodes_per_graph = [s.num_nodes for s in test_loader.samples]
            visualizer.num_nodes_plot(nodes_per_graph)
        if visualizer is not None and plot_init_solution:
            _, _, tv, pv = test_epoch(test_loader, model, return_samples=True, step=eval_fn)
            visualizer.create_scatter_plots(tv, pv, iepoch=-1)

        parallel_block = partitioner.manifest(model, optimizer)
        if pv_monitor is not None:
            pv_monitor.set_parallel(parallel_block)  # the layout, for the collective attribution
        # the lineage a pod restore in this process left (utils/checkpoint.py
        # -> resilience/podckpt.py), taken once: only the run that restored stamps it
        from hydragnn_tpu_torch.resilience.podckpt import consume_last_restore_info

        pod_lineage = consume_last_restore_info()
        if flight.enabled:
            flight.start_run(_manifest(
                model, config, run_config, log_name, log_dir, dev, (train_loader, val_loader, test_loader),
                num_epoch=num_epoch, start_epoch=start_epoch, compute_dtype=compute_dtype, dispatch=dispatch,
                cmon=cmon, guard=guard, diag=diag, ledger=ledger, extra=manifest_extra,
                preempt=preempt, stall_s=stall_s, parallel=parallel_block,
                podview_block={"enabled": pv_on, "host": pv_host, "hosts": pv_hosts, "run_id": pv_run_id},
                pod_lineage=pod_lineage,
            ), device=dev)
            if resumed_from is not None:
                flight.record("resumed", epoch=resumed_from)
            if pod_lineage is not None:
                flight.record("pod_resume", gen=int(pod_lineage.get("gen", -1)),
                              prior_hosts=pod_lineage.get("hosts"), prior_layout=pod_lineage.get("layout"),
                              fallbacks=pod_lineage.get("fallbacks") or [])
        writer = get_summary_writer(log_name, log_dir)
    except BaseException as exc:
        abort_telemetry(exc, 0)
        raise

    hist_plots = visualizer if plot_hist_solution else None
    timer = Timer("train_validate_test")
    timer.start()
    epochs_done = start_epoch
    try:
        for epoch in range(start_epoch, num_epoch):
            hooks.epoch_start(epoch)
            if hooks.preempted:
                preempt_exit(epoch)
            if pv_signaler is not None:
                # a SIGTERM anywhere in this epoch announces the cut at its
                # end, so every host checkpoints the same generation
                if preempt is not None:
                    preempt.proposed_gen = epoch + 1
                pv_signaler.heartbeat(epoch=epoch, force=True)
            for loader in (train_loader, val_loader, test_loader):
                loader.set_epoch(epoch)
            profiled = profiler is not None and not profiler.done and epoch == profiler.target_epoch
            if profiler is not None:
                profiler.set_current_epoch(epoch)
            if profiled and incidents is not None:
                incidents.finalize()  # the Profile's epoch owns the profiler: an open incident ends here
            if cmon is not None:
                cmon.mark("epoch_start")
            spans.epoch_start(epoch)
            timing: Dict[str, float] = {}
            t0 = time.perf_counter()
            # the profiler's context closes a trace the epoch's steps left open
            with profiler if profiler is not None else contextlib.nullcontext():
                train_loss, train_tasks = train_epoch(train_loader, model, step_fn, epoch, fixed, sentry, timing,
                                                      profiler, spans=spans, diag=diag,
                                                      incidents=None if profiled else incidents, hooks=hooks,
                                                      partitioned=partitioned)
            # finalize read the losses: the steps are done
            train_wall = time.perf_counter() - t0
            history["train_wall_s"].append(train_wall)
            history["data_wait_s"].append(timing.get("data_wait_s", 0.0))
            if profiled and profiler.trace_path is not None:
                flight.record("profile_trace", path=profiler.trace_path, epoch=epoch)
            if hooks.preempted and pv_signaler is None:
                # stopped mid-epoch: the epoch is incomplete and the resumed run re-runs it (a pod
                # host goes on to the epoch's end, the generation its signal announced)
                preempt_exit(epoch)
            nonfinite = None
            if sentry is not None:
                skipped, consec_end = sentry.epoch_finalize()
                history["nonfinite_skipped"].append(skipped)
                if skipped and telemetry_on:
                    get_registry().counter("train.nonfinite_skipped").inc(skipped)
                    nonfinite = {"skipped": skipped, "consec_end": consec_end}
                if sentry.needs_rollback(consec_end):
                    rollback(epoch, consec_end)
                    epochs_done = epoch + 1
                    continue  # the rolled-back epoch consumed its slot
            val_loss, val_tasks = evaluate_epoch(val_loader, model, val_resident, step=eval_fn)
            test_loss, test_tasks, tv, pv = test_epoch(test_loader, model,
                                                       return_samples=hist_plots is not None or introspect_on,
                                                       step=eval_fn)
            if hist_plots is not None:
                hist_plots.create_error_histograms(tv, pv, iepoch=epoch)
            scheduler.step(optimizer, val_loss)
            for key, val in (("train_loss", train_loss), ("val_loss", val_loss), ("test_loss", test_loss),
                             ("train_tasks", train_tasks.tolist()), ("val_tasks", val_tasks.tolist()),
                             ("test_tasks", test_tasks.tolist()), ("lr", current_learning_rate(optimizer))):
                history[key].append(val)
            if verbosity > 0:
                per_head = ", ".join(f"{n}={v:.6f}" for n, v in zip(names, train_tasks))
                print(f"Epoch: {epoch:02d}, Train Loss: {train_loss:.8f}, Val Loss: {val_loss:.8f}, "
                      f"Test Loss: {test_loss:.8f} ({per_head})", flush=True)
            if epoch == 0:
                # after the first epoch the peak holds the weights, the
                # activations and the optimizer state: the run's footprint
                print_peak_memory(verbosity, prefix=f"epoch {epoch}", device=dev)
            _write_epoch_record(writer, metrics_path, names, epoch, history)
            if telemetry_on:
                _epoch_telemetry(
                    flight, writer, epoch, history, names, dispatch, training, start_epoch, len(train_loader),
                    train_wall, spans, cmon, diag, ledger, (tv, pv) if introspect_on else None, nonfinite,
                    trig_engine, incidents, pv_host if pv_on else (0 if rank0 else None),
                    pod_epoch=(lambda span_snap, hw: pod_epoch(epoch, train_wall, span_snap, hw, nonfinite))
                    if pv_on else None,
                )
            stop = stopper is not None and stopper(val_loss)
            epochs_done = epoch + 1
            if ckpt_every and (epoch + 1) % ckpt_every == 0:
                write_checkpoint(epoch + 1, early_stopped=False)
            if hooks.preempted:
                # the signal landed during evaluation (on a pod, anywhere in the
                # epoch): this epoch is complete and recorded
                preempt_exit(epoch + 1)
            if pv_signaler is not None:
                req = pv_signaler.preempt_request()
                if req is not None and int(req.get("host", -1)) != pv_host and epoch + 1 >= int(req.get("gen", 0)):
                    # a peer announced a preemption: cut the same generation
                    # here, so the supervisor restarts every host from one COMMIT
                    preempt_exit(epoch + 1, coordinated_from=int(req.get("host", -1)))
            if stop:
                if verbosity > 0:
                    print(f"Early stopping at epoch {epoch}", flush=True)
                break
        # a resume that trained no epoch (a completed or early-stopped run) is
        # a no-op: no recalibration, no checkpoint rewrite
        resumed_noop = training.get("continue") == 1 and epochs_done == start_epoch
        if training.get("bn_recalibration", True) and not resumed_noop:
            for _ in range(2):
                for batch in train_loader:
                    hooks.beat()  # the recalibration batches count as liveness
                    stats_fn(batch.to(dev, non_blocking=True))
        if ckpt_every and not resumed_noop:
            write_checkpoint(epochs_done, early_stopped=bool(stopper and stopper.count >= stopper.patience))
        writer.flush()
        if visualizer is not None:
            _, _, tv, pv = test_epoch(test_loader, model, return_samples=True, step=eval_fn)
            visualizer.create_scatter_plots(tv, pv)
            visualizer.create_plot_global(tv, pv)
            visualizer.create_reference_plot_suite(tv, pv, model.cfg.output_type, nodes_per_graph)
            visualizer.plot_history(history)
    except TrainingPreempted:
        # preempt_exit wrote the checkpoint and the record and tore the hooks down
        raise
    except BaseException as exc:
        timer.stop_if_running()
        abort_telemetry(exc, epochs_done - start_epoch)
        raise
    finally:
        writer.close()
        timer.stop_if_running()

    # run_end: the record's last event
    if cmon is not None:
        cmon.stop()
    if incidents is not None:
        incidents.finalize()  # an incident still capturing closes as "truncated"
    if pv_monitor is not None:
        pv_monitor.close()
    flight.end_run(
        status="completed",
        epochs=epochs_done - start_epoch,
        epochs_total=epochs_done,
        early_stopped=bool(stopper and stopper.count >= stopper.patience),
        best_val_loss=min(history["val_loss"]) if history["val_loss"] else None,
        final_lr=history["lr"][-1] if history["lr"] else None,
        compiles=cmon.snapshot() if cmon is not None else None,
        timers=timers_snapshot(),
        metrics=get_registry().snapshot(),
        hw=ledger.run_summary() if ledger is not None else None,
        triggers=trig_engine.summary(incidents.capture_s if incidents else 0.0) if trig_engine is not None else None,
        # the pod plane's measured cost: its shard writes and host 0's skew
        # folds as a fraction of the run's wall
        podview={"enabled": True, "host": pv_host, "hosts": pv_hosts, "run_id": pv_run_id,
                 "overhead_s": round(pv_cost["s"], 6),
                 "overhead_frac": round(pv_cost["s"] / max(time.perf_counter() - pv_cost["t0"], 1e-9), 8)}
        if pv_on else None,
    )
    if own_flight:
        flight.close()
    hooks.teardown()
    return history


def _manifest(model, config, run_config, log_name, log_dir, dev, loaders, *, num_epoch, start_epoch, compute_dtype,
              dispatch, cmon, guard, diag, ledger, extra, preempt, stall_s, parallel, podview_block,
              pod_lineage=None) -> Dict[str, Any]:
    """The ``run_start`` manifest: what the run is and how to rerun it.
    ``parallel`` is the partitioner's block (``Partitioner.manifest``),
    ``podview_block`` the pod identity (which host's shard, the run id
    the merge joins on), ``pod_lineage`` a pod restore's (the
    ``pod_resume`` block: the committed generation, the prior layout,
    the generations passed over). ``graftcheck`` says the port has no
    counterpart."""
    from hydragnn_tpu_torch.obs.introspect import card_identity

    train_loader, val_loader, test_loader = loaders
    cuda = dev.type == "cuda"
    stats_block = None
    samples = getattr(train_loader, "samples", None)
    if samples:
        from hydragnn_tpu_torch.obs.drift import build_reference

        stats_block = build_reference(samples, head_names=list(model.cfg.output_names))
    return {
        "run": log_name,
        "log_dir": log_dir,
        "config": run_config if run_config is not None else {"NeuralNetwork": config},
        "device_kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
        "local_device_count": torch.cuda.device_count() if cuda else 1,
        "card": card_identity() if cuda else None,
        "mesh": {"device_stack": 1, "process_count": process_count()},
        "podview": dict(podview_block),
        "parallel": parallel,
        "graftcheck": {"available": False, "reason": "graftcheck audits XLA programs; the port compiles none"},
        "pad_plans": {"train": _loader_plan(train_loader), "val": _loader_plan(val_loader),
                      "test": _loader_plan(test_loader)},
        "num_epoch": num_epoch,
        "start_epoch": start_epoch,
        "mixed_precision": compute_dtype is not None,
        # the port's counterpart of the JAX whole-epoch scan: the fixed
        # membership's resident batches, launched step by step
        "scan_epoch": dispatch["mode"] == "fixed_epoch",
        "dispatch_mode": dict(dispatch),
        "compile_monitor_available": bool(cmon and cmon.available),
        "nonfinite_guard": guard,
        "preempt_handler": bool(preempt and preempt.available),
        "watchdog_stall_s": stall_s or None,
        "head_names": list(model.cfg.output_names),
        "diagnostics": {"enabled": diag is not None, "diag_every": diag.every if diag is not None else None},
        "hw_cost": ledger.manifest() if ledger is not None else {"available": False},
        "stats": stats_block,
        **({"pod_resume": {"resumed_from_gen": pod_lineage.get("gen"), "step": pod_lineage.get("step"),
                           "prior_hosts": pod_lineage.get("hosts"), "prior_layout": pod_lineage.get("layout"),
                           "fallbacks": pod_lineage.get("fallbacks") or []}} if pod_lineage is not None else {}),
        **(extra or {}),
    }


def _epoch_telemetry(flight, writer, epoch, history, names, dispatch, training, start_epoch, steps, train_wall,
                     spans, cmon, diag, ledger, samples, nonfinite, trig_engine, incidents, prom_host,
                     pod_epoch=None) -> None:
    """The epoch's telemetry after its records: the flight ``epoch``
    event, the pod's ``pod_epoch(span_snap, hw)`` (its summary, skew and
    liveness), the trigger rules, tensorboard's ``obs/*`` and ``heads/*``
    scalars and ``train.prom`` (written by ``prom_host``, None: not by
    this process; ``train.host<k>.prom`` on a pod host k)."""
    from hydragnn_tpu_torch.obs.introspect import per_head_error_metrics

    train_loss, val_loss, test_loss = (history[k][-1] for k in ("train_loss", "val_loss", "test_loss"))
    lr = history["lr"][-1]
    train_named = _named_tasks(names, history["train_tasks"][-1])
    head_quality = per_head_error_metrics(samples[0], samples[1], names) if samples and samples[0] else None
    diag_snap = diag.epoch_snapshot() if diag is not None else None
    hw = ledger.epoch_record(steps=steps, wall_s=train_wall) if ledger is not None else None
    span_snap = spans.epoch_snapshot()
    step_time = dict(span_snap, mode=dispatch["mode"]) if span_snap is not None else {"mode": "disabled"}
    compiles: Dict[str, Any] = {"available": bool(cmon and cmon.available)}
    if cmon is not None:
        n_compiles = cmon.count_since("epoch_start")
        compiles["count"] = n_compiles
        compiles["unexpected"] = bool(cmon.available and epoch > start_epoch and n_compiles > 0)
    heads: Dict[str, Any] = {"names": list(names), "available": False}
    if diag_snap is not None:
        heads.update(diag_snap)
    if head_quality is not None:
        heads["available"] = True
        heads["mae"] = {n: m["mae"] for n, m in head_quality.items()}
        heads["rmse"] = {n: m["rmse"] for n, m in head_quality.items()}
    extra: Dict[str, Any] = {}
    if nonfinite:
        extra["nonfinite"] = nonfinite
    if ledger is not None:
        extra["heads"] = heads
        extra["hw"] = hw
    flight.epoch(epoch, train_loss=train_loss, val_loss=val_loss, test_loss=test_loss, lr=lr,
                 train_tasks=train_named, val_tasks=_named_tasks(names, history["val_tasks"][-1]),
                 test_tasks=_named_tasks(names, history["test_tasks"][-1]), step_time=step_time,
                 compiles=compiles, **extra)
    if pod_epoch is not None:
        pod_epoch(span_snap, hw)

    # the SLO rules at the epoch's end: at most one verdict opens an
    # incident, whose capture runs in the next epoch's steps
    if trig_engine is not None:
        trig_engine.observe("train_loss", train_loss)
        trig_engine.observe("val_loss", val_loss)
        if hw is not None:
            trig_engine.observe("mfu", hw.get("mfu"))
        for verdict in trig_engine.evaluate():
            if incidents is not None:
                incidents.open_incident(verdict, flight=flight)

    if span_snap is not None:
        write_scalar_dict(writer, span_snap, epoch, prefix="obs/step_time")
    if diag_snap is not None:
        for name in names:
            if name in diag_snap["grad_norm"]:
                writer.add_scalar(f"heads/{name}/grad_norm", diag_snap["grad_norm"][name], epoch)
        writer.add_scalar("obs/update_ratio", diag_snap["update_ratio"], epoch)
    if head_quality is not None:
        for name, m in head_quality.items():
            if m["mae"] is not None:
                writer.add_scalar(f"heads/{name}/mae", m["mae"], epoch)
                writer.add_scalar(f"heads/{name}/rmse", m["rmse"], epoch)
    if hw is not None and hw.get("mfu") is not None:
        writer.add_scalar("obs/hw/mfu", hw["mfu"], epoch)
    if hw is not None and hw.get("achieved_tflops") is not None:
        writer.add_scalar("obs/hw/achieved_tflops", hw["achieved_tflops"], epoch)

    # the Prometheus textfile, one atomic snapshot an epoch (rank 0, or each pod host its own)
    prom_dir = training.get("prometheus_dir")
    if prom_dir and prom_host is not None:
        from hydragnn_tpu_torch.obs.export import registry_to_prometheus

        reg = get_registry()
        reg.gauge("train.epoch").set(epoch)
        reg.gauge("train.loss").set(train_loss)
        reg.gauge("train.val_loss").set(val_loss)
        reg.gauge("train.lr").set(lr)
        for name, v in train_named.items():
            reg.gauge(f"train.head.{name}.loss").set(v)
        if diag_snap is not None:
            for name, v in diag_snap["grad_norm"].items():
                reg.gauge(f"train.head.{name}.grad_norm").set(v)
        if hw is not None and hw.get("mfu") is not None:
            reg.gauge("train.mfu").set(hw["mfu"])
        registry_to_prometheus(reg, podview.host_artifact_path(os.path.join(prom_dir, "train.prom"), prom_host))


def _write_epoch_record(writer, metrics_path: Optional[str], names: Sequence[str], epoch: int,
                        history: Dict[str, Any]) -> None:
    """The epoch's tensorboard scalars and its ``metrics.jsonl`` line, from
    the history's last entries."""
    train_loss, val_loss, test_loss = (history[k][-1] for k in ("train_loss", "val_loss", "test_loss"))
    train_named = _named_tasks(names, history["train_tasks"][-1])
    val_named = _named_tasks(names, history["val_tasks"][-1])
    writer.add_scalar("train error", train_loss, epoch)
    writer.add_scalar("validate error", val_loss, epoch)
    writer.add_scalar("test error", test_loss, epoch)
    for name in names:
        if name in train_named:
            writer.add_scalar(f"heads/{name}/train_loss", train_named[name], epoch)
        if name in val_named:
            writer.add_scalar(f"heads/{name}/val_loss", val_named[name], epoch)
    if metrics_path is not None:
        record = {"epoch": epoch, "train_loss": train_loss, "val_loss": val_loss, "test_loss": test_loss,
                  "lr": history["lr"][-1], "train_tasks": train_named, "val_tasks": val_named}
        with open(metrics_path, "a") as f:
            f.write(json.dumps(record) + "\n")
