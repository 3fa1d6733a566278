"""Model-level introspection: per-head gradient diagnostics, per-head
error metrics, and the run's hardware ledger (the port's counterpart of
``hydragnn_tpu/obs/introspect.py``).

**Is the multi-task optimisation healthy?** :func:`make_diagnostics_step`
builds ``diag(batch)``: one forward over the loss the train step
optimises (the same ``compute_dtype`` casts, the same dropout draw, the
same ``model_loss`` tasks), then H one-hot pulls and one pull with the
normalised task weights, all through one retained autograd graph
(``torch.autograd.grad(..., retain_graph=True)``). From them come each
head's gradient norm, the H x H cosine matrix of the head gradients
(negative entries: heads pulling the shared encoder apart), the weighted
total's norm, the parameter norm, and the norm of the update the
optimizer would make from that gradient (``Optimizer.dry_update``: the
rule's formula on the state as it stands, written nowhere) and its ratio
to the parameter norm. The sample
leaves training bit for bit as it was: the BatchNorm running statistics
and the dropout generator are put back, no ``.grad`` is written, and the
real optimizer's state is only read. :class:`HeadDiagnostics` samples it
every ``every`` steps, before the step, and keeps the results on the
device until ``epoch_snapshot`` reads them once.

**How efficiently did the card run?** :class:`HardwareLedger` counts
the FLOPs of one forward and backward of an example batch with
``torch.utils.flop_counter.FlopCounterMode`` (the dense products; the
port's kernels and the plain segment operations count 0, so the card
and the CPU agree on the flagship), takes the card's bf16 dense peak
from :data:`PEAK_BF16_TFLOPS`, and turns each epoch's train wall time
into achieved TFLOP/s and MFU beside the memory watermark
(``torch.cuda.max_memory_allocated``). Off the table (the CPU, another
card) the peaks are None and MFU is unavailable.

The numpy helpers (``pad_waste_from_batch``, ``conv_traffic_model``,
``per_head_error_metrics``, ``collect_head_series``, ``flag_anomalies``)
are copies of the JAX package's.
"""

from __future__ import annotations

import contextlib
import subprocess
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

# bf16 dense tensor-core peak and HBM rate of each card, matched as a
# substring of ``torch.cuda.get_device_name`` (NVIDIA's H100 SXM data
# sheet: 989 TFLOP/s bf16 without sparsity, 3.35 TB/s HBM3)
PEAK_BF16_TFLOPS = (("h100 80gb hbm3", 989.0),)
PEAK_HBM_GBPS = (("h100 80gb hbm3", 3350.0),)

# the reference kernels' tiles (``hydragnn_tpu/ops/segment_pallas.py``,
# its default row of ``TUNE_TILES.json``), which ``conv_traffic_model``
# prices
ALIGN, BN, CE = 16, 128, 512
BW = CE + ALIGN


def _device_name(device) -> Optional[str]:
    if device is None:
        return None
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    return torch.cuda.get_device_name(dev)


def _lookup(table, device) -> Optional[float]:
    name = (_device_name(device) or "").lower()
    for sub, value in table:
        if name and sub in name:
            return value
    return None


def peak_flops(device) -> Optional[float]:
    """The card's bf16 dense peak in FLOP/s, or None off the table (the
    CPU among them): MFU is then unavailable."""
    tf = _lookup(PEAK_BF16_TFLOPS, device)
    return None if tf is None else tf * 1e12


def peak_hbm_bw(device) -> Optional[float]:
    """The card's HBM rate in bytes/s, or None off the table."""
    gb = _lookup(PEAK_HBM_GBPS, device)
    return None if gb is None else gb * 1e9


def card_identity() -> Optional[Dict[str, str]]:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them, or
    None where the tool is absent or fails."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    first = out.stdout.strip().splitlines()[:1]
    if out.returncode != 0 or not first:
        return None
    name, _, limit = first[0].rpartition(",")
    return {"name": name.strip(), "power_limit": limit.strip(), "nvidia_smi": first[0].strip()}


def device_memory_stats(device=None) -> Dict[str, Any]:
    """The card's memory in use, its watermark
    (``torch.cuda.max_memory_allocated``) and its size; ``{"available":
    False}`` on the CPU."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return {"available": False}
    return {
        "available": True,
        "bytes_in_use": int(torch.cuda.memory_allocated(dev)),
        "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(dev)),
        "bytes_limit": int(torch.cuda.get_device_properties(dev).total_memory),
    }


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def pad_waste_from_batch(batch) -> Dict[str, Any]:
    """How much of one ``GraphBatch``'s static edge and node pad it
    fills: from its occupancy fields (``edge_occupancy``, which under
    run alignment counts the masked self-loops below it, and
    ``n_real_nodes``) where present, else from the masks."""
    edge_pad = int(batch.senders.shape[-1])
    nmask = _np(batch.node_mask)
    node_pad = int(nmask.shape[-1])
    occ = getattr(batch, "edge_occupancy", None)
    real_e = float(_np(occ).mean()) if occ is not None else float(_np(batch.edge_mask).sum(axis=-1).mean())
    nrn = getattr(batch, "n_real_nodes", None)
    real_n = float(_np(nrn).mean()) if nrn is not None else float(nmask.sum(axis=-1).mean())
    return {
        "edge_pad": edge_pad,
        "node_pad": node_pad,
        "real_edges_mean": round(real_e, 1),
        "real_nodes_mean": round(real_n, 1),
        "edge_waste_frac": round(1.0 - real_e / max(edge_pad, 1), 4),
        "node_waste_frac": round(1.0 - real_n / max(node_pad, 1), 4),
    }


def conv_traffic_model(
    node_pad: int,
    edge_pad: int,
    hidden: int,
    layers: int,
    real_edges: Optional[float] = None,
) -> Dict[str, Any]:
    """Analytic bytes a step of the conv hot path moves under each mode
    of the reference's fused TPU kernel (the JAX package's model, at its
    tiles ``ALIGN``, ``BN``, ``CE``, ``BW``): edge-id chunks, sender
    gather windows, the layer's parameters and the f32 output, padded,
    bounded at ``real_edges`` (``fused_skip``), with bf16 activations,
    and with the features resident across layers; ``xla_unfused`` is
    the materialised gather, message and scatter chain."""
    hp = ((int(hidden) + 127) // 128) * 128
    node_pad = int(node_pad)
    edge_pad = int(edge_pad)
    layers = max(int(layers), 1)
    n_pad_out = ((node_pad + BN - 1) // BN) * BN
    n_res = max(((node_pad + ALIGN - 1) // ALIGN) * ALIGN, BW, n_pad_out)
    e_eff = edge_pad if real_edges is None else min(float(real_edges), edge_pad)

    def chunks(e: float) -> int:
        return -(-int(e) // CE) if e > 0 else 0

    def fused(e: float, act_bytes: int) -> int:
        per_layer = (
            3 * chunks(e) * CE * 4
            + chunks(e) * BW * hp * act_bytes
            + (hp * hp + hp) * 4
            + n_pad_out * hp * 4
        )
        return layers * per_layer

    xla = layers * (
        node_pad * hp * 4
        + 4 * edge_pad * hp * 4
        + 2 * edge_pad * 4
        + n_pad_out * hp * 4
    )
    padded = fused(edge_pad, 4)
    skip = fused(e_eff, 4)
    skip_bf16 = fused(e_eff, 2)
    resident_skip = n_res * hp * 4 + layers * (
        3 * chunks(e_eff) * CE * 4 + (hp * hp + hp) * 4 + n_pad_out * hp * 4
    )

    def drop(b: int) -> float:
        return round(1.0 - b / max(padded, 1), 4)

    return {
        "hidden_padded": hp,
        "edge_pad": edge_pad,
        "real_edges": None if real_edges is None else int(real_edges),
        "assumption": "one BW-row gather window per CE-edge chunk (loader locality)",
        "bytes_per_step": {
            "xla_unfused": int(xla),
            "fused_padded": int(padded),
            "fused_skip": int(skip),
            "fused_skip_bf16": int(skip_bf16),
            "resident_skip": int(resident_skip),
        },
        "drop_vs_fused_padded": {
            "fused_skip": drop(skip),
            "fused_skip_bf16": drop(skip_bf16),
            "resident_skip": drop(resident_skip),
        },
    }


# ---------------------------------------------------------------------------
# per-head gradient diagnostics
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def preserved_training_state(model):
    """Put the model's buffers (the BatchNorm running statistics) and its
    dropout generator back as they were when the block ends."""
    buffers = list(model.buffers())
    saved = [b.detach().clone() for b in buffers]
    gen = model.dropout_generator(next(model.parameters()).device) if model.uses_dropout else None
    gen_state = None if gen is None else gen.get_state()
    try:
        yield
    finally:
        with torch.no_grad():
            for b, s in zip(buffers, saved):
                b.copy_(s)
        if gen is not None:
            gen.set_state(gen_state)


def _flat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """The tensors as one float64 vector: the norms and dot products over
    a million parameters are summed in float64, so the card's and the
    CPU's summation orders agree to far below float32's rounding."""
    return torch.cat([t.reshape(-1).double() for t in tensors])


def make_diagnostics_step(model, optimizer, compute_dtype: Optional[torch.dtype] = None, group=None
                          ) -> Callable[..., Dict[str, torch.Tensor]]:
    """``diag(batch) -> dict of device tensors`` over the loss the train
    step optimises, leaving the training state as it was (module
    docstring):

      - ``tasks_loss`` [H], ``grad_norms`` [H] (each head's unweighted
        loss gradient over every parameter), ``cosine`` [H, H];
      - ``grad_norm_total`` (the task-weighted gradient the optimizer
        consumes), ``param_norm``, ``update_norm``, ``update_ratio``.

    The norms, dot products and cosines are float64. Cost: one forward
    and H + 1 backward pulls through one graph, and the optimizer's
    dry update. In a partitioned run (``group``: every rank of it) the
    weighted pull is averaged over the ranks first, as the step's
    reduction averages the gradient the optimizer consumes
    (``parallel/sharded.py``); the per-head pulls stay this rank's."""
    from hydragnn_tpu_torch.train.state import _loss

    cfg = model.cfg
    num_heads = cfg.num_heads

    def diag(batch) -> Dict[str, torch.Tensor]:
        params = list(model.parameters())
        with preserved_training_state(model), torch.enable_grad():
            _, tasks = _loss(model, batch, compute_dtype)
            eye = torch.eye(num_heads, dtype=tasks.dtype, device=tasks.device)
            weights = torch.tensor(cfg.normalized_weights, dtype=tasks.dtype, device=tasks.device)
            pulls = []
            for i, cot in enumerate([*eye, weights]):
                got = torch.autograd.grad(tasks, params, grad_outputs=cot, retain_graph=i < num_heads,
                                          allow_unused=True)
                pulls.append([torch.zeros_like(p) if g is None else g for g, p in zip(got, params)])
        with torch.no_grad():
            head_flat = torch.stack([_flat(g) for g in pulls[:num_heads]])
            dots = head_flat @ head_flat.T
            norms = torch.sqrt(torch.clamp(torch.diagonal(dots), min=0.0))
            cosine = dots / torch.clamp(norms[:, None] * norms[None, :], min=1e-30)
            total = pulls[num_heads]
            if group is not None:
                import torch.distributed as dist

                flat = torch.cat([g.reshape(-1) for g in total])
                dist.all_reduce(flat, group=group)
                flat /= dist.get_world_size(group)
                total = [t.view_as(g) for t, g in zip(torch.split(flat, [g.numel() for g in total]), total)]
            param_norm = torch.linalg.vector_norm(_flat(params))
            update_norm = torch.linalg.vector_norm(_flat(optimizer.dry_update(params, total)))
            return {
                "tasks_loss": tasks.detach(),
                "grad_norms": norms,
                "cosine": cosine,
                "grad_norm_total": torch.linalg.vector_norm(_flat(total)),
                "param_norm": param_norm,
                "update_norm": update_norm,
                "update_ratio": update_norm / torch.clamp(param_norm, min=1e-30),
            }

    return diag


class HeadDiagnostics:
    """Sampling around the diagnostics step: ``maybe_sample(batch)`` once
    a train step, before it; every ``every``-th call (the first
    included) runs the step and keeps its device results; the others
    are a counter increment. ``epoch_snapshot`` reads the last sample
    once, keyed by head name."""

    def __init__(self, diag_fn, head_names: Sequence[str], every: int):
        self.fn = diag_fn
        self.head_names = list(head_names)
        self.every = max(int(every), 1)
        self._n = 0
        self._pending = None
        self._pending_step = None

    def maybe_sample(self, batch) -> None:
        if self._n % self.every == 0:
            self._pending = self.fn(batch)
            self._pending_step = self._n
        self._n += 1

    def epoch_snapshot(self) -> Optional[Dict[str, Any]]:
        """The epoch's sample for the flight record, or None when no step
        was sampled this epoch."""
        if self._pending is None:
            return None
        vals = {k: v.detach().cpu().double().numpy() for k, v in self._pending.items()}
        self._pending = None
        names = self.head_names
        snap = {
            "available": True,
            "sampled_step": self._pending_step,
            "grad_norm": {n: float(g) for n, g in zip(names, vals["grad_norms"])},
            "task_loss": {n: float(v) for n, v in zip(names, vals["tasks_loss"])},
            "cosine": vals["cosine"].round(6).tolist(),
            "grad_norm_total": float(vals["grad_norm_total"]),
            "param_norm": float(vals["param_norm"]),
            "update_norm": float(vals["update_norm"]),
            "update_ratio": float(vals["update_ratio"]),
        }
        self._pending_step = None
        return snap


# ---------------------------------------------------------------------------
# per-head eval quality metrics
# ---------------------------------------------------------------------------


def per_head_error_metrics(
    trues: Sequence[np.ndarray],
    preds: Sequence[np.ndarray],
    names: Sequence[str],
) -> Dict[str, Dict[str, float]]:
    """MAE and RMSE per head over the (true, predicted) values the test
    pass gathers."""
    out: Dict[str, Dict[str, float]] = {}
    for name, tv, pv in zip(names, trues, preds):
        tv = np.asarray(tv, np.float64).reshape(-1)
        pv = np.asarray(pv, np.float64).reshape(-1)
        n = min(tv.size, pv.size)
        if n == 0:
            out[name] = {"mae": None, "rmse": None, "count": 0}
            continue
        diff = pv[:n] - tv[:n]
        out[name] = {
            "mae": float(np.abs(diff).mean()),
            "rmse": float(np.sqrt((diff * diff).mean())),
            "count": int(n),
        }
    return out


# ---------------------------------------------------------------------------
# the hardware ledger
# ---------------------------------------------------------------------------


def step_flops(model, batch, compute_dtype: Optional[torch.dtype] = None) -> int:
    """FLOPs of one forward and backward of the train step's loss on
    ``batch`` (``FlopCounterMode``; no optimizer step, no ``.grad``
    written, the BatchNorm statistics and dropout generator put back)."""
    from torch.utils.flop_counter import FlopCounterMode

    from hydragnn_tpu_torch.train.state import _loss

    params = list(model.parameters())
    counter = FlopCounterMode(display=False)
    with preserved_training_state(model), torch.enable_grad(), counter:
        loss, _ = _loss(model, batch, compute_dtype)
        torch.autograd.grad(loss, params, allow_unused=True)
    return int(counter.get_total_flops())


class HardwareLedger:
    """The run's hardware efficiency: FLOPs a step and the card's peaks
    at ``run_start`` (:meth:`manifest`), achieved TFLOP/s, MFU and the
    memory watermark an epoch (:meth:`epoch_record`), their means and
    maximum at ``run_end`` (:meth:`run_summary`)."""

    FLOPS_SOURCE = "torch.utils.flop_counter"

    def __init__(self, flops_per_step: Optional[float], peak: Optional[float], device=None,
                 reason: Optional[str] = None, peak_hbm: Optional[float] = None):
        self.flops_per_step = flops_per_step
        self.peak = peak
        self.peak_hbm = peak_hbm
        self.device = device
        self.reason = reason
        self.pad_waste: Optional[Dict[str, Any]] = None
        self.conv_traffic: Optional[Dict[str, Any]] = None
        self._mfus: List[float] = []
        self._peak_mem: Optional[int] = None

    @classmethod
    def from_model(cls, model, batch, compute_dtype: Optional[torch.dtype] = None):
        """Count one step's FLOPs on ``batch`` (on the model's device)."""
        device = next(model.parameters()).device
        flops = step_flops(model, batch.to(device), compute_dtype)
        return cls(float(flops) if flops else None, peak_flops(device), device=device,
                   reason=None if flops else "no_dense_products", peak_hbm=peak_hbm_bw(device))

    @classmethod
    def disabled(cls, reason: str = "disabled"):
        return cls(None, None, reason=reason)

    @property
    def available(self) -> bool:
        return self.flops_per_step is not None

    def set_conv_traffic(self, pad_waste: Optional[Dict[str, Any]], conv_traffic: Optional[Dict[str, Any]]) -> None:
        self.pad_waste = pad_waste
        self.conv_traffic = conv_traffic

    def manifest(self) -> Dict[str, Any]:
        """The ``run_start`` ``hw_cost`` block."""
        out: Dict[str, Any] = {"available": self.available}
        if not self.available and self.reason:
            out["reason"] = self.reason
        if self.flops_per_step is not None:
            out["flops_per_step"] = self.flops_per_step
            out["flops_source"] = self.FLOPS_SOURCE
        out["peak_dtype"] = "bf16"
        out["peak_bf16_tflops"] = round(self.peak / 1e12, 1) if self.peak else None
        out["peak_hbm_gbps"] = round(self.peak_hbm / 1e9, 1) if self.peak_hbm else None
        if self.pad_waste is not None:
            out["pad_waste"] = self.pad_waste
        if self.conv_traffic is not None:
            out["conv_traffic"] = self.conv_traffic
        return out

    def epoch_record(self, steps: int, wall_s: float) -> Dict[str, Any]:
        """One epoch's achieved TFLOP/s and MFU over its train wall time
        (data waits and dispatch gaps count against it) and the memory
        watermark."""
        out: Dict[str, Any] = {"available": self.available}
        if not self.available and self.reason:
            out["reason"] = self.reason
        out["steps"] = int(steps)
        out["train_wall_s"] = round(float(wall_s), 6)
        if self.available and steps > 0 and wall_s > 0:
            achieved = self.flops_per_step * steps / wall_s
            out["achieved_tflops"] = round(achieved / 1e12, 9)
            if self.peak:
                mfu = achieved / self.peak
                out["mfu"] = round(mfu, 6)
                self._mfus.append(mfu)
            else:
                out["mfu"] = None
        mem = device_memory_stats(self.device)
        out["memory"] = mem
        if mem.get("peak_bytes_in_use") is not None:
            self._peak_mem = max(self._peak_mem or 0, mem["peak_bytes_in_use"])
        return out

    def run_summary(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"available": self.available}
        if self._mfus:
            out["mfu_mean"] = round(float(np.mean(self._mfus)), 6)
            out["mfu_max"] = round(float(np.max(self._mfus)), 6)
        if self._peak_mem is not None:
            out["peak_bytes_in_use"] = self._peak_mem
        return out


# ---------------------------------------------------------------------------
# flight-record series and anomaly heuristics (numpy only)
# ---------------------------------------------------------------------------


def collect_head_series(events: List[dict]) -> Dict[str, Any]:
    """Per-head trajectories from a flight record's epoch events: losses
    (positional lists and name-keyed dicts), sampled gradient norms,
    cosine matrices, MAE and RMSE, update ratios; None where an epoch
    carried no sample."""
    epochs = [e for e in events if e.get("kind") == "epoch"]
    names: List[str] = []
    for e in epochs:
        heads = e.get("heads") or {}
        if heads.get("names"):
            names = list(heads["names"])
            break
        tt = e.get("train_tasks")
        if isinstance(tt, dict) and not names:
            names = list(tt)
    if not names and epochs:
        tt = epochs[0].get("train_tasks")
        if isinstance(tt, list):
            names = [f"task{i}" for i in range(len(tt))]
    series: Dict[str, Any] = {
        "names": names,
        "epochs": [e.get("epoch") for e in epochs],
        "train_loss": {n: [] for n in names},
        "grad_norm": {n: [] for n in names},
        "mae": {n: [] for n in names},
        "rmse": {n: [] for n in names},
        "cosine": [],
        "update_ratio": [],
    }

    def _per_head(container, key) -> Dict[str, Optional[float]]:
        val = (container or {}).get(key)
        if isinstance(val, dict):
            return {n: val.get(n) for n in names}
        if isinstance(val, list):
            return {n: (val[i] if i < len(val) else None) for i, n in enumerate(names)}
        return {n: None for n in names}

    for e in epochs:
        heads = e.get("heads") or {}
        tl = _per_head(e, "train_tasks")
        gn = _per_head(heads, "grad_norm")
        mae = _per_head(heads, "mae")
        rmse = _per_head(heads, "rmse")
        for n in names:
            series["train_loss"][n].append(tl[n])
            series["grad_norm"][n].append(gn[n])
            series["mae"][n].append(mae[n])
            series["rmse"][n].append(rmse[n])
        series["cosine"].append(heads.get("cosine"))
        series["update_ratio"].append(heads.get("update_ratio"))
    return series


def flag_anomalies(
    series: Dict[str, Any],
    spike_factor: float = 3.0,
    imbalance_factor: float = 10.0,
    negative_persistence: float = 0.5,
) -> List[str]:
    """Readable flags over :func:`collect_head_series`, empty when the
    multi-task optimisation looks healthy: a loss spike (a head's train
    loss over ``spike_factor`` x the median of its previous up to 5
    epochs), a task conflict (a pair's cosine negative in more than
    ``negative_persistence`` of the sampled epochs with a mean below
    -0.02), a gradient imbalance (largest over smallest mean head
    gradient norm above ``imbalance_factor``)."""
    flags: List[str] = []
    names = series.get("names") or []
    for n in names:
        losses = series["train_loss"].get(n) or []
        for i in range(1, len(losses)):
            cur = losses[i]
            window = [v for v in losses[max(0, i - 5) : i] if v is not None]
            if cur is None or not window:
                continue
            med = float(np.median(window))
            if med > 0 and cur > spike_factor * med:
                flags.append(
                    f"loss spike: head '{n}' epoch {series['epochs'][i]} "
                    f"train loss {cur:.4g} > {spike_factor:g}x rolling "
                    f"median {med:.4g}"
                )
    mats = [np.asarray(m, np.float64) for m in series.get("cosine") or [] if m is not None]
    if mats:
        h = len(names)
        for i in range(h):
            for j in range(i + 1, h):
                vals = np.asarray([m[i, j] for m in mats if m.shape == (h, h)])
                if vals.size >= 2 and (vals < 0).mean() > negative_persistence and vals.mean() < -0.02:
                    flags.append(
                        f"task conflict: heads '{names[i]}' vs "
                        f"'{names[j]}' gradient cosine negative in "
                        f"{int((vals < 0).sum())}/{vals.size} sampled epochs "
                        f"(mean {vals.mean():+.3f})"
                    )
    means = {}
    for n in names:
        gn = [v for v in (series["grad_norm"].get(n) or []) if v is not None]
        if gn:
            means[n] = float(np.mean(gn))
    if len(means) >= 2:
        hi = max(means, key=means.get)
        lo = min(means, key=means.get)
        if means[lo] > 0 and means[hi] / means[lo] > imbalance_factor:
            flags.append(
                f"gradient imbalance: head '{hi}' mean grad norm "
                f"{means[hi]:.4g} is {means[hi] / means[lo]:.1f}x head "
                f"'{lo}' ({means[lo]:.4g}) — exceeds {imbalance_factor:g}x"
            )
    return flags
