"""The training loop's records on the port against the JAX package's:
``metrics.jsonl``, the tensorboard scalars, the timers, ``setup_log``,
the peak-memory print, and the ``Profile`` section's trace.

Tolerances and why:
  - ``metrics.jsonl``, the two loops from one init
    (``test_torch_train_loop.py``'s ``_both_flagship``/``_run_both``): the
    same keys, epochs and head names; the losses within the loop's own
    tolerances, ``LOSS_RTOL`` (1e-4) for every epoch under SGD, and under
    AdamW 1e-4 for epoch 0 and ``ADAM_LATER_RTOL`` (1e-2) after it, train
    losses only (that file's docstring says why the eval losses part
    under AdamW); the learning rate equal as float32 (optax keeps it in
    float32, torch in float64);
  - the event files: the same tags on both sides, and every value equal,
    as float32, to its own run's ``metrics.jsonl`` number (a scalar event
    stores float32);
  - the ``Profile`` run against the same run without it, both per-step:
    bit-equal histories.
"""

import json
import os

import numpy as np
import pytest

from hydragnn_tpu.utils import print_utils as j_print
from hydragnn_tpu.utils import time_utils as j_time

from hydragnn_tpu_torch.data.ingest import prepare_dataset
from hydragnn_tpu_torch.data.loader import GraphLoader
from hydragnn_tpu_torch.data.synthetic import deterministic_graph_data
from hydragnn_tpu_torch.flagship import flagship_config
from hydragnn_tpu_torch.models.create import create_model_config
from hydragnn_tpu_torch.train import loop as t_loop
from hydragnn_tpu_torch.train.optimizer import select_optimizer
from hydragnn_tpu_torch.utils import print_utils as t_print
from hydragnn_tpu_torch.utils import time_utils as t_time
from hydragnn_tpu_torch.utils.checkpoint import load_existing_model_config
from hydragnn_tpu_torch.utils.config import update_config

from test_torch_conv_stacks import one_thread  # noqa: F401
from test_torch_parallel_cases import two_process_worker
from test_torch_train_loop import ADAM_LATER_RTOL, LOSS_RTOL, _both_flagship, _run_both, _splits

KEYS = ["epoch", "train_loss", "val_loss", "test_loss", "lr", "train_tasks", "val_tasks"]
SCALAR_TAGS = {"train error": "train_loss", "validate error": "val_loss", "test error": "test_loss"}


def _metrics(path):
    with open(os.path.join(path, "metrics.jsonl")) as f:
        return [json.loads(ln) for ln in f]


def _column(records, key):
    """[epochs] of a loss, or [epochs, heads] of a per-task dict."""
    return np.array([list(r[key].values()) if isinstance(r[key], dict) else r[key] for r in records])


def _scalars(path):
    """{tag: [(step, value)]} of the event files under ``path``."""
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(path)
    acc.Reload()
    return {tag: [(e.step, e.value) for e in acc.Scalars(tag)] for tag in acc.Tags()["scalars"]}


def _both_runs(tmp_path, opt_type):
    lr = 0.05 if opt_type == "SGD" else 1e-3
    jax_side, port_side = _both_flagship(optimizer={"type": opt_type, "learning_rate": lr})
    j_time.reset_timers()
    t_time.reset_timers()
    jhist, hist, _, _ = _run_both(jax_side, port_side, tmp_path)
    return jhist, hist


@pytest.mark.parametrize("opt_type", ["SGD", "AdamW"])
def test_metrics_jsonl_and_event_files_match_jax(opt_type, tmp_path, one_thread):
    jhist, hist = _both_runs(tmp_path, opt_type)
    ours, ref = _metrics(tmp_path / "port" / "run"), _metrics(tmp_path / "jax" / "run")
    assert len(ours) == len(ref) == 3
    for a, b in zip(ours, ref):
        assert list(a) == KEYS and list(b) == KEYS
        assert a["epoch"] == b["epoch"]
        assert list(a["train_tasks"]) == list(b["train_tasks"]) == ["sum_x_x2_x3", "x", "x2", "x3"]
        assert list(a["val_tasks"]) == list(b["val_tasks"])
        assert np.float32(a["lr"]) == np.float32(b["lr"])
    keys = ["train_loss", "train_tasks"] + (["val_loss", "test_loss", "val_tasks"] if opt_type == "SGD" else [])
    for key in keys:
        got, want = _column(ours, key), _column(ref, key)
        if opt_type == "SGD":
            np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, err_msg=key)
        else:  # Adam's trajectories part at a flipped tie (test_torch_train_loop.py)
            np.testing.assert_allclose(got[0], want[0], rtol=LOSS_RTOL, err_msg=key)
            np.testing.assert_allclose(got[1:], want[1:], rtol=ADAM_LATER_RTOL, err_msg=key)
    # each side's record is its own history
    for rec, h in ((ours, hist), (ref, jhist)):
        assert [r["train_loss"] for r in rec] == list(h["train_loss"])
        assert [r["val_loss"] for r in rec] == list(h["val_loss"])
    assert set(t_time.timers_snapshot()) == set(j_time.timers_snapshot()) == {"train_validate_test"}

    pytest.importorskip("tensorboard", reason="the event files are read with the tensorboard package")
    ev_ours, ev_ref = _scalars(str(tmp_path / "port" / "run")), _scalars(str(tmp_path / "jax" / "run"))
    heads = list(ours[0]["train_tasks"])
    tags = set(SCALAR_TAGS) | {f"heads/{h}/{k}" for h in heads for k in ("train_loss", "val_loss")}
    # beside the records, the port's telemetry (on by default) writes the
    # step spans, the per-head diagnostics and MAE/RMSE, the update ratio
    # and the ledger's rate; the JAX side runs its scan epoch (no step
    # spans) with its diagnostics off (tests/conftest.py)
    telemetry = {t for t in ev_ours if t.startswith("obs/") or t.rsplit("/", 1)[-1] in ("grad_norm", "mae", "rmse")}
    spans = {f"obs/step_time/{k}" for k in ("steps", "process_index", "process_count", "data_wait_s", "dispatch_s",
                                             "first_step_s", "sampled_steps", "device_wait_ms_mean",
                                             "sync_step_ms_mean")}
    diagnostics = {f"heads/{h}/{k}" for h in heads for k in ("grad_norm", "mae", "rmse")}
    assert telemetry == spans | diagnostics | {"obs/update_ratio", "obs/hw/achieved_tflops"}
    assert set(ev_ours) - telemetry == set(ev_ref) == tags
    for events, rec in ((ev_ours, ours), (ev_ref, ref)):
        for tag, steps in events.items():
            if tag in telemetry:
                continue
            if tag in SCALAR_TAGS:
                want = [r[SCALAR_TAGS[tag]] for r in rec]
            else:
                _, head, kind = tag.split("/")
                want = [r[kind.replace("loss", "tasks")][head] for r in rec]
            assert [s for s, _ in steps] == [r["epoch"] for r in rec]
            np.testing.assert_array_equal(np.float32([v for _, v in steps]), np.float32(want), err_msg=tag)


def _flagship_splits(n, batch, epochs, **training):
    """The port's flagship at hidden 16, 2 layers, prepared, with
    ``training`` keys set."""
    tr, va, te, cfg = _splits(deterministic_graph_data, prepare_dataset, update_config,
                              flagship_config(16, 2, batch, epochs), n)
    cfg["NeuralNetwork"]["Training"].update(training)
    return tr, va, te, cfg


def _port_run(splits, log_dir, profile=None, resume=False, **training):
    """The port's loop on ``splits`` from the seeded init (or, with
    ``resume``, from the run's checkpoint), logging under ``log_dir/run``."""
    tr, va, te, cfg = splits
    nn = json.loads(json.dumps(cfg["NeuralNetwork"]))
    nn["Training"].update(training)
    if profile is not None:
        nn["Profile"] = profile
    bs = int(nn["Training"]["batch_size"])
    model = create_model_config(nn, seed=0, device="cpu")
    optimizer = select_optimizer(model, nn["Training"])
    if resume:
        load_existing_model_config(model, nn["Training"], str(log_dir) + "/", optimizer=optimizer)
    loaders = [GraphLoader(tr, bs, shuffle=True), GraphLoader(va, bs), GraphLoader(te, bs)]
    return t_loop.train_validate_test(model, optimizer, *loaders, nn, log_dir=str(log_dir) + "/")


def _traces(log_dir):
    path = os.path.join(str(log_dir), "run", "profile")
    return sorted(os.listdir(path)) if os.path.isdir(path) else []


def test_profile_writes_one_trace_at_its_epoch_and_changes_no_number(tmp_path, one_thread):
    """An epoch of 12 steps (96 train graphs at batch 8) traces steps 9-11
    into one Chrome trace; a target epoch past the run traces nothing; the
    histories are bit-equal with the profiler, without it, and with it
    aimed past the run (all per-step)."""
    splits = _flagship_splits(120, 8, 2, scan_epoch=False)
    assert len(splits[0]) // 8 >= 11
    plain = _port_run(splits, tmp_path / "plain")
    traced = _port_run(splits, tmp_path / "traced", {"enable": 1, "target_epoch": 0})
    missed = _port_run(splits, tmp_path / "missed", {"enable": 1, "target_epoch": 5})
    assert _traces(tmp_path / "traced") == ["epoch0.pt.trace.json"]
    assert _traces(tmp_path / "missed") == [] and _traces(tmp_path / "plain") == []
    with open(os.path.join(str(tmp_path / "traced"), "run", "profile", "epoch0.pt.trace.json")) as f:
        assert json.load(f)["traceEvents"]
    for hist in (traced, missed):
        assert hist["dispatch_mode"]["mode"] == plain["dispatch_mode"]["mode"] == "per_step"
        for key in t_loop.EPOCH_KEYS:
            assert hist[key] == plain[key], key


class _StubProfile:
    """torch.profiler's ``profile`` as the card's machine gives it where
    CUPTI cannot start (CPU events only) or can (one kernel event)."""

    def __init__(self, device_events, activities):
        self.device_events, self.activities = device_events, activities

    def start(self):
        pass

    def stop(self):
        pass

    @property
    def profiler(self):
        """The raw results, as ``profiler.kineto_results.events()`` gives
        them: events with a ``device_type()``."""
        import types

        import torch

        kinds = [torch.autograd.DeviceType.CPU] + [torch.autograd.DeviceType.CUDA] * self.device_events
        events = [types.SimpleNamespace(device_type=lambda k=k: k) for k in kinds]
        return types.SimpleNamespace(kineto_results=types.SimpleNamespace(events=lambda: events))

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump({"traceEvents": []}, f)


@pytest.mark.parametrize("device_events", [0, 1])
def test_profile_on_the_card_raises_when_the_capture_recorded_no_device_activity(device_events, tmp_path,
                                                                                   monkeypatch):
    """A run on the card whose capture recorded no CUDA events (CUPTI did
    not start; torch.profiler only warns) raises and writes no trace; one
    with a kernel event writes its trace. The capture asks for CUDA
    activity on the card only."""
    import torch

    from hydragnn_tpu_torch.utils import profile as t_profile

    made = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(t_profile, "profile",
                        lambda activities: made.append(_StubProfile(device_events, activities)) or made[-1])
    prof = t_profile.Profiler(str(tmp_path / "profile"), {"enable": 1, "target_epoch": 0}, "cuda")
    prof.set_current_epoch(0)
    for _ in range(t_profile.WAIT + t_profile.WARMUP + t_profile.ACTIVE - 1):
        prof.step()
    assert len(made) == 1 and torch.profiler.ProfilerActivity.CUDA in made[0].activities
    if device_events:
        prof.step()
        assert os.listdir(tmp_path / "profile") == ["epoch0.pt.trace.json"]
    else:
        with pytest.raises(RuntimeError, match="no CUDA activity"):
            prof.step()
        assert not os.path.exists(tmp_path / "profile")
    assert prof.done
    cpu = t_profile.Profiler(str(tmp_path / "cpu"), {"enable": "1"}, "cpu")
    cpu.set_current_epoch(0)
    for _ in range(t_profile.WAIT + t_profile.WARMUP):
        cpu.step()
    assert made[-1].activities == [torch.profiler.ProfilerActivity.CPU]
    cpu._stop()  # the capture holds the process's one profiler slot until it stops


def test_metrics_jsonl_is_appended_across_a_resume(tmp_path, one_thread):
    """2 epochs with a checkpoint each, then ``continue`` to 4: one line an
    epoch, 0-3, the resumed lines equal to the resumed history."""
    splits = _flagship_splits(48, 8, 2, checkpoint_every=1)
    first = _port_run(splits, tmp_path)
    second = _port_run(splits, tmp_path, resume=True, num_epoch=4, startfrom="run", **{"continue": 1})
    lines = _metrics(tmp_path / "run")
    assert [r["epoch"] for r in lines] == [0, 1, 2, 3]
    assert [r["train_loss"] for r in lines] == second["train_loss"]
    assert second["train_loss"][:2] == first["train_loss"]


def test_timers_match_jax():
    """The same calls on both packages' timers: the shared registry by
    name, the errors, ``stop_if_running``, the context manager,
    ``timers_snapshot`` and ``print_timers``."""
    results = []
    for mod in (j_time, t_time):
        mod.reset_timers()
        a = mod.Timer("a")
        a.start()
        with pytest.raises(RuntimeError):
            mod.Timer("a").start()  # the same stopwatch, already running
        mod.Timer("a").stop()
        with pytest.raises(RuntimeError):
            a.stop()
        a.stop_if_running()  # not running: nothing
        with mod.Timer("b"):
            pass
        b = mod.Timer("b")
        b.start()
        snap_running = mod.timers_snapshot()
        b.stop_if_running()
        snap = mod.timers_snapshot()
        stats = mod.print_timers(0)
        for k, v in stats.items():  # one process: min = max = mean = its own elapsed time
            assert v["min"] == v["max"] == v["avg"] and abs(v["avg"] - snap[k]["elapsed_s"]) <= 1e-6
        results.append(({k: v["count"] for k, v in snap_running.items()}, {k: v["count"] for k, v in snap.items()},
                        {k: sorted(v) for k, v in stats.items()}))
        mod.reset_timers()
        assert mod.timers_snapshot() == {}
    assert results[0] == results[1]
    assert results[1][1] == {"a": 1, "b": 2}


def test_peak_memory_is_none_on_the_cpu_and_setup_log_paths_match(tmp_path):
    assert t_print.print_peak_memory(2, "epoch 0", device="cpu") is None
    assert j_print.print_peak_memory(2, "epoch 0") is None
    j_print.setup_log("runx", str(tmp_path / "jax"))
    t_print.setup_log("runx", str(tmp_path / "port"))
    ours = sorted(os.path.relpath(os.path.join(r, f), tmp_path / "port") for r, _, fs in os.walk(tmp_path / "port")
                  for f in fs)
    ref = sorted(os.path.relpath(os.path.join(r, f), tmp_path / "jax") for r, _, fs in os.walk(tmp_path / "jax")
                 for f in fs)
    assert ours == ref == [os.path.join("runx", "run.log")]
    t_print.log("hello")
    with open(tmp_path / "port" / "runx" / "run.log") as f:
        assert f.read().rstrip().endswith("hello")


def test_two_gloo_processes_reduce_the_timers(tmp_path):
    """``setup_distributed`` from torchrun's environment on two CPU
    processes (gloo): (2, rank) each; ``print_timers`` gives both the min,
    max and mean of the two ranks' elapsed times; the examples' training
    trains one model over the group (equal losses and parameters on both
    ranks, each rank on its sub-batch, one checkpoint written by rank 0)."""
    import multiprocessing
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=two_process_worker, args=(r, port, str(tmp_path))) for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=120)
    assert not any(p.is_alive() for p in procs) and all(p.exitcode == 0 for p in procs)
    seen = [json.load(open(tmp_path / f"rank{r}.json")) for r in range(2)]
    owns = [s["own"] for s in seen]
    for rank, s in enumerate(seen):
        assert s["world"] == s["again"] == [2, rank] and s["print_rank"] == rank
        assert s["backend"] == "gloo" and s["trained"]["stack"] == 2 and s["trained"]["stack_rank"] == rank
        assert s["trained"]["train_loss"] == seen[0]["trained"]["train_loss"]
        assert s["trained"]["param"] == seen[0]["trained"]["param"]
        assert s["stats"]["min"] == pytest.approx(min(owns), abs=1e-6)
        assert s["stats"]["max"] == pytest.approx(max(owns), abs=1e-6)
        assert s["stats"]["avg"] == pytest.approx(sum(owns) / 2, abs=1e-6)
    assert owns[1] > owns[0]
    (run,) = os.listdir(tmp_path / "logs")
    assert [f for f in os.listdir(tmp_path / "logs" / run) if f.endswith(".pt")] == [f"{run}.pt"]
