"""The training loop's telemetry in the port (``hydragnn_tpu_torch/train/loop.py``
with ``hydragnn_tpu_torch/obs``), held to the JAX package's record of the
same run.

The flagship at hidden 8, 2 conv layers, batch 5 on 20 BCC graphs
(seed 0) trains on the CPU through ``run_training``. Its flight record
must pass the JAX package's ``validate_flight_record(...,
require_complete=True)`` and ``tools/obs_report.py --validate
--require-complete``; its manifest, epoch and ``run_end`` keys must cover
those of the JAX loop's record of the same config (per-step dispatch,
diagnostics on), except ``preempt_handler`` (preemption waits for
ROADMAP A-7); ``compiles.available`` is false (the port compiles nothing).
Telemetry must not change training: with it on (diagnostics, triggers, an
injected incident, ``train.prom``) the history and parameters are bit for
bit those of ``HGTORCH_TELEMETRY=0``.
"""

import glob
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from hydragnn_tpu.obs.flight import read_flight_record as jax_read_flight_record
from hydragnn_tpu.obs.flight import validate_flight_record as jax_validate_flight_record

from hydragnn_tpu_torch.obs import read_flight_record, reset_registry, validate_flight_record
from hydragnn_tpu_torch.resilience import inject
from hydragnn_tpu_torch.train.loop import EPOCH_KEYS
from hydragnn_tpu_torch.utils import profile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UNIT = dict(unit_cell_x_range=(2, 3), unit_cell_y_range=(2, 3), unit_cell_z_range=(2, 3))
HEADS = ["sum_x_x2_x3", "x", "x2", "x3"]
# manifest keys of the JAX record the port has no counterpart for yet
NOT_PORTED = {"preempt_handler"}


def _config(mod, epochs=2, **training):
    cfg = mod.flagship_config(hidden_dim=8, num_conv_layers=2, batch_size=5, num_epoch=epochs)
    cfg["NeuralNetwork"]["Training"].update(training)
    return cfg


def _port_run(log_dir, epochs=2, **training):
    from hydragnn_tpu_torch import flagship
    from hydragnn_tpu_torch.api import run_training
    from hydragnn_tpu_torch.data.synthetic import deterministic_graph_data

    samples = deterministic_graph_data(number_configurations=20, seed=0, **UNIT)
    return run_training(_config(flagship, epochs, **training), samples=samples, log_dir=log_dir, device="cpu")


def _flight(log_dir):
    (path,) = glob.glob(os.path.join(log_dir, "*", "flight.jsonl"))
    return path


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """The port's record (default dispatch: fixed epoch) and the JAX
    package's (per-step, diagnostics on) of the same config."""
    from hydragnn_tpu import flagship as jax_flagship
    from hydragnn_tpu.api import run_training as jax_run_training
    from hydragnn_tpu.data.synthetic import deterministic_graph_data as jax_data

    port_dir = str(tmp_path_factory.mktemp("port")) + "/"
    _port_run(port_dir)
    jax_dir = str(tmp_path_factory.mktemp("jax")) + "/"
    old = os.environ.get("HYDRAGNN_DIAGNOSTICS")
    os.environ["HYDRAGNN_DIAGNOSTICS"] = "1"
    try:
        jax_run_training(_config(jax_flagship, scan_epoch=False),
                         samples=jax_data(number_configurations=20, seed=0, **UNIT), log_dir=jax_dir)
    finally:
        if old is None:
            os.environ.pop("HYDRAGNN_DIAGNOSTICS")
        else:
            os.environ["HYDRAGNN_DIAGNOSTICS"] = old
    return _flight(port_dir), _flight(jax_dir)


def _by_kind(events, kind):
    return [e for e in events if e["kind"] == kind]


def test_the_flight_record_passes_the_jax_validators(records):
    port_path, _ = records
    assert jax_validate_flight_record(port_path, require_complete=True) == []
    assert validate_flight_record(port_path, require_complete=True) == []
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, os.path.join(REPO, "tools", "obs_report.py"), "--validate",
                          "--require-complete", port_path], capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert len(jax_read_flight_record(port_path)) == len(read_flight_record(port_path))


def test_the_keys_cover_the_jax_record(records):
    port_path, jax_path = records
    port, jx = read_flight_record(port_path), jax_read_flight_record(jax_path)
    man, jman = _by_kind(port, "run_start")[0]["manifest"], _by_kind(jx, "run_start")[0]["manifest"]
    assert set(jman) - NOT_PORTED <= set(man), set(jman) - set(man)
    assert "NeuralNetwork" in man["config"] and "Dataset" in man["config"]
    assert man["backend"] == "cpu" and "jax_version" in man and man["num_processes"] == 1
    assert man["pad_plans"]["train"]["pad_nodes"] > 0 and man["mesh"]["process_count"] == 1
    assert man["head_names"] == HEADS == jman["head_names"]
    assert man["diagnostics"] == {"enabled": True, "diag_every": man["pad_plans"]["train"]["num_batches"]}
    assert man["hw_cost"]["available"] and man["hw_cost"]["flops_per_step"] > 0
    assert man["hw_cost"]["flops_source"] == "torch.utils.flop_counter" and man["hw_cost"]["peak_dtype"] == "bf16"
    assert man["stats"]["schema"] == jman["stats"]["schema"] and set(man["stats"]["heads"]) == set(HEADS)
    assert man["dispatch_mode"]["mode"] == "fixed_epoch" and man["scan_epoch"] is True
    # the partitioner's block with JAX's keys: a single-device run here
    assert set(jman["parallel"]) <= set(man["parallel"]), set(jman["parallel"]) - set(man["parallel"])
    assert man["parallel"]["available"] is True and man["parallel"]["single_device"] is True
    assert man["parallel"]["mesh"] is None and man["parallel"]["params"]["leaves"] > 0
    assert man["graftcheck"]["available"] is False
    # the pod identity, a single host here, as the JAX loop writes it
    assert man["podview"] == jman["podview"] and man["podview"]["enabled"] is False and man["card"] is None
    assert man["compile_monitor_available"] is False

    epochs, jepochs = _by_kind(port, "epoch"), _by_kind(jx, "epoch")
    assert len(epochs) == len(jepochs) == 2
    for ep, jep in zip(epochs, jepochs):
        assert set(jep) <= set(ep), set(jep) - set(ep)
        assert set(jep["step_time"]) <= set(ep["step_time"])
        assert ep["step_time"]["mode"] == "fixed_epoch" and ep["step_time"]["sampled_steps"] == 3
        assert set(ep["train_tasks"]) == set(ep["val_tasks"]) == set(ep["test_tasks"]) == set(HEADS)
        assert ep["compiles"] == {"available": False, "count": 0, "unexpected": False}
        heads, jheads = ep["heads"], jep["heads"]
        assert set(jheads) <= set(heads) and heads["available"]
        assert set(heads["grad_norm"]) == set(heads["mae"]) == set(heads["rmse"]) == set(HEADS)
        assert all(np.isfinite(v) for v in heads["grad_norm"].values())
        cos = heads["cosine"]
        assert len(cos) == 4 and all(len(r) == 4 for r in cos) and all(abs(cos[i][i] - 1) < 1e-5 for i in range(4))
        assert set(jep["hw"]) <= set(ep["hw"]) and set(jep["hw"]["memory"]) <= set(ep["hw"]["memory"])
        assert ep["hw"]["achieved_tflops"] > 0 and ep["hw"]["mfu"] is None
    end, jend = _by_kind(port, "run_end")[0], _by_kind(jx, "run_end")[0]
    assert set(jend) <= set(end), set(jend) - set(end)
    assert end["status"] == "completed" and end["epochs"] == 2
    assert "train_validate_test" in end["timers"] and end["hw"]["available"] and end["triggers"] is None
    assert end["compiles"]["available"] is False and "reason" in end["compiles"]


def test_heads_mae_rmse_are_the_test_pass_metrics(tmp_path):
    """The epoch's ``heads.mae``/``rmse`` recomputed from the test pass of
    the returned model (one epoch, no BatchNorm recalibration, so the
    weights are those the epoch's test pass saw)."""
    from hydragnn_tpu_torch.obs.introspect import per_head_error_metrics
    from hydragnn_tpu_torch.api import prepare_loaders_and_config
    from hydragnn_tpu_torch import flagship
    from hydragnn_tpu_torch.data.synthetic import deterministic_graph_data
    from hydragnn_tpu_torch.train.loop import test_epoch

    log_dir = str(tmp_path) + "/"
    model, _, _, done = _port_run(log_dir, epochs=1, bn_recalibration=False)
    _, _, test_loader, _ = prepare_loaders_and_config(
        _config(flagship, 1, bn_recalibration=False),
        deterministic_graph_data(number_configurations=20, seed=0, **UNIT))
    _, _, tv, pv = test_epoch(test_loader, model)
    want = per_head_error_metrics(tv, pv, HEADS)
    (ep,) = _by_kind(read_flight_record(_flight(log_dir)), "epoch")
    assert ep["heads"]["mae"] == {n: m["mae"] for n, m in want.items()}
    assert ep["heads"]["rmse"] == {n: m["rmse"] for n, m in want.items()}


@pytest.mark.parametrize("dispatch", ["per_step", "fixed_epoch"])
def test_telemetry_is_invisible_to_training(tmp_path, monkeypatch, dispatch):
    """Telemetry on (diagnostics, triggers with an injected incident,
    ``train.prom``) against ``HGTORCH_TELEMETRY=0``: history and
    parameters bit-equal; the on run's step spans name its mode."""
    training = dict(scan_epoch=dispatch == "fixed_epoch", slo_triggers=True,
                    prometheus_dir=str(tmp_path / "prom"))
    runs = {}
    for label, env in (("on", "1"), ("off", "0")):
        monkeypatch.setenv("HGTORCH_TELEMETRY", env)
        monkeypatch.setenv("HGTORCH_INJECT_TRIGGER", "train_loss_spike")
        inject.TRIGGER.reset()
        reset_registry()
        try:
            runs[label] = _port_run(str(tmp_path / label) + "/", epochs=3, **training)
        finally:
            inject.TRIGGER.reset()
            reset_registry()
    (m_on, o_on, h_on, _), (m_off, o_off, h_off, _) = runs["on"], runs["off"]
    for key in EPOCH_KEYS:
        assert h_on[key] == h_off[key], key
    for a, b in zip(list(m_on.state_dict().values()) + o_on.state_tensors(),
                    list(m_off.state_dict().values()) + o_off.state_tensors()):
        assert torch.equal(a, b)
    assert glob.glob(str(tmp_path / "off" / "*" / "flight.jsonl")) == []
    assert glob.glob(str(tmp_path / "off" / "*" / "incidents")) == []
    events = read_flight_record(_flight(str(tmp_path / "on")))
    epochs = _by_kind(events, "epoch")
    assert [e["step_time"]["mode"] for e in epochs] == [dispatch] * 3
    # the incident opened at epoch 0's end captures in epoch 1, which
    # samples no device wait while the capture is live
    assert [e["step_time"]["sampled_steps"] for e in epochs] == [3, 1, 3]
    assert [e["rule"] for e in _by_kind(events, "incident")] == ["train_loss_spike"]
    assert not profile.capture_active()


def test_the_prometheus_textfile_is_written_each_epoch(tmp_path, monkeypatch):
    reset_registry()
    prom = tmp_path / "prom"
    _, _, hist, _ = _port_run(str(tmp_path) + "/", prometheus_dir=str(prom))
    values = {}
    for ln in (prom / "train.prom").read_text().splitlines():
        if ln and not ln.startswith("#"):
            name, value = ln.rsplit(" ", 1)
            values[name] = float(value)
    assert values['hydragnn_train_loss{rank="0"}'] == hist["train_loss"][-1]
    assert values['hydragnn_train_epoch{rank="0"}'] == 1
    assert all(f'hydragnn_train_head_{n}_grad_norm{{rank="0"}}' in values for n in HEADS)
    assert not list(prom.glob("*.tmp*"))
    reset_registry()


class _RaiseAt:
    """A train loader that raises in epoch 1 after two batches."""

    def __init__(self, inner):
        self.inner, self._epoch = inner, 0

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def __len__(self):
        return len(self.inner)

    def set_epoch(self, epoch):
        self._epoch = epoch
        self.inner.set_epoch(epoch)

    def __iter__(self):
        for i, b in enumerate(self.inner):
            if self._epoch == 1 and i == 2:
                raise RuntimeError("loader fault")
            yield b


def test_a_crash_leaves_error_and_a_failed_run_end(tmp_path):
    from hydragnn_tpu_torch import flagship
    from hydragnn_tpu_torch.api import prepare_loaders_and_config, train_with_loaders
    from hydragnn_tpu_torch.data.synthetic import deterministic_graph_data

    tl, vl, tel, done = prepare_loaders_and_config(
        _config(flagship, 3, scan_epoch=False), deterministic_graph_data(number_configurations=20, seed=0, **UNIT))
    log_dir = str(tmp_path) + "/"
    with pytest.raises(RuntimeError, match="loader fault"):
        train_with_loaders(done, _RaiseAt(tl), vl, tel, log_dir=log_dir, device="cpu")
    path = _flight(log_dir)
    events = read_flight_record(path)
    assert [e["kind"] for e in events][-2:] == ["error", "run_end"]
    err, end = events[-2], events[-1]
    assert err["error_type"] == "RuntimeError" and "loader fault" in err["error"]
    assert end["status"] == "failed" and end["epochs"] == 1
    assert jax_validate_flight_record(path) == [] == validate_flight_record(path)
    # epoch 0 finished before the fault: the failed run still has the complete shape
    assert jax_validate_flight_record(path, require_complete=True) == [] == validate_flight_record(
        path, require_complete=True)


def test_a_failed_set_up_after_the_record_opens_still_ends_it(tmp_path, monkeypatch):
    """The set-up between the recorder and the first epoch (the ledger's
    count, the Visualizer, the manifest, the summary writer) is guarded
    too: a Visualizer that cannot import matplotlib leaves ``error`` and
    ``run_end{failed}``."""
    from hydragnn_tpu_torch.train import loop

    class _NoMatplotlib:
        def __init__(self, *args, **kwargs):
            raise ImportError("No module named 'matplotlib'")

    from hydragnn_tpu_torch import flagship
    from hydragnn_tpu_torch.api import run_training
    from hydragnn_tpu_torch.data.synthetic import deterministic_graph_data

    monkeypatch.setattr(loop, "Visualizer", _NoMatplotlib)
    cfg = _config(flagship)
    cfg["Visualization"] = {"create_plots": True}
    log_dir = str(tmp_path) + "/"
    with pytest.raises(ImportError, match="matplotlib"):
        run_training(cfg, samples=deterministic_graph_data(number_configurations=20, seed=0, **UNIT),
                     log_dir=log_dir, device="cpu")
    events = read_flight_record(_flight(log_dir))
    assert [e["kind"] for e in events] == ["error", "run_end"]
    err, end = events
    assert err["error_type"] == "ImportError" and "matplotlib" in err["error"]
    assert end["status"] == "failed" and end["epochs"] == 0
    assert jax_validate_flight_record(events) == [] == validate_flight_record(events)


def test_diagnostics_off_keeps_the_rest_of_the_record(tmp_path, monkeypatch):
    """``HGTORCH_DIAGNOSTICS=0`` (or ``Training.diagnostics: false``):
    no heads or hw blocks, the rest of the record as before."""
    monkeypatch.setenv("HGTORCH_DIAGNOSTICS", "0")
    _port_run(str(tmp_path / "env") + "/")
    monkeypatch.delenv("HGTORCH_DIAGNOSTICS")
    _port_run(str(tmp_path / "cfg") + "/", diagnostics=False)
    for label in ("env", "cfg"):
        events = read_flight_record(_flight(str(tmp_path / label)))
        man = _by_kind(events, "run_start")[0]["manifest"]
        assert man["diagnostics"] == {"enabled": False, "diag_every": None}
        assert man["hw_cost"] == {"available": False}
        for ep in _by_kind(events, "epoch"):
            assert "heads" not in ep and "hw" not in ep and ep["step_time"]["sampled_steps"] == 3
        assert validate_flight_record(events, require_complete=True) == []
