"""The port's training resilience against the JAX package's: in-process
preemption and resume under ``HGTORCH_INJECT_SIGTERM_STEP``/``_EPOCH``
(``HYDRAGNN_INJECT_*`` on the JAX side) from one init, the NaN injection
against the loader-wrapper poisoning of ``test_torch_train_loop.py``,
the dispatch resolution's injection and watchdog rules, the hang
watchdog, the injection list; and, in child processes (never in the test
worker), a mid-epoch SIGTERM (exit 75, then a resume), a torn checkpoint
(SIGKILL, -9, then a resume that rejects it), a stalled loader under the
watchdog (exit 79) and the supervise CLI through a preemption.

Tolerances and why:
  - the preempted-and-resumed runs' losses, JAX package against port:
    ``LOSS_RTOL`` (1e-4) under SGD, the step parity's
    (``test_torch_train_loop.py``); the epoch sequence, the meta's epoch
    and step and the flight event kinds exactly;
  - ``HGTORCH_INJECT_NAN_STEP`` against the ``_NanAt`` wrapper:
    bit-equality (the same computation);
  - the resumed child's final val loss against the uninterrupted run:
    ``rel=0.2`` after a mid-epoch stop (the stopped epoch is re-run on
    weights that took part of it) and ``rel=1e-3`` after the torn
    checkpoint, the JAX package's own bars (``tests/test_resilience.py``).
"""

import glob
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from hydragnn_tpu.data.loader import GraphLoader as JaxGraphLoader
from hydragnn_tpu.obs.flight import validate_flight_record as jax_validate
from hydragnn_tpu.resilience import PreemptionHandler as JaxPreemptionHandler
from hydragnn_tpu.resilience import TrainingPreempted as JaxTrainingPreempted
from hydragnn_tpu.resilience import inject as jax_inject
from hydragnn_tpu.train import create_train_state
from hydragnn_tpu.train import loop as jax_loop
from hydragnn_tpu.utils import checkpoint as jax_ckpt

from hydragnn_tpu_torch.data.loader import GraphLoader
from hydragnn_tpu_torch.obs.flight import FlightRecorder, read_flight_record
from hydragnn_tpu_torch.resilience import (
    EXIT_HUNG,
    EXIT_PREEMPTED,
    HangWatchdog,
    PreemptionHandler,
    TrainHooks,
    TrainingPreempted,
)
from hydragnn_tpu_torch.resilience import inject
from hydragnn_tpu_torch.train import loop as t_loop
from hydragnn_tpu_torch.utils import checkpoint as ckpt

from test_torch_conv_stacks import one_thread  # noqa: F401
from test_torch_train_loop import LOSS_RTOL, _both_flagship, _jax_state, _NanAt, _port_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAULT_KINDS = ("run_start", "epoch", "preempt", "resumed", "rollback", "watchdog", "run_end")


@pytest.fixture(autouse=True, scope="module")
def _diagnostics_off():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HGTORCH_DIAGNOSTICS", "0")
        yield


def _guarded_sigterm(real, handler_cls):
    """``maybe_sigterm`` that first asserts the loop's handler owns
    SIGTERM on the main thread, so a self-signal can never kill the
    test worker."""

    def guarded(step=None, epoch=None):
        assert threading.current_thread() is threading.main_thread()
        owner = getattr(signal.getsignal(signal.SIGTERM), "__self__", None)
        assert isinstance(owner, handler_cls), signal.getsignal(signal.SIGTERM)
        real(step=step, epoch=epoch)

    return guarded


def _kinds(path):
    return [e["kind"] for e in read_flight_record(path) if e["kind"] in FAULT_KINDS]


def _meta(path):
    with open(path) as f:
        meta = json.load(f)
    return meta["epoch"], meta["step"]


@pytest.mark.parametrize("knob,value", [("SIGTERM_STEP", "2"), ("SIGTERM_EPOCH", "1")])
def test_preempt_and_resume_in_process_match_jax(knob, value, tmp_path, monkeypatch, one_thread):
    """Both packages' loops from one init: the injected SIGTERM stops the
    run with the checkpoint and meta pair (the same epoch and step), the
    resume from it completes, and the epochs, the flight event kinds and
    the SGD losses agree."""
    assert threading.current_thread() is threading.main_thread()
    jax_side, port_side = _both_flagship(n=20, batch=5, epochs=3, optimizer={"type": "SGD", "learning_rate": 0.05},
                                         checkpoint_every=1)
    (jtr, jva, jte, jcfg), (tr, va, te, cfg) = jax_side, port_side
    monkeypatch.setattr(jax_inject, "maybe_sigterm", _guarded_sigterm(jax_inject.maybe_sigterm, JaxPreemptionHandler))
    monkeypatch.setattr(inject, "maybe_sigterm", _guarded_sigterm(inject.maybe_sigterm, PreemptionHandler))
    jdir, pdir = str(tmp_path / "jax") + "/", str(tmp_path / "port") + "/"

    def jax_run(state, cont):
        loaders = [JaxGraphLoader(jtr, 5, shuffle=True), JaxGraphLoader(jva, 5), JaxGraphLoader(jte, 5)]
        nn = dict(jcfg["NeuralNetwork"], Training=dict(jcfg["NeuralNetwork"]["Training"], **cont))
        return jax_loop.train_validate_test(jmodel, tx, state, *loaders, nn, log_dir=jdir)

    def port_run(model, optimizer, cont):
        loaders = [GraphLoader(tr, 5, shuffle=True), GraphLoader(va, 5), GraphLoader(te, 5)]
        nn = dict(cfg["NeuralNetwork"], Training=dict(cfg["NeuralNetwork"]["Training"], **cont))
        return t_loop.train_validate_test(model, optimizer, *loaders, nn, log_dir=pdir)

    jmodel, variables, tx = _jax_state(jcfg, next(iter(JaxGraphLoader(jtr, 5))))
    monkeypatch.setenv(f"HYDRAGNN_INJECT_{knob}", value)
    with pytest.raises(JaxTrainingPreempted) as jexc:
        jax_run(create_train_state(variables, tx), {})
    monkeypatch.delenv(f"HYDRAGNN_INJECT_{knob}")
    monkeypatch.setenv(f"HGTORCH_INJECT_{knob}", value)
    model, optimizer = _port_model(cfg, variables)
    with pytest.raises(TrainingPreempted) as exc:
        port_run(model, optimizer, {})
    monkeypatch.delenv(f"HGTORCH_INJECT_{knob}")
    # the handler is gone and its timer cancelled: the worker carries on
    assert signal.getsignal(signal.SIGTERM) == signal.SIG_DFL
    for timer in [t for t in threading.enumerate() if isinstance(t, threading.Timer)]:
        timer.join(2.0)  # a cancelled timer ends at once; a live one waits out its 30 s grace
        assert not timer.is_alive()
    assert (exc.value.signum, exc.value.epoch) == (jexc.value.signum, jexc.value.epoch) == (15, exc.value.epoch)
    assert _meta(os.path.join(pdir, "run", "run.meta.json")) == _meta(os.path.join(jdir, "run", "run.meta.json"))

    cont = {"continue": 1, "startfrom": "run"}
    jstate = jax_ckpt.load_existing_model(create_train_state(variables, tx), "run", jdir)
    _, jhist = jax_run(jstate, cont)
    model, optimizer = _port_model(cfg, variables)
    ckpt.load_existing_model(model, "run", pdir, optimizer=optimizer)
    hist = port_run(model, optimizer, cont)

    kinds = _kinds(os.path.join(pdir, "run", "flight.jsonl"))
    assert kinds == _kinds(os.path.join(jdir, "run", "flight.jsonl"))
    assert kinds.count("preempt") == kinds.count("resumed") == 1
    assert not jax_validate(os.path.join(pdir, "run", "flight.jsonl"))
    assert len(hist["train_loss"]) == len(jhist["train_loss"]) == 3
    for key in ("train_loss", "val_loss", "test_loss"):
        np.testing.assert_allclose(hist[key], jhist[key], rtol=LOSS_RTOL, err_msg=key)


def test_a_signal_during_evaluation_stops_after_the_epoch(tmp_path, monkeypatch, one_thread):
    """SIGTERM during epoch 1's validation pass: the epoch is complete, so
    the checkpoint says epoch 2; the resume runs epoch 2 and ends
    bit-equal to the uninterrupted run (the fixed epoch, the default)."""
    assert threading.current_thread() is threading.main_thread()
    _, (tr, va, te, cfg) = _both_flagship(n=20, batch=5, epochs=3, optimizer={"type": "SGD", "learning_rate": 0.05},
                                          checkpoint_every=1)
    from hydragnn_tpu_torch.models.create import create_model_config
    from hydragnn_tpu_torch.train.optimizer import select_optimizer

    def run(label, training, restore=False):
        model = create_model_config(cfg["NeuralNetwork"], seed=0, device="cpu")
        optimizer = select_optimizer(model, cfg["NeuralNetwork"]["Training"])
        if restore:
            ckpt.load_existing_model(model, "run", str(tmp_path / label) + "/", optimizer=optimizer)
        nn = dict(cfg["NeuralNetwork"], Training=dict(cfg["NeuralNetwork"]["Training"], **training))
        hist = t_loop.train_validate_test(model, optimizer, GraphLoader(tr, 5, shuffle=True), GraphLoader(va, 5),
                                          GraphLoader(te, 5), nn, log_dir=str(tmp_path / label) + "/")
        return hist, [t.detach().clone() for t in model.state_dict().values()]

    straight, straight_state = run("straight", {})
    real_eval, calls = t_loop.evaluate_epoch, []

    def signalling_eval(*args, **kwargs):
        calls.append(1)
        if len(calls) == 2:  # epoch 1's validation pass
            _guarded_sigterm(lambda step=None, epoch=None: os.kill(os.getpid(), signal.SIGTERM),
                             PreemptionHandler)()
        return real_eval(*args, **kwargs)

    monkeypatch.setattr(t_loop, "evaluate_epoch", signalling_eval)
    with pytest.raises(TrainingPreempted) as exc:
        run("stopped", {})
    monkeypatch.setattr(t_loop, "evaluate_epoch", real_eval)
    assert exc.value.epoch == 2 and _meta(str(tmp_path / "stopped" / "run" / "run.meta.json"))[0] == 2
    hist, state = run("stopped", {"continue": 1, "startfrom": "run"}, restore=True)
    assert hist["dispatch_mode"]["mode"] == "fixed_epoch"
    for key in t_loop.EPOCH_KEYS:
        assert hist[key] == straight[key], key
    assert all(torch.equal(a, b) for a, b in zip(state, straight_state))
    kinds = _kinds(str(tmp_path / "stopped" / "run" / "flight.jsonl"))
    assert kinds == ["run_start", "epoch", "epoch", "preempt", "run_end", "run_start", "resumed", "epoch", "run_end"]


def test_nan_injection_equals_the_poisoning_loader(tmp_path, monkeypatch, one_thread):
    """``HGTORCH_INJECT_NAN_STEP=3:2`` and the ``_NanAt`` wrapper poison
    the same steps: bit-equal histories and the same skips."""
    _, port_side = _both_flagship(n=20, batch=5, epochs=3, optimizer={"type": "SGD", "learning_rate": 0.05})
    tr, va, te, cfg = port_side
    from hydragnn_tpu_torch.models.create import create_model_config
    from hydragnn_tpu_torch.train.optimizer import select_optimizer

    hists = []
    for label, injected in (("wrapper", False), ("injected", True)):
        model = create_model_config(cfg["NeuralNetwork"], seed=0, device="cpu")
        optimizer = select_optimizer(model, cfg["NeuralNetwork"]["Training"])
        train = GraphLoader(tr, 5, shuffle=True)
        if injected:
            monkeypatch.setenv("HGTORCH_INJECT_NAN_STEP", "3:2")
        else:
            train = _NanAt(train, 3, 2)
        hists.append(t_loop.train_validate_test(model, optimizer, train, GraphLoader(va, 5), GraphLoader(te, 5),
                                                cfg["NeuralNetwork"], log_dir=str(tmp_path / label) + "/"))
        monkeypatch.delenv("HGTORCH_INJECT_NAN_STEP", raising=False)
    wrapped, hist = hists
    assert hist["dispatch_mode"] == {"mode": "per_step", "auto": True,
                                     "reason": "fault injection active (HGTORCH_INJECT_NAN_STEP)"}
    assert hist["nonfinite_skipped"] == wrapped["nonfinite_skipped"] == [1, 1, 0]
    for key in t_loop.EPOCH_KEYS:
        assert hist[key] == wrapped[key], key
    assert np.isfinite(hist["train_loss"]).all()
    events = read_flight_record(str(tmp_path / "injected" / "run" / "flight.jsonl"))
    assert {e["epoch"]: e["nonfinite"]["skipped"] for e in events if e["kind"] == "epoch" and e.get("nonfinite")} \
        == {0: 1, 1: 1}


def test_nan_injection_never_writes_the_batch_it_is_given(monkeypatch):
    _, (tr, _, _, _) = _both_flagship(n=12, batch=4)
    loader = GraphLoader(tr, 4, shuffle=True)
    resident = loader.device_batches(0)[0]
    before = resident.nodes.clone()
    monkeypatch.setenv("HGTORCH_INJECT_NAN_STEP", "5")
    assert inject.maybe_nan_batch(resident, 4) is resident
    poisoned = inject.maybe_nan_batch(resident, 5)
    assert poisoned is not resident and poisoned.nodes.data_ptr() != resident.nodes.data_ptr()
    assert torch.isnan(poisoned.nodes).all() and torch.equal(resident.nodes, before)
    assert poisoned.senders is resident.senders  # everything else is shared, unchanged


def test_hooks_fire_the_step_injections_in_order(monkeypatch):
    fired = []
    monkeypatch.setattr(inject, "maybe_sigterm", lambda step=None, epoch=None: fired.append((step, epoch)))
    monkeypatch.setenv("HGTORCH_INJECT_NAN_STEP", "1")

    class Beat:
        beats = 0

        def beat(self):
            self.beats += 1

        def stop(self):
            self.stopped = True

    class Flag:
        def should_stop(self):
            return False

        def uninstall(self):
            self.gone = True

    wd, flag = Beat(), Flag()
    hooks = TrainHooks(preempt=flag, watchdog=wd)
    hooks.epoch_start(0)
    _, (tr, _, _, _) = _both_flagship(n=12, batch=4)
    batch = next(iter(GraphLoader(tr, 4, prefetch=0)))
    outs = [hooks.before_step(batch) for _ in range(3)]
    assert fired == [(None, 0), (0, None), (1, None), (2, None)]
    assert outs[0] is batch and outs[2] is batch and torch.isnan(outs[1].nodes).all()
    assert hooks.step_counter == 3 and wd.beats == 4 and not hooks.preempted
    hooks.teardown()
    hooks.teardown()  # idempotent
    assert wd.stopped and flag.gone


@pytest.mark.parametrize("env,reason", [({"HGTORCH_INJECT_SIGTERM_EPOCH": "1"},
                                         "fault injection active (HGTORCH_INJECT_SIGTERM_EPOCH)"),
                                        ({"HGTORCH_WATCHDOG_S": "30"}, "hang watchdog active"),
                                        ({"HGTORCH_INJECT_SERVE_NAN": "1"},
                                         "single-device run + device-resident fixed-membership batches")])
def test_dispatch_resolution_injection_and_watchdog_rules(env, reason, monkeypatch):
    """The JAX package's rules (``hydragnn_tpu/train/loop.py:490-499``): a
    training injection or the watchdog knob turns the auto default to
    per-step; a serving injection does not; an explicit
    ``scan_epoch`` still wins."""
    _, (tr, _, _, _) = _both_flagship(n=12, batch=4)
    loader = GraphLoader(tr, 4, shuffle=True)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    out = t_loop.resolve_dispatch({}, {"Training": {}}, loader)
    assert out == {"mode": "fixed_epoch" if reason.startswith("single") else "per_step", "auto": True,
                   "reason": reason}
    assert t_loop.resolve_dispatch({"scan_epoch": True}, {"Training": {}}, loader)["mode"] == "fixed_epoch"


def test_manifest_records_the_handler_and_the_watchdog(tmp_path, monkeypatch, one_thread):
    """``preempt_handler`` is what installed (false when switched off, and
    false off the main thread, where it cannot install), and
    ``watchdog_stall_s`` reads ``HGTORCH_WATCHDOG_S``; a fixed epoch under
    an explicit ``scan_epoch`` runs no per-step hook."""
    _, (tr, va, te, cfg) = _both_flagship(n=12, batch=4, epochs=1)
    from hydragnn_tpu_torch.models.create import create_model_config
    from hydragnn_tpu_torch.train.optimizer import select_optimizer

    def run(label, training, thread=False):
        model = create_model_config(cfg["NeuralNetwork"], seed=0, device="cpu")
        optimizer = select_optimizer(model, cfg["NeuralNetwork"]["Training"])
        nn = dict(cfg["NeuralNetwork"], Training=dict(cfg["NeuralNetwork"]["Training"], **training))
        args = (model, optimizer, GraphLoader(tr, 4, shuffle=True), GraphLoader(va, 4), GraphLoader(te, 4), nn)
        if thread:
            t = threading.Thread(target=t_loop.train_validate_test, args=args,
                                 kwargs=dict(log_dir=str(tmp_path / label) + "/"))
            t.start()
            t.join()
        else:
            t_loop.train_validate_test(*args, log_dir=str(tmp_path / label) + "/")
        (start,) = [e for e in read_flight_record(str(tmp_path / label / "run" / "flight.jsonl"))
                    if e["kind"] == "run_start"]
        return start["manifest"]

    assert run("on", {})["preempt_handler"] is True
    assert run("off", {"preempt_handler": False})["preempt_handler"] is False
    assert run("thread", {}, thread=True)["preempt_handler"] is False
    monkeypatch.setenv("HGTORCH_WATCHDOG_S", "600")
    man = run("watchdog", {})
    assert man["watchdog_stall_s"] == 600.0 and man["dispatch_mode"]["reason"] == "hang watchdog active"
    monkeypatch.delenv("HGTORCH_WATCHDOG_S")
    monkeypatch.setenv("HGTORCH_INJECT_SIGTERM_STEP", "0")  # would kill a per-step run at its first step
    man = run("fixed", {"scan_epoch": True})
    assert man["dispatch_mode"]["mode"] == "fixed_epoch"
    assert signal.getsignal(signal.SIGTERM) == signal.SIG_DFL
    assert not [t for t in threading.enumerate() if t.name == "hgtorch-watchdog"]


def test_watchdog_arms_after_warmup_and_fires(tmp_path):
    fired = []
    path = str(tmp_path / "flight.jsonl")
    wd = HangWatchdog(stall_s=0.2, flight=FlightRecorder(path), action=lambda: fired.append(True), poll_s=0.02,
                      warmup_beats=2)
    wd.start()
    try:
        time.sleep(0.5)  # unarmed: set-up time never fires
        assert not wd.fired
        for _ in range(3):
            wd.beat()
        assert wd.armed
        time.sleep(0.5)
        assert wd.fired and fired
    finally:
        wd.stop()
    events = read_flight_record(path)
    (ev,) = [e for e in events if e["kind"] == "watchdog"]
    assert ev["stall_s"] >= 0.2 and "MainThread" in ev["stacks"]
    assert events[-1]["kind"] == "run_end" and events[-1]["status"] == "hung"
    assert not jax_validate(events)


@pytest.mark.parametrize("prefetch", [0, 2])
def test_stall_loader_sleeps_before_the_injected_batch(prefetch, monkeypatch):
    _, (tr, _, _, _) = _both_flagship(n=16, batch=4)
    slept = []
    monkeypatch.setattr(inject.time, "sleep", lambda s: slept.append(s))
    monkeypatch.setenv("HGTORCH_INJECT_STALL_LOADER", "2:7")
    batches = list(GraphLoader(tr, 4, shuffle=True, prefetch=prefetch))
    assert slept == [7] and len(batches) >= 3
    monkeypatch.setenv("HGTORCH_INJECT_STALL_LOADER", "1")
    list(GraphLoader(tr, 4, prefetch=prefetch))
    assert slept == [7, 3600]


def test_every_injection_of_the_port_is_listed_and_stripped():
    names = set()
    for path in glob.glob(os.path.join(REPO, "hydragnn_tpu_torch", "**", "*.py"), recursive=True):
        with open(path) as f:
            names |= set(re.findall(r"HGTORCH_INJECT_[A-Z_]+[A-Z]", f.read()))
    # a family's prefix (``HGTORCH_INJECT_SERVE``) is not a name
    names = {n for n in names if not any(k.startswith(n + "_") for k in inject.INJECTIONS)}
    assert names == set(inject.INJECTIONS)
    env = {k: "1" for k in inject.INJECTIONS}
    env.update(HGTORCH_INJECT_FUTURE="1", HGTORCH_AUTO_RESUME="1", HGTORCH_NUM_PREFETCH="0", KEEP="x")
    assert inject.active_injections(env=env, include_serve=True) == sorted(inject.INJECTIONS)
    assert all(not k.startswith("HGTORCH_INJECT_SERVE") for k in inject.active_injections(env=env))
    assert inject.strip_injection_env(env) == {"HGTORCH_AUTO_RESUME": "1", "HGTORCH_NUM_PREFETCH": "0", "KEEP": "x"}


def test_obs_report_faults_view_reads_a_port_record(tmp_path, capsys):
    """The JAX package's ``tools/obs_report.py --faults``, unchanged, on a
    record the port's recorder wrote with every fault event kind."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import obs_report

    path = str(tmp_path / "flight.jsonl")
    with FlightRecorder(path) as fl:
        fl.start_run({"run": "x"})
        fl.record("preempt", signal=15, epoch=1, step=9)
        fl.end_run(status="preempted")
        fl.start_run({"run": "x"})
        fl.record("resumed", epoch=1)
        fl.record("rollback", epoch=2, consec=4, rollbacks=1, lr=5e-4)
        fl.record("watchdog", stall_s=3.2, stacks={"MainThread": "  File loader.py"})
        fl.end_run(status="hung", stall_s=3.2)
        fl.record("restart", attempt=1, cause="hung", exit_code=79, delay_s=1.0)
        fl.start_run({"run": "x"})
        fl.end_run(status="completed")
    assert obs_report.main(["--faults", path]) == 0
    out = capsys.readouterr().out
    assert "preempted=1" in out and "resumed=1" in out and "rollbacks=1" in out
    assert "[watchdog]" in out and "[rollback]" in out and "[restart]" in out


# ---- child processes -----------------------------------------------------

_CHILD = r"""
import sys, time
t0 = time.perf_counter()
sys.path.insert(0, {repo!r})
sys.modules["torch.utils.tensorboard"] = None  # the NullWriter: no TensorFlow import in a test child
from hydragnn_tpu_torch.api import run_training
from hydragnn_tpu_torch.data.synthetic import deterministic_graph_data
from hydragnn_tpu_torch.flagship import flagship_config
from hydragnn_tpu_torch.resilience import run_guard

cfg = flagship_config(hidden_dim=8, num_conv_layers=2, batch_size=5, num_epoch=2)
cfg["NeuralNetwork"]["Training"].update({training!r})
samples = deterministic_graph_data(number_configurations=20, unit_cell_x_range=(2, 3), unit_cell_y_range=(2, 3),
                                   unit_cell_z_range=(2, 3), seed=0)
with run_guard():
    run_training(cfg, samples=samples, log_dir=sys.argv[1] + "/logs/", device="cpu")
print("CHILD-COMPLETED", round(time.perf_counter() - t0, 2))
"""


# every child and the reference stream per step: the injections force
# the per-step path, and the reference must take the same batches
CHILD_TRAINING = {"checkpoint_every": 1, "scan_epoch": False}


def _child_script(tmp_path, training):
    script = tmp_path / "child.py"
    script.write_text(_CHILD.format(repo=REPO, training=dict(training)))
    return script


def _child_env(extra):
    env = {k: v for k, v in os.environ.items() if not k.startswith(("HGTORCH_INJECT_", "HGTORCH_AUTO_RESUME"))}
    env.update(HGTORCH_DIAGNOSTICS="0", OMP_NUM_THREADS="1", **extra)
    return env


def _run_child(tmp_path, training, extra, timeout=240):
    return subprocess.run([sys.executable, str(_child_script(tmp_path, training)), str(tmp_path)],
                          env=_child_env(extra), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                          timeout=timeout)


def _events(tmp_path):
    (fl,) = glob.glob(str(tmp_path / "logs" / "*" / "flight.jsonl"))
    return read_flight_record(fl)


def _final_val_loss(tmp_path):
    (mp,) = glob.glob(str(tmp_path / "logs" / "*" / "metrics.jsonl"))
    with open(mp) as f:
        return [json.loads(line) for line in f][-1]["val_loss"]


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    """The uninterrupted run of the children's config."""
    d = tmp_path_factory.mktemp("reference")
    proc = _run_child(d, CHILD_TRAINING, {})
    assert proc.returncode == 0, proc.stdout[-3000:]
    return _final_val_loss(d)


def test_child_sigterm_mid_epoch_exits_75_then_resumes(tmp_path, reference_run):
    proc = _run_child(tmp_path, CHILD_TRAINING, {"HGTORCH_INJECT_SIGTERM_STEP": "2"})
    assert proc.returncode == EXIT_PREEMPTED, proc.stdout[-3000:]
    events = _events(tmp_path)
    assert events[-1]["kind"] == "run_end" and events[-1]["status"] == "preempted"
    (pre,) = [e for e in events if e["kind"] == "preempt"]
    assert pre["signal"] == 15 and pre["epoch"] == 0 and pre["step"] == 3
    (run_dir,) = glob.glob(str(tmp_path / "logs" / "*/"))
    assert glob.glob(os.path.join(run_dir, "*.pt")) and glob.glob(os.path.join(run_dir, "*.meta.json"))

    proc = _run_child(tmp_path, CHILD_TRAINING, {"HGTORCH_AUTO_RESUME": "1"})
    assert proc.returncode == 0 and "CHILD-COMPLETED" in proc.stdout, proc.stdout[-3000:]
    events = _events(tmp_path)
    assert sum(e["kind"] == "resumed" for e in events) == 1
    assert [e["status"] for e in events if e["kind"] == "run_end"] == ["preempted", "completed"]
    assert not jax_validate(events)
    assert _final_val_loss(tmp_path) == pytest.approx(reference_run, rel=0.2)


def test_child_torn_checkpoint_is_rejected_on_resume(tmp_path, reference_run):
    proc = _run_child(tmp_path, CHILD_TRAINING, {"HGTORCH_INJECT_KILL_CHECKPOINT": "2"})
    assert proc.returncode == -signal.SIGKILL, proc.stdout[-3000:]
    (run_dir,) = glob.glob(str(tmp_path / "logs" / "*/"))
    (pointer,) = [p for p in glob.glob(os.path.join(run_dir, "*.pt")) if ".step" not in os.path.basename(p)]
    assert not ckpt.validate_checkpoint_file(pointer)

    proc = _run_child(tmp_path, CHILD_TRAINING, {"HGTORCH_AUTO_RESUME": "1"})
    assert proc.returncode == 0, proc.stdout[-3000:]
    assert "rejected" in proc.stdout  # the integrity warning fired
    events = _events(tmp_path)
    assert sum(e["kind"] == "resumed" for e in events) == 1 and events[-1]["status"] == "completed"
    assert _final_val_loss(tmp_path) == pytest.approx(reference_run, rel=1e-3)


def test_child_stalled_loader_trips_the_watchdog(tmp_path):
    t0 = time.perf_counter()
    proc = _run_child(tmp_path, {"watchdog_stall_s": 3.0}, {"HGTORCH_INJECT_STALL_LOADER": "2:120"}, timeout=180)
    assert proc.returncode == EXIT_HUNG, proc.stdout[-3000:]
    assert time.perf_counter() - t0 < 100
    events = _events(tmp_path)
    (wd,) = [e for e in events if e["kind"] == "watchdog"]
    assert wd["stall_s"] >= 3.0
    assert "MainThread" in wd["stacks"] and "loader.py" in wd["stacks"]["MainThread"]  # blocked on the loader
    assert events[-1]["kind"] == "run_end" and events[-1]["status"] == "hung"
    assert not jax_validate(events)


def test_supervise_cli_completes_a_training_child_after_one_preemption(tmp_path):
    script = _child_script(tmp_path, CHILD_TRAINING)
    flight = tmp_path / "supervisor.jsonl"
    proc = subprocess.run([sys.executable, "-m", "hydragnn_tpu_torch.tools.supervise", "--flight", str(flight), "--",
                           sys.executable, str(script), str(tmp_path)], cwd=REPO,
                          env=_child_env({"HGTORCH_INJECT_SIGTERM_EPOCH": "1"}), stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:]
    sup = read_flight_record(str(flight))
    assert [e["kind"] for e in sup] == ["run_start", "restart", "run_end"]
    assert sup[1]["cause"] == "preempted" and sup[1]["delay_s"] == 0.0 and sup[-1]["status"] == "completed"
    events = _events(tmp_path)
    assert [e["status"] for e in events if e["kind"] == "run_end"] == ["preempted", "completed"]
    assert [e["epoch"] for e in events if e["kind"] == "preempt"] == [1]
    assert [e["epoch"] for e in events if e["kind"] == "epoch"] == [0, 1]
