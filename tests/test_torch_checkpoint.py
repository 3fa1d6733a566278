"""The port's checkpoints and resume (``hydragnn_tpu_torch/utils/checkpoint.py``,
``train/loop.py``), and its reader of the JAX package's checkpoints
(``convert.py:load_jax_checkpoint``, no msgpack package).

Tolerances: a resumed run against an uninterrupted one, and anything
restored from the port's own files, bit-equal; the port's forward on a
JAX checkpoint against JAX's forward, 1e-5 of the output's largest
magnitude (the step parity's f32 sums in another order); the optimizer
state read from it, bit-equal (a copy); one more step from it on both
sides, ``rtol=1e-5, atol=1e-7``.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from hydragnn_tpu.data.ingest import prepare_dataset as jax_prepare_dataset
from hydragnn_tpu.data.loader import GraphLoader as JaxGraphLoader
from hydragnn_tpu.data.synthetic import deterministic_graph_data as jax_data
from hydragnn_tpu.flagship import flagship_config as jax_flagship_config
from hydragnn_tpu.models.create import create_model_config as jax_create_model_config
from hydragnn_tpu.train import create_train_state, make_train_step as jax_make_train_step
from hydragnn_tpu.train import select_optimizer as jax_select_optimizer
from hydragnn_tpu.utils.checkpoint import save_model as jax_save_model
from hydragnn_tpu.utils.config import update_config as jax_update_config

import hydragnn_tpu_torch as hg
from hydragnn_tpu_torch.convert import load_jax_checkpoint, msgpack_unpackb, variables_from_flax
from hydragnn_tpu_torch.data.ingest import prepare_dataset
from hydragnn_tpu_torch.data.loader import GraphLoader
from hydragnn_tpu_torch.data.synthetic import deterministic_graph_data
from hydragnn_tpu_torch.flagship import flagship_config
from hydragnn_tpu_torch.models.create import create_model_config
from hydragnn_tpu_torch.train.optimizer import SLOTS, current_learning_rate, select_optimizer
from hydragnn_tpu_torch.train.state import make_train_step
from hydragnn_tpu_torch.utils import checkpoint as ckpt
from hydragnn_tpu_torch.utils.config import get_log_name_config, update_config

from test_torch_conv_stacks import one_thread  # noqa: F401

UNIT = dict(unit_cell_x_range=(2, 4), unit_cell_y_range=(2, 4), unit_cell_z_range=(2, 4))


@pytest.fixture(autouse=True, scope="module")
def _diagnostics_off():
    """The training loop's per-head diagnostics and hardware ledger off in
    this file (``test_torch_{introspect,train_obs}.py`` test them): they
    add a forward and H + 1 backward pulls an epoch, and a counted
    forward and backward a run, to every run here."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HGTORCH_DIAGNOSTICS", "0")
        yield


def _tiny():
    cfg = flagship_config(8, 2, 8, 1)
    tr, va, te, _, _ = prepare_dataset(deterministic_graph_data(number_configurations=12, seed=0, **UNIT), cfg)
    cfg = update_config(cfg, tr, va, te)
    model = create_model_config(cfg["NeuralNetwork"], device="cpu")
    return model, select_optimizer(model, cfg["NeuralNetwork"]["Training"])


def test_checkpoint_retention_prunes_and_falls_back(tmp_path):
    log_dir = str(tmp_path)
    model, optimizer = _tiny()
    first = next(model.parameters())
    for step in (1, 2, 3):
        optimizer.steps.fill_(step)
        with torch.no_grad():
            first.fill_(step * 10.0)
        ckpt.save_model(model, "run", log_dir, optimizer=optimizer, epoch=step, keep_last=2)
    versions = ckpt.list_versioned_checkpoints("run", log_dir)
    assert [s for s, _ in versions] == [3, 2]  # keep-last-2, newest first
    assert all(ckpt.validate_checkpoint_file(p) for _, p in versions)
    assert all(os.path.exists(p + ".sha256") for _, p in versions) and ckpt.checkpoint_exists("run", log_dir)

    # a torn latest write fails validation; the restore falls back to the
    # newest intact version and says what it rejected
    latest = ckpt.checkpoint_path("run", log_dir)
    data = open(latest, "rb").read()
    with open(latest, "wb") as f:
        f.write(data[: len(data) // 2])
    assert not ckpt.validate_checkpoint_file(latest)
    fresh, fresh_opt = _tiny()
    with pytest.warns(RuntimeWarning, match="rejected"):
        epoch = ckpt.load_existing_model(fresh, "run", log_dir, optimizer=fresh_opt)
    assert epoch == 3 and int(fresh_opt.steps) == 3
    assert bool((next(fresh.parameters()) == 30.0).all())

    # a version whose bytes no longer match its sidecar (bit rot) is rejected too
    with open(versions[0][1], "r+b") as f:
        f.seek(100)
        f.write(b"\x00\x01")
    with pytest.warns(RuntimeWarning, match="rejected"):
        ckpt.load_existing_model(fresh, "run", log_dir, optimizer=fresh_opt)
    assert int(fresh_opt.steps) == 2

    # every candidate corrupt: a loud failure, not a silent fresh start
    for _, p in ckpt.list_versioned_checkpoints("run", log_dir):
        with open(p, "wb") as f:
            f.write(b"junk")
    with pytest.raises(ValueError, match="no valid checkpoint"):
        ckpt.load_existing_model(fresh, "run", log_dir)


def test_meta_from_a_newer_format_is_refused(tmp_path):
    model, optimizer = _tiny()
    ckpt.save_model(model, "run", str(tmp_path), optimizer=optimizer)
    ckpt.save_train_meta({"epoch": 1}, "run", str(tmp_path))
    assert ckpt.load_train_meta("run", str(tmp_path))["format_version"] == ckpt.CHECKPOINT_FORMAT_VERSION
    ckpt.save_train_meta({"epoch": 1, "format_version": ckpt.CHECKPOINT_FORMAT_VERSION + 1}, "run", str(tmp_path))
    with pytest.raises(ckpt.CheckpointFormatError):
        ckpt.load_existing_model(model, "run", str(tmp_path))


# ---- resume through run_training ----------------------------------------


def _config(model_type, num_epoch, **training):
    cfg = flagship_config(8, 2, 8, num_epoch)
    cfg["NeuralNetwork"]["Architecture"]["model_type"] = model_type
    t = cfg["NeuralNetwork"]["Training"]
    t.update({"checkpoint_every": 1, "bn_recalibration": False, **training})
    return cfg


def _raw():
    return deterministic_graph_data(number_configurations=40, seed=0, **UNIT)


def _state(model, optimizer):
    return ([t.detach().clone() for t in model.state_dict().values()]
            + [t.clone() for t in optimizer.state_tensors()] + [optimizer.steps.clone()])


def _run(cfg, log_dir):
    model, optimizer, hist, done = hg.run_training(cfg, _raw(), log_dir=log_dir, device="cpu")
    return model, optimizer, hist, get_log_name_config(done)


@pytest.mark.parametrize("model_type,extra", [("PNA", {}), ("GAT", {"scan_epoch": False, "grad_accum_steps": 3})])
def test_resumed_run_is_bit_equal_to_an_uninterrupted_one(model_type, extra, tmp_path, one_thread):
    """4 epochs straight against 2 epochs then ``continue`` for 2: the
    history, every parameter, BatchNorm statistic and optimizer tensor
    bit-equal. PNA on the fixed-membership epoch; GAT streams per step
    with its attention dropout on (the generator's state is in the
    checkpoint) and accumulates 3 micro-batches across the epoch
    boundary."""
    m_a, o_a, hist_a, _ = _run(_config(model_type, 4, **extra), str(tmp_path / "a"))
    _, _, hist_b, name = _run(_config(model_type, 2, **extra), str(tmp_path / "b"))
    cfg_c = _config(model_type, 4, **extra)
    cfg_c["NeuralNetwork"]["Training"].update({"continue": 1, "startfrom": name})
    m_c, o_c, hist_c, _ = _run(cfg_c, str(tmp_path / "b"))
    assert hist_c["dispatch_mode"]["mode"] == ("per_step" if extra else "fixed_epoch")
    assert len(hist_c["train_loss"]) == 4 and hist_c["train_loss"][:2] == hist_b["train_loss"]
    for key in ("train_loss", "val_loss", "test_loss", "train_tasks", "val_tasks", "test_tasks", "lr"):
        assert hist_c[key] == hist_a[key], key
    assert all(torch.equal(a, c) for a, c in zip(_state(m_a, o_a), _state(m_c, o_c)))


def _files(log_dir, name):
    run = os.path.join(log_dir, name)
    return {f: open(os.path.join(run, f), "rb").read() for f in os.listdir(run)
            if f.endswith((".meta.json", ".sha256")) or ".step" in f}


def test_resume_of_a_completed_or_early_stopped_run_is_a_noop(tmp_path, one_thread):
    log_dir = str(tmp_path)
    model, optimizer, hist, name = _run(_config("PNA", 3), log_dir)
    before, params = _files(log_dir, name), _state(model, optimizer)
    for num_epoch, early in ((3, False), (6, True)):
        if early:  # an early-stopped run: its resume honours the stop
            meta_path = os.path.join(log_dir, name, f"{name}.meta.json")
            meta = json.load(open(meta_path))
            meta["early_stopped"] = True
            json.dump(meta, open(meta_path, "w"))
            before = _files(log_dir, name)
        cfg = _config("PNA", num_epoch, bn_recalibration=True)
        cfg["NeuralNetwork"]["Training"].update({"continue": 1, "startfrom": name})
        m2, o2, hist2, _ = _run(cfg, log_dir)
        assert hist2["train_loss"] == hist["train_loss"] and hist2["train_wall_s"] == []
        assert _files(log_dir, name) == before, "a no-op resume rewrote the run's versions or meta"
        assert all(torch.equal(a, b) for a, b in zip(params, _state(m2, o2)))


def test_meta_step_mismatch_rederives_the_epoch(tmp_path, one_thread):
    """A meta sidecar older than the weights (a crash between the two
    writes): the resume derives the epoch from the weights' step and
    replays nothing; the sidecar is repaired."""
    log_dir = str(tmp_path)
    model, optimizer, hist, name = _run(_config("PNA", 4), log_dir)
    meta_path = os.path.join(log_dir, name, f"{name}.meta.json")
    meta = json.load(open(meta_path))
    meta["epoch"], meta["step"] = 2, meta["step"] // 2
    meta["history"] = {k: v[:2] for k, v in meta["history"].items()}
    json.dump(meta, open(meta_path, "w"))
    cfg = _config("PNA", 4)
    cfg["NeuralNetwork"]["Training"].update({"continue": 1, "startfrom": name})
    m2, o2, hist2, _ = _run(cfg, log_dir)
    assert all(torch.equal(a, b) for a, b in zip(_state(model, optimizer), _state(m2, o2)))
    assert len(hist2["train_loss"]) == 4 and hist2["train_wall_s"] == []
    repaired = json.load(open(meta_path))
    assert repaired["epoch"] == 4 and repaired["step"] == meta["step"] * 2


# ---- the JAX package's checkpoints ----------------------------------------


def test_msgpack_decoder_matches_msgpack():
    """The decoder against flax's msgpack_restore on every type flax
    writes: nested maps (fix, 16-bit), str and bin, ints of every width,
    floats, bools, None, lists, and arrays (bf16 widened to f32)."""
    rng = np.random.default_rng(0)
    tree = {
        "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32, -1, -32, -33, -129, -40000, -2**40],
        "floats": [0.5, -1.25e-30, float("inf")], "flags": [True, False, None], "text": "x" * 40,
        "blob": b"\x00\x01" * 300,
        "arrays": {f"a{i}": rng.normal(size=(i + 1, 3)).astype(np.float32) for i in range(20)},
        "kinds": {"i32": np.arange(5, dtype=np.int32), "u8": np.arange(7, dtype=np.uint8),
                  "f64": np.linspace(0, 1, 4), "scalar": np.float32(2.5), "empty": np.zeros((0, 4), np.float32),
                  "bf16": jnp.asarray(rng.normal(size=(4, 2)), jnp.bfloat16)},
    }
    data = serialization.msgpack_serialize(tree)
    ref, mine = serialization.msgpack_restore(data), msgpack_unpackb(data)

    def check(a, b, path):
        if isinstance(a, dict):
            assert set(a) == set(b), path
            for k in a:
                check(a[k], b[k], f"{path}/{k}")
        elif isinstance(a, (list, tuple)):
            assert len(a) == len(b), path
            for i, (x, y) in enumerate(zip(a, b)):
                check(x, y, f"{path}/{i}")
        elif isinstance(a, (np.ndarray, np.generic)) or hasattr(a, "dtype"):
            want = np.asarray(a, np.float32) if "bfloat16" in str(np.asarray(a).dtype) else np.asarray(a)
            np.testing.assert_array_equal(np.asarray(b), want, err_msg=path)
            assert np.asarray(b).shape == want.shape
        else:
            assert a == b, path

    check(ref, mine, "")
    with pytest.raises(ValueError, match="truncated"):
        msgpack_unpackb(data[:-3])


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """Both packages' flagship at hidden 16, 2 layers, and the JAX side's
    state after three AdamW steps (and after three SGD micro-steps of a
    2-step accumulation), saved by the JAX package's ``save_model``."""
    out = {}
    for data, prep, upd, fc, key in ((jax_data, jax_prepare_dataset, jax_update_config, jax_flagship_config, "jax"),
                                     (deterministic_graph_data, prepare_dataset, update_config, flagship_config,
                                      "port")):
        cfg = fc(16, 2, 8)
        tr, va, te, _, _ = prep(data(number_configurations=24, seed=2, **UNIT), cfg)
        out[key] = (tr, upd(cfg, tr, va, te))
    jbatches = list(JaxGraphLoader(out["jax"][0], 8, shuffle=True, prefetch=0))
    batches = list(GraphLoader(out["port"][0], 8, shuffle=True, prefetch=0))
    runs = {}
    for label, training in (("adamw", {"Optimizer": {"type": "AdamW", "learning_rate": 1e-3}}),
                            ("accum", {"Optimizer": {"type": "SGD", "learning_rate": 0.05}, "grad_accum_steps": 2})):
        model, variables = jax_create_model_config(out["jax"][1]["NeuralNetwork"], jbatches[0])
        tx = jax_select_optimizer(training)
        state = create_train_state(variables, tx)
        step = jax_make_train_step(model, tx)
        for b in jbatches:
            state, _, _ = step(state, b)
        log_dir = str(tmp_path_factory.mktemp(label))
        path = jax_save_model(state, "run", log_dir)
        runs[label] = (training, model, tx, state, step, path)
    return out["port"][1], jbatches, batches, runs


@pytest.mark.parametrize("label", ["adamw", "accum"])
def test_port_restores_a_jax_checkpoint(jax_run, label, one_thread):
    cfg, jbatches, batches, runs = jax_run
    training, jmodel, tx, state, jstep, path = runs[label]
    model = create_model_config(cfg["NeuralNetwork"], device="cpu")
    optimizer = select_optimizer(model, training)
    assert load_jax_checkpoint(path, model, optimizer) == int(state.step) == int(optimizer.steps) == 3

    # the forward on the restored weights and statistics
    ref = jmodel.apply({"params": state.params, "batch_stats": state.batch_stats}, jbatches[0], train=False)
    with torch.no_grad():
        outs = model(batches[0], train=False)
    for o, r in zip(outs, ref):
        r = np.asarray(r)
        assert np.abs(o.numpy() - r).max() <= 1e-5 * np.abs(r).max()

    # the optimizer state, copied
    named = dict(model.named_parameters())
    if label == "adamw":
        inner = state.opt_state.inner_state[0]
        for slot in ("mu", "nu"):
            want = variables_from_flax({"params": jax.device_get(getattr(inner, slot))})
            for name, t in want.items():
                assert torch.equal(optimizer.state[named[name]][SLOTS["AdamW"][slot]], t), (slot, name)
        assert int(optimizer.count()) == int(inner.count) == 3
    else:
        want = variables_from_flax({"params": jax.device_get(state.opt_state.acc_grads)})
        for name, t in want.items():
            assert torch.equal(optimizer.state[named[name]]["acc"], t), name
        assert int(optimizer.shared["mini_step"]) == int(state.opt_state.mini_step) == 1
    assert current_learning_rate(optimizer) == pytest.approx(float(training["Optimizer"]["learning_rate"]))

    # one more step on each side from the restored state
    new_state, jloss, _ = jstep(state, jbatches[1])
    loss, _ = make_train_step(model, optimizer)(batches[1])
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    want = variables_from_flax({"params": jax.device_get(new_state.params)})
    for name, p in model.named_parameters():
        if name.startswith("convs.") and name.endswith("post.bias") and label == "adamw":
            continue  # feeds a BatchNorm: 0 gradient up to rounding, which Adam scales to lr
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=1e-5, atol=1e-7, err_msg=name)
