"""The port's training loop against the JAX package's: the epoch's
batches under the default dispatch (fixed membership, epoch-seeded
order), ``scan_reshuffle_every``, the dispatch resolution, the
non-finite guard with its rollback and exhaustion, mixed precision,
remat, the prefetch thread and ``cache_device_batches``; and the
accuracy bars of the SAGE, MFC, CGCNN and SchNet stacks through the
port's ``run_training`` (ROADMAP A-1).

Tolerances and why:
  - per-epoch losses of the JAX package's ``train_validate_test`` and
    the port's: ``rtol=1e-4``, the step parity's (``test_torch_train.py``).
    With SGD all three losses of all three epochs. With AdamW the first
    epoch's train loss at ``rtol=1e-4`` and the later ones at
    ``ADAM_LATER_RTOL = 1e-2``: Adam's first steps turn every gradient
    entry to about ±lr whatever its size, so entries whose gradient is 0
    up to rounding (the conv biases that feed a BatchNorm, and others)
    move by up to lr in directions the two frameworks' roundings pick;
    once the parameters are ~5e-5 apart a near-tied PNA maximum flips
    (at the 6th step of this data: convs.0.post.weight's gradient 9e-2
    apart, relative L2, where it was 1e-5), and from there the two
    trajectories are two runs of the same training, 4e-3 apart by the
    15th step. The JAX package's own two dispatch paths are bit-equal
    here, so it offers no spread to hold the port to; the optimizer alone
    is held to optax step by step in ``test_torch_optimizers.py``, and
    the F1 batches bit for bit in
    ``test_scan_reshuffle_membership_matches_jax``. The eval losses are
    not compared under AdamW: BatchNorm removes those biases from the
    outputs but not from the running means;
  - the guarded step on a bad batch, remat, and the prefetch thread:
    bit-equality (the same computation, or none);
  - mixed precision, the port's bf16 step against the JAX package's:
    losses ``rtol=1e-2`` (bf16 keeps 8 significant bits, eps 2^-8 = 3.9e-3,
    and the two frameworks round the forward's sums differently; 1.6e-3
    seen), and the model's whole parameter update by relative L2 within
    twice the distance of JAX's own bf16 update from its f32 one (bf16
    roundings move the near-tied BCC maxima that route conv gradients, so
    the two bf16 steps differ as much as bf16 differs from f32: 0.036
    against 0.02-0.05 seen).
"""

import dataclasses
import math
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hydragnn_tpu.data.ingest import prepare_dataset as jax_prepare_dataset
from hydragnn_tpu.data.loader import GraphLoader as JaxGraphLoader
from hydragnn_tpu.data.synthetic import deterministic_graph_data as jax_data
from hydragnn_tpu.flagship import flagship_config as jax_flagship_config
from hydragnn_tpu.models.create import create_model_config as jax_create_model_config
from hydragnn_tpu.resilience import NonFiniteRollbackExhausted as JaxRollbackExhausted
from hydragnn_tpu.train import create_train_state, make_train_step as jax_make_train_step
from hydragnn_tpu.train import select_optimizer as jax_select_optimizer
from hydragnn_tpu.train import loop as jax_loop
from hydragnn_tpu.utils.config import update_config as jax_update_config

import hydragnn_tpu_torch as hg
from hydragnn_tpu_torch.api import create_dataloaders
from hydragnn_tpu_torch.convert import variables_from_flax
from hydragnn_tpu_torch.data.ingest import prepare_dataset
from hydragnn_tpu_torch.data.loader import GraphLoader
from hydragnn_tpu_torch.data.synthetic import deterministic_graph_data
from hydragnn_tpu_torch.flagship import flagship_config
from hydragnn_tpu_torch.models.create import create_model_config
from hydragnn_tpu_torch.resilience import NonFiniteRollbackExhausted
from hydragnn_tpu_torch.train import loop as t_loop
from hydragnn_tpu_torch.train.optimizer import select_optimizer
from hydragnn_tpu_torch.train.state import make_train_step
from hydragnn_tpu_torch.utils.config import update_config

from test_torch_conv_stacks import one_thread  # noqa: F401
from test_train_e2e import SMOKE_THRESHOLDS, _smoke_budget, make_config

UNIT = dict(unit_cell_x_range=(2, 4), unit_cell_y_range=(2, 4), unit_cell_z_range=(2, 4))
LOSS_RTOL = 1e-4
ADAM_LATER_RTOL = 1e-2
BF16_LOSS_RTOL, BF16_UPDATE_FACTOR = 1e-2, 2.0


@pytest.fixture(autouse=True, scope="module")
def _diagnostics_off():
    """The training loop's per-head diagnostics and hardware ledger off in
    this file (``test_torch_{introspect,train_obs}.py`` test them): they
    add a forward and H + 1 backward pulls an epoch, and a counted
    forward and backward a run, to every run here."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HGTORCH_DIAGNOSTICS", "0")
        yield


def _splits(data, prep, upd, cfg, n, seed=2):
    s = data(number_configurations=n, seed=seed, **UNIT)
    tr, va, te, _, _ = prep(s, cfg)
    return tr, va, te, upd(cfg, tr, va, te)


def _both_flagship(n=48, batch=8, epochs=3, optimizer=None, **training):
    """The flagship at hidden 16, 2 layers, prepared by both packages,
    with ``training`` keys set on both configs."""
    cfgs = []
    for data, prep, upd, fc in ((jax_data, jax_prepare_dataset, jax_update_config, jax_flagship_config),
                                (deterministic_graph_data, prepare_dataset, update_config, flagship_config)):
        cfg = fc(16, 2, batch, epochs)
        t = cfg["NeuralNetwork"]["Training"]
        t.update(training)
        if optimizer is not None:
            t["Optimizer"] = dict(optimizer)
        cfgs.append(_splits(data, prep, upd, cfg, n))
    return cfgs


def _jax_state(jcfg, example):
    model, variables = jax_create_model_config(jcfg["NeuralNetwork"], example)
    tx = jax_select_optimizer(jcfg["NeuralNetwork"]["Training"])
    return model, variables, tx


def _port_model(cfg, variables):
    model = create_model_config(cfg["NeuralNetwork"], device="cpu")
    model.load_state_dict(variables_from_flax(variables), strict=True)
    return model, select_optimizer(model, cfg["NeuralNetwork"]["Training"])


def _run_both(jax_side, port_side, tmp_path, port_train_loader=None):
    """JAX's and the port's ``train_validate_test`` from one init."""
    (jtr, jva, jte, jcfg), (tr, va, te, cfg) = jax_side, port_side
    bs = int(cfg["NeuralNetwork"]["Training"]["batch_size"])
    jloaders = [JaxGraphLoader(jtr, bs, shuffle=True), JaxGraphLoader(jva, bs), JaxGraphLoader(jte, bs)]
    jmodel, variables, tx = _jax_state(jcfg, next(iter(jloaders[0])))
    state = create_train_state(variables, tx)
    _, jhist = jax_loop.train_validate_test(jmodel, tx, state, *jloaders, jcfg["NeuralNetwork"],
                                            log_dir=str(tmp_path / "jax") + "/")
    model, optimizer = _port_model(cfg, variables)
    loaders = [port_train_loader or GraphLoader(tr, bs, shuffle=True), GraphLoader(va, bs), GraphLoader(te, bs)]
    hist = t_loop.train_validate_test(model, optimizer, *loaders, cfg["NeuralNetwork"],
                                      log_dir=str(tmp_path / "port") + "/")
    return jhist, hist, model, optimizer


# ---- F1: the epoch's batches ------------------------------------------


@pytest.mark.parametrize("opt_type,keys", [("SGD", ("train_loss", "val_loss", "test_loss")),
                                           ("AdamW", ("train_loss",))])
def test_epochs_train_on_the_jax_default_dispatch_batches(opt_type, keys, tmp_path, one_thread):
    """The JAX package's ``train_validate_test`` on its default dispatch
    (the whole-epoch scan over fixed-membership batches in an
    epoch-seeded order) and the port's, 3 epochs of 5 batches from one
    init: the same per-epoch losses."""
    lr = 0.05 if opt_type == "SGD" else 1e-3
    jax_side, port_side = _both_flagship(optimizer={"type": opt_type, "learning_rate": lr})
    jhist, hist, _, _ = _run_both(jax_side, port_side, tmp_path)
    assert hist["dispatch_mode"] == {"mode": "fixed_epoch", "auto": True,
                                     "reason": "single-device run + device-resident fixed-membership batches"}
    assert len(hist["train_loss"]) == 3
    for key in keys:
        if opt_type == "SGD":
            np.testing.assert_allclose(hist[key], jhist[key], rtol=LOSS_RTOL, err_msg=key)
        else:  # Adam's trajectories part at a flipped tie (module docstring)
            np.testing.assert_allclose(hist[key][0], jhist[key][0], rtol=LOSS_RTOL, err_msg=key)
            np.testing.assert_allclose(hist[key][1:], jhist[key][1:], rtol=ADAM_LATER_RTOL, err_msg=key)


def test_scan_reshuffle_membership_matches_jax():
    """``device_batches`` holds the JAX package's ``stacked_device_batches``:
    membership fixed by default, re-formed every ``scan_reshuffle_every``
    epochs from the epoch-seeded permutation, every sample once; and the
    epoch's batch order is the JAX scan's."""
    cfg = flagship_config(16, 2, 8)
    jcfg = jax_flagship_config(16, 2, 8)
    tr = _splits(deterministic_graph_data, prepare_dataset, update_config, cfg, 40, seed=3)[0]
    jtr = _splits(jax_data, jax_prepare_dataset, jax_update_config, jcfg, 40, seed=3)[0]
    frozen = GraphLoader(tr, 8, shuffle=True)
    assert frozen.device_batches(0) is frozen.device_batches(5)
    for k, epochs in ((0, (0, 3)), (1, (0, 1, 2)), (2, (0, 1, 2, 3))):
        loader = GraphLoader(tr, 8, shuffle=True, scan_reshuffle_every=k)
        jloader = JaxGraphLoader(jtr, 8, shuffle=True, scan_reshuffle_every=k, prefetch=0)
        for epoch in epochs:
            mine, ref = loader.device_batches(epoch), jloader.stacked_device_batches(epoch)
            assert loader.device_batches(epoch) is mine  # kept, not rebuilt
            np.testing.assert_array_equal(np.stack([b.nodes.numpy() for b in mine]), np.asarray(ref.nodes))
            assert sum(int(b.node_mask.sum()) for b in mine) == sum(s.num_nodes for s in tr)
            want = np.random.default_rng(loader.seed + epoch).permutation(len(loader))
            np.testing.assert_array_equal(loader.epoch_order(epoch), want)
    reshuffled = GraphLoader(tr, 8, shuffle=True, scan_reshuffle_every=1)
    r0, r1 = reshuffled.device_batches(0), reshuffled.device_batches(1)
    assert not np.array_equal(r0[0].nodes.numpy(), r1[0].nodes.numpy())


def test_dispatch_resolution_follows_jax():
    tr = _splits(deterministic_graph_data, prepare_dataset, update_config, flagship_config(16, 2, 8), 24)[0]
    loader = GraphLoader(tr, 8, shuffle=True)
    nn = {"Training": {}}
    assert t_loop.resolve_dispatch({}, nn, loader)["mode"] == "fixed_epoch"
    assert t_loop.resolve_dispatch({"scan_epoch": False}, nn, loader) == {
        "mode": "per_step", "auto": False, "reason": "Training.scan_epoch=false"}
    assert t_loop.resolve_dispatch({"scan_epoch": True}, nn, loader)["reason"] == "Training.scan_epoch=true"
    assert t_loop.resolve_dispatch({}, {"Profile": {}}, loader)["reason"] == "per-step profiler configured"
    assert t_loop.resolve_dispatch({"watchdog_stall_s": 30}, nn, loader)["reason"] == "hang watchdog active"
    assert t_loop.resolve_dispatch({}, nn, list(loader))["reason"] == "loader cannot stack device-resident batches"

    class TooBig(GraphLoader):
        def device_batches(self, epoch=0):
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")

    out = t_loop.resolve_dispatch({}, nn, TooBig(tr, 8, shuffle=True))
    assert out == {"mode": "per_step", "auto": True, "reason": "stacking failed: OutOfMemoryError"}


def test_streaming_split_trains_like_jax_per_step(tmp_path, one_thread):
    """``scan_epoch: false`` on both sides: per-step streaming over
    batches re-formed from a sample permutation each epoch."""
    jax_side, port_side = _both_flagship(epochs=2, optimizer={"type": "SGD", "learning_rate": 0.05},
                                         scan_epoch=False)
    jhist, hist, _, _ = _run_both(jax_side, port_side, tmp_path)
    assert hist["dispatch_mode"]["mode"] == "per_step"
    for key in ("train_loss", "val_loss", "test_loss"):
        np.testing.assert_allclose(hist[key], jhist[key], rtol=LOSS_RTOL, err_msg=key)


# ---- F3: the non-finite guard -------------------------------------------


def _poisoned(batch):
    return dataclasses.replace(batch, nodes=torch.full_like(batch.nodes, float("nan")))


def _state(model, optimizer):
    return ([t.detach().clone() for t in model.parameters()] + [t.clone() for t in model.buffers()]
            + [t.clone() for t in optimizer.state_tensors()] + [optimizer.steps.clone()])


def test_guarded_step_leaves_the_state_bit_unchanged_on_a_nan_batch(one_thread):
    """A NaN batch: parameters, every optimizer state tensor, the
    BatchNorm statistics and the step count bit-unchanged, zero loss,
    consec 1; the next good batch lands and resets consec, as the JAX
    guarded step does on the same batches."""
    (jtr, _, _, jcfg), (tr, _, _, cfg) = _both_flagship(n=24)
    jbatch = next(iter(JaxGraphLoader(jtr, 8, prefetch=0)))
    batch = next(iter(GraphLoader(tr, 8, prefetch=0)))
    jmodel, variables, tx = _jax_state(jcfg, jbatch)
    jstep = jax_make_train_step(jmodel, tx, guard_nonfinite=True)
    jstate = create_train_state(variables, tx)
    model, optimizer = _port_model(cfg, variables)
    step = make_train_step(model, optimizer, guard_nonfinite=True)
    consec, jconsec = torch.zeros((), dtype=torch.int32), jnp.zeros((), jnp.int32)
    jnan = jbatch.replace(nodes=np.full_like(np.asarray(jbatch.nodes), np.nan))
    for b, jb, want_bad in ((_poisoned(batch), jnan, 1.0), (_poisoned(batch), jnan, 1.0), (batch, jbatch, 0.0)):
        before = _state(model, optimizer)
        loss, tasks, consec, bad = step(b, consec)
        jstate, jloss, _, jconsec, jbad = jstep(jstate, jb, jconsec)
        assert float(bad) == float(jbad) == want_bad
        assert int(consec) == int(jconsec) and int(optimizer.steps) == int(jstate.step)
        after = _state(model, optimizer)
        if want_bad:
            assert float(loss) == 0.0 and not tasks.any()
            assert all(torch.equal(a, b_) for a, b_ in zip(before, after))
        else:
            np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
            assert not all(torch.equal(a, b_) for a, b_ in zip(before, after))
    assert int(consec) == 0 and int(optimizer.steps) == 1


def test_guarded_step_equals_the_plain_step_on_finite_data(one_thread):
    (_, _, _, jcfg), (tr, _, _, cfg) = _both_flagship(n=24)
    batches = list(GraphLoader(tr, 8, shuffle=True, prefetch=0))
    runs = []
    for guard in (False, True):
        model = create_model_config(cfg["NeuralNetwork"], device="cpu")
        optimizer = select_optimizer(model, cfg["NeuralNetwork"]["Training"])
        step = make_train_step(model, optimizer, guard_nonfinite=guard)
        consec = torch.zeros((), dtype=torch.int32)
        losses = [(step(b, consec) if guard else step(b))[0] for b in batches]
        runs.append((losses, _state(model, optimizer)))
    assert all(torch.equal(a, b) for a, b in zip(runs[0][0], runs[1][0]))
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


class _NanAt:
    """A train loader that poisons train steps ``start .. start+count-1``
    (counted over the run, as the JAX package's HYDRAGNN_INJECT_NAN_STEP
    does) and offers no resident batches (the JAX package streams per
    step under injection too)."""

    def __init__(self, loader, start, count):
        self.loader, self.start, self.count, self.step = loader, start, count, 0
        self.shuffle = loader.shuffle

    def __len__(self):
        return len(self.loader)

    def set_epoch(self, epoch):
        self.loader.set_epoch(epoch)

    def __iter__(self):
        for b in self.loader:
            bad = self.start <= self.step < self.start + self.count
            self.step += 1
            yield _poisoned(b) if bad else b


def _nan_runs(tmp_path, monkeypatch, spec, epochs, **training):
    jax_side, port_side = _both_flagship(n=20, batch=5, epochs=epochs,
                                         optimizer={"type": "SGD", "learning_rate": 0.05}, **training)
    monkeypatch.setenv("HYDRAGNN_INJECT_NAN_STEP", spec)
    start, count = (int(x) for x in spec.split(":"))
    tr = port_side[0]
    return jax_side, port_side, _NanAt(GraphLoader(tr, 5, shuffle=True), start, count)


def test_nan_batches_are_skipped_as_jax_skips_them(tmp_path, monkeypatch, one_thread):
    """Steps 3 and 4 poisoned (epochs of 4 steps): one skip in each of
    epochs 0 and 1, and the same losses as the JAX package's run."""
    jax_side, port_side, loader = _nan_runs(tmp_path, monkeypatch, "3:2", 3)
    jhist, hist, _, _ = _run_both(jax_side, port_side, tmp_path, port_train_loader=loader)
    assert hist["dispatch_mode"]["mode"] == "per_step" and hist["nonfinite_skipped"] == [1, 1, 0]
    assert np.isfinite(hist["train_loss"]).all()
    for key in ("train_loss", "val_loss", "test_loss"):
        np.testing.assert_allclose(hist[key], jhist[key], rtol=LOSS_RTOL, err_msg=key)


def test_consecutive_nans_roll_back_to_the_last_good_checkpoint(tmp_path, monkeypatch, one_thread):
    """Steps 6-7, the tail of epoch 1: its consec (2) meets the patience,
    the run rolls back to epoch 0's checkpoint at half the learning rate
    and carries on, as the JAX package's does."""
    jax_side, port_side, loader = _nan_runs(tmp_path, monkeypatch, "6:2", 4, checkpoint_every=1,
                                            nonfinite_patience=2)
    jhist, hist, _, _ = _run_both(jax_side, port_side, tmp_path, port_train_loader=loader)
    assert hist["rollbacks"] == [1] and len(hist["train_loss"]) == len(jhist["train_loss"]) == 3
    assert hist["lr"][-1] == pytest.approx(hist["lr"][0] * 0.5)
    assert hist["lr"] == pytest.approx(jhist["lr"])
    for key in ("train_loss", "val_loss", "test_loss"):
        np.testing.assert_allclose(hist[key], jhist[key], rtol=LOSS_RTOL, err_msg=key)


def test_rollback_budget_exhausts_to_the_typed_failure(tmp_path, monkeypatch, one_thread):
    jax_side, port_side, loader = _nan_runs(tmp_path, monkeypatch, "6:100", 6, checkpoint_every=1,
                                            nonfinite_patience=2, nonfinite_max_rollbacks=1)
    with pytest.raises(JaxRollbackExhausted):
        _run_both(jax_side, port_side, tmp_path, port_train_loader=loader)
    # the JAX side raised first; the port's run on its own
    (tr, va, te, cfg) = port_side
    model, optimizer = _port_model(cfg, _jax_state(jax_side[3], next(iter(JaxGraphLoader(jax_side[0], 5))))[1])
    with pytest.raises(NonFiniteRollbackExhausted, match="rollbacks used 1/1"):
        t_loop.train_validate_test(model, optimizer, loader, GraphLoader(va, 5), GraphLoader(te, 5),
                                   cfg["NeuralNetwork"], log_dir=str(tmp_path / "alone") + "/")


# ---- F2: mixed precision, remat ------------------------------------------


def test_mixed_precision_step_matches_jax_bf16(one_thread):
    (jtr, _, _, jcfg), (tr, _, _, cfg) = _both_flagship(n=24, optimizer={"type": "SGD", "learning_rate": 1e-3})
    jbatches = list(JaxGraphLoader(jtr, 8, shuffle=True, prefetch=0))
    batches = list(GraphLoader(tr, 8, shuffle=True, prefetch=0))
    jmodel, variables, tx = _jax_state(jcfg, jbatches[0])
    jstates = {dt: create_train_state(variables, tx) for dt in ("f32", "bf16")}
    jsteps = {"f32": jax_make_train_step(jmodel, tx), "bf16": jax_make_train_step(jmodel, tx, compute_dtype=jnp.bfloat16)}
    model, optimizer = _port_model(cfg, variables)
    step = make_train_step(model, optimizer, compute_dtype=torch.bfloat16)
    start = variables_from_flax(variables)
    for i, (b, jb) in enumerate(zip(batches, jbatches)):
        jstates["f32"] = jsteps["f32"](jstates["f32"], jb)[0]
        jstates["bf16"], jloss, jtasks = jsteps["bf16"](jstates["bf16"], jb)
        loss, tasks = step(b)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=BF16_LOSS_RTOL)
        np.testing.assert_allclose(tasks.numpy(), np.asarray(jtasks), rtol=BF16_LOSS_RTOL)
        if i == 0:  # the first update, from the same parameters on both sides
            got = {k: p.detach() - start[k] for k, p in model.named_parameters()}
            want = {dt: {k: v - start[k] for k, v in variables_from_flax({"params": jax.device_get(s.params)}).items()}
                    for dt, s in jstates.items()}
            names = [k for k in got if not k.endswith("post.bias")]  # 0 up to rounding (feeds a BatchNorm)

            def rel(a, b):
                num = sum(float(((a[k] - b[k]) ** 2).sum()) for k in names)
                return math.sqrt(num / sum(float((b[k] ** 2).sum()) for k in names))

            assert rel(got, want["bf16"]) <= BF16_UPDATE_FACTOR * rel(want["bf16"], want["f32"])
    for p in model.parameters():
        assert p.dtype == torch.float32
    for t in list(model.buffers()) + optimizer.state_tensors():
        assert t.dtype in (torch.float32, torch.int32)


def test_mixed_precision_trains_finite_and_falling(tmp_path, one_thread):
    cfg = flagship_config(16, 2, 8, 3)
    cfg["NeuralNetwork"]["Training"]["mixed_precision"] = True
    raw = deterministic_graph_data(number_configurations=48, seed=0, **UNIT)
    _, _, hist, _ = hg.run_training(cfg, raw, log_dir=str(tmp_path), device="cpu")
    assert np.isfinite(hist["train_loss"]).all() and hist["train_loss"][-1] < hist["train_loss"][0]


def test_remat_step_equals_the_plain_step(one_thread):
    """``Training.remat``: the same loss, parameters and BatchNorm
    statistics bit for bit, the statistics updated once."""
    (_, _, _, _), (tr, _, _, cfg) = _both_flagship(n=24)
    batches = list(GraphLoader(tr, 8, shuffle=True, prefetch=0))
    runs = []
    for remat in (False, True):
        model = create_model_config(cfg["NeuralNetwork"], device="cpu")
        optimizer = select_optimizer(model, cfg["NeuralNetwork"]["Training"])
        step = make_train_step(model, optimizer, remat=remat)
        runs.append(([step(b)[0] for b in batches], _state(model, optimizer)))
    assert all(torch.equal(a, b) for a, b in zip(runs[0][0], runs[1][0]))
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


# ---- the prefetch thread and cached batches -----------------------------


def _fields(batch):
    return [(k, v) for k, v in batch.__dict__.items() if isinstance(v, torch.Tensor)]


def _loader(**kw):
    tr = _splits(deterministic_graph_data, prepare_dataset, update_config, flagship_config(16, 2, 8), 40)[0]
    return GraphLoader(tr, 8, shuffle=True, **kw)


def test_prefetch_yields_the_inline_batches():
    inline, ahead = _loader(prefetch=0), _loader(prefetch=2)
    for epoch in (0, 1):
        inline.set_epoch(epoch)
        ahead.set_epoch(epoch)
        got, want = list(ahead), list(inline)
        assert len(got) == len(want) == len(inline)
        for a, b in zip(got, want):
            for (k, x), (_, y) in zip(_fields(a), _fields(b)):
                assert torch.equal(x, y), k


def test_prefetch_depth_reads_the_port_knob(monkeypatch):
    monkeypatch.setenv("HGTORCH_NUM_PREFETCH", "5")
    assert _loader().prefetch == 5
    assert _loader(prefetch=1).prefetch == 1
    monkeypatch.setenv("HGTORCH_NUM_PREFETCH", "two")
    with pytest.raises(ValueError, match="HGTORCH_NUM_PREFETCH"):
        _loader()


def _prefetch_threads():
    return [t for t in threading.enumerate() if t.name == "GraphLoader-prefetch"]


def test_prefetch_producer_error_is_raised_in_the_consumer(monkeypatch):
    loader = _loader(prefetch=2)
    real, calls = loader.make_batch, []

    def failing(idx):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("producer broke")
        return real(idx)

    monkeypatch.setattr(loader, "make_batch", failing)
    got = []
    with pytest.raises(RuntimeError, match="producer broke"):
        for b in loader:
            got.append(b)
    assert len(got) == 2 and not _prefetch_threads()


def test_abandoned_iterator_stops_the_prefetch_thread():
    loader = _loader(prefetch=1)
    it = iter(loader)
    next(it)
    assert _prefetch_threads()
    it.close()
    deadline = time.time() + 10
    while _prefetch_threads() and time.time() < deadline:
        time.sleep(0.05)
    assert not _prefetch_threads()


def test_cache_device_batches_keeps_membership_and_permutes_order():
    cfg = flagship_config(16, 2, 8)
    cfg["NeuralNetwork"]["Training"].update(cache_device_batches=True, scan_reshuffle_every=2)
    tr, va, te, cfg = _splits(deterministic_graph_data, prepare_dataset, update_config, cfg, 40)
    train, val, _ = create_dataloaders(tr, va, te, cfg)
    assert train.cache_device_batches and val.cache_device_batches and train.scan_reshuffle_every == 2
    # batch b holds samples[b·bs:(b+1)·bs], as the JAX loader's cache
    # (scan_reshuffle_every moves only device_batches' membership)
    fixed = [train.make_batch(np.arange(len(tr))[b * 8:(b + 1) * 8]) for b in range(len(train))]
    seen = []
    for epoch in (0, 1):
        train.set_epoch(epoch)
        batches = list(train)
        order = np.random.default_rng(train.seed + epoch).permutation(len(train))
        for b, i in zip(batches, order):
            assert torch.equal(b.nodes, fixed[i].nodes)
        seen.append([id(b) for b in batches])
    assert sorted(seen[0]) == sorted(seen[1]) and seen[0] != seen[1]


# ---- ROADMAP A-1: the stacks' smoke bars through the port ---------------


@pytest.mark.parametrize("model_type", sorted(m for m in SMOKE_THRESHOLDS if m != "GAT"))
def test_stack_smoke_bar_through_run_training(model_type, tmp_path):
    """tests/test_train_e2e.py's 15-epoch smoke (150 samples,
    ``_smoke_budget``) on the port's run_training -> run_prediction, held
    to its SMOKE_THRESHOLDS (GAT's is held in test_torch_gat_knobs.py)."""
    def config():
        c = make_config(model_type, False, str(tmp_path), num_epoch=15)
        _smoke_budget(c)
        return c

    def samples():
        return deterministic_graph_data(number_configurations=150, seed=0)

    hg.run_training(config(), samples(), log_dir=str(tmp_path) + "/logs/", device="cpu")
    _, err_tasks, trues, preds = hg.run_prediction(config(), samples(), log_dir=str(tmp_path) + "/logs/",
                                                   device="cpu")
    rmse_bar, mae_bar = SMOKE_THRESHOLDS[model_type]
    for ihead, (t, p) in enumerate(zip(trues, preds)):
        mae = float(np.mean(np.abs(t - p)))
        assert float(err_tasks[ihead]) < rmse_bar and mae < mae_bar, (model_type, ihead, float(err_tasks[ihead]), mae)
