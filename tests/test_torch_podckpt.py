"""The port's pod fault tolerance (``hydragnn_tpu_torch/resilience/
podckpt.py``, ``PodSupervisor``, ``PodHostLost``, the pod injections, the
pod restore in ``utils/checkpoint.py``) against the JAX package's
(``hydragnn_tpu/resilience/{podckpt,supervisor,preempt,inject}.py``).

Exact equality between the packages: ``classify_pod_exit`` and the pod's
exit code over every exit-code map of ``tests/test_podckpt.py`` and a grid
of them; the two ``PodSupervisor``s through the same scripted fake
processes (results, histories, flight events, sleeps, child environments
with the port's ``HGTORCH_`` names read as ``HYDRAGNN_``); the pod
injection parsers; the manifest's and the COMMIT's JSON keys and
``format_version``. The payload is the port's own (``torch.save``), so the
commit protocol itself is held to the JAX tests' contract on a model and
optimizer of the port after a few AdamW steps: round trips and the
re-shard from 2 writers (and from 2 FSDP-style slices) onto one process
are exact; a torn shard falls back a generation; a generation without its
COMMIT is never restored; the commit and barrier waits are bounded; a
newer ``format_version`` is refused. One real recovery leg (``ci.sh``'s
small config) runs ``supervise --pod 2`` with child processes: host 1 is
SIGKILLed mid-checkpoint, the pod restarts from the last COMMIT, and its
losses are bit-equal to the same run in this process."""

import copy
import glob
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from hydragnn_tpu.resilience import inject as jinject
from hydragnn_tpu.resilience import supervisor as jsup
from hydragnn_tpu.resilience.podckpt import commit_generation as jax_commit
from hydragnn_tpu.resilience.podckpt import save_pod_shard as jax_save_pod_shard

from hydragnn_tpu_torch.resilience import inject as tinject
from hydragnn_tpu_torch.resilience import podckpt
from hydragnn_tpu_torch.resilience import supervisor as tsup
from hydragnn_tpu_torch.resilience.podckpt import (
    PodShardError,
    PodSignaler,
    commit_generation,
    list_committed_generations,
    pod_barrier,
    read_commit,
    restore_pod_checkpoint,
    save_pod_shard,
)
from hydragnn_tpu_torch.resilience.preempt import PodHostLost, PreemptionHandler
from hydragnn_tpu_torch.utils.checkpoint import CheckpointFormatError

from test_podckpt import _FakeProc, _fake_state as jax_fake_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UNIT = dict(unit_cell_x_range=(2, 3), unit_cell_y_range=(2, 3), unit_cell_z_range=(2, 3))


def _as_jax_names(env):
    return {k.replace("HGTORCH_", "HYDRAGNN_", 1): v for k, v in env.items()}


def _state(steps, seed=0):
    """The flagship at hidden 8, 2 layers, after ``steps`` AdamW steps on
    seeded data: a model and optimizer with every kind of leaf."""
    from hydragnn_tpu_torch.api import create_dataloaders, prepare_config_and_samples
    from hydragnn_tpu_torch.data.synthetic import deterministic_graph_data
    from hydragnn_tpu_torch.flagship import flagship_config
    from hydragnn_tpu_torch.models.create import create_model_config
    from hydragnn_tpu_torch.train.optimizer import select_optimizer
    from hydragnn_tpu_torch.train.state import make_train_step

    cfg = flagship_config(hidden_dim=8, num_conv_layers=2, batch_size=5, num_epoch=1)
    tr, va, te, done = prepare_config_and_samples(cfg, deterministic_graph_data(number_configurations=12, seed=3,
                                                                                **UNIT))
    model = create_model_config(done["NeuralNetwork"], seed=seed, device="cpu")
    opt = select_optimizer(model, done["NeuralNetwork"]["Training"])
    step = make_train_step(model, opt)
    batches = list(create_dataloaders(tr, va, te, done)[0])
    for i in range(steps):
        step(batches[i % len(batches)])
    return model, opt, done


def _fresh(done, seed=9):
    from hydragnn_tpu_torch.models.create import create_model_config
    from hydragnn_tpu_torch.train.optimizer import select_optimizer

    model = create_model_config(done["NeuralNetwork"], seed=seed, device="cpu")
    return model, select_optimizer(model, done["NeuralNetwork"]["Training"])


def _snapshot(model, opt):
    leaves = {f"model/{k}": v.detach().clone() for k, v in model.state_dict().items()}
    sd = opt.state_dict()
    for idx, st in sd["rule"]["state"].items():
        for k, v in st.items():
            leaves[f"opt/{idx}/{k}"] = v.detach().clone() if isinstance(v, torch.Tensor) else v
    leaves["opt/steps"] = sd["steps"].clone()
    return leaves


def _equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


def _save_generation(run_dir, model, opt, gen, hosts=2, step=None):
    for h in range(hosts):
        save_pod_shard(model, run_dir, gen=gen, host=h, hosts=hosts, optimizer=opt, epoch=gen,
                       step=int(opt.steps) if step is None else step)
    return commit_generation(run_dir, gen, hosts, timeout_s=5.0)


# -- the commit protocol and the re-shard -----------------------------------------


def test_pod_roundtrip_and_elastic_restore(tmp_path):
    run_dir = str(tmp_path)
    model, opt, done = _state(3)
    commit = _save_generation(run_dir, model, opt, gen=1)
    assert commit["committed"] and commit["gen"] == 1
    assert list_committed_generations(run_dir) == [1]
    assert read_commit(run_dir, 1)["step"] == 3
    # each leaf has one owner: the two hosts' shards split the leaves
    owners = [json.load(open(os.path.join(run_dir, "podckpt", f"ckpt.gen1.host{h}.manifest.json")))["leaves"]
              for h in (0, 1)]
    paths = [e["path"] for m in owners for e in m]
    assert len(paths) == len(set(paths)) and all(m for m in owners)
    # onto one fresh process: the 2-host -> 1-host re-shard
    model2, opt2 = _fresh(done)
    epoch, info = restore_pod_checkpoint(model2, run_dir, optimizer=opt2)
    assert epoch == 1 and info == {"gen": 1, "step": 3, "hosts": 2, "layout": None, "fallbacks": []}
    _equal(_snapshot(model2, opt2), _snapshot(model, opt))
    assert podckpt.consume_last_restore_info() == info
    assert podckpt.consume_last_restore_info() is None


def test_sliced_leaves_reassemble_and_replicas_write_once(tmp_path):
    """FSDP's layout without a group: each of two ranks keeps dim-0 slices
    of the sharded parameters (a ``ShardedParams``-shaped store), a second
    data replica of each writes nothing of them, and one process
    reassembles the whole tensors exactly."""
    import types

    from hydragnn_tpu_torch.parallel.sharded import LeafShard

    run_dir = str(tmp_path)
    model, opt, done = _state(2)
    whole = {n: p.detach().clone() for n, p in model.named_parameters()}
    sharded = [p for p in model.parameters() if p.dim() >= 1 and p.shape[0] % 2 == 0]
    writers = [(0, 0, 0), (1, 1, 0), (2, 0, 1), (3, 1, 1)]  # (host, slice index, replica)
    for host, index, replica in writers:
        shards = {id(p): LeafShard(0, 2, index, None, replica) for p in sharded}
        model.sharded_params = types.SimpleNamespace(
            pairs=[(p, shards[id(p)]) for p in sharded],
            slices={id(p): shards[id(p)].take(p.detach()).clone() for p in sharded})
        man = save_pod_shard(model, run_dir, gen=1, host=host, hosts=4, optimizer=opt, epoch=1, step=2)
        sliced = [e for e in man["leaves"] if e["slices"] is not None]
        assert bool(sliced) == (replica == 0)
        for e in sliced:
            assert e["slices"][0] == [index * e["shape"][0] // 2, (index + 1) * e["shape"][0] // 2]
    del model.sharded_params
    assert commit_generation(run_dir, 1, 4, timeout_s=5.0)["committed"]
    flat, _ = podckpt.load_generation(run_dir, 1)
    for n, p in whole.items():
        assert torch.equal(flat[f"model/{n}"], p), n
    model2, opt2 = _fresh(done)
    restore_pod_checkpoint(model2, run_dir, optimizer=opt2)
    _equal(_snapshot(model2, opt2), _snapshot(model, opt))
    # a slice missing: the coverage check names the leaf
    os.remove(os.path.join(run_dir, "podckpt", "ckpt.gen1.host1.manifest.json"))
    save_pod_shard(model, run_dir, gen=1, host=1, hosts=4, optimizer=opt, epoch=1)  # whole leaves only now
    with pytest.raises(PodShardError, match="incomplete shard coverage"):
        podckpt.load_generation(run_dir, 1)


def test_manifest_and_commit_keys_match_jax(tmp_path):
    model, opt, _ = _state(1)
    ours = save_pod_shard(model, str(tmp_path / "t"), gen=1, host=0, hosts=1, optimizer=opt, step=1, layout={"x": 1})
    theirs = jax_save_pod_shard(jax_fake_state(1, 1.0), str(tmp_path / "j"), gen=1, host=0, hosts=1, step=1,
                                layout={"x": 1})
    assert sorted(ours) == sorted(theirs)
    assert ours["format_version"] == theirs["format_version"] == 2
    assert sorted(ours["leaves"][0]) == sorted(theirs["leaves"][0])
    assert commit_generation(str(tmp_path / "t"), 1, 1, timeout_s=1)["committed"]
    assert jax_commit(str(tmp_path / "j"), 1, 1, timeout_s=1)["committed"]
    assert sorted(read_commit(str(tmp_path / "t"), 1)) == sorted(json.load(open(tmp_path / "j" / "podckpt" /
                                                                                 "gen1.COMMIT")))
    assert sorted(os.listdir(tmp_path / "t" / "podckpt")) == [
        "ckpt.gen1.host0.manifest.json", "ckpt.gen1.host0.pt", "ckpt.gen1.host0.pt.sha256", "gen1.COMMIT"]


def test_newest_commit_wins_and_prune_keeps_last(tmp_path):
    run_dir = str(tmp_path)
    model, opt, done = _state(1)
    for gen in (1, 2, 3, 4):
        assert _save_generation(run_dir, model, opt, gen=gen, step=gen)["committed"]
    model2, opt2 = _fresh(done)
    epoch, info = restore_pod_checkpoint(model2, run_dir, optimizer=opt2)
    assert info["gen"] == 4 and info["step"] == 4 and epoch == 4
    podckpt.prune_generations(run_dir, keep_last=2)
    assert list_committed_generations(run_dir) == [3, 4]
    assert not glob.glob(os.path.join(run_dir, "podckpt", "ckpt.gen1.*"))


@pytest.mark.parametrize("how", ["corrupt_after_commit", "injected_torn_shard"])
def test_torn_shard_falls_back_a_generation(tmp_path, monkeypatch, how):
    run_dir = str(tmp_path)
    good_model, good_opt, done = _state(1)
    assert _save_generation(run_dir, good_model, good_opt, gen=1)["committed"]
    later_model, later_opt, _ = _state(3)
    if how == "injected_torn_shard":
        monkeypatch.setenv("HGTORCH_INJECT_POD_TORN_SHARD", "1:2")
    assert _save_generation(run_dir, later_model, later_opt, gen=2)["committed"] is (how == "corrupt_after_commit")
    if how == "corrupt_after_commit":
        shard = os.path.join(run_dir, "podckpt", "ckpt.gen2.host1.pt")
        data = open(shard, "rb").read()
        with open(shard, "wb") as f:
            f.write(data[: len(data) // 2])
        model2, opt2 = _fresh(done)
        with pytest.warns(RuntimeWarning, match="gen2"):
            _, info = restore_pod_checkpoint(model2, run_dir, optimizer=opt2)
        assert info["gen"] == 1 and info["fallbacks"][0]["gen"] == 2
        _equal(_snapshot(model2, opt2), _snapshot(good_model, good_opt))
    else:
        # the digest refuses the torn payload at the commit: gen 2 never commits
        assert list_committed_generations(run_dir) == [1]


def test_missing_commit_marker_is_never_valid(tmp_path):
    run_dir = str(tmp_path)
    model, opt, done = _state(1)
    assert _save_generation(run_dir, model, opt, gen=1)["committed"]
    later, later_opt, _ = _state(2)
    for h in range(2):
        save_pod_shard(later, run_dir, gen=2, host=h, hosts=2, optimizer=later_opt, epoch=2)
    assert list_committed_generations(run_dir) == [1]
    model2, opt2 = _fresh(done)
    _, info = restore_pod_checkpoint(model2, run_dir, optimizer=opt2)
    assert info["gen"] == 1
    _equal(_snapshot(model2, opt2), _snapshot(model, opt))


def test_commit_and_barrier_waits_are_bounded(tmp_path, monkeypatch):
    run_dir = str(tmp_path)
    model, opt, _ = _state(1)
    save_pod_shard(model, run_dir, gen=1, host=0, hosts=2, optimizer=opt)
    t0 = time.monotonic()
    commit = commit_generation(run_dir, 1, 2, timeout_s=0.3, poll_s=0.02)
    assert time.monotonic() - t0 < 3.0
    assert not commit["committed"] and commit.get("timeout") and commit["missing"] == [1]
    assert list_committed_generations(run_dir) == []
    monkeypatch.setenv("HGTORCH_POD_LOST_AFTER_S", "0.05")
    sig = PodSignaler(run_dir, host=0, hosts=2)
    time.sleep(0.15)
    commit = commit_generation(run_dir, 1, 2, timeout_s=5.0, poll_s=0.02, signaler=sig)
    assert not commit["committed"] and commit["lost"] == [1]
    ok, missing = pod_barrier(run_dir, "setup", 0, 2, timeout_s=0.3, poll_s=0.02)
    assert not ok and missing == [1]
    ok, missing = pod_barrier(run_dir, "setup", 1, 2, timeout_s=2.0, poll_s=0.02)
    assert ok and missing == []


def test_future_format_version_is_refused(tmp_path):
    from hydragnn_tpu_torch.utils.checkpoint import (
        CHECKPOINT_FORMAT_VERSION,
        load_existing_model,
        save_model,
        save_train_meta,
    )

    run_dir = str(tmp_path / "run")
    model, opt, done = _state(1)
    assert _save_generation(run_dir, model, opt, gen=1)["committed"]
    path = os.path.join(run_dir, "podckpt", "gen1.COMMIT")
    rec = json.load(open(path))
    rec["format_version"] = CHECKPOINT_FORMAT_VERSION + 1
    with open(path, "w") as f:
        json.dump(rec, f)
    with pytest.raises(CheckpointFormatError):
        read_commit(run_dir, 1)
    model2, opt2 = _fresh(done)
    with pytest.raises(CheckpointFormatError):  # an upgrade refusal never falls back
        restore_pod_checkpoint(model2, run_dir, optimizer=opt2)
    with pytest.raises(CheckpointFormatError):
        load_existing_model(model2, "run", str(tmp_path), optimizer=opt2)
    # a newer meta sidecar is refused before the pod generations are read
    rec["format_version"] = CHECKPOINT_FORMAT_VERSION
    with open(path, "w") as f:
        json.dump(rec, f)
    save_model(model, "run", str(tmp_path), optimizer=opt, epoch=1)
    save_train_meta({"epoch": 1, "step": 1, "format_version": CHECKPOINT_FORMAT_VERSION + 1}, "run", str(tmp_path))
    with pytest.raises(CheckpointFormatError):
        load_existing_model(model2, "run", str(tmp_path), optimizer=opt2)


def test_load_existing_model_takes_the_committed_generation_and_reconciles_the_meta(tmp_path):
    from hydragnn_tpu_torch.utils.checkpoint import (
        checkpoint_exists,
        load_existing_model,
        load_train_meta,
        save_model,
        save_train_meta,
    )

    log_dir = str(tmp_path)
    run_dir = os.path.join(log_dir, "run")
    assert not checkpoint_exists("run", log_dir)
    gen1, gen1_opt, done = _state(1)
    assert _save_generation(run_dir, gen1, gen1_opt, gen=1)["committed"]
    assert checkpoint_exists("run", log_dir)  # committed generations alone count
    later, later_opt, _ = _state(3)
    # the single file and the meta of epoch 2, whose generation never committed
    save_model(later, "run", log_dir, optimizer=later_opt, epoch=2)
    save_train_meta({"epoch": 2, "step": 3, "early_stopped": False, "history": {"train_loss": [1.0, 0.5]}},
                    "run", log_dir)
    model2, opt2 = _fresh(done)
    assert load_existing_model(model2, "run", log_dir, optimizer=opt2) == 1
    _equal(_snapshot(model2, opt2), _snapshot(gen1, gen1_opt))
    meta = load_train_meta("run", log_dir)
    assert (meta["epoch"], meta["step"], meta["history"]["train_loss"]) == (1, 1, [1.0])


# -- heartbeats, loss detection, coordinated preemption -----------------------------


def test_signaler_lost_detection_dedupe_and_stale_beats(tmp_path, monkeypatch):
    run_dir = str(tmp_path)
    monkeypatch.setenv("HGTORCH_POD_HEARTBEAT_S", "0.01")
    monkeypatch.setenv("HGTORCH_POD_LOST_AFTER_S", "0.2")
    sig1 = PodSignaler(run_dir, host=1, hosts=2)
    sig1.heartbeat(epoch=0, force=True)
    time.sleep(0.05)
    sig0 = PodSignaler(run_dir, host=0, hosts=2)
    assert sig0.lost_hosts() == []
    time.sleep(0.3)
    assert sig0.lost_hosts() == [1]
    assert sig0.undeclared_lost() == [1]
    assert sig0.undeclared_lost() == []
    assert sig0.mark_declared([1]) == []
    sig1.heartbeat(epoch=1, force=True)
    assert sig0.lost_hosts() == []
    # the LOST_HEARTBEAT injection silences the host from its epoch on
    monkeypatch.setenv("HGTORCH_INJECT_POD_LOST_HEARTBEAT", "1:2")
    before = json.load(open(os.path.join(run_dir, "podsync", "heartbeat.host1.json")))
    sig1.heartbeat(epoch=2, force=True)
    assert json.load(open(os.path.join(run_dir, "podsync", "heartbeat.host1.json"))) == before


def test_signaler_disarmed_by_default(tmp_path, monkeypatch):
    monkeypatch.delenv("HGTORCH_POD_LOST_AFTER_S", raising=False)
    sig = PodSignaler(str(tmp_path), host=0, hosts=4)
    assert sig.lost_after_s == 0.0 and sig.lost_hosts() == []


def test_coordinated_preempt_posting_and_max_gen(tmp_path):
    run_dir = str(tmp_path)
    sig0 = PodSignaler(run_dir, host=0, hosts=2)
    sig1 = PodSignaler(run_dir, host=1, hosts=2)
    handler = PreemptionHandler(hard_exit=False)
    handler.signaler = sig1
    handler.proposed_gen = 3
    handler._handle(15, None)
    req = sig0.preempt_request()
    assert (req["gen"], req["host"], req["signum"]) == (3, 1, 15)
    sig0.post_preempt(5, signum=15)
    assert sig1.preempt_request()["gen"] == 5
    PodSignaler(run_dir, host=0, hosts=2)  # a restarted host clears its own posting
    assert sig1.preempt_request()["gen"] == 3
    # ROADMAP C10: a posting older than the signaler is a previous
    # attempt's. The JAX package's restarted host still reads a peer's old
    # one (until that peer clears it at its own start) and preempts the new
    # attempt; the port's does not
    from hydragnn_tpu.resilience.podckpt import PodSignaler as JaxSignaler

    sig0.post_preempt(4, signum=15)
    time.sleep(0.02)
    assert PodSignaler(run_dir, host=1, hosts=2).preempt_request() is None
    assert JaxSignaler(run_dir, host=1, hosts=2).preempt_request()["gen"] == 4


# -- the injections' parsers --------------------------------------------------------


_SPECS = [None, "1:2", "0:0", "1", "3:7", "1:"]


@pytest.mark.parametrize("name", ["POD_TORN_SHARD", "POD_LOST_HEARTBEAT"])
def test_pod_injection_parsers_match_jax(monkeypatch, name):
    fn = {"POD_TORN_SHARD": "maybe_pod_torn_shard", "POD_LOST_HEARTBEAT": "maybe_pod_lost_heartbeat"}[name]
    for spec in _SPECS:
        for k in (f"HGTORCH_INJECT_{name}", "HYDRAGNN_INJECT_" + name):
            if spec is None:
                monkeypatch.delenv(k, raising=False)
            else:
                monkeypatch.setenv(k, spec)
        for host in (0, 1, 3):
            for g in (None, 0, 1, 2, 3, 5, 7):
                assert getattr(tinject, fn)(host, g) == getattr(jinject, fn)(host, g), (spec, host, g)


def test_pod_injections_are_stripped_from_restarts():
    env = {"HGTORCH_INJECT_POD_KILL_HOST": "1:2", "HGTORCH_INJECT_POD_TORN_SHARD": "0:1",
           "HGTORCH_INJECT_POD_LOST_HEARTBEAT": "1:0", "HGTORCH_INJECT_POD_BARRIER_STALL": "1:3",
           "HGTORCH_INJECT_STRAGGLER": "1:200", "KEEP": "1"}
    assert tinject.strip_injection_env(env) == {"KEEP": "1"}
    assert sorted(tinject.active_injections(env=env)) == sorted(k for k in env if k != "KEEP")
    stripped = jinject.strip_injection_env(_as_jax_names(env))
    assert stripped == {"KEEP": "1"}


# -- the pod's exit classification and the supervisor -------------------------------


_JAX_TEST_MAPS = [{0: 0, 1: 0}, {0: 75, 1: -9}, {0: 0, 1: -15}, {0: 75, 1: 0}, {0: 79, 1: 75}, {0: 79, 1: 0},
                  {0: 1, 1: 0}, {0: 78, 1: -9}, {0: 76, 1: 75}]
_CODES = [0, 1, 75, 76, 78, 79, -9, -15]


def test_classify_pod_exit_matches_jax():
    maps = list(_JAX_TEST_MAPS) + [{0: a, 1: b} for a in _CODES for b in _CODES] + \
        [{0: a, 1: b, 2: c} for a in _CODES for b in _CODES for c in (0, 75, -9)] + [{0: a} for a in _CODES]
    for m in maps:
        cause = tsup.classify_pod_exit(m)
        assert cause == jsup.classify_pod_exit(m), m
        assert tsup._pod_exit_code(m, cause) == jsup._pod_exit_code(m, cause), m
    for mod in (tsup, jsup):
        with pytest.raises(ValueError):
            mod.classify_pod_exit({})


class _Flight:
    def __init__(self):
        self.calls = []

    def record(self, kind, **payload):
        self.calls.append((kind, payload))

    def end_run(self, status, **payload):
        self.calls.append(("run_end", dict(payload, status=status)))


def _scripts(case):
    return {
        "host_lost": [[_FakeProc(rc=None), _FakeProc(rc=-9)], [_FakeProc(rc=0), _FakeProc(rc=0)]],
        "elastic": [[_FakeProc(rc=None), _FakeProc(rc=None), _FakeProc(rc=-9)], [_FakeProc(rc=0), _FakeProc(rc=0)]],
        "fail_fast": [[_FakeProc(rc=None), _FakeProc(rc=78)]],
        "crash_backoff": [[_FakeProc(rc=1), _FakeProc(rc=None)], [_FakeProc(rc=79), _FakeProc(rc=0)],
                          [_FakeProc(rc=0), _FakeProc(rc=0)]],
        "preempt_gives_up": [[_FakeProc(rc=75), _FakeProc(rc=None)], [_FakeProc(rc=None), _FakeProc(rc=75)]],
    }[case]


@pytest.mark.parametrize("case,hosts,kw", [
    ("host_lost", 2, dict(policy=dict(max_restarts=0))),
    ("elastic", 3, dict(elastic=True)),
    ("fail_fast", 2, {}),
    ("crash_backoff", 2, dict(policy=dict(backoff_base_s=0.5, backoff_factor=3.0))),
    ("preempt_gives_up", 2, dict(policy=dict(max_preemptions=1))),
])
def test_pod_supervisor_matches_jax(case, hosts, kw):
    results = []
    for mod, env in ((tsup, {"HGTORCH_INJECT_POD_KILL_HOST": "1:2", "KEEP": "1"}),
                     (jsup, _as_jax_names({"HGTORCH_INJECT_POD_KILL_HOST": "1:2", "KEEP": "1"}))):
        script, launches, sleeps, flight = _scripts(case), [], [], _Flight()

        def fake_popen(argv, env=None):
            attempt = 0
            seen = len(launches)
            while seen >= len(script[attempt]):
                seen -= len(script[attempt])
                attempt += 1
            launches.append(_as_jax_names(dict(env or {})))
            return script[attempt][seen]

        policy = mod.SupervisorPolicy(**kw.get("policy", {}))
        sup = mod.PodSupervisor(["cmd"], hosts=hosts, policy=policy, env=env, flight=flight, run_id="podrun",
                                popen=fake_popen, sleep=sleeps.append, elastic=kw.get("elastic", False))
        results.append((sup.run(), launches, sleeps, flight.calls))
    assert results[0] == results[1]
    result, launches, sleeps, calls = results[0]
    for i, env in enumerate(launches):
        assert env["HYDRAGNN_PODVIEW_RUN_ID"] == "podrun" and env["KEEP"] == "1"
    if case == "host_lost":
        assert result["status"] == "completed" and sleeps == [] and result["preemptions"] == 1
        assert [k for k, _ in calls] == ["host_lost", "restart", "run_end"]
        assert "HYDRAGNN_INJECT_POD_KILL_HOST" in launches[0]
        assert all("HYDRAGNN_INJECT_POD_KILL_HOST" not in e and e["HYDRAGNN_AUTO_RESUME"] == "1" for e in launches[2:])
    if case == "elastic":
        assert result["hosts"] == 2 and [h["hosts"] for h in result["history"]] == [3, 2]
    if case == "fail_fast":
        assert (result["status"], result["cause"], result["attempts"]) == ("failed_fast", "config_error", 1)


# -- one real recovery leg with child processes -----------------------------------

_CHILD = r"""
import os, sys
sys.modules["torch.utils.tensorboard"] = None
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads(1)
from hydragnn_tpu_torch.api import prepare_loaders_and_config, train_with_loaders
from hydragnn_tpu_torch.data.synthetic import deterministic_graph_data
from hydragnn_tpu_torch.flagship import flagship_config
from hydragnn_tpu_torch.obs.podview import host_identity
from hydragnn_tpu_torch.resilience import run_guard
from hydragnn_tpu_torch.resilience.podckpt import pod_barrier

cfg = flagship_config(hidden_dim=8, num_conv_layers=2, batch_size=5, num_epoch=3)
cfg["NeuralNetwork"]["Training"].update(checkpoint_every=1, scan_epoch=False)
samples = deterministic_graph_data(number_configurations=20, seed=0, unit_cell_x_range=(2, 3),
                                   unit_cell_y_range=(2, 3), unit_cell_z_range=(2, 3))
# run_training's two halves, the data prepared before the barrier: the hosts
# then enter their loops (and install their SIGTERM handlers) together
*loaders, done = prepare_loaders_and_config(cfg, samples)
host, hosts = host_identity()
if hosts > 1:
    pod_barrier(sys.argv[2], "start.attempt" + os.environ.get("HGTORCH_AUTO_RESUME", "0"), host, hosts,
                timeout_s=60)
with run_guard():
    train_with_loaders(done, *loaders, log_dir=sys.argv[1] + "/logs/", device="cpu")
"""


def test_one_real_pod_recovery_leg_is_bit_equal_to_the_run_in_process(tmp_path, monkeypatch):
    from hydragnn_tpu_torch.api import run_training
    from hydragnn_tpu_torch.data.synthetic import deterministic_graph_data
    from hydragnn_tpu_torch.flagship import flagship_config
    from hydragnn_tpu_torch.obs.flight import read_flight_record
    from hydragnn_tpu_torch.resilience.podckpt import latest_commit_info
    from hydragnn_tpu_torch.utils.checkpoint import load_train_meta

    script = tmp_path / "child.py"
    script.write_text(_CHILD.format(repo=REPO))
    env = {k: v for k, v in os.environ.items() if not k.startswith(("HGTORCH_", "HYDRAGNN_PODVIEW"))}
    # host 1 straggles (50 ms a step), so host 0 is at its commit wait, not
    # before its loop, when host 1 dies
    env.update(HGTORCH_INJECT_POD_KILL_HOST="1:2", HGTORCH_INJECT_STRAGGLER="1:50", HGTORCH_POD_COMMIT_TIMEOUT_S="6",
               HGTORCH_DIAGNOSTICS="0", OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-m", "hydragnn_tpu_torch.tools.supervise", "--pod", "2", "--pod-grace",
                           "60", "--run-id", "podrec", "--flight", str(tmp_path / "sup.jsonl"), "--",
                           sys.executable, str(script), str(tmp_path / "pod"), str(tmp_path / "sync")],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=400)
    assert proc.returncode == 0, proc.stderr[-4000:]
    # the same run in this process, uninterrupted
    monkeypatch.setenv("HGTORCH_DIAGNOSTICS", "0")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = flagship_config(hidden_dim=8, num_conv_layers=2, batch_size=5, num_epoch=3)
        cfg["NeuralNetwork"]["Training"].update(checkpoint_every=1, scan_epoch=False)
        run_training(cfg, samples=deterministic_graph_data(number_configurations=20, seed=0, **UNIT),
                     log_dir=str(tmp_path / "ref" / "logs") + "/", device="cpu")
    finally:
        torch.set_num_threads(threads)
    sup = read_flight_record(str(tmp_path / "sup.jsonl"))
    lost = [e for e in sup if e["kind"] == "host_lost"]
    restarts = [e for e in sup if e["kind"] == "restart"]
    assert len(lost) == 1 and lost[0]["host"] == 1 and lost[0]["exit_code"] < 0
    assert len(restarts) == 1 and restarts[0]["cause"] == "host_lost" and restarts[0]["delay_s"] == 0
    assert restarts[0]["hosts"] == 2
    assert [e["status"] for e in sup if e["kind"] == "run_end"] == ["completed"]
    (flight,) = glob.glob(str(tmp_path / "pod" / "logs" / "*" / "flight.jsonl"))
    run_dir = os.path.dirname(flight)
    ev = read_flight_record(flight)
    assert [e["status"] for e in ev if e["kind"] == "run_end"] == ["preempted", "completed"]
    assert [e["signal"] for e in ev if e["kind"] == "preempt"] == [15]
    assert any(e["kind"] == "error" and e["error_type"] == "PodCommitFailed" for e in ev)
    (resume,) = [e for e in ev if e["kind"] == "pod_resume"]
    assert resume["gen"] == 1 and resume["prior_hosts"] == 2 and not resume["fallbacks"]
    assert [e for e in ev if e["kind"] == "run_start"][-1]["manifest"]["pod_resume"]["resumed_from_gen"] == 1
    assert int(latest_commit_info(run_dir)["gen"]) == 3
    assert int(load_train_meta(os.path.basename(run_dir), os.path.dirname(run_dir))["epoch"]) == 3
    (ref_flight,) = glob.glob(str(tmp_path / "ref" / "logs" / "*" / "flight.jsonl"))
    ref = {e["epoch"]: e for e in read_flight_record(ref_flight) if e["kind"] == "epoch"}
    got = {e["epoch"]: e for e in ev if e["kind"] == "epoch"}  # the restarted segment's epochs come last
    assert sorted(got) == sorted(ref) == [0, 1, 2]
    for ep in ref:
        for k in ("train_loss", "val_loss", "test_loss"):
            assert got[ep][k] == ref[ep][k], (ep, k)
