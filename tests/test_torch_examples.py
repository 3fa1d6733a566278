"""The port's example drivers (``hydragnn_tpu_torch/examples/``) against
the JAX package's (``examples/``), at ``tests/test_examples.py``'s tiny
arguments.

For each driver: the JAX driver's ``--preonly`` runs as a subprocess on
a hermetic copy of its example directory (``tests/test_examples.py``'s
``_example_copy`` and ``_run_example``, ``JAX_PLATFORMS=cpu``), the
port's in-process in a working directory of its own. Then the JAX
driver's training phase runs in-process with its ``train_with_loaders``
replaced by a recorder (the config and loaders it would train on, and
the driver's own timers), and the port's training phase runs for real
on the CPU.

Tolerances: none. The raw files are byte-equal; the containers' samples
(float32 as stored), their global min-max and attributes bit-equal; the
samples and completed config the training phase builds equal (for QM9
and MD17, which write no container, these are the prepared samples).
The port's run gives finite losses, one ``metrics.jsonl`` line an epoch,
and the JAX driver's timers plus the loop's ``train_validate_test``.
"""

import copy
import importlib
import importlib.util
import json
import os
import sys

import numpy as np
import pytest

from hydragnn_tpu.data.container import ContainerDataset as JaxContainerDataset
from hydragnn_tpu.utils import time_utils as j_time

from hydragnn_tpu_torch.data.container import ContainerDataset
from hydragnn_tpu_torch.utils import time_utils as t_time
from hydragnn_tpu_torch.utils.config import get_log_name_config

from test_examples import _example_copy, _run_example
from test_torch_conv_stacks import one_thread  # noqa: F401
from test_torch_data import _assert_samples_equal
from test_torch_data_formats import _strip

LOOP_TIMERS = {"train_validate_test"}  # the loop's own, held to the JAX loop's in test_torch_records.py

# (example dir, JAX script, port module, tiny arguments, raw data under
# dataset/, container under dataset/ or None)
DRIVERS = [
    ("ising_model", "train_ising.py", "ising_model.train_ising", ["--natom", "2", "--cutoff", "6"],
     "ising_model_2_6", "ising_model_2_6.hgc"),
    ("lsms", "lsms.py", "lsms.lsms", ["--nconfig", "40"], "FePt_enthalpy", "FePt_32atoms.hgc"),
    ("eam", "eam.py", "eam.eam", ["--nconfig", "30"], "NiNb_solid_solution", "NiNb_NiNb_EAM_energy.hgc"),
    ("csce", "train_gap.py", "csce.train_gap", ["--sampling", "0.2"], "csce_gap.csv", "csce_gap.hgc"),
    ("ogb", "train_gap.py", "ogb.train_gap", ["--sampling", "0.05"], "pcqm4m_gap.csv", "ogb_gap.hgc"),
    ("qm9", "qm9.py", "qm9.qm9", ["--nsamples", "120"], None, None),
    ("md17", "md17.py", "md17.md17", ["--maxframes", "150"], None, None),
]


@pytest.fixture(autouse=True, scope="module")
def _diagnostics_off():
    """The training loop's per-head diagnostics and hardware ledger off in
    this file (``test_torch_{introspect,train_obs}.py`` test them): they
    add a forward and H + 1 backward pulls an epoch, and a counted
    forward and backward a run, to every run here."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HGTORCH_DIAGNOSTICS", "0")
        yield


def _tree_bytes(path):
    """{relative path: bytes} of a file, or of every file under a directory."""
    if os.path.isfile(path):
        with open(path, "rb") as f:
            return {"": f.read()}
    out = {}
    for root, _, files in os.walk(path):
        for name in files:
            full = os.path.join(root, name)
            with open(full, "rb") as f:
                out[os.path.relpath(full, path)] = f.read()
    return out


def _jax_training_phase(workdir, subdir, script, args, monkeypatch):
    """The JAX driver's training phase in-process, from its hermetic copy,
    with ``train_with_loaders`` recording (config, loaders) instead of
    training; returns them and the driver's timer names."""
    spec = importlib.util.spec_from_file_location(f"jax_example_{subdir}", os.path.join(workdir, script))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    seen = {}

    def record(config, *loaders, **kw):
        seen["config"], seen["loaders"] = copy.deepcopy(config), loaders

    monkeypatch.setattr(mod, "train_with_loaders", record)
    monkeypatch.setattr(sys, "argv", [script, *args])
    monkeypatch.chdir(workdir)
    j_time.reset_timers()
    mod.main()
    return seen["config"], seen["loaders"], set(j_time.timers_snapshot())


@pytest.mark.parametrize("subdir,script,module,args,raw,container", DRIVERS, ids=[d[0] for d in DRIVERS])
def test_driver_writes_and_trains_as_the_jax_driver(subdir, script, module, args, raw, container, tmp_path,
                                                      monkeypatch, one_thread):
    # one thread a process: the workers of a parallel run would otherwise
    # each start a pool as wide as the machine (the subprocess inherits it)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    driver = importlib.import_module(f"hydragnn_tpu_torch.examples.{module}")
    jax_dir = _example_copy(subdir, tmp_path)
    port_dir = tmp_path / "port"
    port_dir.mkdir()
    monkeypatch.chdir(port_dir)
    if container is not None:
        _run_example(subdir, script, "--preonly", *args, workdir=jax_dir)
        assert driver.main(["--preonly", *args, "--device", "cpu"]) is None
        ours, ref = _tree_bytes(os.path.join("dataset", raw)), _tree_bytes(os.path.join(jax_dir, "dataset", raw))
        assert sorted(ours) == sorted(ref) and ours, "raw file names"
        for name in ref:
            assert ours[name] == ref[name], f"raw file {name} differs"
        for split in ("trainset", "valset", "testset"):
            t = ContainerDataset(os.path.join("dataset", container, split), mode="preload")
            j = JaxContainerDataset(os.path.join(jax_dir, "dataset", container, split), mode="preload")
            _assert_samples_equal(t.samples(), j.samples())
            assert t.attrs == j.attrs
            for a, b in zip(t.minmax(), j.minmax()):
                assert (a is None) == (b is None)
                if a is not None:
                    np.testing.assert_array_equal(a, b)
                    assert a.dtype == b.dtype

    jax_config, jax_loaders, jax_timers = _jax_training_phase(jax_dir, subdir, script, args, monkeypatch)
    monkeypatch.chdir(port_dir)
    t_time.reset_timers()
    result = driver.main([*args, "--device", "cpu"])
    for ours, ref in zip(result.loaders, jax_loaders):
        _assert_samples_equal(ours.samples, ref.all_samples)
    assert _strip(result.config) == _strip(jax_config)

    hist = result.history
    epochs = result.config["NeuralNetwork"]["Training"]["num_epoch"]
    assert len(hist["train_loss"]) == epochs
    assert all(np.isfinite(hist[k]).all() for k in ("train_loss", "val_loss", "test_loss"))
    with open(os.path.join("logs", get_log_name_config(result.config), "metrics.jsonl")) as f:
        lines = [json.loads(ln) for ln in f]
    assert [ln["epoch"] for ln in lines] == list(range(epochs))
    assert [ln["train_loss"] for ln in lines] == hist["train_loss"]
    assert set(t_time.timers_snapshot()) == jax_timers | LOOP_TIMERS
