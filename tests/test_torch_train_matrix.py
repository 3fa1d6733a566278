"""The full train-to-accuracy matrix of ``tests/test_train_matrix.py``
through the port's ``run_training`` / ``run_prediction``: every conv
stack single- and multi-head, PNA, CGCNN and SchNet with edge lengths,
the node vector head from raw files, and SchNet's in-forward radius
graph, each at the reference budget (100 epochs, lr 0.02, batch 32).

Heavy, and meant for the card: skipped unless ``HGTORCH_FULL_MATRIX=1``
(the cases run on the card when one is present, else on the CPU). The
configs and bars are the JAX tests' own (``THRESHOLDS``, ``make_config``
from ``tests/test_train_e2e.py``, ``LENGTH_THRESHOLDS`` from
``tests/test_train_matrix.py``), imported unedited; where the JAX package
cannot be imported (the card's machine has no JAX), the two modules'
imports of it are stood in by empty modules, since the names taken from
them are plain data and a config builder. GIN's single-head bar is
printed, not gated (ROADMAP C3: the JAX package misses it at some
seeds). ``HGTORCH_MATRIX_REPORT=<path>`` appends one JSON line a case.
"""

import importlib
import json
import os
import sys
import types

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.skipif(
    os.environ.get("HGTORCH_FULL_MATRIX", "0") != "1",
    reason="the full matrix is gated behind HGTORCH_FULL_MATRIX=1",
)

ALL_MODELS = ["SAGE", "GIN", "GAT", "MFC", "PNA", "CGCNN", "SchNet"]
EPOCHS = 100
DEVICE = "cuda" if torch.cuda.is_available() else "cpu"
TESTS = os.path.dirname(os.path.abspath(__file__))


def _jax_test_module(name):
    """``tests/<name>.py`` imported unedited; without JAX, its imports of
    the JAX package are stood in by empty modules."""
    if TESTS not in sys.path:
        sys.path.insert(0, TESTS)
    try:
        return importlib.import_module(name)
    except ImportError:
        pass
    for mod in ("hydragnn_tpu", "hydragnn_tpu.api", "hydragnn_tpu.data", "hydragnn_tpu.data.synthetic"):
        stub = types.ModuleType(mod)
        stub.__getattr__ = lambda attr: None
        sys.modules.setdefault(mod, stub)
    sys.modules.setdefault("tests", types.ModuleType("tests"))
    e2e = importlib.import_module("test_train_e2e")
    sys.modules.setdefault("tests.test_train_e2e", e2e)
    return e2e if name == "test_train_e2e" else importlib.import_module(name)


_e2e = _jax_test_module("test_train_e2e")
_matrix = _jax_test_module("test_train_matrix")
THRESHOLDS, make_config, LENGTH_THRESHOLDS = _e2e.THRESHOLDS, _e2e.make_config, _matrix.LENGTH_THRESHOLDS


def _ref_budget(config):
    config["NeuralNetwork"]["Training"]["Optimizer"]["learning_rate"] = 0.02
    config["NeuralNetwork"]["Training"]["batch_size"] = 32


def _ref_budget_with_lengths(config):
    _ref_budget(config)
    config["NeuralNetwork"]["Architecture"]["edge_features"] = ["lengths"]


def _inforward(config):
    _ref_budget(config)
    config["NeuralNetwork"]["Architecture"]["radius_graph_in_forward"] = True


def _report(case, thresholds, heads, gated):
    ok = all(h["rmse"] < thresholds[0] and h["mae"] < thresholds[1] for h in heads)
    rec = {"case": case, "device": DEVICE, "thresholds_rmse_mae": list(thresholds), "heads": heads, "ok": ok,
           "gated": gated}
    print(f"[matrix] {json.dumps(rec)}", flush=True)
    path = os.environ.get("HGTORCH_MATRIX_REPORT")
    if path:
        with open(path, "a") as f:
            f.write(json.dumps(rec) + "\n")


def _train_and_check(case, model_type, multihead, tmp_path, mutate, thresholds=None, gated=True):
    from hydragnn_tpu_torch.api import run_prediction, run_training
    from hydragnn_tpu_torch.data.synthetic import deterministic_graph_data

    thresholds = thresholds or THRESHOLDS[model_type]
    log_dir = str(tmp_path) + "/logs/"
    configs = []
    for _ in range(2):
        cfg = make_config(model_type, multihead, str(tmp_path), EPOCHS)
        mutate(cfg)
        configs.append(cfg)
    model, _, _, _ = run_training(configs[0], samples=deterministic_graph_data(number_configurations=300, seed=0),
                                  log_dir=log_dir, device=DEVICE)
    _, rmse, trues, preds = run_prediction(configs[1], samples=deterministic_graph_data(number_configurations=300,
                                                                                        seed=0),
                                           log_dir=log_dir, device=DEVICE)
    heads = [{"rmse": float(rmse[i]), "mae": float(np.mean(np.abs(trues[i] - preds[i])))}
             for i in range(model.cfg.num_heads)]
    _report(case, thresholds, heads, gated)
    if gated:
        for i, h in enumerate(heads):
            assert h["rmse"] < thresholds[0], f"{case} head {i} RMSE {h['rmse']} >= {thresholds[0]}"
            assert h["mae"] < thresholds[1], f"{case} head {i} MAE {h['mae']} >= {thresholds[1]}"


@pytest.mark.parametrize("model_type", ALL_MODELS)
def test_matrix_singlehead(model_type, tmp_path):
    _train_and_check(f"{model_type}_singlehead", model_type, False, tmp_path, _ref_budget,
                     gated=model_type != "GIN")


@pytest.mark.parametrize("model_type", ALL_MODELS)
def test_matrix_multihead(model_type, tmp_path):
    _train_and_check(f"{model_type}_multihead", model_type, True, tmp_path, _ref_budget)


@pytest.mark.parametrize("model_type", ["PNA", "CGCNN", "SchNet"])
def test_matrix_edge_lengths(model_type, tmp_path):
    _train_and_check(f"{model_type}_edge_lengths", model_type, False, tmp_path, _ref_budget_with_lengths,
                     thresholds=LENGTH_THRESHOLDS[model_type])


def test_matrix_vector_output(tmp_path):
    """The node vector head (dim 2) from raw LSMS files, bars 0.2 / 0.15."""
    from hydragnn_tpu_torch.api import run_prediction, run_training
    from hydragnn_tpu_torch.data.synthetic import write_lsms_files

    data_dir = tmp_path / "lsms"
    write_lsms_files(str(data_dir), number_configurations=300, seed=0)
    config = make_config("PNA", False, str(tmp_path), num_epoch=40)
    config["Dataset"]["path"] = {"total": str(data_dir)}
    config["Dataset"]["node_features"] = {"name": ["atom_type", "out_x", "x2x3_vec"], "dim": [1, 1, 2],
                                          "column_index": [0, 5, 6]}
    voi = config["NeuralNetwork"]["Variables_of_interest"]
    voi.update(input_node_features=[0], output_names=["x2x3_vec"], output_index=[2], type=["node"])
    config["NeuralNetwork"]["Architecture"]["task_weights"] = [1.0]
    log_dir = str(tmp_path) + "/logs/"
    run_training(config, log_dir=log_dir, device=DEVICE)
    _, rmse, trues, preds = run_prediction({**config}, log_dir=log_dir, device=DEVICE)
    heads = [{"rmse": float(rmse[0]), "mae": float(np.mean(np.abs(trues[0] - preds[0])))}]
    _report("PNA_vector_output", (0.2, 0.15), heads, True)
    assert heads[0]["rmse"] < 0.2 and heads[0]["mae"] < 0.15
    assert trues[0].shape[-1] == 2


def test_matrix_schnet_inforward_radius(tmp_path):
    _train_and_check("SchNet_inforward_radius", "SchNet", False, tmp_path, _inforward)
