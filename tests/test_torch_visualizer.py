"""The port's ``Visualizer`` (``hydragnn_tpu_torch/postprocess/visualizer.py``)
against the JAX package's: ``tests/test_visualizer.py``'s three cases on
the port, the same file names from the same inputs, and the same
plotted arrays (scatter offsets, histogram bar heights, line data),
compared exactly: both draw the same numpy arrays through one
matplotlib; and ``run_training`` with ``Visualization.create_plots``
writing the PNG names the JAX loop writes on the same config.
"""

import os

import matplotlib
import numpy as np
import pytest

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from hydragnn_tpu.api import run_training as j_run_training  # noqa: E402
from hydragnn_tpu.data.synthetic import deterministic_graph_data as j_data  # noqa: E402
from hydragnn_tpu.postprocess.visualizer import Visualizer as JaxVisualizer  # noqa: E402
from hydragnn_tpu.utils.config import get_log_name_config as j_log_name  # noqa: E402

from hydragnn_tpu_torch.api import run_training  # noqa: E402
from hydragnn_tpu_torch.data.synthetic import deterministic_graph_data  # noqa: E402
from hydragnn_tpu_torch.postprocess.visualizer import Visualizer  # noqa: E402
from hydragnn_tpu_torch.utils.config import get_log_name_config  # noqa: E402

from test_train_e2e import make_config  # noqa: E402


def _pngs(path):
    return sorted(f for f in os.listdir(path) if f.endswith(".png"))


def _two_head_values(seed=0):
    rng = np.random.default_rng(seed)
    t = [rng.normal(size=(50, 1)), rng.normal(size=(200, 1))]
    p = [a + 0.1 * rng.normal(size=a.shape) for a in t]
    return t, p


def _lsms_like_values(seed=1, n_samples=30, n_nodes=4):
    """A scalar and a 3-vector nodal head on fixed 4-node graphs, rows
    node-major [S * n_nodes, dim]."""
    rng = np.random.default_rng(seed)
    t_scalar = rng.normal(size=(n_samples * n_nodes, 1))
    p_scalar = t_scalar + 0.05 * rng.normal(size=t_scalar.shape)
    t_vec = rng.normal(size=(n_samples * n_nodes, 3))
    p_vec = t_vec + 0.05 * rng.normal(size=t_vec.shape)
    return t_scalar, p_scalar, t_vec, p_vec


# -- tests/test_visualizer.py's cases on the port ------------------------------


def test_visualizer_artifacts(tmp_path):
    t, p = _two_head_values()
    viz = Visualizer("vtest", num_heads=2, head_names=["e", "x"], log_dir=str(tmp_path))
    for path in viz.create_scatter_plots(t, p, iepoch=3):
        assert os.path.exists(path)
    for path in viz.create_error_histograms(t, p):
        assert os.path.exists(path)
    for path in viz.create_plot_global(t, p):
        assert os.path.exists(path)
    hist = {"train_loss": [1.0, 0.5], "val_loss": [1.1, 0.6], "test_loss": [1.2, 0.7]}
    assert os.path.exists(viz.plot_history(hist))
    assert os.path.exists(viz.num_nodes_plot([4, 8, 8, 16]))


def test_train_loop_writes_the_jax_loops_plots(tmp_path):
    """``tests/test_visualizer.py``'s loop case on the port, and the JAX
    loop's run on the same config: the same PNG names."""
    viz = {"create_plots": True, "plot_init_solution": True, "plot_hist_solution": True}
    names = []
    for run, data, log_name, side in ((run_training, deterministic_graph_data, get_log_name_config, "port"),
                                      (j_run_training, j_data, j_log_name, "jax")):
        config = make_config("GIN", False, str(tmp_path / side), num_epoch=2)
        config["Visualization"] = dict(viz)
        log_dir = str(tmp_path / side / "logs") + "/"
        kw = {"device": "cpu"} if side == "port" else {}
        *_, full_config = run(config, samples=data(number_configurations=40, seed=2), log_dir=log_dir, **kw)
        names.append(_pngs(os.path.join(log_dir, log_name(full_config))))
    pngs = names[0]
    assert any(f.startswith("scatter_") for f in pngs)
    assert any(f.startswith("errhist_") for f in pngs)
    assert any(f.startswith("global_") for f in pngs)
    assert any(f.startswith("global_analysis_") for f in pngs)
    assert "history.png" in pngs
    assert names[0] == names[1]


def test_visualizer_vector_and_pernode(tmp_path):
    n_samples, n_nodes = 30, 4
    viz = Visualizer("vtest2", num_heads=2, head_names=["charge", "moment"], log_dir=str(tmp_path))
    t_scalar, p_scalar, t_vec, p_vec = _lsms_like_values(n_samples=n_samples, n_nodes=n_nodes)
    paths = viz.create_reference_plot_suite(
        [t_scalar, t_vec], [p_scalar, p_vec], output_types=["node", "node"],
        nodes_per_graph=[n_nodes] * n_samples,
    )
    assert len(paths) >= 5
    for path in paths:
        assert os.path.exists(path) and os.path.getsize(path) > 0
    names = [os.path.basename(p) for p in paths]
    for want in ("vector_moment.png", "errhist_pernode_charge.png", "parity_pernode_moment.png",
                 "global_analysis_charge.png", "global_analysis_moment.png"):
        assert want in names
    fig_path = viz.create_parity_plot_vector("moment", t_vec, p_vec, 3)
    assert os.path.getsize(fig_path) > 0
    fig, ax = plt.subplots()
    viz._parity_panel(ax, t_vec[:, 0], p_vec[:, 0])
    assert ax.collections and ax.collections[0].get_offsets().shape[0] == len(t_vec)
    plt.close(fig)
    ragged = viz.create_reference_plot_suite(
        [t_scalar], [p_scalar], output_types=["node"], nodes_per_graph=[3, 4] * n_samples,
    )
    assert not any("pernode" in os.path.basename(p) for p in ragged)


# -- against the JAX Visualizer ---------------------------------------------


def _drawn(fig):
    """Every axes' scatter offsets, bar heights and line data."""
    out = []
    for ax in fig.axes:
        out.append((
            [np.asarray(c.get_offsets()) for c in ax.collections if hasattr(c, "get_offsets")],
            [p.get_height() for p in ax.patches],
            [np.asarray(ln.get_xydata()) for ln in ax.lines],
            ax.get_title(),
        ))
    return out


def _every_plot(viz_cls, log_dir, monkeypatch):
    """Every method of a Visualizer on the same inputs: the files written
    and the figures' arrays, in call order."""
    figures = []
    real_close = plt.close

    def close(fig=None):
        figures.append(_drawn(fig))
        real_close(fig)

    monkeypatch.setattr(plt, "close", close)
    t, p = _two_head_values()
    t_s, p_s, t_v, p_v = _lsms_like_values()
    viz = viz_cls("cmp", num_heads=2, head_names=["e", "x"], log_dir=log_dir)
    paths = viz.create_scatter_plots(t, p, iepoch=3) + viz.create_error_histograms(t, p, iepoch=1)
    paths += viz.create_plot_global(t, p)
    paths += [viz.plot_history({"train_loss": [1.0, 0.5], "val_loss": [1.1, 0.6], "test_loss": [1.2, 0.7]})]
    paths += [viz.num_nodes_plot([4, 8, 8, 16])]
    paths += viz.create_reference_plot_suite([t_s, t_v], [p_s, p_v], ["node", "node"], [4] * 30, iepoch=2)
    paths += viz.create_reference_plot_suite([t_s], [p_s], ["graph"], [3, 4] * 15)
    monkeypatch.setattr(plt, "close", real_close)
    return sorted(os.path.basename(q) for q in paths), _pngs(os.path.join(log_dir, "cmp")), figures


def test_same_inputs_give_the_jax_visualizers_files_and_arrays(tmp_path, monkeypatch):
    names, files, figs = _every_plot(Visualizer, str(tmp_path / "port"), monkeypatch)
    j_names, j_files, j_figs = _every_plot(JaxVisualizer, str(tmp_path / "jax"), monkeypatch)
    assert names == j_names and files == j_files == sorted(set(names))
    assert len(figs) == len(j_figs) == len(names)  # a figure a file
    for fig, j_fig in zip(figs, j_figs):
        assert len(fig) == len(j_fig)
        for (offs, bars, lines, title), (j_offs, j_bars, j_lines, j_title) in zip(fig, j_fig):
            assert title == j_title
            assert len(offs) == len(j_offs) and len(lines) == len(j_lines)
            for a, b in zip(offs + lines, j_offs + j_lines):
                np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(bars, j_bars)


def test_plots_without_matplotlib_raise_naming_it(tmp_path, monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_matplotlib(name, *args, **kwargs):
        if name.split(".")[0] == "matplotlib":
            raise ImportError(f"No module named {name!r}")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    with pytest.raises(ImportError, match="matplotlib"):
        Visualizer("none", log_dir=str(tmp_path))
