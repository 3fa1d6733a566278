"""Result plots: parity scatters, error histograms, density and
conditional-mean figures, loss curves, the node-count histogram (the
port's copy of ``hydragnn_tpu/postprocess/visualizer.py``: the same
methods writing the same file names under ``<log_dir>/<name>/``).

Values arrive as per-head numpy arrays, the format of
``train/loop.py:test_epoch``. matplotlib is imported when a
``Visualizer`` is made, with the Agg backend, not when this module is
imported: it is an optional dependency, and a ``Visualizer`` without it
raises ``ImportError`` naming it.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np


def _pyplot():
    """matplotlib's pyplot on the Agg backend."""
    try:
        import matplotlib
    except ImportError as exc:
        raise ImportError(
            "the Visualizer (Visualization.create_plots) needs matplotlib, which is not installed"
        ) from exc
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


class Visualizer:
    def __init__(
        self,
        model_with_config_name: str,
        num_heads: int = 1,
        head_names: Optional[Sequence[str]] = None,
        log_dir: str = "./logs/",
    ):
        self.name = model_with_config_name
        self.num_heads = num_heads
        self.head_names = list(head_names or [f"head{i}" for i in range(num_heads)])
        self.out_dir = os.path.join(log_dir, model_with_config_name)
        self._plt = _pyplot()
        os.makedirs(self.out_dir, exist_ok=True)

    # ---- per-head parity scatter (reference create_scatter_plots) ----

    def create_scatter_plots(
        self,
        true_values: List[np.ndarray],
        predicted_values: List[np.ndarray],
        output_names: Optional[Sequence[str]] = None,
        iepoch: Optional[int] = None,
    ) -> List[str]:
        names = list(output_names or self.head_names)
        paths = []
        for ihead in range(len(true_values)):
            t = np.asarray(true_values[ihead]).reshape(-1)
            p = np.asarray(predicted_values[ihead]).reshape(-1)
            fig, ax = self._plt.subplots(figsize=(5, 5))
            ax.scatter(t, p, s=4, alpha=0.4, edgecolors="none")
            lo = float(min(t.min(), p.min())) if t.size else 0.0
            hi = float(max(t.max(), p.max())) if t.size else 1.0
            ax.plot([lo, hi], [lo, hi], "k--", linewidth=1)
            ax.set_xlabel("True")
            ax.set_ylabel("Predicted")
            suffix = "" if iepoch is None else f"_epoch{iepoch}"
            ax.set_title(f"{names[ihead]}{suffix}")
            path = os.path.join(self.out_dir, f"scatter_{names[ihead]}{suffix}.png")
            fig.tight_layout()
            fig.savefig(path, dpi=100)
            self._plt.close(fig)
            paths.append(path)
        return paths

    # ---- per-head error histogram (reference create_error_histograms) ----

    def create_error_histograms(
        self,
        true_values: List[np.ndarray],
        predicted_values: List[np.ndarray],
        output_names: Optional[Sequence[str]] = None,
        iepoch: Optional[int] = None,
    ) -> List[str]:
        names = list(output_names or self.head_names)
        paths = []
        for ihead in range(len(true_values)):
            err = (
                np.asarray(predicted_values[ihead]).reshape(-1)
                - np.asarray(true_values[ihead]).reshape(-1)
            )
            fig, ax = self._plt.subplots(figsize=(5, 4))
            ax.hist(err, bins=50)
            ax.set_xlabel("Predicted - True")
            ax.set_ylabel("Count")
            suffix = "" if iepoch is None else f"_epoch{iepoch}"
            ax.set_title(f"{names[ihead]} error{suffix}")
            path = os.path.join(self.out_dir, f"errhist_{names[ihead]}{suffix}.png")
            fig.tight_layout()
            fig.savefig(path, dpi=100)
            self._plt.close(fig)
            paths.append(path)
        return paths

    # ---- 2-D density + conditional mean (reference create_plot_global) ----

    def create_plot_global(
        self,
        true_values: List[np.ndarray],
        predicted_values: List[np.ndarray],
        output_names: Optional[Sequence[str]] = None,
    ) -> List[str]:
        names = list(output_names or self.head_names)
        paths = []
        for ihead in range(len(true_values)):
            t = np.asarray(true_values[ihead]).reshape(-1)
            p = np.asarray(predicted_values[ihead]).reshape(-1)
            fig, axes = self._plt.subplots(1, 3, figsize=(13, 4))
            if t.size:
                h, xe, ye = np.histogram2d(t, p, bins=50)
                xc = 0.5 * (xe[:-1] + xe[1:])
                yc = 0.5 * (ye[:-1] + ye[1:])
                hmax = h.max() if h.max() > 0 else 1.0
                axes[0].contourf(xc, yc, (h / hmax).T, levels=10)
                # conditional mean error per true-value bin
                bin_ids = np.clip(np.digitize(t, xe) - 1, 0, len(xc) - 1)
                cond_mean = np.full(len(xc), np.nan)
                for b in range(len(xc)):
                    sel = bin_ids == b
                    if sel.any():
                        cond_mean[b] = (p[sel] - t[sel]).mean()
                axes[1].plot(xc, cond_mean)
                axes[2].hist(p - t, bins=50, density=True)
            axes[0].set_title(f"{names[ihead]} density")
            axes[1].set_title("conditional mean error")
            axes[2].set_title("error pdf")
            path = os.path.join(self.out_dir, f"global_{names[ihead]}.png")
            fig.tight_layout()
            fig.savefig(path, dpi=100)
            self._plt.close(fig)
            paths.append(path)
        return paths

    # ---- vector parity grid (reference create_parity_plot_vector,
    # hydragnn/postprocess/visualizer.py:467-516) ----

    def create_parity_plot_vector(
        self,
        varname: str,
        true_values: np.ndarray,
        predicted_values: np.ndarray,
        head_dim: int,
        iepoch: Optional[int] = None,
    ) -> str:
        """Per-component parity scatters for a vector head: one panel per
        component in a near-square grid."""
        t = np.asarray(true_values).reshape(-1, head_dim)
        p = np.asarray(predicted_values).reshape(-1, head_dim)
        nrow = int(np.floor(np.sqrt(head_dim))) or 1
        ncol = int(np.ceil(head_dim / nrow))
        fig, axs = self._plt.subplots(nrow, ncol, figsize=(ncol * 4, nrow * 4), squeeze=False)
        axs = axs.flatten()
        markers = ["o", "s", "d"]
        for ic in range(head_dim):
            self._parity_panel(
                axs[ic], t[:, ic], p[:, ic],
                marker=markers[ic % len(markers)], title=f"comp:{ic}",
            )
        for iext in range(head_dim, axs.size):
            axs[iext].axis("off")
        suffix = "" if iepoch is None else f"_epoch{iepoch}"
        path = os.path.join(self.out_dir, f"vector_{varname}{suffix}.png")
        fig.tight_layout()
        fig.savefig(path, dpi=100)
        self._plt.close(fig)
        return path

    # ---- per-node error histograms (reference
    # create_error_histogram_per_node, visualizer.py:387-466) ----

    def create_error_histogram_per_node(
        self,
        varname: str,
        true_values: np.ndarray,
        predicted_values: np.ndarray,
        iepoch: Optional[int] = None,
    ) -> Optional[str]:
        """Error PDF per node site for fixed-size graphs (the LSMS
        multihead diagnostic): inputs [num_samples, num_nodes], one panel
        per node plus a per-sample SUM panel and a per-node
        summed-over-samples panel."""
        t = np.asarray(true_values)
        p = np.asarray(predicted_values)
        if t.ndim != 2 or t.shape[1] == 1:
            return None
        n_nodes = t.shape[1]
        nrow = int(np.floor(np.sqrt(n_nodes + 2))) or 1
        ncol = int(np.ceil((n_nodes + 2) / nrow))
        fig, axs = self._plt.subplots(
            nrow, ncol, figsize=(ncol * 3.5, nrow * 3.2), squeeze=False
        )
        axs = axs.flatten()

        for inode in range(n_nodes):
            self._errpdf_panel(
                axs[inode], p[:, inode] - t[:, inode], f"node:{inode}"
            )
        self._errpdf_panel(axs[n_nodes], p.sum(axis=1) - t.sum(axis=1), "SUM")
        self._errpdf_panel(
            axs[n_nodes + 1],
            p.sum(axis=0) - t.sum(axis=0),
            f"SMP_Mean4sites:0-{n_nodes}",
        )
        for iext in range(n_nodes + 2, axs.size):
            axs[iext].axis("off")
        suffix = "" if iepoch is None else f"_epoch{iepoch}"
        path = os.path.join(self.out_dir, f"errhist_pernode_{varname}{suffix}.png")
        fig.tight_layout()
        fig.savefig(path, dpi=100)
        self._plt.close(fig)
        return path

    # ---- per-node vector parity grid (reference
    # create_parity_plot_per_node_vector, visualizer.py:519-613) ----

    def create_parity_plot_per_node_vector(
        self,
        varname: str,
        true_values: np.ndarray,
        predicted_values: np.ndarray,
        head_dim: int = 3,
        iepoch: Optional[int] = None,
    ) -> Optional[str]:
        """Per-node parity panels for a nodal VECTOR head on fixed-size
        graphs: inputs [num_samples, num_nodes * head_dim]; one panel per
        node with a marker per component, plus per-sample SUM and
        per-node summed-over-samples panels."""
        t = np.asarray(true_values)
        p = np.asarray(predicted_values)
        if t.ndim != 2 or t.shape[1] % head_dim:
            return None
        s = t.shape[0]
        t = t.reshape(s, -1, head_dim)
        p = p.reshape(s, -1, head_dim)
        n_nodes = t.shape[1]
        markers = ["o", "s", "d"]
        nrow = int(np.floor(np.sqrt(n_nodes + 2))) or 1
        ncol = int(np.ceil((n_nodes + 2) / nrow))
        fig, axs = self._plt.subplots(nrow, ncol, figsize=(ncol * 3, nrow * 3), squeeze=False)
        axs = axs.flatten()
        for inode in range(n_nodes):
            for ic in range(head_dim):
                self._parity_panel(
                    axs[inode], t[:, inode, ic], p[:, inode, ic],
                    marker=markers[ic % len(markers)], title=f"node:{inode}", s=6,
                )
        for ic in range(head_dim):
            self._parity_panel(
                axs[n_nodes], t[:, :, ic].sum(1), p[:, :, ic].sum(1),
                marker=markers[ic % len(markers)], title="SUM", s=40,
            )
            self._parity_panel(
                axs[n_nodes + 1], t[:, :, ic].sum(0), p[:, :, ic].sum(0),
                marker=markers[ic % len(markers)],
                title=f"SMP_Mean4sites:0-{n_nodes}", s=40,
            )
        for iext in range(n_nodes + 2, axs.size):
            axs[iext].axis("off")
        suffix = "" if iepoch is None else f"_epoch{iepoch}"
        path = os.path.join(self.out_dir, f"parity_pernode_{varname}{suffix}.png")
        fig.tight_layout()
        fig.savefig(path, dpi=100)
        self._plt.close(fig)
        return path

    # ---- global analysis (reference create_plot_global_analysis,
    # visualizer.py:134-280: scalar 1x3 / vector 3x3 with length & sum
    # rows and conditional-mean-abs-error overlays) ----

    def create_plot_global_analysis(
        self,
        varname: str,
        true_values: np.ndarray,
        predicted_values: np.ndarray,
    ) -> str:
        t = np.asarray(true_values)
        p = np.asarray(predicted_values)
        if t.ndim == 1:
            t, p = t[:, None], p[:, None]
        if t.shape[1] == 1:
            fig, axs = self._plt.subplots(1, 3, figsize=(15, 4.5))
            self._parity_panel(axs[0], t[:, 0], p[:, 0], title="Scalar output")
            self._condmean_panel(axs[1], t[:, 0], p[:, 0])
            self._errpdf_panel(axs[2], p[:, 0] - t[:, 0], "Scalar output: error PDF")
        else:
            fig, axs = self._plt.subplots(3, 3, figsize=(15, 13))
            vlen_t = np.linalg.norm(t, axis=1)
            vlen_p = np.linalg.norm(p, axis=1)
            vsum_t, vsum_p = t.sum(axis=1), p.sum(axis=1)
            w = 1.0 / np.sqrt(t.shape[1])
            for col, (tt, pp, label, weight) in enumerate(
                (
                    (vlen_t, vlen_p, "length", w),
                    (vsum_t, vsum_p, "sum", w),
                    (t.reshape(-1), p.reshape(-1), "components", 1.0),
                )
            ):
                self._parity_panel(axs[0, col], tt, pp, title=f"Vector output: {label}")
                self._condmean_panel(axs[1, col], tt, pp, weight=weight)
                self._errpdf_panel(axs[2, col], pp - tt, f"{label}: error PDF")
        path = os.path.join(self.out_dir, f"global_analysis_{varname}.png")
        fig.tight_layout()
        fig.savefig(path, dpi=100)
        self._plt.close(fig)
        return path

    # ---- the full reference artifact set for one test pass ----

    def create_reference_plot_suite(
        self,
        true_values: List[np.ndarray],
        predicted_values: List[np.ndarray],
        output_types: Sequence[str],
        nodes_per_graph: Optional[Sequence[int]] = None,
        iepoch: Optional[int] = None,
    ) -> List[str]:
        """Dispatch every applicable reference plot family per head:
        vector parity grids for dim>1 heads; per-node error histograms /
        per-node vector grids for nodal heads when all test graphs share
        one size (the LSMS use case — per-node panels are meaningless for
        ragged graph sizes); global-analysis figures for every head."""
        paths: List[str] = []
        fixed = (
            nodes_per_graph is not None
            and len(set(int(n) for n in nodes_per_graph)) == 1
        )
        n_nodes = int(nodes_per_graph[0]) if fixed else 0
        # one panel per node only makes sense for small fixed cells (the
        # LSMS 32-atom diagnostic); a supercell dataset would render a
        # thousand-panel figure (or exceed matplotlib's pixel limit)
        if n_nodes > 64:
            fixed = False
        for ihead, name in enumerate(self.head_names[: len(true_values)]):
            t = np.asarray(true_values[ihead])
            p = np.asarray(predicted_values[ihead])
            dim = t.shape[1] if t.ndim == 2 else 1
            if dim > 1:
                paths.append(
                    self.create_parity_plot_vector(name, t, p, dim, iepoch)
                )
            if output_types[ihead] == "node" and fixed and n_nodes > 1:
                # rows arrive node-major per graph: [S * n_nodes, dim]
                per_node_t = t.reshape(-1, n_nodes * dim)
                per_node_p = p.reshape(-1, n_nodes * dim)
                if dim == 1:
                    r = self.create_error_histogram_per_node(
                        name, per_node_t, per_node_p, iepoch
                    )
                else:
                    r = self.create_parity_plot_per_node_vector(
                        name, per_node_t, per_node_p, dim, iepoch
                    )
                if r:
                    paths.append(r)
            paths.append(self.create_plot_global_analysis(name, t, p))
        return paths

    # ---- shared panel helpers ----

    def _parity_panel(self, ax, t, p, marker="o", title="", s=6):
        t = np.asarray(t).reshape(-1)
        p = np.asarray(p).reshape(-1)
        ax.scatter(t, p, s=s, alpha=0.5, marker=marker, edgecolors="none")
        if t.size:
            lo = float(min(t.min(), p.min()))
            hi = float(max(t.max(), p.max()))
            # panels drawn in several calls (one per vector component)
            # must keep limits covering EVERY component, not the last
            prev = getattr(ax, "_hgt_parity_lim", None)
            if prev is not None:
                lo, hi = min(lo, prev[0]), max(hi, prev[1])
            ax._hgt_parity_lim = (lo, hi)
            ax.plot([lo, hi], [lo, hi], "k--", linewidth=1)
            ax.set_xlim(lo, hi)
            ax.set_ylim(lo, hi)
        if title:
            ax.set_title(title)

    def _condmean_panel(self, ax, t, p, weight=1.0, bins=40):
        """Conditional mean ABSOLUTE error vs the true value (reference
        __err_condmean, visualizer.py:100-132)."""
        t = np.asarray(t).reshape(-1)
        p = np.asarray(p).reshape(-1)
        if t.size:
            edges = np.histogram_bin_edges(t, bins=bins)
            ids = np.clip(np.digitize(t, edges) - 1, 0, bins - 1)
            err = np.abs(p - t) * weight
            sums = np.bincount(ids, weights=err, minlength=bins)
            cnts = np.bincount(ids, minlength=bins)
            centers = 0.5 * (edges[:-1] + edges[1:])
            good = cnts > 0
            ax.plot(centers[good], sums[good] / cnts[good], "ro", markersize=3)
        ax.set_title("Conditional mean abs. error")
        ax.set_xlabel("True")
        ax.set_ylabel("abs. error")

    def _errpdf_panel(self, ax, err, title):
        err = np.asarray(err).reshape(-1)
        if err.size:
            hist, edges = np.histogram(err, bins=40, density=True)
            ax.plot(0.5 * (edges[:-1] + edges[1:]), hist, "ro", markersize=3)
        ax.set_title(title)
        ax.set_xlabel("Error")
        ax.set_ylabel("PDF")

    # ---- loss-history curves (reference plot_history) ----

    def plot_history(self, history: Dict[str, list]) -> str:
        fig, ax = self._plt.subplots(figsize=(6, 4))
        for key in ("train_loss", "val_loss", "test_loss"):
            if history.get(key):
                ax.plot(history[key], label=key)
        ax.set_xlabel("Epoch")
        ax.set_ylabel("Loss")
        ax.set_yscale("log")
        ax.legend()
        path = os.path.join(self.out_dir, "history.png")
        fig.tight_layout()
        fig.savefig(path, dpi=100)
        self._plt.close(fig)
        return path

    # ---- node-count histogram (reference num_nodes_plot) ----

    def num_nodes_plot(self, num_nodes_list: Sequence[int]) -> str:
        fig, ax = self._plt.subplots(figsize=(5, 4))
        ax.hist(np.asarray(num_nodes_list), bins=30)
        ax.set_xlabel("Nodes per graph")
        ax.set_ylabel("Count")
        path = os.path.join(self.out_dir, "num_nodes.png")
        fig.tight_layout()
        fig.savefig(path, dpi=100)
        self._plt.close(fig)
        return path
