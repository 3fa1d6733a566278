"""LSMS data-preparation tools (the port's copy of
``hydragnn_tpu/tools/lsms_tools.py``; the original HydraGNN's
``utils/lsms/``).

Two host-side utilities for binary-alloy LSMS datasets:

- ``convert_raw_data_energy_to_gibbs`` — rewrite each raw file's header
  total energy as the formation Gibbs energy: enthalpy relative to the
  linear mix of the two pure-element energies, minus T times the ideal
  configurational-entropy term (reference:
  utils/lsms/convert_total_energy_to_formation_gibbs.py:30-186).
- ``compositional_histogram_cutoff`` — downselect to at most N samples per
  composition bin (reference: utils/lsms/compositional_histogram_cutoff.py:16-76).

The binomial term uses ``math.lgamma`` instead of ``log(comb(n, k))`` so it
stays finite for arbitrarily large supercells.
"""

from __future__ import annotations

import math
import os
import shutil
from typing import Dict, List, Sequence, Tuple

import numpy as np

# LSMS energies are in Rydberg; k_B converted accordingly (same constants
# as the reference, convert_total_energy_to_formation_gibbs.py:175-177).
_KB_JOULE_PER_KELVIN = 1.380649e-23
_JOULE_PER_RYDBERG_INV = 4.5874208973812e17
KB_RYDBERG_PER_KELVIN = _KB_JOULE_PER_KELVIN * _JOULE_PER_RYDBERG_INV


def _read_lsms(path: str) -> Tuple[str, List[str], np.ndarray]:
    """(total_energy_token, raw_lines, atoms[n, cols]); one header line,
    atom rows after (col 0 = atomic number)."""
    with open(path, "r") as f:
        lines = f.readlines()
    energy_token = lines[0].split()[0]
    atoms = np.loadtxt(lines[1:], ndmin=2)
    return energy_token, lines, atoms


def _log_comb(n: int, k: int) -> float:
    return math.lgamma(n + 1) - math.lgamma(k + 1) - math.lgamma(n - k + 1)


def compute_formation_enthalpy(
    elements_list: Sequence[float],
    pure_elements_energy: Dict[float, float],
    total_energy: float,
    atoms: np.ndarray,
) -> Tuple[float, float, float, float, float]:
    """(composition_of_element0, total_energy, linear_mixing_energy,
    formation_enthalpy, entropy) for one binary-alloy configuration."""
    elements_list = sorted(elements_list)
    if len(elements_list) != 2:
        raise ValueError("binary alloys only")
    elements, counts = np.unique(atoms[:, 0], return_counts=True)
    for e in elements:
        if e not in elements_list:
            raise ValueError(f"element {e} not in binary {elements_list}")
    count_map = dict(zip(elements.tolist(), counts.tolist()))
    counts_full = [count_map.get(e, 0) for e in elements_list]

    num_atoms = int(atoms.shape[0])
    composition = counts_full[0] / num_atoms
    linear_mixing_energy = (
        pure_elements_energy[elements_list[0]] * composition
        + pure_elements_energy[elements_list[1]] * (1.0 - composition)
    ) * num_atoms
    formation_enthalpy = total_energy - linear_mixing_energy
    # thermodynamic (not statistical) entropy of the ideal mixture
    entropy = KB_RYDBERG_PER_KELVIN * _log_comb(num_atoms, counts_full[0])
    return composition, total_energy, linear_mixing_energy, formation_enthalpy, entropy


def convert_raw_data_energy_to_gibbs(
    dir: str,
    elements_list: Sequence[float],
    temperature_kelvin: float = 0.0,
    overwrite_data: bool = False,
    create_plots: bool = True,
) -> str:
    """Rewrite every LSMS file under ``dir`` into ``<dir>_gibbs_energy/``
    with the header total energy replaced by the formation Gibbs energy.
    Returns the output directory path."""
    dir = dir.rstrip("/")
    new_dir = dir + "_gibbs_energy/"
    if os.path.exists(new_dir) and overwrite_data:
        shutil.rmtree(new_dir)
    os.makedirs(new_dir, exist_ok=True)

    elements_list = sorted(elements_list)
    pure_elements_energy: Dict[float, float] = {}
    all_files = sorted(os.listdir(dir))
    for filename in all_files:
        energy_token, _, atoms = _read_lsms(os.path.join(dir, filename))
        pure = np.unique(atoms[:, 0])
        if len(pure) == 1:
            pure_elements_energy[float(pure[0])] = (
                float(energy_token) / atoms.shape[0]
            )
    if len(pure_elements_energy) != 2:
        raise ValueError("Must have two single element files.")

    comps = np.empty(len(all_files))
    totals = np.empty(len(all_files))
    mixing = np.empty(len(all_files))
    enthalpies = np.empty(len(all_files))
    gibbs = np.empty(len(all_files))
    for i, filename in enumerate(all_files):
        path = os.path.join(dir, filename)
        energy_token, lines, atoms = _read_lsms(path)
        comp, total, lin, enth, entropy = compute_formation_enthalpy(
            elements_list, pure_elements_energy, float(energy_token), atoms
        )
        g = enth - temperature_kelvin * entropy
        comps[i], totals[i], mixing[i], enthalpies[i], gibbs[i] = (
            comp, total, lin, enth, g,
        )
        lines[0] = lines[0].replace(energy_token, str(g))
        with open(os.path.join(new_dir, filename), "w") as f:
            f.write("".join(lines))

    print("Min formation enthalpy: ", float(gibbs.min()))
    print("Max formation enthalpy: ", float(gibbs.max()))

    if create_plots:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        for fname, xs, ys, xl, yl in [
            ("linear_mixing_energy.png", totals, mixing,
             "Total energy (Rydberg)", "Linear mixing energy (Rydberg)"),
            ("formation_enthalpy.png", comps, enthalpies,
             "Concentration", "Formation enthalpy (Rydberg)"),
            ("formation_gibbs_energy.png", comps, gibbs,
             "Concentration", "Formation Gibbs energy (Rydberg)"),
        ]:
            fig, ax = plt.subplots()
            ax.scatter(xs, ys, edgecolor="b", facecolor="none")
            ax.set_xlabel(xl)
            ax.set_ylabel(yl)
            fig.savefig(fname)
            plt.close(fig)
    return new_dir


def find_bin(comp: float, nbins: int) -> int:
    bins = np.linspace(0, 1, nbins)
    for bi in range(len(bins) - 1):
        if bins[bi] < comp < bins[bi + 1]:
            return bi
    return nbins - 1


def compositional_histogram_cutoff(
    dir: str,
    elements_list: Sequence[float],
    histogram_cutoff: int,
    num_bins: int,
    overwrite_data: bool = False,
    create_plots: bool = True,
) -> str:
    """Symlink at most ``histogram_cutoff`` samples per composition bin into
    ``<dir>_histogram_cutoff/``. Returns the output directory path."""
    dir = dir.rstrip("/")
    new_dir = dir + "_histogram_cutoff/"
    if os.path.exists(new_dir):
        if overwrite_data:
            shutil.rmtree(new_dir)
        else:
            print("Exiting: path to histogram cutoff data already exists")
            return new_dir
    os.makedirs(new_dir, exist_ok=True)

    elements_list = sorted(elements_list)
    comp_final: List[float] = []
    comp_all = np.zeros(num_bins)
    for filename in sorted(os.listdir(dir)):
        path = os.path.join(dir, filename)
        atoms = np.loadtxt(path, skiprows=1, ndmin=2)
        elements, counts = np.unique(atoms[:, 0], return_counts=True)
        count_map = dict(zip(elements.tolist(), counts.tolist()))
        counts_full = [count_map.get(e, 0) for e in elements_list]
        composition = counts_full[0] / atoms.shape[0]

        b = find_bin(composition, num_bins)
        comp_all[b] += 1
        if comp_all[b] < histogram_cutoff:
            comp_final.append(composition)
            os.symlink(os.path.abspath(path), os.path.join(new_dir, filename))

    if create_plots:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots()
        ax.hist(comp_final, bins=num_bins)
        fig.savefig("composition_histogram_cutoff.png")
        plt.close(fig)
        fig, ax = plt.subplots()
        ax.bar(np.linspace(0, 1, num_bins), comp_all, width=1 / num_bins)
        fig.savefig("composition_initial.png")
        plt.close(fig)
    return new_dir
