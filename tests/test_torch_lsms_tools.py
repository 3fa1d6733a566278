"""The port's LSMS tools (``hydragnn_tpu_torch/tools/lsms_tools.py``)
against the JAX package's on the same generated FePt-like LSMS files:
the formation-Gibbs rewrite byte-equal file for file, the compositional
histogram cutoff selecting the same files, ``find_bin`` and the
formation enthalpy equal (the same float64 arithmetic), and the
``lgamma`` binomial finite on a supercell where ``comb`` overflows a
float.
"""

import math
import os
import shutil

import numpy as np
import pytest

from hydragnn_tpu.tools import lsms_tools as j_tools

from hydragnn_tpu_torch.examples.lsms.lsms import FE, PT, generate_fept_like
from hydragnn_tpu_torch.tools import lsms_tools as t_tools

ELEMENTS = [float(FE), float(PT)]


def _lsms_dir(path, n_config=30):
    """FePt-like files from the LSMS example's generator plus one pure Fe
    and one pure Pt configuration (the Gibbs rewrite needs both)."""
    generate_fept_like(str(path), n_config=n_config, seed=5)
    with open(os.path.join(str(path), "out_00000.txt")) as f:
        lines = f.read().splitlines()
    for z, energy, name in ((FE, -2.5e3, "pure_fe.txt"), (PT, -1.9e4, "pure_pt.txt")):
        rows = [ln.split("\t") for ln in lines[1:]]
        body = ["\t".join([f"{z:.10g}"] + r[1:]) for r in rows]
        with open(os.path.join(str(path), name), "w") as f:
            f.write("\n".join([f"{energy * len(rows):.10g}"] + body))
    return str(path)


def _files(path):
    return {name: open(os.path.join(path, name), "rb").read() for name in sorted(os.listdir(path))}


@pytest.mark.parametrize("temperature", [0.0, 600.0])
def test_gibbs_rewrite_is_byte_equal(tmp_path, temperature):
    src = _lsms_dir(tmp_path / "raw")
    ours_in, ref_in = str(tmp_path / "ours" / "raw"), str(tmp_path / "ref" / "raw")
    shutil.copytree(src, ours_in)
    shutil.copytree(src, ref_in)
    ours = t_tools.convert_raw_data_energy_to_gibbs(ours_in, ELEMENTS, temperature, create_plots=False)
    ref = j_tools.convert_raw_data_energy_to_gibbs(ref_in, ELEMENTS, temperature, create_plots=False)
    assert ours == ours_in + "_gibbs_energy/" and ref == ref_in + "_gibbs_energy/"
    got, want = _files(ours), _files(ref)
    assert len(got) == 32 and got == want
    assert got != _files(src)  # the header energies were rewritten


def test_histogram_cutoff_selects_the_same_files(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the plots land in the working directory
    src = _lsms_dir(tmp_path / "raw", n_config=60)
    ours_in, ref_in = str(tmp_path / "ours" / "raw"), str(tmp_path / "ref" / "raw")
    shutil.copytree(src, ours_in)
    shutil.copytree(src, ref_in)
    ours = t_tools.compositional_histogram_cutoff(ours_in, ELEMENTS, histogram_cutoff=3, num_bins=8)
    ref = j_tools.compositional_histogram_cutoff(ref_in, ELEMENTS, histogram_cutoff=3, num_bins=8)
    picked = sorted(os.listdir(ours))
    assert picked == sorted(os.listdir(ref)) and 0 < len(picked) < 62
    assert all(os.readlink(os.path.join(ours, f)) == os.path.join(ours_in, f) for f in picked)
    assert os.path.exists("composition_histogram_cutoff.png") and os.path.exists("composition_initial.png")
    # an existing output directory is kept unless overwrite_data
    assert t_tools.compositional_histogram_cutoff(ours_in, ELEMENTS, 3, 8, create_plots=False) == ours
    assert sorted(os.listdir(ours)) == picked


def test_find_bin_and_formation_enthalpy_match():
    for comp in np.linspace(0, 1, 41):
        assert t_tools.find_bin(comp, 10) == j_tools.find_bin(comp, 10)
    rng = np.random.default_rng(3)
    atoms = np.column_stack([np.where(rng.random(32) < 0.4, FE, PT), rng.normal(size=(32, 6))])
    pure = {float(FE): -2.5e3, float(PT): -1.9e4}
    assert t_tools.compute_formation_enthalpy(ELEMENTS, pure, -3.1e5, atoms) == \
        j_tools.compute_formation_enthalpy(ELEMENTS, pure, -3.1e5, atoms)
    with pytest.raises(ValueError):
        t_tools.compute_formation_enthalpy(ELEMENTS + [1.0], pure, -3.1e5, atoms)


def test_large_supercell_entropy_stays_finite():
    """2,000 atoms, half Fe: C(2000, 1000) ~ 1e600 does not fit a float, the
    lgamma form does."""
    n = 2000
    atoms = np.zeros((n, 7))
    atoms[: n // 2, 0], atoms[n // 2:, 0] = FE, PT
    with pytest.raises(OverflowError):
        float(math.comb(n, n // 2))
    pure = {float(FE): -2.5e3, float(PT): -1.9e4}
    ours = t_tools.compute_formation_enthalpy(ELEMENTS, pure, -2.1e7, atoms)
    assert all(np.isfinite(ours))
    assert ours == j_tools.compute_formation_enthalpy(ELEMENTS, pure, -2.1e7, atoms)
    log_comb = math.lgamma(n + 1) - 2 * math.lgamma(n // 2 + 1)
    assert ours[4] == pytest.approx(t_tools.KB_RYDBERG_PER_KELVIN * log_comb, rel=1e-12)
