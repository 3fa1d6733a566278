"""Parity of the port's SMILES featurizer and atomic descriptor tables
with the JAX package's (the case list of ``tests/test_smiles.py``): the
same hydrogen-complete molecules, and node features, edges and edge
classes BIT-equal on the same strings."""

import numpy as np
import pytest

from hydragnn_tpu.data import atomic_descriptors as j_desc
from hydragnn_tpu.data import smiles as j_smiles

from hydragnn_tpu_torch.data import atomic_descriptors as t_desc
from hydragnn_tpu_torch.data import smiles as t_smiles

from test_smiles import TYPES
from test_torch_data import _assert_samples_equal

MOLECULES = ["C", "CC", "C=C", "C#N", "CO", "c1ccccc1", "c1ccncc1", "c1cc[nH]c1", "c1ccoc1", "Cc1ccccc1",
             "CC(=O)O", "C1CC1", "[NH4+]", "O.O", "N#N", "CS(=O)(=O)C", "C%12CCCCC%12", "FC(F)(F)S"]


@pytest.mark.parametrize("smiles", MOLECULES)
def test_molecule_and_features_match(smiles):
    ours, ref = t_smiles.mol_from_smiles(smiles), j_smiles.mol_from_smiles(smiles)
    assert t_smiles.molecular_formula(ours) == j_smiles.molecular_formula(ref)
    assert [(a.symbol, a.aromatic, a.charge) for a in ours.atoms] == [(a.symbol, a.aromatic, a.charge) for a in ref.atoms]
    assert [(b.a, b.b, b.order) for b in ours.bonds] == [(b.a, b.b, b.order) for b in ref.bonds]
    y = np.array([1.5])
    _assert_samples_equal([t_smiles.generate_graphdata_from_smilestr(smiles, y, TYPES)],
                          [j_smiles.generate_graphdata_from_smilestr(smiles, y, TYPES)])


@pytest.mark.parametrize("bad", ["C(", "C)", "C1CC", "[C", "Cl(", "Xx", "C%1"])
def test_parse_errors(bad):
    with pytest.raises((t_smiles.SmilesParseError, ValueError)):
        t_smiles.mol_from_smiles(bad)
    with pytest.raises((j_smiles.SmilesParseError, ValueError)):
        j_smiles.mol_from_smiles(bad)


def test_feature_layout_methane():
    g = t_smiles.generate_graphdata_from_smilestr("C", np.array([1.5]), TYPES)
    assert g.x.shape == (5, len(TYPES) + 6)
    assert g.x[0, 0] == 1.0 and g.x[0, len(TYPES)] == 6 and g.x[0, len(TYPES) + 5] == 4
    assert tuple(g.x[0, len(TYPES) + 2 : len(TYPES) + 5]) == (0, 0, 1)
    assert g.edge_index.shape == (2, 8) and np.all(g.edge_attr[:, 0] == 1)
    assert np.all(np.diff(g.edge_index[0] * 5 + g.edge_index[1]) > 0)


def test_node_attribute_names_match():
    assert t_smiles.get_node_attribute_name(TYPES) == j_smiles.get_node_attribute_name(TYPES)


@pytest.mark.parametrize("one_hot", [False, True])
@pytest.mark.parametrize("elements", [("C", "H", "S"), ("C", "H", "O", "N", "F", "S"), None])
def test_descriptor_tables_match(tmp_path, one_hot, elements):
    ours = t_desc.atomicdescriptors(str(tmp_path / "t.json"), element_types=elements, one_hot=one_hot)
    ref = j_desc.atomicdescriptors(str(tmp_path / "j.json"), element_types=elements, one_hot=one_hot)
    assert ours.atom_embeddings == ref.atom_embeddings
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()
    sym = "C"
    np.testing.assert_array_equal(ours.get_atom_features(sym), ref.get_atom_features(6))
    reloaded = t_desc.atomicdescriptors(str(tmp_path / "t.json"), overwritten=False)
    assert reloaded.atom_embeddings == ours.atom_embeddings
    if elements == ("C", "H", "S") and not one_hot:
        assert ours.get_atom_features("C").shape == (17,)
    if one_hot:
        assert set(np.unique(ours.get_atom_features("H"))) <= {0.0, 1.0}


def test_unknown_element_raises():
    with pytest.raises(ValueError, match="Xx"):
        t_desc.atomicdescriptors("unused.json", element_types=["C", "Xx"])


def test_graph_with_descriptors_matches(tmp_path):
    desc = t_desc.atomicdescriptors(str(tmp_path / "e.json"), element_types=["C", "H", "O"])
    g0 = t_smiles.generate_graphdata_from_smilestr("CO", np.array([2.0]), TYPES)
    table = np.stack([desc.get_atom_features(int(z)) for z in g0.x[:, len(TYPES)]])
    ours = t_smiles.generate_graphdata_from_smilestr("CO", np.array([2.0]), TYPES, atomic_descriptors=table)
    ref = j_smiles.generate_graphdata_from_smilestr("CO", np.array([2.0]), TYPES, atomic_descriptors=table)
    _assert_samples_equal([ours], [ref])
    assert ours.x.shape[1] == len(TYPES) + 6 + table.shape[1]
