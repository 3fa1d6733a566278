"""SMILES -> graph featurization without RDKit (the port's copy of
``hydragnn_tpu/data/smiles.py``; pure Python and numpy).

The reference turns SMILES strings into PyG graphs with RDKit (reference:
hydragnn/utils/smiles_utils.py:18-119): explicit hydrogens are added, node
features are [one-hot atom type | atomic number | is-aromatic | SP | SP2 |
SP3 | #H-neighbors], and edge features are a 4-class one-hot over
{single, double, triple, aromatic} bonds, duplicated in both directions and
sorted by (sender * N + receiver).

RDKit is not available in this environment, so this module carries its own
small SMILES parser covering the subset those pipelines need (OGB/CSCE-style
organic molecules): organic-subset atoms, bracket atoms with isotope /
charge / explicit H, branches, ring closures (incl. %nn), aromatic
lowercase notation, disconnected components, and directional bonds (read as
single). Implicit hydrogens follow the Daylight valence rules;
hybridization is derived from steric number (sigma neighbors + lone pairs),
with aromatic atoms pinned to SP2 — matching RDKit's assignments on the
molecules these datasets contain.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

from hydragnn_tpu_torch.data.dataset import GraphSample

# Daylight organic subset: these may appear bare (outside brackets) and get
# implicit hydrogens. Every other element must be written in brackets.
_ORGANIC = {"B", "C", "N", "O", "P", "S", "F", "Cl", "Br", "I"}
_AROMATIC_ORGANIC = {"b", "c", "n", "o", "p", "s"}

# Default valences used for implicit-H completion (Daylight rules).
_DEFAULT_VALENCE: Dict[str, Tuple[int, ...]] = {
    "B": (3,),
    "C": (4,),
    "N": (3, 5),
    "O": (2,),
    "P": (3, 5),
    "S": (2, 4, 6),
    "F": (1,),
    "Cl": (1,),
    "Br": (1,),
    "I": (1,),
}

# Valence (outer-shell) electron counts, for lone-pair / hybridization math.
_VALENCE_ELECTRONS = {
    "H": 1, "B": 3, "C": 4, "N": 5, "O": 6, "P": 5, "S": 6,
    "F": 7, "Cl": 7, "Br": 7, "I": 7, "Si": 4, "Se": 6, "As": 5,
}

ATOMIC_NUMBERS = {
    "H": 1, "He": 2, "Li": 3, "Be": 4, "B": 5, "C": 6, "N": 7, "O": 8,
    "F": 9, "Ne": 10, "Na": 11, "Mg": 12, "Al": 13, "Si": 14, "P": 15,
    "S": 16, "Cl": 17, "Ar": 18, "K": 19, "Ca": 20, "Sc": 21, "Ti": 22,
    "V": 23, "Cr": 24, "Mn": 25, "Fe": 26, "Co": 27, "Ni": 28, "Cu": 29,
    "Zn": 30, "Ga": 31, "Ge": 32, "As": 33, "Se": 34, "Br": 35, "Kr": 36,
    "Rb": 37, "Sr": 38, "Y": 39, "Zr": 40, "Nb": 41, "Mo": 42, "Tc": 43,
    "Ru": 44, "Rh": 45, "Pd": 46, "Ag": 47, "Cd": 48, "In": 49, "Sn": 50,
    "Sb": 51, "Te": 52, "I": 53, "Xe": 54,
}

_BOND_ORDER = {"-": 1.0, "=": 2.0, "#": 3.0, ":": 1.5, "/": 1.0, "\\": 1.0}
# bond-type -> one-hot class, matching the reference's {SINGLE:0, DOUBLE:1,
# TRIPLE:2, AROMATIC:3} (smiles_utils.py:50)
BOND_CLASSES = {1.0: 0, 2.0: 1, 3.0: 2, 1.5: 3}

_BRACKET_RE = re.compile(
    r"^(?P<isotope>\d+)?"
    r"(?P<symbol>[A-Z][a-z]?|[a-z])"
    r"(?P<chiral>@{1,2}(?:TH\d|AL\d|SP\d|TB\d+|OH\d+)?)?"
    r"(?P<hcount>H\d*)?"
    r"(?P<charge>\+{1,}\d*|-{1,}\d*)?"
    r"(?::(?P<map>\d+))?$"
)


class SmilesParseError(ValueError):
    pass


@dataclasses.dataclass
class Atom:
    symbol: str            # capitalized element symbol
    aromatic: bool
    charge: int = 0
    explicit_h: int = 0    # H count from a bracket spec (bracket atoms only)
    bracket: bool = False
    isotope: int = 0


@dataclasses.dataclass
class Bond:
    a: int
    b: int
    order: float           # 1, 2, 3, or 1.5 (aromatic)


def _parse_bracket(body: str) -> Atom:
    m = _BRACKET_RE.match(body)
    if m is None:
        raise SmilesParseError(f"bad bracket atom [{body}]")
    sym = m.group("symbol")
    aromatic = sym[0].islower()
    sym = sym.capitalize()
    hc = m.group("hcount")
    explicit_h = 0 if hc is None else (1 if hc == "H" else int(hc[1:]))
    ch = m.group("charge")
    charge = 0
    if ch:
        n = ch.lstrip("+-")
        mag = int(n) if n else len(ch)
        charge = mag if ch[0] == "+" else -mag
    iso = int(m.group("isotope")) if m.group("isotope") else 0
    return Atom(sym, aromatic, charge, explicit_h, bracket=True, isotope=iso)


def parse_smiles(s: str) -> Tuple[List[Atom], List[Bond]]:
    """Parse a SMILES string into atom and bond lists (no H completion)."""
    atoms: List[Atom] = []
    bonds: List[Bond] = []
    prev: Optional[int] = None
    pending_bond: Optional[str] = None
    stack: List[Optional[int]] = []
    rings: Dict[str, Tuple[int, Optional[str]]] = {}
    i, n = 0, len(s)

    def attach(idx: int):
        nonlocal prev, pending_bond
        if prev is not None:
            if pending_bond is not None:
                order = _BOND_ORDER[pending_bond]
            elif atoms[prev].aromatic and atoms[idx].aromatic:
                order = 1.5
            else:
                order = 1.0
            bonds.append(Bond(prev, idx, order))
        prev = idx
        pending_bond = None

    def close_ring(label: str):
        nonlocal pending_bond
        if prev is None:
            raise SmilesParseError(f"ring closure {label} before any atom")
        if label in rings:
            j, sym = rings.pop(label)
            bsym = pending_bond or sym
            if bsym is not None:
                order = _BOND_ORDER[bsym]
            elif atoms[j].aromatic and atoms[prev].aromatic:
                order = 1.5
            else:
                order = 1.0
            if j == prev:
                raise SmilesParseError(f"self ring bond {label}")
            bonds.append(Bond(j, prev, order))
        else:
            rings[label] = (prev, pending_bond)
        pending_bond = None

    while i < n:
        c = s[i]
        if c == "[":
            j = s.find("]", i)
            if j < 0:
                raise SmilesParseError("unclosed bracket")
            atoms.append(_parse_bracket(s[i + 1 : j]))
            attach(len(atoms) - 1)
            i = j + 1
        elif c in "-=#:/\\":
            pending_bond = c
            i += 1
        elif c == "(":
            stack.append(prev)
            i += 1
        elif c == ")":
            if not stack:
                raise SmilesParseError("unbalanced parenthesis")
            prev = stack.pop()
            i += 1
        elif c == ".":
            prev = None
            pending_bond = None
            i += 1
        elif c == "%":
            if i + 2 >= n or not s[i + 1 : i + 3].isdigit():
                raise SmilesParseError("bad %nn ring label")
            close_ring(s[i + 1 : i + 3])
            i += 3
        elif c.isdigit():
            close_ring(c)
            i += 1
        elif c.isupper():
            sym = s[i : i + 2] if s[i : i + 2] in ("Cl", "Br") else c
            if sym not in _ORGANIC:
                raise SmilesParseError(
                    f"element {sym!r} must be bracketed (organic subset only)"
                )
            atoms.append(Atom(sym, aromatic=False))
            attach(len(atoms) - 1)
            i += len(sym)
        elif c in _AROMATIC_ORGANIC:
            atoms.append(Atom(c.upper(), aromatic=True))
            attach(len(atoms) - 1)
            i += 1
        elif c == "*":
            raise SmilesParseError("wildcard atoms unsupported")
        else:
            raise SmilesParseError(f"unexpected character {c!r} at {i}")
    if stack:
        raise SmilesParseError("unbalanced parenthesis")
    if rings:
        raise SmilesParseError(f"unclosed ring bonds: {sorted(rings)}")
    return atoms, bonds


def _implicit_h(atom: Atom, bond_sum: float, degree: int) -> int:
    """Daylight implicit-hydrogen count for a bare organic-subset atom."""
    if atom.bracket:
        return atom.explicit_h
    if atom.aromatic:
        # one valence is consumed by the aromatic pi system; sigma bonds
        # count 1 each regardless of the 1.5 bookkeeping order
        need = _DEFAULT_VALENCE[atom.symbol][0] - degree - 1
        return max(0, need)
    total = int(np.ceil(bond_sum))
    for v in _DEFAULT_VALENCE[atom.symbol]:
        if v >= total:
            return v - total
    return 0


def _hybridization(atom: Atom, bond_sum: float, degree: int) -> Tuple[int, int, int]:
    """(sp, sp2, sp3) flags from steric number = sigma neighbors + lone
    pairs; aromatic atoms are SP2 (matches RDKit on these datasets)."""
    if atom.symbol == "H":
        return (0, 0, 0)
    if atom.aromatic:
        return (0, 1, 0)
    ve = _VALENCE_ELECTRONS.get(atom.symbol)
    if ve is None:
        return (0, 0, 1)
    lone_pairs = max(0, (ve - atom.charge - int(round(bond_sum))) // 2)
    steric = degree + lone_pairs
    if steric <= 2:
        return (1, 0, 0)
    if steric == 3:
        return (0, 1, 0)
    return (0, 0, 1)


@dataclasses.dataclass
class Molecule:
    """Hydrogen-complete molecular graph ready for featurization."""

    atoms: List[Atom]
    bonds: List[Bond]

    @property
    def num_atoms(self) -> int:
        return len(self.atoms)


def mol_from_smiles(s: str) -> Molecule:
    """Parse and add explicit hydrogens (reference AddHs,
    smiles_utils.py:52)."""
    atoms, bonds = parse_smiles(s)
    bond_sum = [0.0] * len(atoms)
    degree = [0] * len(atoms)
    for b in bonds:
        bond_sum[b.a] += b.order
        bond_sum[b.b] += b.order
        degree[b.a] += 1
        degree[b.b] += 1
    # cache pre-H sigma counts/bond sums for hybridization
    heavy_stats = [(bond_sum[i], degree[i]) for i in range(len(atoms))]
    for i, atom in enumerate(list(atoms)):
        if atom.symbol == "H":
            continue
        nh = _implicit_h(atom, bond_sum[i], degree[i])
        for _ in range(nh):
            atoms.append(Atom("H", aromatic=False))
            bonds.append(Bond(i, len(atoms) - 1, 1.0))
    mol = Molecule(atoms, bonds)
    mol._heavy_stats = heavy_stats  # type: ignore[attr-defined]
    return mol


def get_node_attribute_name(types: Dict[str, int]):
    """Node feature names/dims, mirroring smiles_utils.py:18-32."""
    names = ["atom" + k for k in types] + [
        "atomicnumber", "IsAromatic", "HSP", "HSP2", "HSP3", "Hprop",
    ]
    return names, [1] * len(names)


def generate_graphdata_from_smilestr(
    smilestr: str,
    ytarget,
    types: Dict[str, int],
    atomic_descriptors: Optional[np.ndarray] = None,
) -> GraphSample:
    """SMILES -> GraphSample with the reference's exact feature layout
    (smiles_utils.py:35-119): x = [one-hot type | Z | aromatic | sp | sp2 |
    sp3 | #H-neighbors], edge_attr = one-hot{single,double,triple,aromatic},
    both edge directions, sorted by sender*N+receiver."""
    mol = mol_from_smiles(smilestr)
    N = mol.num_atoms
    n_types = len(types)

    x = np.zeros((N, n_types + 6), dtype=np.float32)
    # per-atom sigma degree and bond-order sum over the H-complete graph
    bond_sum = [0.0] * N
    degree = [0] * N
    for b in mol.bonds:
        bond_sum[b.a] += b.order
        bond_sum[b.b] += b.order
        degree[b.a] += 1
        degree[b.b] += 1

    for i, atom in enumerate(mol.atoms):
        if atom.symbol not in types:
            raise SmilesParseError(
                f"atom {atom.symbol} not in dataset element types {list(types)}"
            )
        x[i, types[atom.symbol]] = 1.0
        x[i, n_types + 0] = ATOMIC_NUMBERS[atom.symbol]
        x[i, n_types + 1] = 1.0 if atom.aromatic else 0.0
        sp, sp2, sp3 = _hybridization(atom, bond_sum[i], degree[i])
        x[i, n_types + 2] = sp
        x[i, n_types + 3] = sp2
        x[i, n_types + 4] = sp3

    senders: List[int] = []
    receivers: List[int] = []
    bond_cls: List[int] = []
    for b in mol.bonds:
        senders += [b.a, b.b]
        receivers += [b.b, b.a]
        bond_cls += 2 * [BOND_CLASSES[b.order]]
    ei = np.asarray([senders, receivers], dtype=np.int32)
    cls = np.asarray(bond_cls, dtype=np.int64)
    perm = np.argsort(ei[0] * N + ei[1], kind="stable")
    ei = ei[:, perm]
    cls = cls[perm]
    edge_attr = np.eye(len(BOND_CLASSES), dtype=np.float32)[cls]

    # H-neighbor count per atom (reference scatter of hs over col,
    # smiles_utils.py:88-89)
    is_h = np.array([a.symbol == "H" for a in mol.atoms], dtype=np.float32)
    num_hs = np.zeros(N, dtype=np.float32)
    np.add.at(num_hs, ei[1], is_h[ei[0]])
    x[:, n_types + 5] = num_hs

    if atomic_descriptors is not None:
        if atomic_descriptors.shape[0] != N:
            raise ValueError("atomic descriptor rows must equal atom count")
        x = np.concatenate([x, atomic_descriptors.astype(np.float32)], axis=1)

    y = np.atleast_1d(np.asarray(ytarget, dtype=np.float32))
    return GraphSample(x=x, edge_index=ei, edge_attr=edge_attr, graph_y=y)


def molecular_formula(mol: Molecule) -> Dict[str, int]:
    """Element -> count map (test/assertion helper)."""
    out: Dict[str, int] = {}
    for a in mol.atoms:
        out[a.symbol] = out.get(a.symbol, 0) + 1
    return out
