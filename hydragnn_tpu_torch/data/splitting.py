"""Dataset splitting: proportional slice and compositional stratification
(the port's copy of ``hydragnn_tpu/data/splitting.py``; numpy only).

Mirrors the reference semantics (reference:
hydragnn/preprocess/load_data.py:286-304 for the plain split,
hydragnn/preprocess/compositional_data_splitting.py:117-155 for the
stratified one): the stratification category of a graph is its composition
fingerprint — per-element atom counts positionally encoded by powers of
10^ceil(log10(max_graph_size)) — singleton categories are duplicated so
they can appear on both sides of a split, train is carved out first, then
val/test 50/50. The shuffle-split itself is a numpy per-category
proportional allocation rather than sklearn's StratifiedShuffleSplit; the
statistical contract (every category represented proportionally in every
partition) is the same.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import List, Sequence, Tuple

import numpy as np

from hydragnn_tpu_torch.data.dataset import GraphSample


def composition_categories(samples: Sequence[GraphSample]) -> List[int]:
    max_graph_size = max(s.num_nodes for s in samples)
    power_ten = math.ceil(math.log10(max(max_graph_size, 2)))
    elements: List[float] = sorted({float(v) for s in samples for v in np.unique(s.x[:, 0])})
    index_of = {e: i for i, e in enumerate(elements)}
    cats = []
    for s in samples:
        vals, freqs = np.unique(s.x[:, 0], return_counts=True)
        cat = 0
        for v, f in zip(vals, freqs):
            cat += int(f) * 10 ** (power_ten * index_of[float(v)])
        cats.append(cat)
    return cats


def _duplicate_singletons(samples: list, cats: List[int]) -> Tuple[list, List[int]]:
    counts = Counter(cats)
    extra = [(s, c) for s, c in zip(samples, cats) if counts[c] == 1]
    samples = list(samples) + [s for s, _ in extra]
    cats = list(cats) + [c for _, c in extra]
    return samples, cats


def _stratified_two_way(
    samples: list, cats: List[int], train_size: float, seed: int
) -> Tuple[list, list]:
    """Split so each category contributes ~train_size of its members to the
    first partition (at least one to each side when it has >= 2 members)."""
    rng = np.random.default_rng(seed)
    by_cat = {}
    for i, c in enumerate(cats):
        by_cat.setdefault(c, []).append(i)
    first, second = [], []
    for c in sorted(by_cat):
        idx = np.asarray(by_cat[c])
        rng.shuffle(idx)
        k = int(round(train_size * len(idx)))
        k = min(max(k, 1), len(idx) - 1) if len(idx) >= 2 else k
        first.extend(idx[:k].tolist())
        second.extend(idx[k:].tolist())
    # Shuffle across categories so batches are not composition-ordered.
    first = [first[i] for i in rng.permutation(len(first))]
    second = [second[i] for i in rng.permutation(len(second))]
    return [samples[i] for i in first], [samples[i] for i in second]


def compositional_stratified_splitting(
    samples: Sequence[GraphSample], perc_train: float, seed: int = 0
) -> Tuple[list, list, list]:
    samples = list(samples)
    cats = composition_categories(samples)
    samples, cats = _duplicate_singletons(samples, cats)
    trainset, val_test = _stratified_two_way(samples, cats, perc_train, seed)

    vt_cats = composition_categories(val_test)
    val_test, vt_cats = _duplicate_singletons(val_test, vt_cats)
    valset, testset = _stratified_two_way(val_test, vt_cats, 0.5, seed + 1)
    return trainset, valset, testset


def split_dataset(
    samples: Sequence[GraphSample],
    perc_train: float,
    stratify_splitting: bool = False,
    seed: int = 0,
) -> Tuple[list, list, list]:
    if not stratify_splitting:
        perc_val = (1 - perc_train) / 2
        n = len(samples)
        a = int(n * perc_train)
        b = int(n * (perc_train + perc_val))
        return list(samples[:a]), list(samples[a:b]), list(samples[b:])
    return compositional_stratified_splitting(samples, perc_train, seed)
