"""Dataset splitting and subsampling: proportional slice, compositional
stratification and the stratified subsample (the port's copy of
``hydragnn_tpu/data/splitting.py``; numpy only).

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


def subsample_categories(samples: Sequence[GraphSample]) -> List[int]:
    """The reference's subsample category: sorted positive type
    frequencies encoded by powers of 100 (``freq * 100**index``,
    hydragnn/utils/abstractrawdataset.py:430-438) — note this merges
    compositions sharing a frequency pattern, unlike
    :func:`composition_categories`."""
    cats: List[int] = []
    for s in samples:
        freqs = sorted(np.unique(s.x[:, 0], return_counts=True)[1].tolist())
        cats.append(sum(int(f) * 100**i for i, f in enumerate(freqs)))
    return cats


def stratified_subsample(
    samples: Sequence[GraphSample], subsample_percentage: float, seed: int = 0
) -> list:
    """Downselect ``samples`` to a fraction with composition-stratified
    sampling (reference: stratified_sampling,
    hydragnn/utils/abstractrawdataset.py:412-452 and the serialized-loader
    subsample path, preprocess/serialized_dataset_loader.py:193-259).

    The reference's per-sample category is the sorted positive type
    frequencies positionally encoded by powers of 100 (``freq *
    100**index``); here the frequencies come from ``np.unique`` of the
    first node-feature column (robust to float/normalized type columns,
    where the reference's ``bincount(x.int())`` degenerates), and the
    per-category proportional draw replaces sklearn's
    StratifiedShuffleSplit with the same contract: every category
    represented ~proportionally in the subsample."""
    if not 0.0 < subsample_percentage <= 1.0:
        raise ValueError(
            f"subsample_percentage must be in (0, 1], got {subsample_percentage}"
        )
    samples = list(samples)
    if subsample_percentage == 1.0:
        return samples
    cats = subsample_categories(samples)

    rng = np.random.default_rng(seed)
    by_cat: dict = {}
    for i, c in enumerate(cats):
        by_cat.setdefault(c, []).append(i)
    # Largest-remainder allocation so the TOTAL hits round(frac * n)
    # exactly (sklearn StratifiedShuffleSplit's _approximate_mode
    # contract): floor per category, then +1 by descending fractional
    # remainder until the target is met.
    target = int(round(subsample_percentage * len(samples)))
    order = sorted(by_cat)
    floors = {c: int(subsample_percentage * len(by_cat[c])) for c in order}
    rem = sorted(
        order,
        key=lambda c: subsample_percentage * len(by_cat[c]) - floors[c],
        reverse=True,
    )
    short = target - sum(floors.values())
    for c in rem[:short]:
        floors[c] += 1
    picked: List[int] = []
    for c in order:
        idx = np.asarray(by_cat[c])
        rng.shuffle(idx)
        picked.extend(idx[: floors[c]].tolist())
    picked = [picked[i] for i in rng.permutation(len(picked))]
    return [samples[i] for i in picked]


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
