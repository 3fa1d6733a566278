"""The example drivers (the port's copies of the JAX package's
``examples/``): each generates or reads its data, writes the HGC
container where the JAX driver does, and trains from it on the card.

    python -m hydragnn_tpu_torch.examples.ising_model.train_ising --preonly
    python -m hydragnn_tpu_torch.examples.ising_model.train_ising [--device cpu]

Every driver is a module with ``main(argv=None)``; nothing runs at
import. It takes the JAX driver's arguments with the same defaults, plus
``--device`` (``cuda`` unless given ``cpu``; without a card it raises).
Its configs are the published JSON files under the repository's
``examples/<name>/``, read unedited by path; its raw data and containers
go to ``./dataset/`` and its logs to ``./logs/``, under the current
working directory. On the same arguments it writes the same raw files,
byte for byte, as the JAX driver.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, NamedTuple, Sequence, Tuple

import numpy as np

from hydragnn_tpu_torch.data.container import ContainerDataset, ContainerWriter
from hydragnn_tpu_torch.parallel import nsplit

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SPLITS = ("trainset", "valset", "testset")


class TrainResult(NamedTuple):
    model: Any
    optimizer: Any
    history: Dict[str, Any]
    config: Dict[str, Any]
    loaders: Tuple[Any, Any, Any]


def add_device_argument(parser) -> None:
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; raises without a card) or cpu")


def published_config(example: str, inputfile: str) -> Dict[str, Any]:
    """The JSON config ``examples/<example>/<inputfile>`` of the
    repository (an absolute ``inputfile`` is read as it is)."""
    with open(os.path.join(REPO_ROOT, "examples", example, inputfile)) as f:
        return json.load(f)


def write_split_containers(container_dir: str, splits: Sequence[List], comm_size: int, rank: int,
                           attrs: Dict[str, Any]) -> None:
    """This process's shard of each split into
    ``<container_dir>/{trainset,valset,testset}``, with ``attrs`` as the
    containers' globals."""
    for name, split in zip(SPLITS, splits):
        shard = list(nsplit(split, comm_size))[rank]
        writer = ContainerWriter(os.path.join(container_dir, name))
        writer.add(shard)
        for key, value in attrs.items():
            writer.add_global(key, value)
        writer.save()


def read_split_containers(container_dir: str, mode: str):
    """(train, val, test samples, the train container) from the three
    split containers, timed as ``load_data``."""
    from hydragnn_tpu_torch.utils.time_utils import Timer

    timer = Timer("load_data")
    timer.start()
    datasets = {name: ContainerDataset(os.path.join(container_dir, name), mode=mode) for name in SPLITS}
    train, val, test = (list(datasets[name].samples()) for name in SPLITS)
    timer.stop()
    return train, val, test, datasets["trainset"]


def set_minmax(config: Dict[str, Any], mm_g: np.ndarray, mm_n: np.ndarray) -> None:
    voi = config["NeuralNetwork"]["Variables_of_interest"]
    voi["minmax_graph_feature"] = mm_g.tolist()
    voi["minmax_node_feature"] = mm_n.tolist()


def train_splits(config: Dict[str, Any], train: List, val: List, test: List, device: str) -> TrainResult:
    """``update_config``, the three loaders and ``train_with_loaders`` on
    ``device``; prints the timers at the config's verbosity. In a group
    of processes every rank calls it with the same splits and trains its
    share of each step (``api.create_dataloaders``) of one model."""
    from hydragnn_tpu_torch.api import create_dataloaders, train_with_loaders
    from hydragnn_tpu_torch.utils.config import update_config
    from hydragnn_tpu_torch.utils.time_utils import print_timers

    config = update_config(config, train, val, test)
    loaders = create_dataloaders(train, val, test, config)
    model, optimizer, history = train_with_loaders(config, *loaders, device=device)
    print_timers(config["Verbosity"]["level"])
    return TrainResult(model, optimizer, history, config, loaders)
