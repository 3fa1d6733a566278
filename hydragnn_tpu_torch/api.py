"""Top-level entry points: ``run_training``, ``run_prediction`` and
``serve_model``.

The port's counterpart of ``hydragnn_tpu/api.py``. Every entry point
takes ``device=`` and runs on the CUDA card unless given ``"cpu"``;
without a card a CUDA request raises. The dataset comes either from an
in-memory ``samples`` list or, when ``samples`` is None, from the files
under ``Dataset.path``: ``{"total": dir}`` (prepared, then split), or
``{"train": dir, "validate": dir, "test": dir}`` (predefined splits,
normalized together), in ``Dataset.format`` ``LSMS``/``unit_test``,
``XYZ``, ``CFG`` or ``HGC`` (the container).

Several processes (``torchrun --nproc_per_node N``, or any launcher that
sets ``WORLD_SIZE``/``RANK``/``MASTER_ADDR``/``MASTER_PORT``; a driver
calls ``parallel.setup_distributed`` first) train one model together:
the ``Parallel`` section's ``fsdp`` and ``edge`` widths and
``Training.Optimizer.use_zero_redundancy`` pick the layout, and the
loaders give each rank its sub-batch of every step
(``parallel/partitioner.py``).
"""

from __future__ import annotations

import warnings
from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from hydragnn_tpu_torch.data.ingest import load_raw_samples, prepare_dataset, prepare_presplit_dataset
from hydragnn_tpu_torch.data.loader import GraphLoader
from hydragnn_tpu_torch.device import resolve_device
from hydragnn_tpu_torch.models.create import create_model_config
from hydragnn_tpu_torch.postprocess import output_denormalize
from hydragnn_tpu_torch.resilience.preempt import auto_resume_config
from hydragnn_tpu_torch.train.loop import test_epoch, train_validate_test
from hydragnn_tpu_torch.train.optimizer import select_optimizer
from hydragnn_tpu_torch.utils.checkpoint import load_existing_model, load_existing_model_config, save_model
from hydragnn_tpu_torch.utils.config import get_log_name_config, load_config, save_config, update_config
from hydragnn_tpu_torch.utils.print_utils import print_model, setup_log
from hydragnn_tpu_torch.utils.time_utils import Timer, print_timers


def _prepared_splits(config: Dict[str, Any], samples: Optional[List]):
    """(train, val, test, minmax_graph, minmax_node) from ``samples`` or,
    when None, from ``Dataset.path`` (the JAX package's
    ``prepare_loaders_and_config`` dispatch)."""
    if samples is not None:
        return prepare_dataset(samples, config)
    path = config["Dataset"]["path"]
    if "total" in path:
        return prepare_dataset(load_raw_samples(config, path["total"]), config)
    splits = {}
    for key in ("train", "validate", "test"):
        if key not in path:
            raise ValueError(f"Dataset.path needs 'total' or 'train'/'validate'/'test'; missing {key!r}")
        splits[key] = load_raw_samples(config, path[key])
    return prepare_presplit_dataset(splits["train"], splits["validate"], splits["test"], config)


def prepare_config_and_samples(
    config: Dict[str, Any], samples: Optional[List] = None
) -> Tuple[List, List, List, Dict[str, Any]]:
    """Data preparation + split + config inference: (train, val, test,
    completed config). ``samples`` are raw in-memory samples and are
    prepared in place; None reads ``Dataset.path``."""
    train, val, test, mm_g, mm_n = _prepared_splits(config, samples)
    voi = config["NeuralNetwork"]["Variables_of_interest"]
    voi["minmax_graph_feature"] = mm_g.tolist()
    voi["minmax_node_feature"] = mm_n.tolist()
    config = update_config(config, train, val, test)
    return train, val, test, config


def _choose_device_stack(config: Dict[str, Any]) -> int:
    """The sub-batches one batch splits into: the processes of the run
    over ``Parallel.edge`` (which shards within a sub-batch) when the
    batch size divides evenly, else 1, and then each rank takes whole
    batches of its own shard of the samples (the JAX package's
    multi-host layout). The width feeds ``Partitioner.from_config``,
    which splits it into ``data × fsdp``."""
    from hydragnn_tpu_torch.parallel import get_comm_size_and_rank

    world = get_comm_size_and_rank()[0]
    nn = config["NeuralNetwork"]
    par = nn.get("Parallel") or {}
    fsdp = int(par.get("fsdp", 1) or 1)
    edge = int(par.get("edge", 1) or 1)
    if world % edge:
        raise ValueError(f"Parallel.edge={edge} must divide local_device_count={world}")
    usable = world // edge
    bs = int(nn["Training"]["batch_size"])
    if usable > 1 and bs % usable != 0:
        if fsdp > 1:
            # an explicit fsdp request must not silently degrade to a
            # replicated single-device run that may not even fit HBM
            raise ValueError(
                f"Parallel.fsdp={fsdp} is set but batch_size={bs} is not "
                f"divisible by the usable device width {usable}; pick a "
                "batch size the device width divides"
            )
        warnings.warn(
            f"batch_size={bs} is not divisible by the usable device "
            f"width {usable}; falling back to one sub-batch a process "
            f"(each of the {usable} processes trains whole batches of its "
            f"own shard of the samples). Use a batch_size divisible "
            f"by {usable} to split each batch over the processes.",
            RuntimeWarning,
            stacklevel=2,
        )
        return 1
    if fsdp > 1 and (usable < fsdp or usable % fsdp):
        raise ValueError(
            f"Parallel.fsdp={fsdp} must divide the usable device width "
            f"{usable} (local_device_count={world}, edge={edge})"
        )
    return usable


def create_dataloaders(
    train: List, val: List, test: List, config: Dict[str, Any], device_stack: Optional[int] = None
) -> Tuple[GraphLoader, GraphLoader, GraphLoader]:
    """Per-split loaders: the train split reshuffles every epoch;
    ``Training.cache_device_batches`` and ``scan_reshuffle_every`` reach
    every loader. In a group of processes each rank's loaders yield its
    share: sub-batch ``rank // Parallel.edge`` of ``device_stack``
    (default ``_choose_device_stack``), or, at a width of 1, whole
    batches of its shard of the samples."""
    from hydragnn_tpu_torch.parallel import get_comm_size_and_rank

    training = config["NeuralNetwork"]["Training"]
    bs = int(training["batch_size"])
    world, rank = get_comm_size_and_rank()
    edge = int((config["NeuralNetwork"].get("Parallel") or {}).get("edge", 1) or 1)
    stack = _choose_device_stack(config) if device_stack is None else int(device_stack)
    kw = dict(
        cache_device_batches=bool(training.get("cache_device_batches", False)),
        scan_reshuffle_every=int(training.get("scan_reshuffle_every", 0)),
    )
    if stack > 1:
        kw.update(device_stack=stack, stack_rank=rank // edge)
    elif world > 1:
        kw.update(num_shards=world // edge, shard_rank=rank // edge)
    return GraphLoader(train, bs, shuffle=True, **kw), GraphLoader(val, bs, **kw), GraphLoader(test, bs, **kw)


def _optimizer_for(model, nn_config: Dict[str, Any]):
    """The optimizer chain of the config: the same one for training and
    for restoring a run's checkpoint."""
    freeze = bool(nn_config["Architecture"].get("freeze_conv_layers", False))
    return select_optimizer(model, nn_config["Training"], freeze_conv=freeze)


def prepare_loaders_and_config(
    config: Dict[str, Any], samples: Optional[List] = None
) -> Tuple[GraphLoader, GraphLoader, GraphLoader, Dict[str, Any]]:
    """Data preparation, split, config inference and the three loaders."""
    train, val, test, config = prepare_config_and_samples(config, samples)
    return (*create_dataloaders(train, val, test, config), config)


def train_with_loaders(
    config: Dict[str, Any],
    train_loader: GraphLoader,
    val_loader: GraphLoader,
    test_loader: GraphLoader,
    log_dir: str = "./logs/",
    device: Optional[str] = "cuda",
    seed: int = 0,
):
    """Model (seeded init) + optimizer + epoch loop + checkpoint, on
    loaders whose config went through ``update_config``. With
    ``Training.continue = 1`` the model and optimizer start from
    ``Training.startfrom``'s checkpoint. The run's log, config, records
    (``metrics.jsonl``, tensorboard events, a ``Profile`` trace) and the
    ``Visualization`` section's plots go to ``<log_dir>/<log name>/``.
    Returns (model, optimizer, history).

    The run's ``Partitioner`` (``parallel/partitioner.py``) comes from the
    config and the loaders' split; in a group of processes the loaders'
    widths are first checked to agree on every rank. The model is built
    with SyncBatchNorm's group, the loaders are attached, and the
    optimizer is placed in the layout before a checkpoint is restored
    into it; rank 0 prints the model and writes the checkpoint."""
    from hydragnn_tpu_torch.parallel import Partitioner, get_comm_size_and_rank

    dev = resolve_device(device)
    verbosity = config.get("Verbosity", {}).get("level", 0)
    log_name = get_log_name_config(config)
    setup_log(log_name, log_dir)
    save_config(config, log_name, log_dir)
    nn_config = config["NeuralNetwork"]
    world, rank = get_comm_size_and_rank()
    stack = int(getattr(train_loader, "device_stack", 1))
    if world > 1:
        # every process's width, gathered BEFORE anyone raises: a rank
        # that raised alone would leave the others blocked in a collective
        import torch.distributed as dist

        widths = [None] * world
        dist.all_gather_object(widths, stack)
        if any(w != stack for w in widths):
            raise ValueError(f"device_stack must agree across processes, got {widths}")
    partitioner = Partitioner.from_config(nn_config, device_stack=stack, multihost=world > 1 and stack == 1)
    model = create_model_config(nn_config, seed=seed, device=dev, bn_axis_name=partitioner.bn_axis_name)
    optimizer = _optimizer_for(model, nn_config)
    for loader in (train_loader, val_loader, test_loader):
        partitioner.attach_loader(loader)
    # placed BEFORE the restore: a checkpoint loads into the run's layout
    optimizer = partitioner.shard_init(model, optimizer)
    # a child the restart supervisor started again (HGTORCH_AUTO_RESUME=1)
    # picks up its own checkpoint through continue/startfrom
    auto_resume_config(nn_config["Training"], log_name, log_dir)
    load_existing_model_config(model, nn_config["Training"], log_dir, optimizer=optimizer)
    if rank == 0:
        print_model(model, verbosity)
    viz = config.get("Visualization", {})
    history = train_validate_test(
        model, optimizer, train_loader, val_loader, test_loader, nn_config, verbosity=verbosity,
        log_name=log_name, log_dir=log_dir,
        create_plots=bool(viz.get("create_plots", False)),
        plot_init_solution=bool(viz.get("plot_init_solution", False)),
        plot_hist_solution=bool(viz.get("plot_hist_solution", False)),
        # the full resolved config goes into the flight record's manifest
        run_config=config,
        partitioner=partitioner,
    )
    save_model(model, log_name, log_dir, optimizer=optimizer, epoch=len(history["train_loss"]))
    return model, optimizer, history


def run_training(
    config_file_or_dict,
    samples: Optional[List] = None,
    log_dir: str = "./logs/",
    device: Optional[str] = "cuda",
    seed: int = 0,
):
    """The full training pipeline on ``device``, timed as
    ``total_training`` (``utils/time_utils.py``, printed at the config's
    verbosity); returns (model, optimizer, history, completed config).

    Telemetry (``NeuralNetwork.Training``; all of it inert under
    ``HGTORCH_TELEMETRY=0``): the run writes the flight record
    ``<log_dir>/<log name>/flight.jsonl``. ``diagnostics`` (default
    true; ``HGTORCH_DIAGNOSTICS=0`` forces it off) samples per-head
    gradient norms, the inter-task cosine matrix and the update ratio
    every ``diag_every`` steps (0: once an epoch), per-head MAE/RMSE of
    the test pass, and the hardware ledger (FLOPs a step, achieved
    TFLOP/s, MFU against the card's bf16 peak, the memory watermark);
    ``slo_triggers`` evaluates ``train_nonfinite_burst``
    (``slo_nonfinite_burst``), ``train_loss_spike``
    (``slo_loss_spike_factor``) and ``train_mfu_drop``
    (``slo_mfu_drop_factor``) at each epoch's end and writes incident
    bundles under ``incidents/``; ``prometheus_dir`` writes an atomic
    ``train.prom`` snapshot each epoch."""
    resolve_device(device)
    config = load_config(config_file_or_dict)
    verbosity = config.get("Verbosity", {}).get("level", 0)
    timer = Timer("total_training")
    timer.start()
    try:
        train_loader, val_loader, test_loader, config = prepare_loaders_and_config(config, samples)
        model, optimizer, history = train_with_loaders(
            config, train_loader, val_loader, test_loader, log_dir=log_dir, device=device, seed=seed
        )
    finally:
        timer.stop_if_running()
    print_timers(verbosity)
    return model, optimizer, history, config


def run_prediction(
    config_file_or_dict,
    samples: Optional[List] = None,
    log_dir: str = "./logs/",
    device: Optional[str] = "cuda",
) -> Tuple[float, np.ndarray, List[np.ndarray], List[np.ndarray]]:
    """Load the data and the trained run's checkpoint, run the full test
    pass on ``device``; returns (error, per-head errors, true values,
    predicted values), denormalized when
    ``Variables_of_interest.denormalize_output`` is set."""
    dev = resolve_device(device)
    config = load_config(config_file_or_dict)
    _, _, test_loader, config = prepare_loaders_and_config(config, samples)
    nn_config = config["NeuralNetwork"]
    model = create_model_config(nn_config, device=dev)
    load_existing_model(model, get_log_name_config(config), log_dir, optimizer=_optimizer_for(model, nn_config))
    error, error_tasks, true_values, predicted_values = test_epoch(test_loader, model)
    voi = nn_config["Variables_of_interest"]
    if voi.get("denormalize_output"):
        true_values, predicted_values = output_denormalize(voi["y_minmax"], true_values, predicted_values)
    return error, error_tasks, true_values, predicted_values


def serve_model(
    config_file_or_dict,
    samples: Optional[List] = None,
    params: Union[None, str, Mapping[str, torch.Tensor]] = None,
    serve_config=None,
    device: Optional[str] = "cuda",
    start: bool = True,
    seed: int = 0,
    log_dir: Optional[str] = None,
    flight=None,
):
    """Stand up a batched online-inference server on ``device``.

    The dataset pipeline runs as in the JAX package (normalization,
    radius edges, config inference); its prepared samples size the
    bucket ladder and fix the request field spec, and requests must be
    prepared the same way (``server.reference_samples`` holds them).
    The weights: ``params``, a state dict or the path of one saved with
    ``torch.save``; else, with ``log_dir``, the run's checkpoint under
    ``<log_dir>/<log_name>/`` through the validating loader, as the JAX
    package serves; else the seeded init (``seed``). The server's
    ``log_dir`` (``reload("run")``'s root) is ``log_dir``, or
    ``./logs/``. ``flight`` (``obs/flight.py:FlightRecorder``) takes the
    serving record. ``Parallel.fsdp`` above 1 warns and serves
    replicated on the one device (fsdp serving, a server over several
    processes, is ROADMAP A-5c).
    Predictions are in model space (normalized targets).

    Raises without a CUDA card unless ``device="cpu"``. Returns the
    server (started unless ``start=False``); callers own its lifecycle
    (``server.stop()``, or use it as a context manager)."""
    dev = resolve_device(device)
    config = load_config(config_file_or_dict)
    train, val, test, config = prepare_config_and_samples(config, samples)

    from hydragnn_tpu_torch.serve import ModelRegistry, ModelServer, ServeConfig

    nn_config = config["NeuralNetwork"]
    fsdp = int((nn_config.get("Parallel") or {}).get("fsdp", 1) or 1)
    if fsdp > 1:
        warnings.warn(
            f"Parallel.fsdp={fsdp} exceeds the one device this server holds; serving single-device "
            "(replicated parameters)",
            RuntimeWarning,
            stacklevel=2,
        )
    registry = ModelRegistry(log_dir or "./logs/", device=dev)
    name = config["Dataset"].get("name", "model") if "Dataset" in config else "model"
    if isinstance(params, str):
        served = registry.load_state_dict_file(name, nn_config, params)
    elif params is None and log_dir is not None:
        served = registry.load(get_log_name_config(config), nn_config, seed=seed)
    else:
        served = registry.register(name, nn_config, params, seed=seed)
    server = ModelServer(served, list(train) + list(val) + list(test), serve_config or ServeConfig(), flight=flight)
    server.log_dir = registry.log_dir
    if start:
        server.start()
    return server
