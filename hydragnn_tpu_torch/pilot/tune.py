"""The fine-tune child (the port's counterpart of
``hydragnn_tpu/pilot/tune.py``): retrain the serving model over a pinned
request-spool window, warm-started from the serving checkpoint.

The pilot starts it under the restart supervisor::

    python -m hydragnn_tpu_torch.pilot.tune \\
        --log-dir ./logs/ --serving-run <run> --spool-dir <spool> \\
        --candidate <run>-pilot-c1 [--shards shard-000001,...] [--epochs 2] \\
        [--device cuda]

It re-derives nothing: it loads the serving run's SAVED resolved config
(``<log_dir>/<run>/config.json``, through ``update_config`` already) and
the spool shards' samples, which are prepared already (the spool stores
the served answers as target fields, so a shard loads as a labelled set
with the old weights' predictions as pseudo-labels). The loaders are
built over those samples with no second normalisation; the model and
optimizer are restored from the serving checkpoint through the
validating loader, and ``train_validate_test`` runs a short fine-tune
under a DISTINCT candidate run name, so the serving checkpoint is never
written.

Exit codes (``resilience/preempt.py``, what the supervisor classifies): 0
completed, 78 config error (missing config or checkpoint, too few
samples: a retry cannot help), 70 the injected crash
(``HGTORCH_INJECT_PILOT_TRAIN_CRASH``), anything else crash-class.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Any, Dict, List, Optional, Sequence

from hydragnn_tpu_torch.obs.triggers import _knob
from hydragnn_tpu_torch.resilience import inject
from hydragnn_tpu_torch.resilience.preempt import EXIT_CONFIG_ERROR


def _split(samples: Sequence) -> tuple:
    """A deterministic ~80/10/10 split that leaves no split empty."""
    n = len(samples)
    if n < 3:
        raise ValueError(f"fine-tune needs at least 3 spooled samples, got {n}")
    val = [s for i, s in enumerate(samples) if i % 10 == 8]
    test = [s for i, s in enumerate(samples) if i % 10 == 9]
    train = [s for i, s in enumerate(samples) if i % 10 < 8]
    if not val:
        val = [train.pop()]
    if not test:
        test = [train.pop()]
    return train, val, test


def _load_window(spool_dir: Optional[str], shards: Optional[Sequence[str]]) -> List[Any]:
    """The samples of the pinned window: the named shards, else every
    shard of the spool."""
    from hydragnn_tpu_torch.data.container import ContainerDataset
    from hydragnn_tpu_torch.obs.spool import list_shards

    if spool_dir is None:
        raise ValueError("fine-tune needs a spool directory")
    if shards:
        dirs = [os.path.join(spool_dir, os.path.basename(s)) for s in shards]
    else:
        dirs = list_shards(spool_dir)
    out: List[Any] = []
    for d in dirs:
        out.extend(ContainerDataset(d).samples())
    return out


def fine_tune(
    log_dir: str,
    serving_run: str,
    candidate: str,
    spool_dir: Optional[str] = None,
    shards: Optional[Sequence[str]] = None,
    epochs: Optional[int] = None,
    device: Optional[str] = "cuda",
) -> Dict[str, Any]:
    """Run the fine-tune on ``device``; returns a small result manifest.
    Raises ``ValueError``, ``FileNotFoundError`` or ``KeyError`` on a
    deterministic configuration problem (the CLI's exit 78)."""
    # the injected wedge fires before any work, so the supervisor's wall
    # clock is what ends it
    inject.maybe_pilot_hang()

    with open(os.path.join(log_dir, serving_run, "config.json")) as f:
        config = json.load(f)
    nn_config = config["NeuralNetwork"]
    training = nn_config["Training"]
    training["num_epoch"] = int(epochs if epochs is not None else _knob("HGTORCH_PILOT_TUNE_EPOCHS", 2))
    # the serving run's own continue/startfrom must not leak into the
    # fine-tune; the warm start below is explicit
    training.pop("continue", None)
    training.pop("startfrom", None)

    samples = _load_window(spool_dir, shards)
    train, val, test = _split(samples)

    from hydragnn_tpu_torch.api import _optimizer_for, create_dataloaders
    from hydragnn_tpu_torch.device import resolve_device
    from hydragnn_tpu_torch.models.create import create_model_config
    from hydragnn_tpu_torch.train.loop import train_validate_test
    from hydragnn_tpu_torch.utils.checkpoint import load_existing_model, save_model
    from hydragnn_tpu_torch.utils.config import save_config

    dev = resolve_device(device)
    train_loader, val_loader, test_loader = create_dataloaders(train, val, test, config)
    model = create_model_config(nn_config, device=dev)
    optimizer = _optimizer_for(model, nn_config)
    # the warm start: the serving checkpoint through the validating loader
    # (sha256 sidecars, the torn-pointer fallback)
    load_existing_model(model, serving_run, log_dir, optimizer=optimizer)
    history = train_validate_test(
        model, optimizer, train_loader, val_loader, test_loader, nn_config,
        log_name=candidate, log_dir=log_dir, run_config=config,
        manifest_extra={"fine_tune": {"from_run": serving_run, "spool_dir": spool_dir, "shards": list(shards or []),
                                      "num_samples": len(samples)}},
    )
    save_model(model, candidate, log_dir, optimizer=optimizer, epoch=len(history["train_loss"]))
    save_config(config, candidate, log_dir)
    return {
        "candidate": candidate,
        "serving_run": serving_run,
        "num_samples": len(samples),
        "epochs": training["num_epoch"],
        "splits": [len(train), len(val), len(test)],
    }


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--log-dir", required=True)
    p.add_argument("--serving-run", required=True)
    p.add_argument("--candidate", required=True)
    p.add_argument("--spool-dir", default=None)
    p.add_argument("--shards", default=None,
                   help="comma-separated shard names (the pinned window); default: every shard of the spool")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    # the injected crash, before training: crash-class; the supervisor
    # strips the injection from the retried child, which runs clean
    if inject.pilot_train_crashes() > 0:
        print("pilot.tune: injected train crash", file=sys.stderr)
        return 70

    shards = args.shards.split(",") if args.shards else None
    try:
        out = fine_tune(args.log_dir, args.serving_run, args.candidate, spool_dir=args.spool_dir, shards=shards,
                        epochs=args.epochs, device=args.device)
    except (FileNotFoundError, ValueError, KeyError) as exc:
        print(f"pilot.tune: config error: {exc!r}", file=sys.stderr)
        return EXIT_CONFIG_ERROR
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    from hydragnn_tpu_torch.resilience.preempt import run_guard

    with run_guard():
        raise SystemExit(main())
