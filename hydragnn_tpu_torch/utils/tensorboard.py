"""Tensorboard scalars from process 0 (the port's copy of
``hydragnn_tpu/utils/tensorboard.py``).

``get_summary_writer`` returns a ``torch.utils.tensorboard.SummaryWriter``
under ``<log_dir>/<log_name>`` on process 0, and a writer that drops
everything on the other processes or where the ``tensorboard`` package
is not installed (an optional dependency: the loop's ``metrics.jsonl``
keeps the same numbers either way). The writer is imported inside the
function, so importing this module needs no tensorboard.
"""

from __future__ import annotations

import numbers
import os

from hydragnn_tpu_torch.utils.print_utils import process_index


class NullWriter:
    """The writer where there is no tensorboard or on process > 0."""

    def add_scalar(self, tag: str, value, step: int) -> None:
        pass

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


def write_scalar_dict(writer, scalars: dict, step: int, prefix: str = "") -> int:
    """Write a (possibly nested) dict of numbers as ``prefix/key/subkey``
    scalars; booleans and non-numeric leaves are skipped. Returns the
    number of scalars written."""
    written = 0
    for key, value in scalars.items():
        tag = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, dict):
            written += write_scalar_dict(writer, value, step, prefix=tag)
        elif isinstance(value, bool):
            continue
        elif isinstance(value, numbers.Real):
            writer.add_scalar(tag, float(value), step)
            written += 1
    return written


def get_summary_writer(log_name: str, log_dir: str = "./logs/"):
    """Process 0's ``SummaryWriter`` under ``<log_dir>/<log_name>``; a
    ``NullWriter`` on other processes or without tensorboard."""
    if process_index() != 0:
        return NullWriter()
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        return NullWriter()
    path = os.path.join(log_dir, log_name)
    os.makedirs(path, exist_ok=True)
    return SummaryWriter(log_dir=path)
