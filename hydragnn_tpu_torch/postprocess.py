"""Output denormalization (the port's copy of
``hydragnn_tpu/postprocess/postprocess.py:output_denormalize``)."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def output_denormalize(
    y_minmax: Sequence[Sequence[float]],
    true_values: List[np.ndarray],
    predicted_values: List[np.ndarray],
):
    """Inverse min-max transform per head: ``v·(max − min) + min``."""
    out_true, out_pred = [], []
    for ihead in range(len(y_minmax)):
        ymin = np.asarray(y_minmax[ihead][0], dtype=np.float64)
        ymax = np.asarray(y_minmax[ihead][1], dtype=np.float64)
        scale = ymax - ymin
        out_true.append(np.asarray(true_values[ihead]) * scale + ymin)
        out_pred.append(np.asarray(predicted_values[ihead]) * scale + ymin)
    return out_true, out_pred
