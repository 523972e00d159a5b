"""Reprojection error of tracked points: a copy of the arithmetic of the
port's ``utils/evaluation.py`` (``reprojection_errors``, ``summarize``),
which the reference and the harness use on the program's reported
coordinates."""

from __future__ import annotations

import numpy as np


def reprojection_errors(gt_xy, gt_valid, est_xy, est_valid) -> np.ndarray:
    """Per-point pixel distance, -1 where the GT point is invisible or the
    point is not tracked."""
    d = np.linalg.norm(np.asarray(gt_xy, np.float32)
                       - np.asarray(est_xy, np.float32), axis=-1)
    ok = np.asarray(gt_valid, bool) & np.asarray(est_valid, bool)
    return np.where(ok, d, -1.0)


def mean_error(errors) -> float:
    """Mean over the valid (>= 0) point-frames of a list of per-frame error
    arrays; NaN where none is valid."""
    arr = np.concatenate([np.ravel(e) for e in errors]) if errors else \
        np.zeros(0)
    valid = arr >= 0
    return float(arr[valid].mean()) if valid.any() else float("nan")
