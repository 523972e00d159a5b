"""Tracking-accuracy evaluation (host-side numpy): the port's own copy of
super_tpu/utils/evaluation.py, which imports no JAX.

Parity: the module-level ``evaluate`` (super/nodes.py:17-34) + the scalar
summaries of ``log_trackpts_err`` (utils/utils.py:499-511): per-point L2
pixel error, -1 where GT invisible; report mean/std over all and over a
designated edge-point subset.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


def reprojection_errors(gt_xyv: np.ndarray, est_xyv: np.ndarray,
                        ignored_ids: Sequence[int] = ()) -> np.ndarray:
    """Per-point pixel error; -1 where GT invalid (nodes.py:17-34)."""
    valid = gt_xyv[:, 2] == 1
    if len(ignored_ids) > 0:
        valid = valid.copy()
        valid[np.asarray(ignored_ids) - 1] = False
    d = np.linalg.norm(gt_xyv[:, 0:2] - est_xyv[:, 0:2], axis=1)
    d[~valid] = -1.0
    return d


def baseline_errors_from_bundle(bundle, key: str = "super_cpp"
                                ) -> Dict[int, np.ndarray]:
    """Per-frame reprojection errors of a baseline trajectory stored in the
    GT bundle (the original C++ SuPer results shipped inside the GT file;
    reference co-plots them, super/nodes.py:128-132,780-789)."""
    if key not in bundle:
        return {}
    gt = bundle["gt"]
    out = {}
    for name, est in bundle[key].items():
        if name in gt:
            out[int(name)] = reprojection_errors(np.asarray(gt[name]),
                                                 np.asarray(est))
    return out


def summarize(err_frames: Dict[int, np.ndarray],
              edge_ids: Sequence[int] = ()) -> Dict[str, float]:
    """Mean/std of reprojection error over frames x points.

    Invalid entries (-1) are excluded from the statistics (the reference's
    raw np.mean over the array including -1 is also reported as *_raw for
    comparability with its TensorBoard scalars)."""
    if not err_frames:
        return {}
    arr = np.stack([err_frames[k] for k in sorted(err_frames)], axis=0)
    valid = arr >= 0
    out = {
        "reproj_mean": float(arr[valid].mean()) if valid.any() else float("nan"),
        "reproj_std": float(arr[valid].std()) if valid.any() else float("nan"),
        "reproj_mean_raw": float(arr.mean()),
        "reproj_std_raw": float(arr.std()),
        "num_eval_frames": float(arr.shape[0]),
        "frac_valid": float(valid.mean()),
    }
    if len(edge_ids) > 0:
        sel = np.zeros(arr.shape[1], dtype=bool)
        sel[np.asarray(edge_ids) - 1] = True
        sub = arr[:, sel]
        subv = sub >= 0
        out["reproj_edge_mean"] = float(sub[subv].mean()) if subv.any() else float("nan")
        out["reproj_edge_std"] = float(sub[subv].std()) if subv.any() else float("nan")
    return out


def compute_depth_errors(gt: np.ndarray, pred: np.ndarray) -> Dict[str, float]:
    """Standard monocular-depth error metrics.

    Parity: compute_depth_errors (depth/monodepth2/layers.py:250-267) --
    abs_rel, sq_rel, rmse, rmse_log and the delta < 1.25^k accuracies, over
    already-masked/aligned gt/pred arrays.
    """
    gt = np.asarray(gt, np.float64)
    pred = np.asarray(pred, np.float64)
    thresh = np.maximum(gt / pred, pred / gt)
    diff = gt - pred
    return {
        "abs_rel": float(np.mean(np.abs(diff) / gt)),
        "sq_rel": float(np.mean(diff ** 2 / gt)),
        "rmse": float(np.sqrt(np.mean(diff ** 2))),
        "rmse_log": float(np.sqrt(np.mean((np.log(gt) - np.log(pred)) ** 2))),
        "a1": float(np.mean(thresh < 1.25)),
        "a2": float(np.mean(thresh < 1.25 ** 2)),
        "a3": float(np.mean(thresh < 1.25 ** 3)),
    }
