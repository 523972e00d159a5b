"""Host-side frame loop around the tracking step, with tracking accuracy
against ground-truth points (counterpart of super_tpu/pipeline.py).

The sequence has a serial dependency (frame t feeds t + 1), so the loop
lives on the host: each frame is preprocessed onto the device, frame 0
initialises the tracker, every later frame runs ``track_step``, and where
ground truth is given the tracked points are bound and read
(core/track_points.py) and their reprojection errors kept
(utils/evaluation.py).  The loop synchronises with the device once a
frame, for the frame's time, as the JAX package's ``block_until_ready``
does.

Given segmentations (``segs``, ``seg_confs``) go into each frame's
preprocessing, as the semantic configurations need.  Not ported yet: the
logger, render and checkpoint hooks, depth and segmentation from models,
and the optical-flow step of ``sf_corr``; each raises
``NotImplementedError`` when asked for.
"""

from __future__ import annotations

import time as _time
from typing import Dict, Optional

import numpy as np
import torch

from super_tpu_torch.config import SuPerConfig
from super_tpu_torch.core.preprocess import preprocess_frame
from super_tpu_torch.core.state import TrackerState
from super_tpu_torch.core.track_points import (
    assign_track_points,
    record_track_coords,
)
from super_tpu_torch.core.tracker import init_tracker, track_step
from super_tpu_torch.geometry.camera import Intrinsics
from super_tpu_torch.utils import evaluation

OVERFLOW_COUNTERS = ("tuple_overflow", "pair_overflow", "proj_overflow",
                     "add_overflow", "free_exhausted", "dup_skipped")


class SuPerPipeline:
    """Single-stream tracking pipeline on ``device`` (the card unless the
    caller asks for the CPU)."""

    def __init__(self, cfg: SuPerConfig, intr: Intrinsics,
                 logdir: Optional[str] = None,
                 checkpoint_dir: Optional[str] = None, device="cuda"):
        if logdir is not None or checkpoint_dir is not None:
            raise NotImplementedError(
                "the logger and checkpoint hooks are not ported")
        self.cfg = cfg
        self.device = torch.device(device)
        self.intr = Intrinsics(*(x.to(self.device) for x in intr))
        self.state: Optional[TrackerState] = None
        self.track_results: Dict[int, np.ndarray] = {}
        self.errors: Dict[int, np.ndarray] = {}
        self.frame_times = []
        self.overflow_totals: Dict[str, int] = {}

    def run(self, depths, colors, gt_xy=None, gt_valid=None, segs=None,
            seg_confs=None, right_colors=None, models=None,
            verbose: bool = False):
        """Track a whole sequence.

        depths: (T, H, W) numpy; colors: (T, H, W, 3) or (T, 3, H, W)
        numpy; gt_xy: optional (T, P, 2) GT screen coordinates, gt_valid
        (T, P) bool; segs: optional (T, H, W) class labels, seg_confs
        (T, C, H, W) class scores.  Returns the summary metrics.
        """
        if depths is None or models is not None or right_colors is not None:
            raise NotImplementedError(
                "depth from models (and stereo) is not ported; pass depths")
        cfg, dev = self.cfg, self.device
        for t in range(len(colors)):
            tic = _time.perf_counter()
            color = np.asarray(colors[t])
            if color.shape[-1] == 3:  # HWC -> CHW
                color = color.transpose(2, 0, 1)
            frame = preprocess_frame(
                cfg, self.intr, np.asarray(depths[t]),
                np.ascontiguousarray(color), float(t),
                seg=None if segs is None else np.asarray(segs[t]),
                seg_conf=None if seg_confs is None else np.asarray(
                    seg_confs[t]), device=dev)
            outs = None
            if self.state is None:
                self.state = init_tracker(cfg, frame)
            else:
                self.state, outs = track_step(cfg, self.intr, self.state,
                                              frame)
            if gt_xy is not None:
                self._eval_frame(t, frame, gt_xy[t], gt_valid[t])
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            self.frame_times.append(_time.perf_counter() - tic)
            if outs is not None:
                # One host fetch for all counters.
                vals = torch.stack([getattr(outs, n).to(torch.int64)
                                    for n in OVERFLOW_COUNTERS]).tolist()
                for name, c in zip(OVERFLOW_COUNTERS, vals):
                    if c > 0:
                        self.overflow_totals[name] = \
                            self.overflow_totals.get(name, 0) + c
                        if verbose:
                            print(f"frame {t}: capacity overflow {name}={c} "
                                  f"(accuracy degraded; see StepOutputs)")
            if verbose and t % 10 == 0:
                n = int(self.state.surfels.num_active)
                print(f"frame {t}: {n} surfels, "
                      f"{self.frame_times[-1] * 1e3:.1f} ms")
        return self.summary()

    def _eval_frame(self, t, frame, gt_xy_t, gt_valid_t):
        dev = self.device
        gt_xy_t = np.asarray(gt_xy_t)
        gt_valid_t = np.asarray(gt_valid_t)
        track = assign_track_points(
            self.cfg, self.state.surfels, frame, self.state.track,
            torch.as_tensor(gt_xy_t.astype(np.int32), device=dev),
            torch.as_tensor(gt_valid_t, device=dev))
        track = record_track_coords(self.state.surfels, track)
        self.state = self.state._replace(track=track)
        coord_valid = track.coord_valid.cpu().numpy()
        est = np.concatenate(
            [track.coords.cpu().numpy(),
             coord_valid.astype(np.float32)[:, None]], axis=1)
        gt = np.concatenate(
            [gt_xy_t, gt_valid_t.astype(np.float32)[:, None]], axis=1)
        self.track_results[t] = est
        # Errors only count points that are both GT-visible and tracked.
        err = evaluation.reprojection_errors(gt, est)
        err[~coord_valid] = -1.0
        self.errors[t] = err

    def summary(self) -> Dict[str, float]:
        out = evaluation.summarize(self.errors, edge_ids=self.cfg.edge_ids)
        if self.frame_times:
            steady = self.frame_times[2:] or self.frame_times
            out["mean_frame_ms"] = float(np.mean(steady) * 1e3)
            out["p50_frame_ms"] = float(np.percentile(steady, 50) * 1e3)
            out["fps"] = 1e3 / out["p50_frame_ms"]
        if self.state is not None:
            out["num_surfels"] = float(self.state.surfels.num_active)
            out["num_nodes"] = float(self.state.graph.num_active)
        for name, total in self.overflow_totals.items():
            out[f"overflow_{name}"] = float(total)
        return out
