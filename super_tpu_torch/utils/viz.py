"""The tracking pipeline's logger (counterpart of super_tpu/utils/viz.py),
host-side numpy, with no TensorBoard and no matplotlib.

The JAX package's ``TrackingLogger`` writes TensorBoard event files and
draws its plots with matplotlib; the card machine has neither.  This one
has the same methods and tags, and writes plain files under ``logdir``:

- scalars as JSON lines in ``scalars.jsonl``, one ``{"tag", "step",
  "value"}`` object a line, appended as they come;
- images as 8-bit RGB PNGs (``data/png.py``) at ``<tag>/<step:08d>.png``,
  converted as TensorBoard's ``image()`` converts them: a float image times
  255 in float32, clipped to [0, 255], truncated to uint8 (a uint8 image
  as it is), so that they decode to what the JAX logger stores;
- the three reprojection plots and the point cloud as the data they
  would draw, ``np.savez`` files at ``<tag>/<step:08d>.npz``.

The image helpers (points and mesh edges drawn into the render, the
disparity ``1 / max(depth, 1e-6)`` over its maximum through magma) are
the JAX logger's.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Sequence

import numpy as np

from super_tpu_torch.data.png import write_png
from super_tpu_torch.utils.colormap import magma
from super_tpu_torch.utils.labels import seg_to_color

CAPACITY_COUNTERS = ("tuple_overflow", "pair_overflow", "proj_overflow",
                     "add_overflow", "free_exhausted", "dup_skipped")


def image_to_uint8(image_chw) -> np.ndarray:
    """(3, H, W) image -> (H, W, 3) uint8, as TensorBoard's ``image()``."""
    a = np.asarray(image_chw)
    scale = 1 if a.dtype == np.uint8 else 255
    return (a.transpose(1, 2, 0).astype(np.float32) * scale).clip(
        0, 255).astype(np.uint8)


class TrackingLogger:
    """File sink of the tracking pipeline's scalars, images and plots."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self.logdir = logdir

    def _path(self, tag: str, step: int, ext: str) -> str:
        d = os.path.join(self.logdir, tag)
        os.makedirs(d, exist_ok=True)
        return os.path.join(d, f"{int(step):08d}.{ext}")

    def add_scalar(self, tag: str, value, step: int):
        with open(os.path.join(self.logdir, "scalars.jsonl"), "a") as f:
            f.write(json.dumps({"tag": tag, "step": int(step),
                                "value": float(value)}) + "\n")

    def add_image(self, tag: str, image_chw, step: int):
        write_png(self._path(tag, step, "png"), image_to_uint8(image_chw))

    def add_data(self, tag: str, step: int, **arrays):
        np.savez(self._path(tag, step, "npz"), **arrays)

    # -- scalars ----------------------------------------------------------

    def log_step(self, time: int, outs, frame_ms: Optional[float] = None):
        self.add_scalar("graph_info/num_surfels", int(outs.num_surfels), time)
        self.add_scalar("graph_info/num_ED_nodes", int(outs.num_nodes), time)
        self.add_scalar("optimization_record/final_cost",
                        float(outs.lm_cost), time)
        self.add_scalar("optimization_record/damping",
                        float(outs.lm_damping), time)
        if frame_ms is not None:
            self.add_scalar("optimization_record/optim_time_per_frame",
                            frame_ms / 1e3, time)
        for name in CAPACITY_COUNTERS:
            if hasattr(outs, name):
                self.add_scalar(f"capacity/{name}", int(getattr(outs, name)),
                                time)

    def log_reproj(self, time: int, err_frames: Dict[int, np.ndarray],
                   edge_ids: Sequence[int] = ()):
        if not err_frames:
            return
        arr = np.stack([err_frames[k] for k in sorted(err_frames)], axis=0)
        valid = arr >= 0
        if valid.any():
            self.add_scalar("reprojerr/mean", arr[valid].mean(), time)
            self.add_scalar("reprojerr/std", arr[valid].std(), time)
        if len(edge_ids) > 0:
            sel = np.zeros(arr.shape[1], dtype=bool)
            sel[np.asarray(edge_ids) - 1] = True
            sub = arr[:, sel]
            sv = sub >= 0
            if sv.any():
                self.add_scalar("reprojerr/edge_pts_mean", sub[sv].mean(),
                                time)
                self.add_scalar("reprojerr/edge_pts_std", sub[sv].std(),
                                time)

    # -- the plots' data --------------------------------------------------

    def log_trackpts_plots(self, time: int, err_frames: Dict[int, np.ndarray],
                           results: Dict[int, np.ndarray],
                           gt_xy: np.ndarray):
        """Per-point mean and std of the error, the mean error over time,
        and the GT and tracked trajectories of the first 8 points."""
        keys = sorted(err_frames)
        if not keys:
            return
        arr = np.stack([err_frames[k] for k in keys], axis=0)   # (T, P)
        npts = arr.shape[1]
        valid = arr >= 0
        means = [arr[:, i][valid[:, i]].mean() if valid[:, i].any() else 0
                 for i in range(npts)]
        stds = [arr[:, i][valid[:, i]].std() if valid[:, i].any() else 0
                for i in range(npts)]
        self.add_data("plots/reproj_per_point", time,
                      point_id=np.arange(npts), mean=np.asarray(means),
                      std=np.asarray(stds))
        per_t = np.where(valid, arr, np.nan)
        self.add_data("plots/reproj_over_time", time, frame=np.asarray(keys),
                      mean=np.nanmean(per_t, axis=1))
        show = min(npts, 8)
        self.add_data("plots/trajectories", time,
                      gt_xy=np.asarray(gt_xy)[:, :show, :2],
                      pred_xy=np.stack([results[k][:show, :2] for k in keys]),
                      pred_frame=np.asarray(keys))

    # -- images -----------------------------------------------------------

    def log_images(self, time: int, color_chw: np.ndarray,
                   depth: Optional[np.ndarray] = None,
                   render_chw: Optional[np.ndarray] = None,
                   keypoints_xy: Optional[np.ndarray] = None,
                   mesh_points_xy: Optional[np.ndarray] = None,
                   mesh_edges: Optional[np.ndarray] = None,
                   seg: Optional[np.ndarray] = None):
        self.add_image("visualization/raw", np.clip(color_chw, 0, 1), time)
        if depth is not None:
            disp = 1.0 / np.maximum(depth, 1e-6)
            disp = np.nan_to_num(disp)
            disp = disp / max(disp.max(), 1e-6)
            self.add_image("visualization/disparity",
                           magma(np.clip(disp, 0, 1)).transpose(2, 0, 1),
                           time)
        if render_chw is not None:
            img = np.clip(render_chw.copy(), 0, 1)
            if keypoints_xy is not None:
                img = _draw_points(img, keypoints_xy, (1.0, 0.1, 0.1))
            if mesh_points_xy is not None and mesh_edges is not None:
                img = _draw_edges(img, mesh_points_xy, mesh_edges,
                                  (1.0, 1.0, 1.0))
            self.add_image("visualization/render", img, time)
        if seg is not None:
            self.add_image("visualization/seg_pred", seg_to_color(seg), time)

    def log_pointcloud(self, time: int, points: np.ndarray,
                       colors: np.ndarray):
        """The surfel map's (N, 3) points and colours (clipped to [0, 1])."""
        self.add_data("visualization/pcd", time, points=np.asarray(points),
                      colors=np.clip(colors, 0, 1))

    def close(self):
        """Nothing is held open: every write opens and closes its file."""


def _draw_points(img_chw, xy, color, radius=2):
    _, h, w = img_chw.shape
    for x, y in np.asarray(xy).reshape(-1, 2):
        xi, yi = int(round(x)), int(round(y))
        x0, x1 = max(0, xi - radius), min(w, xi + radius + 1)
        y0, y1 = max(0, yi - radius), min(h, yi + radius + 1)
        for c in range(3):
            img_chw[c, y0:y1, x0:x1] = color[c]
    return img_chw


def _draw_edges(img_chw, pts_xy, edges, color):
    _, h, w = img_chw.shape
    for a, b in np.asarray(edges).reshape(-1, 2):
        x0, y0 = pts_xy[a]
        x1, y1 = pts_xy[b]
        n = int(max(abs(x1 - x0), abs(y1 - y0), 1))
        xs = np.linspace(x0, x1, n).round().astype(int)
        ys = np.linspace(y0, y1, n).round().astype(int)
        ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
        for c in range(3):
            img_chw[c, ys[ok], xs[ok]] = color[c]
    return img_chw
