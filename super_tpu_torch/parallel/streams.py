"""Many sequences tracked at once (counterpart of
super_tpu/parallel/streams.py).

The north-star deployment is many concurrent surgical streams: each
stream's state is independent, so the streams batch (parallel/sharded.py:
make_batched_step) and split over the 'stream' axis of a mesh
(make_multichip_step).  This host loop drives the batched step over the
streams' frames with per-stream tracking evaluation: the multi-sequence
counterpart of pipeline.py.  As there, the B streams' steps (the LM
solve and the autograd fit alike) are one CUDA graph on the card,
replayed once a batch, and each stream's frame is preprocessed by one
captured ``preprocess_frame`` (``loop`` "graph"); on a mesh with two or
more shards the step's graphs are cut at its all-reduces
(make_multichip_step).  On CPU tensors both run eagerly (``loop``
"eager").  The loop's spans are pipeline.py's (``pipeline.frame`` a
batch step; ``pipeline.fetch`` and ``pipeline.preprocess`` once a
stream).
"""

from __future__ import annotations

import time as _time
from typing import Dict, List

import numpy as np
import torch
import torch.distributed as dist

from super_tpu_torch.config import SuPerConfig
from super_tpu_torch.core.preprocess import preprocess_frame
from super_tpu_torch.core.track_points import (
    assign_track_points,
    record_track_coords,
)
from super_tpu_torch.core.tracker import init_tracker
from super_tpu_torch.geometry.camera import Intrinsics
from super_tpu_torch.parallel import multihost
from super_tpu_torch.parallel.sharded import (
    make_batched_step,
    make_multichip_step,
)
from super_tpu_torch.pipeline import CPU_EAGER, _chw, captured_preprocess
from super_tpu_torch.utils import evaluation
from super_tpu_torch.utils.profiling import span
from super_tpu_torch.utils.tree import stack, unstack


class MultiStreamPipeline:
    """Tracking of B concurrent streams sharing one config and camera, each
    a (depths, colors) sequence of the same length, on ``device`` (the
    card unless the caller asks for the CPU).  With a ('stream', 'shard')
    ``mesh`` this process tracks its block of the streams
    (multihost.stream_block) on its mesh device, each solve split over its
    shard group, and the summary covers every stream.  ``outputs`` keeps
    each tracked frame's stacked StepOutputs (device tensors, this
    process's streams)."""

    def __init__(self, cfg: SuPerConfig, intr: Intrinsics, mesh=None,
                 device="cuda"):
        self.cfg = cfg
        self.mesh = mesh
        self.device = (multihost.mesh_device(mesh) if mesh is not None
                       else torch.device(device))
        self.intr = Intrinsics(*(x.to(self.device) for x in intr))
        self._step = (make_multichip_step(cfg, self.intr, mesh)
                      if mesh is not None
                      else make_batched_step(cfg, self.intr))
        self._preprocess = captured_preprocess(cfg, self.device)
        reason = CPU_EAGER if self.device.type != "cuda" else None
        self.loop = "eager" if reason else "graph"
        self.loop_reason = reason
        self.states = None
        self.num_streams = 0          # B, all processes' streams
        self.streams = None           # this process's streams of the batch
        self.errors: List[Dict[int, np.ndarray]] = []
        self.frame_times: List[float] = []
        self.outputs = []             # each tracked frame's StepOutputs

    def run(self, depths, colors, gt_xy=None, gt_valid=None,
            verbose: bool = False):
        """depths (B, T, H, W); colors (B, T, H, W, 3) or channel-first;
        gt_xy: optional (B, T, P, 2) GT screen coordinates, gt_valid (B, T,
        P).  Returns :meth:`summary`."""
        b, t_total = np.shape(depths)[0], np.shape(depths)[1]
        self.num_streams = b
        self.streams = (slice(0, b) if self.mesh is None
                        else multihost.stream_block(self.mesh, b))
        ids = range(b)[self.streams]
        cfg, dev = self.cfg, self.device
        self.errors = [dict() for _ in ids]
        cuda = dev.type == "cuda"
        for t in range(t_total):
            with span("pipeline.frame"):
                tic = _time.perf_counter()
                frames = []
                for s in ids:
                    with span("pipeline.fetch"):
                        depth = np.asarray(depths[s][t])
                        color = _chw(colors[s][t])
                    with span("pipeline.preprocess"):
                        frames.append(self._frame(depth, color, float(t)))
                with span("pipeline.step"):
                    if self.states is None:
                        self.states = stack([init_tracker(cfg, f)
                                             for f in frames])
                    else:
                        self.states, outs = self._step(self.states,
                                                       stack(frames))
                        self.outputs.append(outs)
                if gt_xy is not None:
                    self._eval_frame(t, ids, frames, gt_xy, gt_valid)
                with span("pipeline.sync"):
                    if cuda:
                        torch.cuda.synchronize(dev)
                self.frame_times.append(_time.perf_counter() - tic)
                if verbose:
                    print(f"t={t}: {self.frame_times[-1] * 1e3:.0f} ms "
                          f"({len(ids)} streams)")
        return self.summary()

    def _frame(self, depth, color, time):
        if self._preprocess is not None:
            return self._preprocess(self.intr, depth, color, time, None,
                                    None)
        return preprocess_frame(self.cfg, self.intr, depth, color, time,
                                device=self.device)

    def _eval_frame(self, t, ids, frames, gt_xy, gt_valid):
        """Bind each stream's tracked points (enqueued), then read them,
        one host read for the batch, and keep their errors."""
        dev = self.device
        with span("pipeline.gt_binding"):
            gt = [(np.asarray(gt_xy[s][t]), np.asarray(gt_valid[s][t]))
                  for s in ids]
            tracks = []
            for (xy, valid), frame, st in zip(gt, frames,
                                              unstack(self.states)):
                track = assign_track_points(
                    self.cfg, st.surfels, frame, st.track,
                    torch.as_tensor(xy.astype(np.int32), device=dev),
                    torch.as_tensor(valid, device=dev))
                tracks.append(record_track_coords(st.surfels, track))
            track = stack(tracks)
            self.states = self.states._replace(track=track)
        with span("pipeline.read"):
            est_xy = track.coords.cpu().numpy()
            est_v = track.coord_valid.cpu().numpy()
            for i, (xy, valid) in enumerate(gt):
                gtv = np.concatenate([xy, valid[:, None]],
                                     axis=1).astype(np.float32)
                est = np.concatenate(
                    [est_xy[i], est_v[i][:, None].astype(np.float32)],
                    axis=1)
                err = evaluation.reprojection_errors(gtv, est)
                err[~est_v[i]] = -1.0
                self.errors[i][t] = err

    def stream_means(self) -> List[float]:
        """Each stream's mean reprojection error, all B streams (gathered
        over the mesh's 'stream' groups)."""
        means = [evaluation.summarize(e).get("reproj_mean", np.nan)
                 for e in self.errors]
        if self.mesh is None or self.mesh.size(0) == 1:
            return means
        parts = [None] * self.mesh.size(0)
        dist.all_gather_object(parts, means,
                               group=self.mesh.get_group("stream"))
        return [m for part in parts for m in part]

    def summary(self) -> Dict[str, float]:
        """reproj_mean over the streams and its worst stream;
        p50_batch_ms, the median frame time after two frames, and
        aggregate_fps, all B streams' frames a second."""
        out = {}
        means = self.stream_means()
        if means and np.isfinite(means).any():
            out["reproj_mean"] = float(np.nanmean(means))
            out["reproj_mean_worst_stream"] = float(np.nanmax(means))
        if self.frame_times:
            steady = self.frame_times[2:] or self.frame_times
            ms = float(np.median(steady) * 1e3)
            out["p50_batch_ms"] = ms
            out["aggregate_fps"] = self.num_streams * 1e3 / ms
        return out
