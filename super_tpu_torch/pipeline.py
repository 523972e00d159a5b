"""Host-side frame loop around the tracking step, with tracking accuracy
against ground-truth points (counterpart of super_tpu/pipeline.py).

The sequence has a serial dependency (frame t feeds t + 1), so the loop
lives on the host: each frame is preprocessed onto the device, frame 0
initialises the tracker, every later frame runs ``track_step``, and where
ground truth is given the tracked points are bound and read
(core/track_points.py) and their reprojection errors kept
(utils/evaluation.py).  A frame with ground truth first waits for the
card where it reads the tracked points to the host (their ``.cpu()``,
behind the step and the binding); then the loop synchronises with the
device, for the frame's time, as the JAX package's ``block_until_ready``
does, and reads the step's overflow counters.

Spans (utils/profiling.py:span; no-ops unless a profiler is on) name the
parts of a frame on the profiler's clock, the same in
parallel/streams.py: ``pipeline.frame`` around each frame and under it
``pipeline.fetch`` (the frame's arrays from their sources),
``pipeline.preprocess``, ``pipeline.step`` (frame 0's init, else the
step), ``pipeline.gt_binding`` (enqueued), ``pipeline.read`` (each host
read), ``pipeline.sync`` and ``pipeline.observe``; the compiled steps'
calls add ``graph.load``, ``graph.run`` and ``graph.copy_out``
(core/compiled.py).

The loop runs what the JAX package jits as compiled steps (core/
compiled.py): ``preprocess_frame`` and ``track_step`` (make_jit_step's,
the LM solve or the autograd fit, with the sf_corr flow net's inference
where the config has it) each captured once as a CUDA graph on the card
(at their first call, after an eager warm-up) and replayed every later
frame, each returning tensors that no later replay overwrites.  With
``compiled=False`` each frame runs them eagerly.  ``loop`` says which:
``"graph"``, or ``"eager"`` with ``loop_reason``; on CPU tensors the
compiled steps run eagerly on their buffers, and ``loop`` is
``"eager"`` too.

Given segmentations (``segs``, ``seg_confs``) go into each frame's
preprocessing, as the semantic configurations need.  Without given depths
the perception nets of ``models`` (factory.py) infer each frame's depth,
and its segmentation where the config has a segmentation net; with
``sf_corr`` and a flow net, each step's fit takes the flow from the
previous frame's colour.

Every ``cfg.save_sample_freq`` frames the loop observes the run: with a
``logdir`` it logs the step's scalars and the reprojection errors, and
images (the raw frame, its disparity, the z-buffer render of the map
with the tracked points and the ED mesh drawn in, and the surfels'
confidences through magma, rendered) through utils/viz.py's
``TrackingLogger``; with a ``checkpoint_dir`` it saves the state
(utils/checkpoint.py).  Observation runs after the frame's time is taken,
so it is not in ``frame_times``; its own host time is kept in
``observe_times``.  The plots' data is logged once, at the end of a run.
"""

from __future__ import annotations

import time as _time
from typing import Dict, Optional

import numpy as np
import torch

from super_tpu_torch.config import SuPerConfig
from super_tpu_torch.core.compiled import CapturedStep
from super_tpu_torch.core.preprocess import preprocess_frame
from super_tpu_torch.core.state import TrackerState
from super_tpu_torch.core.track_points import (
    assign_track_points,
    record_track_coords,
)
from super_tpu_torch.core.tracker import (
    init_tracker,
    jit_step_takes_prev,
    make_jit_step,
    track_step,
)
from super_tpu_torch.geometry.camera import Intrinsics, project_points
from super_tpu_torch.render.splat import render_zbuffer
from super_tpu_torch.utils import evaluation
from super_tpu_torch.utils.checkpoint import save_state
from super_tpu_torch.utils.colormap import magma
from super_tpu_torch.utils.profiling import span
from super_tpu_torch.utils.viz import TrackingLogger

OVERFLOW_COUNTERS = ("tuple_overflow", "pair_overflow", "proj_overflow",
                     "add_overflow", "free_exhausted", "dup_skipped")


CPU_EAGER = "CPU tensors: the compiled steps run eagerly"


def captured_preprocess(cfg: SuPerConfig, device):
    """``preprocess_frame`` captured once and replayed (core/compiled.py),
    the JAX package's jitted preprocess: called as ``(intr, depth, color,
    time, seg, seg_conf)``, each frame with the first one's structure."""
    return CapturedStep(
        lambda intr, depth, color, time, seg, seg_conf: preprocess_frame(
            cfg, intr, depth, color, time, seg=seg, seg_conf=seg_conf,
            device=device), device=device)


def _chw(image) -> np.ndarray:
    """One (H, W, 3) or (3, H, W) image as contiguous (3, H, W) numpy."""
    image = np.asarray(image)
    if image.shape[-1] == 3:
        image = image.transpose(2, 0, 1)
    return np.ascontiguousarray(image)


class SuPerPipeline:
    """Single-stream tracking pipeline on ``device`` (the card unless the
    caller asks for the CPU)."""

    def __init__(self, cfg: SuPerConfig, intr: Intrinsics,
                 logdir: Optional[str] = None,
                 checkpoint_dir: Optional[str] = None, device="cuda",
                 compiled: bool = True):
        self.cfg = cfg
        self.device = torch.device(device)
        self.compiled = compiled
        self._step = None         # make_jit_step's, where it captures cfg
        self._preprocess = None   # preprocess_frame captured alike
        self.loop = None          # "graph" or "eager", set by run
        self.loop_reason = None
        self.intr = Intrinsics(*(x.to(self.device) for x in intr))
        self.state: Optional[TrackerState] = None
        self.track_results: Dict[int, np.ndarray] = {}
        self.errors: Dict[int, np.ndarray] = {}
        self.frame_times = []
        self.overflow_totals: Dict[str, int] = {}
        self._prev_color = None   # (3, H, W): the source of the sf_corr flow
        self.logger = None if logdir is None else TrackingLogger(logdir)
        self.checkpoint_dir = checkpoint_dir
        self.observe_times = []   # host seconds of each observation

    def run(self, depths, colors, gt_xy=None, gt_valid=None, segs=None,
            seg_confs=None, right_colors=None, models=None,
            verbose: bool = False):
        """Track a whole sequence.

        depths: (T, H, W) numpy, or None to infer depth with ``models``
        (factory.Models); colors: (T, H, W, 3) or (T, 3, H, W) numpy, and
        right_colors the right images for RAFT-Stereo depth; gt_xy:
        optional (T, P, 2) GT screen coordinates, gt_valid (T, P) bool;
        segs: optional (T, H, W) class labels, seg_confs (T, C, H, W)
        class scores (else a segmentation net's, where ``models`` has
        one).  Returns the summary metrics.
        """
        if depths is None and models is None:
            raise ValueError("run needs depths, or models to infer them "
                             "(factory.build_models)")
        cfg, dev = self.cfg, self.device
        self._choose_loop(models)
        if verbose:
            print(f"step loop: {self.loop}"
                  + (f" ({self.loop_reason})" if self.loop_reason else ""))
        cuda = dev.type == "cuda"
        for t in range(len(colors)):
            with span("pipeline.frame"):
                tic = _time.perf_counter()
                with span("pipeline.fetch"):
                    # Colour first: a frame source may start the frame's
                    # clock at it.
                    color = _chw(colors[t])
                    seg = None if segs is None else np.asarray(segs[t])
                    seg_conf = None if seg_confs is None \
                        else np.asarray(seg_confs[t])
                    depth = None if depths is None \
                        else np.asarray(depths[t])
                    gt = None if gt_xy is None else (gt_xy[t], gt_valid[t])
                if depth is None:
                    from super_tpu_torch.factory import predict_frame_inputs

                    with span("pipeline.perception"):
                        pred = predict_frame_inputs(
                            cfg, models, color, right_color_chw=None
                            if right_colors is None
                            else _chw(right_colors[t]))
                    depth = pred["depth"]
                    if "seg" in pred and seg is None:
                        seg, seg_conf = pred["seg"], pred["seg_conf"]
                with span("pipeline.preprocess"):
                    if self._preprocess is not None:
                        frame = self._preprocess(self.intr, depth, color,
                                                 float(t), seg, seg_conf)
                    else:
                        frame = preprocess_frame(
                            cfg, self.intr, depth, color, float(t), seg=seg,
                            seg_conf=seg_conf, device=dev)
                with span("pipeline.step"):
                    outs = self._track(frame, models)
                self._prev_color = frame.color_image
                if gt is not None:
                    self._eval_frame(t, frame, *gt)
                with span("pipeline.sync"):
                    if cuda:
                        torch.cuda.synchronize(dev)
                self.frame_times.append(_time.perf_counter() - tic)
                if outs is not None:
                    self._count_overflow(t, outs, verbose)
                if verbose and t % 10 == 0:
                    n = int(self.state.surfels.num_active)
                    print(f"frame {t}: {n} surfels, "
                          f"{self.frame_times[-1] * 1e3:.1f} ms")
                observed = (self.logger is not None
                            or self.checkpoint_dir is not None)
                if observed and t % cfg.save_sample_freq == 0:
                    with span("pipeline.observe"):
                        tic = _time.perf_counter()
                        self._observe(t, frame, depth, outs)
                        self.observe_times.append(
                            _time.perf_counter() - tic)
        if self.logger is not None and self.errors:
            self.logger.log_trackpts_plots(max(self.errors), self.errors,
                                           self.track_results,
                                           np.asarray(gt_xy))
        return self.summary()

    def _track(self, frame, models):
        """Frame 0 initialises the tracker; a later frame runs the step.
        Returns the step's outputs (None at frame 0)."""
        if self.state is None:
            self.state = init_tracker(self.cfg, frame)
            return None
        # The flow's source is the previous frame (the frame's own colour,
        # zero flow, when the state came from elsewhere).
        prev = (frame.color_image if self._prev_color is None
                else self._prev_color)
        if self._step is None:
            self.state, outs = track_step(self.cfg, self.intr, self.state,
                                          frame, models=models,
                                          prev_color=prev)
        elif jit_step_takes_prev(self.cfg, models):
            self.state, outs = self._step(self.intr, self.state, frame,
                                          prev)
        else:
            self.state, outs = self._step(self.intr, self.state, frame)
        return outs

    def _count_overflow(self, t, outs, verbose):
        """The step's overflow counters, one host read for all."""
        with span("pipeline.read"):
            vals = torch.stack([getattr(outs, n).to(torch.int64)
                                for n in OVERFLOW_COUNTERS]).tolist()
        for name, c in zip(OVERFLOW_COUNTERS, vals):
            if c > 0:
                self.overflow_totals[name] = \
                    self.overflow_totals.get(name, 0) + c
                if verbose:
                    print(f"frame {t}: capacity overflow {name}={c} "
                          f"(accuracy degraded; see StepOutputs)")

    def _choose_loop(self, models):
        """The compiled steps (make_jit_step with ``models``) unless
        ``compiled=False``; ``loop`` says whether they replay graphs."""
        if self.loop is not None:
            return
        reason = "compiled=False"
        if self.compiled:
            self._step = make_jit_step(self.cfg, models)
            self._preprocess = captured_preprocess(self.cfg, self.device)
            reason = CPU_EAGER if self.device.type != "cuda" else None
        self.loop = "eager" if reason else "graph"
        self.loop_reason = reason

    def _render(self, colors):
        sf = self.state.surfels
        return render_zbuffer(sf.points, colors, sf.active, self.intr,
                              self.cfg.height, self.cfg.width).cpu().numpy()

    def _observe(self, t, frame, depth, outs):
        """Periodic logging and checkpointing (the reference's
        save_sample_freq behaviour)."""
        cfg = self.cfg
        if self.logger is not None:
            log = self.logger
            if outs is not None:
                log.log_step(t, outs, self.frame_times[-1] * 1e3)
            log.log_reproj(t, self.errors, cfg.edge_ids)
            sf, g = self.state.surfels, self.state.graph
            kp = None
            if self.track_results.get(t) is not None:
                est = self.track_results[t]
                kp = est[est[:, 2] > 0][:, :2]
            gv, gu, _, _ = project_points(g.points.T, self.intr, cfg.height,
                                          cfg.width)
            mesh_xy = torch.stack([gu, gv], dim=1).cpu().numpy()
            edges = g.edges[g.edge_active].cpu().numpy()
            log.log_images(
                t, frame.color_image.cpu().numpy(),
                depth=(depth.cpu().numpy() if isinstance(depth, torch.Tensor)
                       else np.asarray(depth)),
                render_chw=self._render(sf.colors), keypoints_xy=kp,
                mesh_points_xy=mesh_xy, mesh_edges=edges)
            # The confidence heat map (the reference's renderImg_conf_heat):
            # the surfels' confidences through magma, rendered.
            confs = np.clip(sf.confs.cpu().numpy(), 0, 1)
            heat = np.ascontiguousarray(magma(confs).T.astype(np.float32))
            log.add_image("visualization/uncertainty", np.clip(
                self._render(torch.as_tensor(heat, device=self.device)), 0, 1),
                t)
        if self.checkpoint_dir is not None:
            save_state(self.checkpoint_dir, self.state, step=t)

    def _eval_frame(self, t, frame, gt_xy_t, gt_valid_t):
        """Bind the GT points to surfels (enqueued on the device), then read
        the tracked points to the host, where the frame waits for the
        card, and keep their errors."""
        dev = self.device
        with span("pipeline.gt_binding"):
            gt_xy_t = np.asarray(gt_xy_t)
            gt_valid_t = np.asarray(gt_valid_t)
            track = assign_track_points(
                self.cfg, self.state.surfels, frame, self.state.track,
                torch.as_tensor(gt_xy_t.astype(np.int32), device=dev),
                torch.as_tensor(gt_valid_t, device=dev))
            track = record_track_coords(self.state.surfels, track)
            self.state = self.state._replace(track=track)
        with span("pipeline.read"):
            coord_valid = track.coord_valid.cpu().numpy()
            est = np.concatenate(
                [track.coords.cpu().numpy(),
                 coord_valid.astype(np.float32)[:, None]], axis=1)
            gt = np.concatenate(
                [gt_xy_t, gt_valid_t.astype(np.float32)[:, None]], axis=1)
            self.track_results[t] = est
            # Errors only count points that are both GT-visible and
            # tracked.
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
