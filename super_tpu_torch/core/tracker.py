"""SuPer tracking: frame-0 init and the per-frame step (counterpart of
super_tpu/core/tracker.py).

Frame 0 builds the ED graph and the surfel map; each later frame solves the
warp field, applies it, fuses the frame, prunes and refreshes the
projections.  The warp field comes from the LM solve (prepare_lm, lm_solve)
with ``use_derived_gradient``, else from the autograd fit
(core/optimizer.py:graph_fit).  The step issues no host sync: every counter
of :class:`StepOutputs` stays a device tensor until the caller reads it.
Profiler ranges (``step.*``) mark the stages for a traced run.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
from torch.profiler import record_function

from super_tpu_torch.config import SuPerConfig
from super_tpu_torch.core import fusion as fusion_mod
from super_tpu_torch.core.anchoring import anchor_points, update_graph_knn
from super_tpu_torch.core.graph import build_graph
from super_tpu_torch.core.lm import lm_solve
from super_tpu_torch.core.losses import prepare_lm
from super_tpu_torch.core.optimizer import graph_fit
from super_tpu_torch.core.state import (
    FrameData,
    GraphState,
    SurfelState,
    TrackerState,
    empty_track,
)
from super_tpu_torch.core.warp import apply_deformation
from super_tpu_torch.geometry.camera import (
    Intrinsics,
    pixel_grid,
    project_points,
)


def init_surfels_from_frame(cfg: SuPerConfig, graph: GraphState,
                            frame: FrameData) -> SurfelState:
    """Frame-0 surfel map: every valid candidate becomes the surfel in its
    pixel-indexed slot (surfel_capacity >= H*W)."""
    n = cfg.capacity.surfel_capacity
    p = frame.points.shape[-1]
    if n < p:
        raise ValueError(f"surfel_capacity {n} < pixel count {p}")

    def pad(x):
        return torch.nn.functional.pad(x, (0, n - p))

    knn_idx, knn_w, stable = anchor_points(cfg, graph, frame.points,
                                           frame.valid, seg=frame.seg,
                                           seg_conf=frame.seg_conf)
    uu, vv = pixel_grid(cfg.height, cfg.width, frame.points.device)
    proj_uv = torch.stack([uu.reshape(-1), vv.reshape(-1)], dim=0)
    return SurfelState(
        points=pad(frame.points), norms=pad(frame.norms),
        colors=pad(frame.colors), radii=pad(frame.radii),
        confs=pad(torch.where(frame.valid, frame.confs, 0.0)),
        time_stamp=pad(torch.zeros_like(frame.confs) + frame.time),
        active=pad(stable), knn_idx=pad(knn_idx), knn_w=pad(knn_w),
        proj_uv=pad(proj_uv), seg=pad(frame.seg),
        seg_conf=pad(frame.seg_conf), dist2edge=pad(frame.dist2edge))


def init_tracker(cfg: SuPerConfig, frame: FrameData) -> TrackerState:
    """Frame-0 initialisation: ED graph, node KNN weights, surfels."""
    graph = update_graph_knn(cfg, build_graph(cfg, frame))
    return TrackerState(surfels=init_surfels_from_frame(cfg, graph, frame),
                        graph=graph,
                        track=empty_track(cfg, frame.points.device),
                        time=frame.time)


class StepOutputs(NamedTuple):
    """Per-frame diagnostics; the overflow counters make silent capacity
    degradation visible."""

    lm_cost: torch.Tensor
    lm_damping: torch.Tensor
    num_surfels: torch.Tensor
    num_nodes: torch.Tensor
    tuple_overflow: torch.Tensor   # surfels dropped from the JTJ assembly
    pair_overflow: torch.Tensor    # distinct node pairs beyond pair_cap
    proj_overflow: torch.Tensor    # surfels deleted beyond proj_map_depth
    add_overflow: torch.Tensor     # add candidates deferred (capacity)
    free_exhausted: torch.Tensor   # adds dropped: no free surfel slot
    dup_skipped: torch.Tensor      # duplicate merges deferred


def track_step(cfg: SuPerConfig, intr: Intrinsics, state: TrackerState,
               frame: FrameData, models=None,
               prev_color=None) -> Tuple[TrackerState, StepOutputs]:
    """One frame: solve the warp, apply it, fuse, prune, reproject.
    ``models`` (factory.Models) and ``prev_color`` (3, H, W) feed the flow
    of the autograd fit's ``sf_corr`` term (core/optimizer.py:graph_fit)."""
    if cfg.solver.use_derived_gradient:
        with record_function("step.prepare_lm"):
            ctx = prepare_lm(cfg, state.surfels, state.graph, frame)
        with record_function("step.lm_solve"):
            result = lm_solve(cfg, ctx, intr)
        with record_function("step.apply_deformation"):
            surfels, graph = apply_deformation(cfg, state.surfels,
                                               state.graph, result.beta)
        cost, damping = result.cost, result.final_damping
        tuple_overflow = ctx.layout.overflow_count
        pair_overflow = ctx.layout.pair_overflow
    else:
        with record_function("step.graph_fit"):
            deform, cost = graph_fit(cfg, state.surfels, state.graph, frame,
                                     intr, models=models,
                                     prev_color=prev_color)
        with record_function("step.apply_deformation"):
            surfels, graph = apply_deformation(cfg, state.surfels,
                                               state.graph, deform[:-1],
                                               global_dq=deform[-1])
        damping = torch.zeros((), dtype=torch.float32,
                              device=frame.points.device)
        tuple_overflow = pair_overflow = torch.zeros(
            (), dtype=torch.int32, device=frame.points.device)
    with record_function("step.fuse_frame"):
        surfels, remap, fdiag = fusion_mod.fuse_frame(cfg, intr, surfels,
                                                      graph, frame)
    with record_function("step.prune"):
        # Tracked surfels merged into another slot follow the merge.
        track = state.track
        tid = torch.clamp(track.track_id, 0, surfels.capacity - 1).long()
        track = track._replace(track_id=torch.where(
            track.track_id >= 0, remap[tid], track.track_id))
        surfels, track = fusion_mod.prune_surfels(cfg, surfels, track,
                                                  frame.time)
        v, u, _, _ = project_points(surfels.points, intr, cfg.height,
                                    cfg.width)
        surfels = surfels._replace(proj_uv=torch.stack([u, v], dim=0))
    outs = StepOutputs(
        lm_cost=cost, lm_damping=damping,
        num_surfels=surfels.num_active, num_nodes=graph.num_active,
        tuple_overflow=tuple_overflow, pair_overflow=pair_overflow,
        proj_overflow=fdiag.proj_overflow, add_overflow=fdiag.add_overflow,
        free_exhausted=fdiag.free_exhausted, dup_skipped=fdiag.dup_skipped)
    return TrackerState(surfels=surfels, graph=graph, track=track,
                        time=frame.time), outs
