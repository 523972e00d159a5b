"""SuPer tracking: frame-0 init and the per-frame step (counterpart of
super_tpu/core/tracker.py).

Frame 0 builds the ED graph and the surfel map; each later frame solves the
warp field, applies it, fuses the frame, prunes and refreshes the
projections.  The warp field comes from the LM solve (prepare_lm, lm_solve)
with ``use_derived_gradient``, else from the autograd fit
(core/optimizer.py:graph_fit).  The step issues no host sync: every counter
of :class:`StepOutputs` stays a device tensor until the caller reads it.
Spans (``step.*``, utils/profiling.py:span) mark the stages for a traced
run, and time them in a step built with ``stage_times``.

:func:`make_jit_step` is the JAX package's compiled step: on the card,
``track_step`` captured once as a CUDA graph and replayed every frame
(core/compiled.py), for every configuration; the step sharded over a
process group is captured by parallel/sharded.py:make_multichip_step.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch

from super_tpu_torch.config import SuPerConfig
from super_tpu_torch.core import fusion as fusion_mod
from super_tpu_torch.core.anchoring import anchor_points, update_graph_knn
from super_tpu_torch.core.compiled import CapturedStep
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
from super_tpu_torch.utils.profiling import span


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


def layout_overflow(ctx, device):
    """(tuple_overflow, pair_overflow) of an LM context's layout; with no
    layout (scatter assembly) or no pair table nothing overflows."""
    zero = torch.zeros((), dtype=torch.int32, device=device)
    lay = ctx.layout
    tuple_overflow = zero if lay is None else lay.overflow_count
    pair_overflow = zero if lay is None or lay.pair_overflow is None \
        else lay.pair_overflow
    return tuple_overflow, pair_overflow


def track_step(cfg: SuPerConfig, intr: Intrinsics, state: TrackerState,
               frame: FrameData, models=None,
               prev_color=None) -> Tuple[TrackerState, StepOutputs]:
    """One frame: solve the warp, apply it, fuse, prune, reproject.
    ``models`` (factory.Models) and ``prev_color`` (3, H, W) feed the flow
    of the autograd fit's ``sf_corr`` term (core/optimizer.py:graph_fit)."""
    if cfg.solver.use_derived_gradient:
        with span("step.prepare_lm"):
            ctx = prepare_lm(cfg, state.surfels, state.graph, frame)
        with span("step.lm_solve"):
            result = lm_solve(cfg, ctx, intr)
        with span("step.apply_deformation"):
            surfels, graph = apply_deformation(cfg, state.surfels,
                                               state.graph, result.beta)
        cost, damping = result.cost, result.final_damping
        overflow = layout_overflow(ctx, frame.points.device)
    else:
        with span("step.graph_fit"):
            deform, cost = graph_fit(cfg, state.surfels, state.graph, frame,
                                     intr, models=models,
                                     prev_color=prev_color)
        with span("step.apply_deformation"):
            surfels, graph = apply_deformation(cfg, state.surfels,
                                               state.graph, deform[:-1],
                                               global_dq=deform[-1])
        damping = torch.zeros((), dtype=torch.float32,
                              device=frame.points.device)
        overflow = (torch.zeros((), dtype=torch.int32,
                                device=frame.points.device),) * 2
    return finish_step(cfg, intr, state, frame, surfels, graph, cost,
                       damping, overflow)


def finish_step(cfg: SuPerConfig, intr: Intrinsics, state: TrackerState,
                frame: FrameData, surfels: SurfelState, graph: GraphState,
                cost, damping, overflow) -> Tuple[TrackerState, StepOutputs]:
    """The step after the warp is applied: fuse the frame, prune, refresh
    the projections, and the frame's outputs; ``overflow`` is the solve's
    (tuple_overflow, pair_overflow)."""
    with span("step.fuse_frame"):
        surfels, remap, fdiag = fusion_mod.fuse_frame(cfg, intr, surfels,
                                                      graph, frame)
    with span("step.prune"):
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
        tuple_overflow=overflow[0], pair_overflow=overflow[1],
        proj_overflow=fdiag.proj_overflow, add_overflow=fdiag.add_overflow,
        free_exhausted=fdiag.free_exhausted, dup_skipped=fdiag.dup_skipped)
    return TrackerState(surfels=surfels, graph=graph, track=track,
                        time=frame.time), outs


def jit_step_takes_prev(cfg: SuPerConfig, models=None) -> bool:
    """Whether :func:`make_jit_step`'s step is called as ``(intr, state,
    frame, prev_color)``: the sf_corr step with ``models``."""
    return models is not None and cfg.losses.sf_corr


def make_jit_step(cfg: SuPerConfig, models=None, stage_times: bool = False):
    """The compiled step (the JAX package's ``make_jit_step``): a callable
    ``(intr, state, frame) -> (state, outs)`` that runs ``track_step``
    with ``cfg``, captured as a CUDA graph at its first call on the card
    and replayed at every later one (core/compiled.py:CapturedStep; on
    CPU tensors it runs the step eagerly on its buffers).  Each call
    returns a state and outputs that no later call overwrites.  The graph
    holds the whole step, the autograd fit's forward and backward passes
    and its optimizer updates too.

    With ``sf_corr`` and ``models`` the callable is ``(intr, state, frame,
    prev_color)``, the flow net's inference inside the graph (its weights
    stay where they are): at the first frame, pass the frame's own colour
    (zero flow, one capture).  The step sharded over a process group is
    captured where the JAX package jits it, in
    parallel/sharded.py:make_multichip_step.

    ``stage_times``: the step times its stages in every run, with timing
    events in the graph (CapturedStep.stage_ms; profile_step.py
    --captured); the pipelines build it without."""
    if not jit_step_takes_prev(cfg, models):
        return CapturedStep(functools.partial(track_step, cfg), carry=(1, 0),
                            stage_times=stage_times)
    return CapturedStep(
        lambda intr, state, frame, prev: track_step(
            cfg, intr, state, frame, models=models, prev_color=prev),
        carry=(1, 0), stage_times=stage_times)
