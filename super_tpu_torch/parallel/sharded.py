"""Streams and shards of the tracking step (counterpart of
super_tpu/parallel/sharded.py).

- :func:`make_batched_step`: B concurrent streams in one process, the JAX
  package's ``jit(vmap(step))`` interface: stacked (B, ...) states and
  frames in, stacked states and outputs out.  Inside, a loop runs
  ``track_step`` on each stream's views ``x[b]``: the step writes in
  place at many sites and its kernels take no batch axis, so it does not
  vmap (ROADMAP queue 2 K).  On the card the loop is captured as one
  CUDA graph and a batch is one replay.  Each stream's result is the
  single-stream step's, bit for bit on one device.
- :func:`track_step_sharded`: one stream's LM solve split over the surfel
  slots of a process group (:func:`shard_ctx`): each process sums the data
  term over its slots, the sums of every assembly and cost pass are
  all-reduced (core/losses.py:all_reduce_sum), and each process solves the
  same reduced system; warp, fusion, prune and reprojection then run whole
  on every process of the group.
- :func:`make_multichip_step`: both over a ('stream', 'shard') mesh
  (parallel/mesh.py): this process's streams, each solved over its shard
  group, captured on the card as the stream batch is (with two or more
  shards as graphs cut at the all-reduces).
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch
import torch.distributed as dist

from super_tpu_torch.config import SuPerConfig
from super_tpu_torch.core.compiled import CapturedStep, CutGraph
from super_tpu_torch.core.lm import lm_solve
from super_tpu_torch.core.losses import (
    LMContext,
    assembly_chunk_size,
    prepare_lm,
    scatter_plans,
)
from super_tpu_torch.core.state import FrameData, TrackerState
from super_tpu_torch.core.tracker import (
    StepOutputs,
    finish_step,
    layout_overflow,
    track_step,
)
from super_tpu_torch.core.warp import apply_deformation
from super_tpu_torch.geometry.camera import Intrinsics
from super_tpu_torch.utils.profiling import span
from super_tpu_torch.utils.tree import batch_size, stack, unstack

# The context's fields with one entry per surfel slot on their last axis.
_SLOT_FIELDS = ("sf_mask", "sf_knn_w", "sf_points", "slot_tuple",
                "sf_knn_idx", "sf_knn", "sf_diff")


def shard_ctx(ctx: LMContext, index: int, count: int) -> LMContext:
    """Shard ``index`` of ``count``: the LM context with its surfel-slot
    fields cut to the shard's contiguous slice.

    The tuple assembly keeps the surfel fields in the layout's padded slot
    order, so the slice takes ``layout.block_tuple`` (one tuple id a
    G-block), ``src_pos`` and ``slot_valid`` with them, and ``live_end``
    relative to the slice; kernel K2 (kernels/gram.py:data_gram) then sums
    the shard's blocks into whole-size tuple Grams (a tuple cut by the
    slice's edge gets a part on each side), and the per-tuple and
    per-pair tables stay whole.  Slices fall on G-block edges: a slot
    count that ``G * count`` does not divide is refused.  The scatter
    assembly (no layout) slices the slots' anchors and rebuilds its chunk
    plans and J^T r plan over the slice (core/losses.py:scatter_plans),
    in chunks of the whole context's size halved until they divide it.
    The slices are copies, made once a frame."""
    np_cap = ctx.sf_mask.shape[0]
    lay = ctx.layout
    block = 1 if lay is None else np_cap // lay.block_tuple.shape[0]
    if not 0 <= index < count or np_cap % (block * count):
        raise ValueError(
            f"shard_ctx: {np_cap} slots do not split into {count} shards "
            f"of whole {block}-slot blocks (shard {index})")
    local = np_cap // count
    lo, hi = index * local, (index + 1) * local
    repl = {name: getattr(ctx, name)[..., lo:hi].clone()
            for name in _SLOT_FIELDS if getattr(ctx, name) is not None}
    if lay is not None:
        lb = local // block
        repl["layout"] = lay._replace(
            block_tuple=lay.block_tuple[index * lb:(index + 1) * lb].clone(),
            src_pos=lay.src_pos[lo:hi].clone(),
            slot_valid=lay.slot_valid[lo:hi].clone(),
            live_end=None if lay.live_end is None else torch.clamp(
                lay.live_end - lo, 0, local).to(lay.live_end.dtype))
    else:
        k = ctx.sf_knn_w.shape[0]
        chunk = ctx.chunk_plans[0].ids.shape[0] // (k * k)
        repl.update(scatter_plans(repl["sf_knn_idx"], repl["sf_mask"],
                                  ctx.ed_mask.shape[0],
                                  assembly_chunk_size(local, chunk)))
    return ctx._replace(**repl)


def track_step_sharded(cfg: SuPerConfig, intr: Intrinsics, num_shards: int,
                       state: TrackerState, frame: FrameData, group=None
                       ) -> Tuple[TrackerState, StepOutputs]:
    """``track_step`` with the LM solve split over the ``num_shards``
    processes of ``group`` (this process's share by its rank there); one
    shard is ``track_step`` itself.  Returns the same state and outputs on
    every process of the group: the overflow counters are the whole
    layout's."""
    if num_shards == 1:
        return track_step(cfg, intr, state, frame)
    if group is None or dist.get_world_size(group) != num_shards:
        raise ValueError(f"track_step_sharded: {num_shards} shards need a "
                         f"process group of that size")
    if not cfg.solver.use_derived_gradient:
        raise ValueError("track_step_sharded shards the LM solve "
                         "(use_derived_gradient)")
    with span("step.prepare_lm"):
        ctx = prepare_lm(cfg, state.surfels, state.graph, frame)
        overflow = layout_overflow(ctx, frame.points.device)
        ctx = shard_ctx(ctx, dist.get_rank(group), num_shards)
    with span("step.lm_solve"):
        result = lm_solve(cfg, ctx, intr, group=group)
    with span("step.apply_deformation"):
        surfels, graph = apply_deformation(cfg, state.surfels, state.graph,
                                           result.beta)
    return finish_step(cfg, intr, state, frame, surfels, graph, result.cost,
                       result.final_damping, overflow)


def _batched(step):
    """``step`` on each stream of stacked (B, ...) states and frames, the
    results stacked."""

    def run(states, frames):
        b, nf = batch_size(states), batch_size(frames)
        if nf != b:
            raise ValueError(f"{b} states but {nf} frames")
        outs = [step(s, f) for s, f in zip(unstack(states), unstack(frames))]
        return stack([o[0] for o in outs]), stack([o[1] for o in outs])

    return run


def make_batched_step(cfg: SuPerConfig, intr: Intrinsics, *,
                      compiled: bool = True, stage_times: bool = False):
    """The single-process multi-stream step: stacked (B, ...)
    ``TrackerState`` and ``FrameData`` to stacked states and
    ``StepOutputs``.

    ``compiled`` (the default): the B streams' steps captured as one CUDA
    graph at the first call on the card and replayed by every later call,
    so that a batch is one launch from the host, the dispatch counterpart
    of the JAX package's ``jit(vmap)`` (core/compiled.py:CapturedStep; on
    CPU tensors the loop runs eagerly on its buffers), for the LM solve
    and the autograd fit alike.  The graph holds the loop's order, so
    each stream stays bitwise its single track; each call returns results
    that no later call overwrites.  Without ``compiled``, the eager
    loop.  ``stage_times``: each stage's time summed over the streams
    (CapturedStep.stage_ms)."""
    run = _batched(functools.partial(track_step, cfg, intr))
    return CapturedStep(run, carry=(0, 0), stage_times=stage_times) \
        if compiled else run


def make_multichip_step(cfg: SuPerConfig, intr: Intrinsics, mesh):
    """The multi-stream step over a ('stream', 'shard') mesh: takes this
    process's streams, stacked (B_local, ...) as
    multihost.shard_stream_batch placed them (multihost.stream_block says
    which streams of the whole batch they are, by this process's
    coordinate on 'stream'), and tracks each with its LM solve split over
    the process's 'shard' group.  Every process of a shard group gets the
    same results.

    Captured at its first call on the card and replayed by every later
    one, the counterpart of the JAX package's ``jax.jit`` of its mapped
    step: with one shard the step has no collective and is
    :func:`make_batched_step`'s, one CUDA graph; with two or more, one
    graph for each stretch between two all-reduces, the all-reduces run on
    the host between replays (core/compiled.py:CutGraph).  On CPU tensors
    it runs eagerly on its buffers."""
    num_shards = mesh.size(mesh.mesh_dim_names.index("shard"))
    if num_shards == 1:
        return make_batched_step(cfg, intr)
    run = _batched(functools.partial(track_step_sharded, cfg, intr,
                                     num_shards, group=mesh.get_group(
                                         "shard")))
    return CapturedStep(run, carry=(0, 0), graph=(
        CutGraph if mesh.device_type == "cuda" else None))
