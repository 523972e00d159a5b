"""One process of the port's multi-process tests (tests/test_torch_sharded.py).

Imports neither JAX nor a test module that does: the test writes the
inputs (configs as ``dataclasses.asdict`` dicts, the JAX package's frames
and frame-0 state as plain dicts of numpy arrays) to ``<dir>/inputs.pkl``,
starts one worker per rank, and compares what they write.  The workers
start their ``torch.distributed`` world with gloo through a file under
``<dir>``, each on one CPU thread.

Usage: python torch_parallel_worker.py <scenario> <rank> <world> <dir>

- ``shard`` (2 ranks, mesh ('stream' 1, 'shard' 2)): the surfel-sharded
  assembly of each mode at two betas, the LM solve of frame 2, the bf16
  dense-memory solve, the pair solve through K1b, and 2 tracked frames
  of ``track_step_sharded``, each beside the single process's; then the
  same frames through ``make_multichip_step`` captured (deferred and
  classic schedules), beside the eager frames;
- ``streams`` (2 ranks, mesh ('stream' 2, 'shard' 1)): each rank's
  stream through ``multihost.shard_stream_batch`` and
  ``make_multichip_step``, then ``MultiStreamPipeline(mesh=...)``, each
  beside the single-stream track of the same stream;
- ``mesh4`` (4 ranks, mesh ('stream' 2, 'shard' 2)): each stream tracked
  by its shard pair, beside the single-stream track (run by the pair's
  first rank).

Every ``make_multichip_step`` runs captured under :class:`CutStandIn`, the
cut graph's behaviour without a card.

Writes ``<dir>/<scenario>_<rank>.pkl``: a dict of numpy arrays and numbers.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import sys

import numpy as np
import torch
from torch.utils import _pytree as pytree

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import torch.distributed as dist  # noqa: E402

from super_tpu_torch import convert  # noqa: E402
from super_tpu_torch.core import compiled, losses  # noqa: E402
from super_tpu_torch.core.losses import (  # noqa: E402
    assemble_normal_equations,
    associate,
    prepare_lm,
    total_cost,
)
from super_tpu_torch.core.lm import lm_solve  # noqa: E402
from super_tpu_torch.core.tracker import init_tracker, track_step  # noqa
from super_tpu_torch.kernels import pcg as kpcg  # noqa: E402
from super_tpu_torch.parallel import multihost  # noqa: E402
from super_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from super_tpu_torch.parallel.sharded import (  # noqa: E402
    make_multichip_step,
    shard_ctx,
    track_step_sharded,
)
from super_tpu_torch.utils.tree import leaves, stack, tree_map, \
    unstack  # noqa: E402

CPU = torch.device("cpu")
STREAM_FRAMES = 4        # frames of each stream (frame 0 initialises)


def _np(x):
    return convert.to_numpy(x)


def _identity(j):
    beta = torch.zeros((j, 7))
    beta[:, 0] = 1.0
    return beta


class CutStandIn:
    """core/compiled.py:CutGraph's behaviour without a card (as
    tests/torch_helpers.py:StandInGraph's for a CUDA graph): the capture
    runs ``body`` once, each all-reduce performed at its cut; a replay
    runs it again with every launch counter left as it was and writes its
    results into the captured outputs in place.  ``cuts`` holds each
    run's count of cuts, the capture's first."""

    def __init__(self, body, stream):
        self.body = body
        self.cuts = []
        self.outputs = self._run()

    def _cut(self, host, group):
        self.cuts[-1] += 1
        losses.reduce_host(host, group)

    def _run(self):
        self.cuts.append(0)
        with losses.cut_at_reduces(self._cut):
            return self.body()

    def replay(self):
        counts = compiled.launch_counts()
        new = self._run()
        for k, c in zip(compiled.counted_kernels(), counts):
            k.launches = c
        for old, fresh in zip(pytree.tree_leaves(self.outputs),
                              pytree.tree_leaves(new)):
            if old.data_ptr() != fresh.data_ptr():
                old.copy_(fresh)


def _multichip_step(cfg, intr, mesh):
    step = make_multichip_step(cfg, intr, mesh)
    step._graph_type = CutStandIn
    return step


def _mesh_info(mesh):
    return dict(mesh=mesh.mesh.tolist(),
                coordinate=list(mesh.get_coordinate()),
                names=mesh.mesh_dim_names)


def scenario_shard(inp, rank):
    mesh = make_mesh(num_streams=1, num_shards=2, device_type="cpu")
    group = mesh.get_group("shard")
    out = _mesh_info(mesh)
    intr = convert.intrinsics_from_numpy(inp["intr"], CPU)
    frames = [convert.frame_from_numpy(f, CPU) for f in inp["frames"]]
    state = convert.tracker_state_from_numpy(inp["state0"], CPU)
    betas = {"identity": None,
             "perturbed": torch.as_tensor(inp["beta_perturbed"])}
    for mode, cfg_d in inp["assembly_cfgs"].items():
        cfg = convert.config_from_dict(cfg_d)
        ctx = prepare_lm(cfg, state.surfels, state.graph, frames[1])
        local = shard_ctx(ctx, dist.get_rank(group), 2)
        per_frame = cfg.solver.association == "per_frame"
        for name, beta in betas.items():
            beta = _identity(ctx.ed_mask.shape[0]) if beta is None else beta
            single = assemble_normal_equations(
                cfg, ctx, beta, intr,
                associate(cfg, ctx, intr) if per_frame else None)
            sharded = assemble_normal_equations(
                cfg, local, beta, intr,
                associate(cfg, local, intr) if per_frame else None,
                group=group)
            out[f"assemble/{mode}/{name}"] = dict(single=_np(single),
                                                  sharded=_np(sharded))

    cfg = convert.config_from_dict(inp["cfg"])
    ctx = prepare_lm(cfg, state.surfels, state.graph, frames[2])
    ref = lm_solve(cfg, ctx, intr)
    sh = lm_solve(cfg, shard_ctx(ctx, dist.get_rank(group), 2), intr,
                  group=group)
    out["lm"] = dict(ref=_np(ref), sharded=_np(sh), cost_of_sharded_beta=float(
        total_cost(cfg, ctx, sh.beta, intr, None)))

    cfg = dataclasses.replace(cfg, solver=dataclasses.replace(
        cfg.solver, jtj_dtype="bf16", linear_solver="pcg", pcg_iterations=24))
    ctx = prepare_lm(cfg, state.surfels, state.graph, frames[2])
    sh = lm_solve(cfg, shard_ctx(ctx, dist.get_rank(group), 2), intr,
                  group=group)
    out["bf16"] = dict(cost0=float(total_cost(
        cfg, ctx, _identity(ctx.ed_mask.shape[0]), intr, None)),
        sharded=_np(sh))

    # The dense graph's route: K1b (its plain version here) in place of K1,
    # as tests/test_torch_dense_graph.py takes it, by the threshold.
    cfg = convert.config_from_dict(inp["track_cfg"])
    ctx = prepare_lm(cfg, state.surfels, state.graph, frames[2])
    assoc = associate(cfg, ctx, intr)
    threshold = kpcg._PAIRS_PERSISTENT_OH_MAX
    kpcg._PAIRS_PERSISTENT_OH_MAX = 0
    try:
        ref = lm_solve(cfg, ctx, intr)
        sh = lm_solve(cfg, shard_ctx(ctx, dist.get_rank(group), 2), intr,
                      group=group)
    finally:
        kpcg._PAIRS_PERSISTENT_OH_MAX = threshold
    out["k1b"] = dict(cost0=float(total_cost(
        cfg, ctx, _identity(ctx.ed_mask.shape[0]), intr, assoc)),
        ref=_np(ref), sharded=_np(sh))

    single, sharded = state, state
    out["track"] = []
    for f in frames[1:]:
        single, o1 = track_step(cfg, intr, single, f)
        sharded, o2 = track_step_sharded(cfg, intr, 2, sharded, f,
                                         group=group)
        out["track"].append(dict(single=_np(o1), sharded=_np(o2)))
    out["track_nodes"] = dict(single=_np(single.graph.points),
                              sharded=_np(sharded.graph.points))
    out["captured"] = _captured_frames(cfg, intr, mesh, group, state,
                                       frames[1:])
    classic = dataclasses.replace(cfg, solver=dataclasses.replace(
        cfg.solver, lm_schedule="classic"))
    out["captured_classic"] = _captured_frames(classic, intr, mesh, group,
                                               state, frames[1:2])
    return out


def _captured_frames(cfg, intr, mesh, group, state0, frames):
    """``frames`` tracked from ``state0`` by track_step_sharded and through
    make_multichip_step captured: its first call (the eager warm-up, then
    the capture), a replay a frame after it, then the first frame again
    from ``state0`` as a replay.  The eager and captured states and
    outputs of each frame, numpy, and the stand-in's cuts a run."""
    eager, state = [], state0
    for f in frames:
        state, o = track_step_sharded(cfg, intr, 2, state, f, group=group)
        eager.append(_np((state, o)))
    step = _multichip_step(cfg, intr, mesh)
    got, states = [], stack([state0])
    for f in frames + frames[:1]:
        if len(got) == len(frames):
            states = stack([state0])
        states, o = step(states, stack([f]))
        got.append(_np((unstack(states)[0], unstack(o)[0])))
    return dict(eager=eager + eager[:1], captured=got,
                cuts=step._graph.cuts)


def _stream_data(inp):
    """The streams of the streams scenarios: ``len(inp["streams"])`` time
    windows of one generated sequence (the generator's seed varies only
    the tracked pixels, not the scene)."""
    from super_tpu_torch.data.synthetic import default_intrinsics, generate

    cfg = convert.config_from_dict(inp["track_cfg"])
    intr = default_intrinsics(cfg.height, cfg.width, device="cpu")
    n = len(inp["streams"])
    seq = generate(n * STREAM_FRAMES, cfg.height, cfg.width, intr=intr,
                   seed=inp["stream_seed"])
    win = lambda a: np.stack([a[s * STREAM_FRAMES:(s + 1) * STREAM_FRAMES]
                              for s in range(n)])  # noqa: E731
    return cfg, intr, (win(seq.depths), win(seq.colors), win(seq.gt_xy),
                       win(seq.gt_valid))


def _frames(cfg, intr, depths, colors):
    from super_tpu_torch.core.preprocess import preprocess_frame

    return [preprocess_frame(cfg, intr, depths[t], np.ascontiguousarray(
        colors[t].transpose(2, 0, 1)), float(t), device="cpu")
        for t in range(len(depths))]


def _single_track(cfg, intr, frames):
    state = init_tracker(cfg, frames[0])
    outs = []
    for f in frames[1:]:
        state, o = track_step(cfg, intr, state, f)
        outs.append(_np(o))
    return state, outs


def _multichip_track(cfg, intr, mesh, streams, depths, colors):
    """This process's streams through shard_stream_batch and
    make_multichip_step: (final local states, per-frame local outputs)."""
    block = multihost.stream_block(mesh, len(streams))
    frames = [_frames(cfg, intr, depths[s], colors[s])
              for s in range(len(streams))[block]]
    host = _np(stack([init_tracker(cfg, f[0]) for f in frames]))
    states = multihost.shard_stream_batch(mesh, host)
    step = _multichip_step(cfg, intr, mesh)
    outs = []
    for t in range(1, STREAM_FRAMES):
        fb = multihost.shard_stream_batch(mesh, _np(stack(
            [f[t] for f in frames])))
        states, o = step(states, fb)
        outs.append(_np(o))
    return block, frames, states, outs, step._graph.cuts


def _state_arrays(state):
    """The surfel map and graph of a state, as numpy leaves in order."""
    return [np.asarray(x) for x in leaves(_np(state.surfels)) +
            leaves(_np(state.graph))]


def scenario_streams(inp, rank):
    from super_tpu_torch.parallel.streams import MultiStreamPipeline
    from super_tpu_torch.pipeline import SuPerPipeline

    mesh = make_mesh(device_type="cpu")       # every rank on 'stream'
    out = _mesh_info(mesh)
    cfg, intr, (depths, colors, gt_xy, gt_valid) = _stream_data(inp)
    block, frames, states, outs, cuts = _multichip_track(
        cfg, intr, mesh, inp["streams"], depths, colors)
    s = range(len(inp["streams"]))[block][0]
    single, single_outs = _single_track(cfg, intr, frames[0])
    out.update(stream=s, cuts=cuts,
               outs=[tree_map(lambda x: x[0], o) for o in outs],
               single_outs=single_outs,
               state=_state_arrays(tree_map(lambda x: x[0], states)),
               single_state=_state_arrays(single))

    pipe = MultiStreamPipeline(cfg, intr, mesh=mesh, device="cpu")
    pipe._step._graph_type = CutStandIn
    pipe._preprocess._graph_type = CutStandIn
    out["summary"] = pipe.run(depths, colors, gt_xy=gt_xy, gt_valid=gt_valid)
    ref = SuPerPipeline(cfg, intr, device="cpu")
    ref.run(depths[s], colors[s], gt_xy=gt_xy[s], gt_valid=gt_valid[s])
    out["pipe_state"] = _state_arrays(tree_map(lambda x: x[0], pipe.states))
    out["pipe_track"] = [np.asarray(x) for x in leaves(_np(
        tree_map(lambda x: x[0], pipe.states.track)))]
    out["ref_state"] = _state_arrays(ref.state)
    out["ref_track"] = [np.asarray(x) for x in leaves(_np(ref.state.track))]
    out["pipe_errors"] = pipe.errors[0]
    out["pipe_loop"] = (pipe.loop, pipe._step.captured,
                        pipe._step._graph.cuts)
    out["ref_errors"] = ref.errors
    return out


def scenario_mesh4(inp, rank):
    mesh = make_mesh(num_streams=2, num_shards=2, device_type="cpu")
    out = _mesh_info(mesh)
    cfg, intr, (depths, colors, _, _) = _stream_data(inp)
    block, frames, states, outs, cuts = _multichip_track(
        cfg, intr, mesh, inp["streams"], depths, colors)
    out.update(stream=range(len(inp["streams"]))[block][0], cuts=cuts,
               outs=[tree_map(lambda x: x[0], o) for o in outs],
               nodes=_np(states.graph.points[0]),
               state=_state_arrays(tree_map(lambda x: x[0], states)))
    if mesh.get_local_rank("shard") == 0:   # one single track a stream
        single, out["single_outs"] = _single_track(cfg, intr, frames[0])
        out["single_nodes"] = _np(single.graph.points)
    return out


SCENARIOS = dict(shard=scenario_shard, streams=scenario_streams,
                 mesh4=scenario_mesh4)


def main():
    scenario, rank, world, root = (sys.argv[1], int(sys.argv[2]),
                                   int(sys.argv[3]), sys.argv[4])
    torch.set_num_threads(1)
    multihost.initialize("gloo", init_method=f"file://{root}/{scenario}.store",
                         world_size=world, rank=rank)
    with open(os.path.join(root, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    out = SCENARIOS[scenario](inp, rank)
    dist.barrier()
    dist.destroy_process_group()
    with open(os.path.join(root, f"{scenario}_{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main()
