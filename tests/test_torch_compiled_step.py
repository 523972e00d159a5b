"""The port's compiled step (super_tpu_torch/core/compiled.py,
core/tracker.py:make_jit_step) on the CPU, where it has no graph.

- ``make_jit_step(cfg)`` on CPU tensors against the JAX package's
  ``make_jit_step(cfg)`` (jitted, CPU) over 4 frames of the tiny scene,
  held to tests/torch_helpers.py:check_track's bands (the tracked state is
  chaotic at f32 rounding, test_torch_track.py).
- The captured step's buffers: on the CPU seam (no graph, the step run
  eagerly on the buffers) and under a stand-in graph (a capture that runs
  the body once as the CUDA capture runs its Python, and replays that run
  the body again into the captured outputs with the launch counters left
  as they were, as a CUDA replay runs no Python), each frame bitwise
  ``track_step``'s, the results of every call kept to the end of the run
  (no later call writes them).
- The launch counters: a stand-in step that counts launches as the
  kernel wrappers do, captured and replayed: each run counts once.
- every step captured (the autograd fit, sf_corr with nets, the mesh's
  step of one shard and of two), the stream batch for B = 2 bitwise two
  single tracks,
  and SuPerPipeline's compiled loop bitwise its eager one.

On the card the same objects capture CUDA graphs; chip_smoke.py's
``graph`` phase holds them to the eager step bitwise there.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from torch_helpers import StandInGraph, check_track, port_config, \
    port_intr, same_tensor_bits as same_bits, slice_config

from super_tpu.core.preprocess import preprocess_frame as jax_preprocess
from super_tpu.core.tracker import init_tracker as jax_init
from super_tpu.core.tracker import make_jit_step as jax_make_jit_step
from super_tpu.data.synthetic import default_intrinsics, generate
from super_tpu_torch.convert import to_numpy
from super_tpu_torch.core import compiled
from super_tpu_torch.core.preprocess import preprocess_frame
from super_tpu_torch.core.tracker import init_tracker, make_jit_step, \
    track_step
from super_tpu_torch.kernels import pcg, segsum
from super_tpu_torch.parallel.sharded import make_batched_step, \
    make_multichip_step
from super_tpu_torch.pipeline import SuPerPipeline, captured_preprocess
from super_tpu_torch.utils.tree import stack, unstack

FRAMES = 4               # tracked frames after frame 0


@pytest.fixture(scope="module")
def scene():
    cfg = slice_config(gram_sum_dtype="bf16")
    intr = default_intrinsics(cfg.height, cfg.width)
    seq = generate(FRAMES + 1, cfg.height, cfg.width, intr=intr, seed=0)
    pcfg, pintr = port_config(cfg), port_intr(intr)
    colors = np.ascontiguousarray(seq.colors.transpose(0, 3, 1, 2))
    frames = [preprocess_frame(pcfg, pintr, seq.depths[t], colors[t],
                               float(t), device="cpu")
              for t in range(FRAMES + 1)]
    eager, state = [], init_tracker(pcfg, frames[0])
    for f in frames[1:]:
        state, outs = track_step(pcfg, pintr, state, f)
        eager.append((state, outs))
    return cfg, intr, seq, pcfg, pintr, frames, eager


@pytest.fixture(scope="module")
def jax_run(scene):
    """The JAX package's make_jit_step over the frames: (per-frame
    outputs, final node positions), numpy."""
    cfg, intr, seq, *_ = scene
    pre = jax.jit(lambda d, c, t: jax_preprocess(cfg, intr, d, c, t))
    frames = [pre(seq.depths[t], seq.colors[t].transpose(2, 0, 1),
                  np.float32(t)) for t in range(FRAMES + 1)]
    state = jax.jit(lambda f: jax_init(cfg, f))(frames[0])
    step = jax_make_jit_step(cfg)
    outs = []
    for f in frames[1:]:
        state, o = step(intr, state, f)
        outs.append(jax.tree.map(np.asarray, o))
    return outs, np.asarray(state.graph.points)


def _track(step, scene):
    *_, pintr, frames, _ = scene
    state = init_tracker(scene[3], frames[0])
    kept = []
    for f in frames[1:]:
        state, outs = step(pintr, state, f)
        kept.append((state, outs))
    return kept


def test_make_jit_step_within_the_jax_compiled_steps_bands(scene, jax_run):
    kept = _track(make_jit_step(scene[3]), scene)
    want, nodes = jax_run
    check_track((want, [to_numpy(o) for _, o in kept], nodes,
                 kept[-1][0].graph.points.numpy()))


@pytest.mark.parametrize("graph", [None, StandInGraph],
                         ids=["cpu_seam", "stand_in"])
def test_captured_step_is_the_eager_step(scene, graph):
    """Every frame bitwise track_step's, each call's results kept to the
    end: no later call writes them."""
    step = compiled.CapturedStep(functools.partial(track_step, scene[3]),
                                 carry=(1, 0), graph=graph)
    kept = _track(step, scene)
    for (state, outs), (e_state, e_outs) in zip(kept, scene[-1]):
        same_bits(state, e_state)
        same_bits(outs, e_outs)
    assert step.captured == (graph is not None)
    if graph is not None:
        assert step._graph.replays == FRAMES - 1


def test_captured_step_leaves_its_input_state(scene):
    """A call reads the state it is given and writes none of it (the
    pipeline and the bench's cold start rely on it)."""
    *_, pcfg, pintr, frames, _ = scene
    state0 = init_tracker(pcfg, frames[0])
    copy = pytree.tree_map(torch.clone, state0)
    step = compiled.CapturedStep(functools.partial(track_step, pcfg),
                                 carry=(1, 0), graph=StandInGraph)
    state, _ = step(pintr, state0, frames[1])
    step(pintr, state, frames[2])
    again, _ = step(pintr, state0, frames[1])
    same_bits(state0, copy)
    same_bits(again, state)


def _counting_step(intr, state, frame):
    """A stand-in step: one K1, two K3 and forty segment-sum launches
    counted as the wrappers count them."""
    pcg.pairs_cg.launches += 1
    pcg.dense_cg.launches += 2
    segsum.segment_sum.launches += 40
    return state + frame, state * 2


@pytest.mark.parametrize("graph", [None, StandInGraph],
                         ids=["cpu_seam", "stand_in"])
def test_launch_counters_count_each_run_once(graph):
    """The capture's own launches are undone and every replay adds the
    run's; without a graph every run counts by itself."""
    kernels = (pcg.pairs_cg, pcg.dense_cg, segsum.segment_sum)
    saved = [k.launches for k in kernels]
    try:
        for k in kernels:
            k.launches = 0
        step = compiled.CapturedStep(_counting_step, carry=(1, 0),
                                     graph=graph)
        state = torch.zeros(3)
        for t in range(5):
            state, doubled = step(torch.ones(()), state,
                                  torch.full((3,), float(t)))
            assert [k.launches for k in kernels] == [t + 1, 2 * (t + 1),
                                                     40 * (t + 1)]
        assert torch.equal(state, torch.full((3,), 10.0))
        step.replay()
        assert pcg.pairs_cg.launches == 6
        assert torch.equal(step.buffers[1], torch.full((3,), 14.0))
    finally:
        for k, n in zip(kernels, saved):
            k.launches = n


def test_captured_step_refuses_another_structure(scene):
    *_, pcfg, pintr, frames, _ = scene
    step = compiled.CapturedStep(lambda intr, x: (x + 1,),
                                 graph=StandInGraph)
    step(pintr, torch.zeros(3))
    with pytest.raises(ValueError, match="shape|structure|capture had"):
        step(pintr, torch.zeros(4))
    with pytest.raises(ValueError, match="structure"):
        step(pintr, (torch.zeros(3),))


class _Mesh:
    """A ('stream', 'shard') mesh of ``shape`` without a world: what
    make_multichip_step reads of a DeviceMesh."""

    mesh_dim_names = ("stream", "shard")

    def __init__(self, shape, device_type):
        self.shape, self.device_type = shape, device_type
        self.group = object()

    def size(self, dim):
        return self.shape[dim]

    def get_group(self, name):
        assert name == "shard"
        return self.group


def test_every_step_is_captured(scene):
    """make_jit_step captures the autograd fit and the sf_corr step with
    nets (tests/test_torch_compiled_fit.py runs them), and
    make_multichip_step the mesh's step: a one-shard mesh as the stream
    batch (one CUDA graph on the card), two shards as graphs cut at the
    all-reduces on a card's mesh, eagerly on a CPU one."""
    pcfg, pintr = scene[3], scene[4]
    autograd = pcfg.replace(solver=dataclasses.replace(
        pcfg.solver, use_derived_gradient=False))
    assert isinstance(make_jit_step(autograd), compiled.CapturedStep)
    corr = autograd.replace(losses=dataclasses.replace(autograd.losses,
                                                       sf_corr=True))
    assert isinstance(make_jit_step(corr, models=object()),
                      compiled.CapturedStep)
    assert isinstance(make_batched_step(autograd, pintr),
                      compiled.CapturedStep)
    for device_type in ("cpu", "cuda"):
        for cfg in (pcfg, autograd):
            one = make_multichip_step(cfg, pintr, _Mesh((2, 1), device_type))
            assert isinstance(one, compiled.CapturedStep)
            assert one._graph_type is None
        two = make_multichip_step(pcfg, pintr, _Mesh((1, 2), device_type))
        assert isinstance(two, compiled.CapturedStep)
        assert two._graph_type is (compiled.CutGraph
                                   if device_type == "cuda" else None)
    with pytest.raises(TypeError, match="group"):
        make_jit_step(pcfg, group=object())


def test_batched_step_is_two_single_tracks(scene):
    """Two streams (the frames from frame 0 and from frame 1) through the
    batch step captured under the stand-in graph: each bitwise its single
    track.  (tests/test_torch_streams.py runs make_batched_step's CPU seam
    on three streams.)"""
    *_, pcfg, pintr, frames, eager = scene
    step = compiled.CapturedStep(
        make_batched_step(pcfg, pintr, compiled=False), carry=(0, 0),
        graph=StandInGraph)
    state, second = init_tracker(pcfg, frames[1]), []
    for f in frames[2:4]:
        state, o = track_step(pcfg, pintr, state, f)
        second.append((state, o))
    singles = (eager[:2], second)
    states = stack([init_tracker(pcfg, frames[s]) for s in (0, 1)])
    kept = []
    for t in range(2):
        states, outs = step(states, stack([frames[1 + t], frames[2 + t]]))
        kept.append((states, outs))
    for t, (states, outs) in enumerate(kept):
        for b in range(2):
            same_bits(unstack(states)[b], singles[b][t][0])
            same_bits(unstack(outs)[b], singles[b][t][1])
    assert step._graph.replays == 1


def test_pipeline_compiled_loop_is_the_eager_loop(scene):
    """SuPerPipeline with its compiled steps (on the CPU: run eagerly on
    their buffers) against compiled=False: the same tracked points,
    errors and final state, bit for bit."""
    *_, seq, pcfg, pintr, _, _ = scene
    runs = []
    for flag in (True, False):
        pipe = SuPerPipeline(pcfg, pintr, device="cpu", compiled=flag)
        pipe.run(seq.depths, seq.colors, gt_xy=seq.gt_xy,
                 gt_valid=seq.gt_valid)
        runs.append(pipe)
    on, off = runs
    assert (on.loop, off.loop) == ("eager", "eager")
    assert on.loop_reason.startswith("CPU") and off.loop_reason == \
        "compiled=False"
    assert on._step is not None and off._step is None
    same_bits(on.state, off.state)
    assert on.track_results.keys() == off.track_results.keys()
    for t in on.track_results:
        np.testing.assert_array_equal(on.track_results[t],
                                      off.track_results[t])
        np.testing.assert_array_equal(on.errors[t], off.errors[t])


def test_preprocess_captured_is_preprocess_frame(scene):
    """The pipelines' captured preprocess_frame, under the stand-in graph:
    each frame bitwise preprocess_frame's, time included."""
    *_, seq, pcfg, pintr, frames, _ = scene
    pre = captured_preprocess(pcfg, "cpu")
    pre._graph_type = StandInGraph
    colors = np.ascontiguousarray(seq.colors.transpose(0, 3, 1, 2))
    got = [pre(pintr, seq.depths[t], colors[t], float(t), None, None)
           for t in range(3)]
    for t in range(3):
        same_bits(got[t], frames[t])
    assert pre._graph.replays == 2
