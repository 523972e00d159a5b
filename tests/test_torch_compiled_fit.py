"""make_jit_step's capture of the autograd fit (super_tpu_torch/core/
tracker.py:make_jit_step, core/compiled.py:CapturedStep, core/
optimizer.py:graph_fit) on the CPU, on the tiny scene with the generator's
two-class segmentations (tests/torch_helpers.py:semantic_scene, seed 3).

On the CPU there is no CUDA graph.  The captured step runs on its buffers
eagerly (``cpu_seam``) or under tests/torch_helpers.py:StandInGraph
(``stand_in``: the capture runs the body once, a replay runs it again into
the captured outputs).  Each holds:

- the bench's semantic configuration (Adam), its render-loss variant (one
  frame) and SGD (the tiny counterpart of ``semantic_super_config``):
  every frame's state and outputs bitwise the eager ``track_step``'s;
- (in test_torch_compiled_fit_jax.py) the captured steps in the port's
  SuPerPipeline against the JAX package's SuPerPipeline running its
  jitted ``make_jit_step``;
- ``make_jit_step(cfg, models)`` with ``sf_corr`` and a deterministic
  flow (tests/torch_helpers.py:corr_tflow / corr_jflow): the
  4-argument call bitwise the eager step with ``prev_color``, with the
  per-frame flow and with ``sf_corr_match_renderimg``;
- the segment sum's scratch in a backward pass run on another thread
  (autograd's device thread on the card): the store of the forward pass;
- two semantic streams in one captured batch, each bitwise its single
  track, and SuPerPipeline compiled against its eager loop, bitwise.

On the card chip_smoke.py's ``graph`` phase holds the CUDA graphs to the
eager step bitwise.
"""

import functools
import threading
import types

import numpy as np
import pytest
import torch

from torch_helpers import CORR_T_MODELS as T_MODELS, FIT_CONFIGS, \
    FIT_FLOWS, FIT_FRAMES, StandInGraph, fit_pipeline_run as _run, \
    fit_port_pipeline as _port_pipeline, port_config, semantic_scene, \
    same_tensor_bits

from super_tpu_torch.core.preprocess import preprocess_frame
from super_tpu_torch.core.tracker import init_tracker, make_jit_step, \
    track_step
from super_tpu_torch.data.synthetic import default_intrinsics
from super_tpu_torch.kernels import segsum
from super_tpu_torch.parallel.sharded import make_batched_step
from super_tpu_torch.pipeline import SuPerPipeline
from super_tpu_torch.utils.tree import stack, unstack

FRAMES = FIT_FRAMES
CONFIGS, FLOWS = FIT_CONFIGS, FIT_FLOWS


@pytest.fixture(scope="module")
def scene():
    """The tiny semantic sequence, the JAX package's and the port's
    intrinsics, and ``frames(cfg)``: the port's preprocessed frames under
    ``cfg`` (the render configurations read superv2 data)."""
    cfg = CONFIGS["adam"][0]
    jintr, seq, _ = semantic_scene(FRAMES, cfg)
    pintr = default_intrinsics(cfg.height, cfg.width, device="cpu")
    colors = np.ascontiguousarray(seq.colors.transpose(0, 3, 1, 2))

    @functools.cache
    def frames(data):
        pcfg = port_config(cfg.replace(data=data))
        return [preprocess_frame(pcfg, pintr, seq.depths[t], colors[t],
                                 float(t), seg=seq.segs[t],
                                 seg_conf=seq.seg_confs[t], device="cpu")
                for t in range(FRAMES)]

    def frames_of(c, n=FRAMES):
        return frames(c.data)[:n]

    @functools.cache
    def eager(name):
        """The eager track of CONFIGS[name] or FLOWS[name]."""
        cfg, n = {**CONFIGS, **FLOWS}[name]
        models = T_MODELS if name in FLOWS else None
        pcfg = port_config(cfg)
        return _track(_eager(pcfg, models), pcfg, pintr, frames_of(cfg, n),
                      models)

    return types.SimpleNamespace(seq=seq, jintr=jintr, pintr=pintr,
                                 frames=frames_of, eager=eager)


def _track(step, pcfg, pintr, frames, models=None):
    """Frames 1.. through ``step`` from frame 0's state: (state, outputs)
    of each frame.  With ``models`` the step takes the previous frame's
    colour (frame 1: frame 0's)."""
    state, kept = init_tracker(pcfg, frames[0]), []
    for t in range(1, len(frames)):
        args = (pintr, state, frames[t])
        if models is not None:
            args += (frames[t - 1].color_image,)
        state, outs = step(*args)
        kept.append((state, outs))
    return kept


def _eager(pcfg, models=None):
    if models is None:
        return functools.partial(track_step, pcfg)
    return lambda intr, st, fr, prev: track_step(pcfg, intr, st, fr,
                                                 models=models,
                                                 prev_color=prev)


def _same_tracks(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        same_tensor_bits(g, w)


@pytest.mark.parametrize("graph", [None, StandInGraph],
                         ids=["cpu_seam", "stand_in"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_captured_fit_is_the_eager_step(scene, name, graph):
    """make_jit_step of the autograd configurations: every frame bitwise
    the eager track_step, each call's results kept to the end."""
    cfg, n = CONFIGS[name]
    pcfg, pintr, frames = port_config(cfg), scene.pintr, scene.frames(cfg, n)
    step = make_jit_step(pcfg)
    step._graph_type = graph
    _same_tracks(_track(step, pcfg, pintr, frames), scene.eager(name))
    assert step.captured == (graph is not None)
    if graph is not None:
        assert step._graph.replays == n - 2


@pytest.mark.parametrize("name", list(FLOWS))
def test_captured_flow_step_is_the_eager_step(scene, name):
    """make_jit_step(cfg, models) with sf_corr and the flow stand-in, under
    the stand-in graph: the 4-argument call, every frame bitwise the eager
    step with prev_color."""
    cfg, n = FLOWS[name]
    pcfg, pintr, frames = port_config(cfg), scene.pintr, scene.frames(cfg, n)
    step = make_jit_step(pcfg, T_MODELS)
    step._graph_type = StandInGraph
    got = _track(step, pcfg, pintr, frames, T_MODELS)
    _same_tracks(got, scene.eager(name))
    assert step.captured and step._graph.replays == n - 2
    # The corr face moved the fit: the flow step is not the plain one.
    assert float(got[0][1].lm_cost) != float(scene.eager("adam")[0][1].lm_cost)


def test_pipeline_compiled_is_the_eager_loop(scene):
    """SuPerPipeline on the bench's semantic configuration, its captured
    steps (stand-in graph) against compiled=False: the same tracked
    points, errors and final state, bit for bit."""
    seq = scene.seq
    cfg, n = CONFIGS["adam"]
    on = _port_pipeline(cfg)
    _run(on, seq, n)
    off = SuPerPipeline(port_config(cfg),
                        default_intrinsics(cfg.height, cfg.width,
                                           device="cpu"),
                        device="cpu", compiled=False)
    _run(off, seq, n)
    assert off.loop == "eager" and off.loop_reason == "compiled=False"
    assert on._step._graph.replays == n - 2
    same_tensor_bits(on.state, off.state)
    assert on.track_results.keys() == off.track_results.keys()
    for t in on.track_results:
        np.testing.assert_array_equal(on.track_results[t],
                                      off.track_results[t])
        np.testing.assert_array_equal(on.errors[t], off.errors[t])


def test_two_semantic_streams_in_one_graph(scene):
    """Two streams (the frames from frame 0 and from frame 1) through
    make_batched_step on the bench's semantic configuration, under the
    stand-in graph: each bitwise its single track."""
    pcfg, pintr = port_config(CONFIGS["adam"][0]), scene.pintr
    frames = scene.frames(CONFIGS["adam"][0])
    step = make_batched_step(pcfg, pintr)
    step._graph_type = StandInGraph
    singles = [scene.eager("adam"),
               _track(_eager(pcfg), pcfg, pintr, frames[1:4])]
    states = stack([init_tracker(pcfg, frames[s]) for s in (0, 1)])
    kept = []
    for t in range(2):
        states, outs = step(states, stack([frames[1 + t], frames[2 + t]]))
        kept.append((states, outs))
    for t, (states, outs) in enumerate(kept):
        for b in range(2):
            same_tensor_bits((unstack(states)[b], unstack(outs)[b]),
                             singles[b][t])
    assert step._graph.replays == 1


@pytest.mark.parametrize("op", ["gather", "reduce"])
def test_backward_on_another_thread_takes_the_forward_scratch(op,
                                                              monkeypatch):
    """segment_gather's and segment_reduce's backward passes run on a fresh
    thread (as autograd runs a card's backward pass on its device thread):
    every segment sum takes the scratch store that was current at the
    forward pass, and the gradient is the plain one."""
    rng = np.random.default_rng(0)
    ids = torch.as_tensor(rng.integers(0, 6, size=40))
    plan = segsum.segment_plan(ids, 6)
    x = torch.tensor(rng.normal(size=(6, 7)).astype(np.float32),
                     requires_grad=True)
    seen = []
    real = segsum.segment_sum

    def spy(values, plan, **kw):
        seen.append((segsum._scratch_store.get(), threading.current_thread()))
        return real(values, plan, **kw)

    spy.launches = 0
    monkeypatch.setattr(segsum, "segment_sum", spy)
    store = {}
    with segsum.scratch_scope(store):
        rows = segsum.segment_gather(x, plan)
        out = rows if op == "gather" else segsum.segment_reduce(2 * rows,
                                                                plan)
    weights = torch.as_tensor(rng.normal(size=out.shape).astype(np.float32))
    loss = torch.sum(out * weights)
    worker = threading.Thread(target=loss.backward)
    worker.start()
    worker.join()
    assert [t for _, t in seen][-1] is worker
    assert len(seen) == (1 if op == "gather" else 2)
    assert all(s is store for s, _ in seen)
    xr = x.detach().clone().requires_grad_(True)
    rows_r = xr[ids]
    out_r = rows_r if op == "gather" else torch.zeros(
        6, 7).index_add(0, ids, 2 * rows_r)
    torch.sum(out_r * weights).backward()
    torch.testing.assert_close(x.grad, xr.grad, rtol=1e-6, atol=1e-6)
