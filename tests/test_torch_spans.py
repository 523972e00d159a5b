"""The port's spans (super_tpu_torch/utils/profiling.py:span) on the CPU:
the frame loops' spans under ``torch.profiler`` (one ``pipeline.frame``
root a frame or batch step, its parts in order, the compiled steps'
``graph.*`` spans inside), the same outputs with the profiler on and off,
no ``RecordFunction`` made without a profiler, and the stage times of a
step built with ``stage_times`` (core/compiled.py:CapturedStep.stage_ms).

The scene: the port's generator at 48 x 64 (mesh step 8), 2 frames; the
LM path is config.lm_workload_config's, the autograd path
config.semantic_workload_config's with the generator's segmentations.
"""

import numpy as np
import pytest
import torch

from torch_helpers import same_tensor_bits

from super_tpu_torch.config import lm_workload_config, \
    semantic_workload_config
from super_tpu_torch.core.preprocess import preprocess_frame
from super_tpu_torch.core.tracker import init_tracker, make_jit_step
from super_tpu_torch.data.synthetic import default_intrinsics, generate
from super_tpu_torch.parallel.sharded import make_batched_step
from super_tpu_torch.parallel.streams import MultiStreamPipeline
from super_tpu_torch.pipeline import SuPerPipeline
from super_tpu_torch.utils import profiling
from super_tpu_torch.utils.tree import stack

H, W, STEP, FRAMES = 48, 64, 8, 2
GRAPH = ("graph.load", "graph.run", "graph.copy_out")
SINGLE = {0: ["pipeline.fetch", "pipeline.preprocess", "pipeline.step",
              "pipeline.gt_binding", "pipeline.read", "pipeline.sync"],
          1: ["pipeline.fetch", "pipeline.preprocess", "pipeline.step",
              "pipeline.gt_binding", "pipeline.read", "pipeline.sync",
              "pipeline.read"]}
STREAMS = ["pipeline.fetch", "pipeline.preprocess"] * 2 + [
    "pipeline.step", "pipeline.gt_binding", "pipeline.read",
    "pipeline.sync"]
LM_STAGES = {"step.prepare_lm", "step.lm_solve", "step.apply_deformation",
             "step.fuse_frame", "step.prune"}
FIT_STAGES = {"step.graph_fit", "step.apply_deformation",
              "step.fuse_frame", "step.prune"}


@pytest.fixture(scope="module")
def seq():
    return generate(FRAMES, H, W, intr=default_intrinsics(H, W, device="cpu"),
                    seed=1, num_classes=2)


def run_single(seq):
    pipe = SuPerPipeline(lm_workload_config(H, W, STEP),
                         default_intrinsics(H, W, device="cpu"),
                         device="cpu")
    pipe.run(seq.depths, seq.colors, gt_xy=seq.gt_xy,
             gt_valid=seq.gt_valid)
    return pipe, (pipe.state, (pipe.track_results, pipe.errors,
                               pipe.overflow_totals))


def run_streams(seq):
    pipe = MultiStreamPipeline(lm_workload_config(H, W, STEP),
                               default_intrinsics(H, W, device="cpu"),
                               device="cpu")
    two = lambda a: np.stack([a, a[::-1].copy()])  # noqa: E731
    pipe.run(two(seq.depths), two(seq.colors), gt_xy=two(seq.gt_xy),
             gt_valid=two(seq.gt_valid))
    return pipe, ((pipe.states, pipe.outputs), pipe.errors)


RUNS = {"single": run_single, "streams": run_streams}


def program_spans(prof):
    """(start, end, name) of the program's spans, by start, in ns.  Read
    from the profiler's raw events: building ``prof.events()``'s tree over
    every op of the run takes tens of seconds."""
    return sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                  for e in prof.profiler.kineto_results.events()
                  if e.name().startswith(("pipeline.", "graph.")))


def inside(a, b):
    return b[0] <= a[0] and a[1] <= b[1] and a != b


@pytest.fixture(scope="module", params=sorted(RUNS))
def traced(request, seq):
    run = RUNS[request.param]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _, on = run(seq)
    _, off = run(seq)
    return request.param, program_spans(prof), on, off


def test_one_frame_root_a_frame_with_its_parts_in_order(traced):
    kind, spans, _, _ = traced
    roots = [s for s in spans if s[2] == "pipeline.frame"]
    assert len(roots) == FRAMES
    parts = [s for s in spans if s[2].startswith("pipeline.")
             and s[2] != "pipeline.frame"]
    for t, root in enumerate(roots):
        mine = [s for s in parts if inside(s, root)]
        top = [s[2] for s in mine
               if not any(inside(s, o) for o in mine)]
        want = SINGLE[min(t, 1)] if kind == "single" else STREAMS
        assert top == want, (t, top)
    # Every part lies in a root.
    assert all(any(inside(s, r) for r in roots) for s in parts)


def test_graph_spans_nest_under_preprocess_and_step(traced):
    kind, spans, _, _ = traced
    graph = [s for s in spans if s[2].startswith("graph.")]
    homes = [s for s in spans
             if s[2] in ("pipeline.preprocess", "pipeline.step")]
    for s in graph:
        home = [h for h in homes if inside(s, h)]
        assert len(home) == 1, s
    for h in homes:
        calls = [s[2] for s in graph if inside(s, h)]
        # Frame 0's step is the init: no compiled step there.
        assert calls in ([], list(GRAPH)), (h, calls)
    streams = 2 if kind == "streams" else 1
    assert len(graph) == 3 * (FRAMES * streams + FRAMES - 1)


def test_outputs_are_the_same_with_the_profiler_on_and_off(traced):
    _, _, on, off = traced
    same_tensor_bits(on[0], off[0])
    np.testing.assert_equal(on[1], off[1])


def test_span_makes_no_record_function_without_a_profiler(monkeypatch):
    calls = []
    enter = torch.ops.profiler._record_function_enter_new

    def counted(*a):
        calls.append(a[0])
        return enter(*a)

    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new",
                        counted)
    assert not profiling.profiler_enabled()
    for _ in range(3):
        with profiling.span("pipeline.frame"):
            pass
    assert calls == []
    assert profiling.span("a") is profiling.span("b")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("pipeline.frame"):
            pass
    assert calls == ["pipeline.frame"]


def _frames(cfg, seq, semantic):
    intr = default_intrinsics(H, W, device="cpu")
    return intr, [preprocess_frame(
        cfg, intr, seq.depths[t], seq.colors[t].transpose(2, 0, 1),
        float(t), seg=seq.segs[t] if semantic else None,
        seg_conf=seq.seg_confs[t] if semantic else None, device="cpu")
        for t in range(2)]


@pytest.mark.parametrize("path", ["lm", "autograd", "batched", "off"])
def test_stage_ms_names_the_stages_of_the_path_taken(seq, path):
    semantic = path == "autograd"
    cfg = (semantic_workload_config(H, W, STEP) if semantic
           else lm_workload_config(H, W, STEP))
    intr, frames = _frames(cfg, seq, semantic)
    state = init_tracker(cfg, frames[0])
    if path == "batched":
        step = make_batched_step(cfg, intr, stage_times=True)
        step(stack([state, state]), stack([frames[1], frames[1]]))
    else:
        step = make_jit_step(cfg, stage_times=path != "off")
        step(intr, state, frames[1])
    ms = step.stage_ms()
    if path == "off":
        assert ms == {} and step.body_ms() is None
        return
    assert set(ms) == (FIT_STAGES if semantic else LM_STAGES)
    assert all(v >= 0 for v in ms.values())
    assert step.body_ms() >= sum(ms.values())
