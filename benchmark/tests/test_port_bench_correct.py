"""The comparison that decides ``correct``, on the CPU at 48 x 64: a sound
run of the port passes; the control (the reference with its map and
frames stored in bfloat16, in the port's place) fails; and so does a run
with the timed path broken underneath, for each fault a cell can have: a
step that returns its state unchanged, half the batch of streams left
untracked, one tracked point moved half a pixel where it is reported, and
a fusion that drops each frame's new surfels.  The cells' own
limits (benchmark/configs) are used.  Each run takes a minute or two on
the CPU (the kernels' plain versions).

At 48 x 64 (mesh step 8) the surface's fine relief is not resolved, the
LM solve has flat directions, and on some frames its accept test falls
within rounding of a tie: there the reference computed in float32 parts
from itself in float64 by up to ~90 um at the nodes, as the port does
(PERF.md, "Open questions").  The tests' seed, 2**31 + 11, fixed before
that was seen, draws clips whose checked frames have no such tie.  At
480 x 640 no checked frame has come near one (nodes at most 4 um)."""

import dataclasses
import json

import pytest
import torch

from benchmark import compare, run, spec


def tiny(streams: int):
    from super_tpu_torch.config import lm_workload_config

    conf = spec.load_config("super_lm")
    conf["config"] = json.loads(json.dumps(dataclasses.asdict(
        lm_workload_config(48, 64, 8))))
    traffic = dict(spec.load_traffic("clip" if streams == 1 else
                                     "streams4"))
    traffic.update(frames=6, reproj_frames=6, warmup_frames=3,
                   streams=streams, checks=2)
    return conf, traffic


def cell_run(streams: int, patch=None, control=False):
    torch.set_num_threads(2)
    conf, traffic = tiny(streams)
    return run.run_cell(conf, traffic, 2 ** 31 + 11, 0.01, False, "cpu",
                        patch=patch, control=control), conf


def test_sound_run_passes_and_the_control_fails():
    res, conf = cell_run(1, control=True)
    assert res["correct"], res["check"]
    assert res["checked_frames"] == 3
    ok, lines = compare.verdict(
        {k: float(v) for k, v in res["control"].items()}, conf["limits"])
    assert not ok, lines


def _unchanged_state(pipe):
    step = pipe._step

    def broken(*args):
        state, outs = step(*args)
        return args[1] if len(args) == 3 else args[0], outs
    pipe._step = broken


def _altered_point(pipe):
    evaluate = pipe._eval_frame

    def broken(*args):
        evaluate(*args)
        tr = pipe.state.track
        coords = tr.coords.clone()
        coords[0, 0] += 0.5
        pipe.state = pipe.state._replace(track=tr._replace(coords=coords))
    pipe._eval_frame = broken


def _adds_dropped(pipe):
    step = pipe._step

    def broken(*args):
        before = (args[1] if len(args) == 3 else args[0]).surfels
        state, outs = step(*args)
        sf = state.surfels
        kept = sf.active & before.active
        return state._replace(surfels=sf._replace(active=kept)), outs
    pipe._step = broken


def _half_the_batch(pipe):
    step = pipe._step

    def mix(new, old, h):
        if isinstance(new, torch.Tensor):
            return torch.cat([new[:h], old[h:]]) if new.dim() else new
        return type(new)(*(mix(a, b, h) for a, b in zip(new, old)))

    def broken(states, frames):
        new, outs = step(states, frames)
        return mix(new, states, new.time.shape[0] // 2), outs
    pipe._step = broken


@pytest.mark.parametrize("streams,patch", [
    (1, _unchanged_state), (1, _altered_point), (2, _half_the_batch),
    (1, _adds_dropped)],
    ids=["state_unchanged", "point_altered", "half_the_batch",
         "adds_dropped"])
def test_a_broken_timed_path_is_not_correct(streams, patch):
    res, _ = cell_run(streams, patch=patch)
    assert not res["correct"], res["check"]


def moving_run(patch=None, control=False):
    """The port's moving target (``association`` "per_iteration") at 48 x
    64, checked by benchmark/reference/moving.py under super_lm's limits."""
    torch.set_num_threads(2)
    conf, traffic = tiny(1)
    conf["config"]["solver"]["association"] = "per_iteration"
    conf["reference"] = "moving"
    return run.run_cell(conf, traffic, 2 ** 31 + 11, 0.01, False, "cpu",
                        patch=patch, control=control), conf


# The sound run of the moving target is not asserted correct: at this seed
# it is not (PERF.md, "Open questions", 1): on the pixel lines its first
# trip's rows follow float32 rounding that no float64 reference repeats.
@pytest.mark.parametrize("broken", ["control", "state_unchanged"])
def test_moving_target_broken_is_not_correct(broken):
    if broken == "control":
        res, conf = moving_run(control=True)
        ok, lines = compare.verdict(
            {k: float(v) for k, v in res["control"].items()},
            conf["limits"])
    else:
        res, conf = moving_run(patch=_unchanged_state)
        ok, lines = res["correct"], res["check"]
    assert res["checked_frames"] == 3
    assert not ok, lines
