"""The port's frame loop against the JAX package's on the headline's node
grid at a quarter of its pixels (``torch_helpers.headline_grid_config``:
240 x 320, mesh step 15, 352 anchors in 384, the headline's assembly
settings with bf16 pair sums), 6 synthetic frames with ground-truth
points, seed 0, with the per-frame association: the path whose steps do
not re-sample the target, so the two trackers stay together.
test_torch_pipeline.py holds the same at 48 x 64;
test_torch_pipeline_mid_moving.py runs the moving target here."""

import dataclasses

import numpy as np
import pytest

from torch_helpers import headline_grid_config, port_config

from super_tpu import pipeline as jpipeline
from super_tpu.data.synthetic import default_intrinsics, generate
from super_tpu_torch import pipeline as tpipeline
from super_tpu_torch.core import tracker as ttracker
from super_tpu_torch.data.synthetic import default_intrinsics as tintr

FRAMES = 6
# Fusion's counters compared per frame (test_fusion_counters_match_jax).
COUNTERS = ("add_overflow", "dup_skipped")


def _recording(step, out):
    """``step`` that also appends each frame's fusion counters to ``out``."""
    def wrapped(*args, **kw):
        state, outs = step(*args, **kw)
        out.append([int(getattr(outs, n)) for n in COUNTERS])
        return state, outs
    return wrapped


@pytest.fixture(scope="module")
def runs():
    """(cfg, seq, JAX summary, port summary, port pipeline, per-frame
    counters of the JAX run, of the port's): torch_helpers.pipeline_pair's
    two runs, each step's fusion counters recorded on the way."""
    cfg = headline_grid_config(association="per_frame")
    h, w = cfg.height, cfg.width
    seq = generate(FRAMES, h, w, intr=default_intrinsics(h, w), seed=0)
    counts_j, counts_t = [], []
    ref = jpipeline.SuPerPipeline(cfg, default_intrinsics(h, w))
    ref._step = _recording(ref._step, counts_j)
    port = tpipeline.SuPerPipeline(port_config(cfg),
                                   tintr(h, w, device="cpu"), device="cpu")
    # The pipeline's compiled step (make_jit_step) binds the tracker's
    # track_step when the run starts, its eager loop the pipeline's name.
    tstep = ttracker.track_step
    ttracker.track_step = tpipeline.track_step = _recording(tstep, counts_t)
    try:
        ref_m, port_m = [p.run(seq.depths, seq.colors, gt_xy=seq.gt_xy,
                               gt_valid=seq.gt_valid) for p in (ref, port)]
    finally:
        ttracker.track_step = tpipeline.track_step = tstep
    return (cfg, seq, ref_m, port_m, port, np.array(counts_j),
            np.array(counts_t))


def test_per_frame_matches_jax_mid(runs):
    cfg, seq, ref_m, port_m, port = runs[:5]
    print(dataclasses.asdict(cfg.solver)["association"], ref_m, port_m)
    # test_torch_pipeline.py's tolerances: the mean reprojection error
    # within max(0.3 px, 20%) of the JAX package's, the valid share within
    # 0.1, the surfel count within 2%.
    tol = max(0.3, 0.2 * ref_m["reproj_mean"])
    assert abs(port_m["reproj_mean"] - ref_m["reproj_mean"]) <= tol, \
        (port_m, ref_m)
    assert abs(port_m["frac_valid"] - ref_m["frac_valid"]) <= 0.1
    assert abs(port_m["num_surfels"] - ref_m["num_surfels"]) <= \
        0.02 * ref_m["num_surfels"]
    assert port_m["num_nodes"] == ref_m["num_nodes"]


def test_per_frame_tracks_mid(runs):
    """tests/test_pipeline.py's criterion on the port's run."""
    cfg, seq, _, port_m, port = runs[:5]
    static = np.mean([np.linalg.norm(seq.gt_xy[t] - seq.gt_xy[0],
                                     axis=1).mean()
                      for t in range(1, FRAMES)])
    assert port_m["frac_valid"] > 0.6, port_m
    assert port_m["reproj_mean"] < 0.75 * static, (port_m, static)
    assert np.isfinite(port.state.surfels.points.numpy()).all()


def test_fusion_counters_match_jax(runs):
    """Deferred adds (``add_overflow``) and skipped merges
    (``dup_skipped``) a frame, the port against the JAX package.  Both
    trackers are chaotic at the f32 rounding level (the surfel counts above
    are held to 2%), so a merge gate may flip: the band of a frame is the
    counter's own spread over the frames of the two runs (its standard
    deviation, at least one), and the sums over the track are held to
    sqrt(frames) of it.  A gap past it is a fault of fusion."""
    counts_j, counts_t = runs[5], runs[6]
    print(COUNTERS, counts_j.tolist(), counts_t.tolist())
    assert counts_j.shape == counts_t.shape == (FRAMES - 1, len(COUNTERS))
    band = np.maximum(1.0, np.concatenate([counts_j, counts_t]).std(axis=0))
    assert (np.abs(counts_t - counts_j) <= band).all(), band
    assert (np.abs(counts_t.sum(0) - counts_j.sum(0))
            <= np.sqrt(FRAMES - 1) * band).all(), band
    ref_m, port_m = runs[2], runs[3]
    for i, name in enumerate(COUNTERS):
        assert ref_m.get(f"overflow_{name}", 0.0) == counts_j[:, i].sum()
        assert port_m.get(f"overflow_{name}", 0.0) == counts_t[:, i].sum()
