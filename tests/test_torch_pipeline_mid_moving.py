"""The moving target (``association="per_iteration"``, the ``SolverConfig``
default and the bench's ``per_iteration_hz``) through the port's frame
loop and the JAX package's on the headline's node grid at a quarter of its
pixels (``torch_helpers.headline_grid_config``: 240 x 320, mesh step 15,
the headline's assembly settings with bf16 pair sums), 6 synthetic frames
with ground-truth points, seed 0.

Each trip re-samples the target, and a sample an ULP from a pixel line
takes the next bilinear cell, whose gradient jumps at a depth edge
(test_torch_moving_mid.py finds two such slots on frame 1 here), so two
trackers of this loop part ways at f32 rounding and no tolerance on their
distance holds.  The port is held to tests/test_pipeline.py's criterion
and to be no worse than the JAX package by test_torch_pipeline.py's
tolerance; both summaries are printed (``-s``)."""

import numpy as np
import pytest

from torch_helpers import headline_grid_config, pipeline_pair

from super_tpu.data.synthetic import default_intrinsics, generate

FRAMES = 6


@pytest.fixture(scope="module")
def runs():
    cfg = headline_grid_config(association="per_iteration")
    seq = generate(FRAMES, cfg.height, cfg.width,
                   intr=default_intrinsics(cfg.height, cfg.width), seed=0)
    return (cfg, seq) + pipeline_pair(cfg, seq)


def test_moving_target_tracks_mid(runs):
    cfg, seq, ref_m, port_m, port = runs
    static = np.mean([np.linalg.norm(seq.gt_xy[t] - seq.gt_xy[0],
                                     axis=1).mean()
                      for t in range(1, FRAMES)])
    print(f"static {static}\njax {ref_m}\nport {port_m}")
    assert port_m["frac_valid"] > 0.6, port_m
    assert port_m["reproj_mean"] < 0.75 * static, (port_m, static)
    assert np.isfinite(port.state.surfels.points.numpy()).all()
    tol = max(0.3, 0.2 * ref_m["reproj_mean"])
    assert port_m["reproj_mean"] <= ref_m["reproj_mean"] + tol, \
        (port_m, ref_m)
