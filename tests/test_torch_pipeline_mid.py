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

from torch_helpers import headline_grid_config, pipeline_pair

from super_tpu.data.synthetic import default_intrinsics, generate

FRAMES = 6


@pytest.fixture(scope="module")
def runs():
    cfg = headline_grid_config(association="per_frame")
    seq = generate(FRAMES, cfg.height, cfg.width,
                   intr=default_intrinsics(cfg.height, cfg.width), seed=0)
    return (cfg, seq) + pipeline_pair(cfg, seq)


def test_per_frame_matches_jax_mid(runs):
    cfg, seq, ref_m, port_m, port = runs
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
    cfg, seq, _, port_m, port = runs
    static = np.mean([np.linalg.norm(seq.gt_xy[t] - seq.gt_xy[0],
                                     axis=1).mean()
                      for t in range(1, FRAMES)])
    assert port_m["frac_valid"] > 0.6, port_m
    assert port_m["reproj_mean"] < 0.75 * static, (port_m, static)
    assert np.isfinite(port.state.surfels.points.numpy()).all()
