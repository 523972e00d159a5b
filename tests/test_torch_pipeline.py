"""The port's frame loop (super_tpu_torch.pipeline.SuPerPipeline) against
the JAX package's on tests/test_pipeline.py's sequence: 8 synthetic frames
at 48 x 64, mesh step 8, seed 2, with ground-truth points, for
``tiny_config`` (the ``SolverConfig`` defaults: per-iteration
association, Cholesky) and for the per-frame association."""

import dataclasses

import numpy as np
import pytest

import torch_helpers  # noqa: F401  (two threads)
from helpers import tiny_config

from super_tpu.data.synthetic import default_intrinsics, generate
from super_tpu.pipeline import SuPerPipeline
from super_tpu_torch.data.synthetic import default_intrinsics as tintr
from super_tpu_torch.pipeline import SuPerPipeline as TSuPerPipeline
from torch_helpers import port_config

H, W = 48, 64
CONFIGS = ("tiny_config", "per_frame")


def _config(name):
    cfg = tiny_config(h=H, w=W, step=8)
    if name == "per_frame":
        cfg = cfg.replace(solver=dataclasses.replace(
            cfg.solver, association="per_frame"))
    return cfg


@pytest.fixture(scope="module")
def runs():
    """Both packages' pipelines on the sequence, per config; and each
    one's frame-0 binding alone."""
    seq = generate(8, H, W, intr=default_intrinsics(H, W), seed=2)
    out = {}
    for name in CONFIGS:
        cfg = _config(name)
        ref = SuPerPipeline(cfg, default_intrinsics(H, W))
        ref_m = ref.run(seq.depths, seq.colors, gt_xy=seq.gt_xy,
                        gt_valid=seq.gt_valid)
        port = TSuPerPipeline(port_config(cfg), tintr(H, W, device="cpu"),
                              device="cpu")
        port_m = port.run(seq.depths, seq.colors, gt_xy=seq.gt_xy,
                          gt_valid=seq.gt_valid)
        ids = []
        for cls, intr, kw in ((SuPerPipeline, default_intrinsics(H, W), {}),
                              (TSuPerPipeline, tintr(H, W, device="cpu"),
                               dict(device="cpu"))):
            p = cls(cfg if cls is SuPerPipeline else port_config(cfg), intr,
                    **kw)
            p.run(seq.depths[:1], seq.colors[:1], gt_xy=seq.gt_xy,
                  gt_valid=seq.gt_valid)
            ids.append(np.asarray(p.state.track.track_id))
        out[name] = dict(cfg=cfg, ref=ref, ref_m=ref_m, port=port,
                         port_m=port_m, ids=ids)
    return seq, out


@pytest.mark.parametrize("name", CONFIGS)
def test_frame0_binding_matches(runs, name):
    ref_ids, port_ids = runs[1][name]["ids"]
    np.testing.assert_array_equal(ref_ids, port_ids)
    assert (port_ids >= 0).sum() > 10


@pytest.mark.parametrize("name", CONFIGS)
def test_accuracy_matches_jax(runs, name):
    r = runs[1][name]
    ref_m, port_m = r["ref_m"], r["port_m"]
    # Two trackers of one chaotic loop (f32 rounding moves single
    # accept/reject decisions, ROADMAP queue 3): the mean reprojection
    # error within max(0.3 px, 20%) of the JAX package's, the valid share
    # within 0.1, the surfel count within 2%.
    tol = max(0.3, 0.2 * ref_m["reproj_mean"])
    assert abs(port_m["reproj_mean"] - ref_m["reproj_mean"]) <= tol, \
        (port_m, ref_m)
    assert abs(port_m["frac_valid"] - ref_m["frac_valid"]) <= 0.1
    assert abs(port_m["num_surfels"] - ref_m["num_surfels"]) <= \
        0.02 * ref_m["num_surfels"]
    assert set(port_m) >= {"reproj_mean", "reproj_std", "frac_valid",
                           "mean_frame_ms", "p50_frame_ms", "fps",
                           "num_surfels", "num_nodes"}


@pytest.mark.parametrize("name", CONFIGS)
def test_tracking_bounds(runs, name):
    """tests/test_pipeline.py's own bounds, on the port's run."""
    seq, out = runs
    cfg, pipe, metrics = out[name]["cfg"], out[name]["port"], \
        out[name]["port_m"]
    st = pipe.state
    n = int(st.surfels.num_active)
    assert 1000 <= n <= cfg.capacity.surfel_capacity
    assert n < 3 * (H * W)
    pts = st.surfels.points.numpy().T[st.surfels.active.numpy()]
    assert np.isfinite(pts).all()
    assert np.isfinite(st.graph.points.numpy()).all()
    assert 0.3 < pts[:, 2].mean() < 0.9
    assert metrics["frac_valid"] > 0.6, metrics
    assert metrics["reproj_mean"] < 6.0, metrics
    static_err = np.mean([
        np.linalg.norm(seq.gt_xy[t] - seq.gt_xy[0], axis=1).mean()
        for t in range(1, len(seq.gt_xy))])
    assert metrics["reproj_mean"] < 0.75 * static_err, (metrics, static_err)


def test_unported_hooks_raise():
    """The logger and checkpoint hooks raise; depth from the perception
    nets is ported (test_torch_perception_pipeline.py), and a run with
    neither depths nor nets raises."""
    cfg = port_config(_config("per_frame"))
    intr = tintr(H, W, device="cpu")
    with pytest.raises(NotImplementedError):
        TSuPerPipeline(cfg, intr, logdir="x", device="cpu")
    with pytest.raises(NotImplementedError):
        TSuPerPipeline(cfg, intr, checkpoint_dir="x", device="cpu")
    pipe = TSuPerPipeline(cfg, intr, device="cpu")
    with pytest.raises(ValueError):
        pipe.run(None, np.zeros((1, H, W, 3), np.float32))
