"""Parity of the port's tracked control points (core/track_points.py) and
its copy of the evaluation module (utils/evaluation.py) with the JAX
package's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import close, port_config, port_frame, port_state, \
    scene, slice_config, to_np

from super_tpu.core import track_points as jtp
from super_tpu.core.tracker import init_tracker, track_step
from super_tpu.utils import evaluation as jev
from super_tpu_torch import convert
from super_tpu_torch.core import track_points as ttp
from super_tpu_torch.utils import evaluation as tev


@pytest.fixture(scope="module")
def states():
    """Frame 0's state and the state after two steps, with their frames
    and the sequence's GT points."""
    cfg = slice_config()
    intr, seq, frames = scene(3, cfg)
    st0 = jax.jit(lambda f: init_tracker(cfg, f))(frames[0])
    step = jax.jit(lambda s, f: track_step(cfg, intr, s, f))
    st2 = step(step(st0, frames[1])[0], frames[2])[0]
    return cfg, seq, frames, {0: st0, 2: st2}


def _assign_both(cfg, st, frame, track, gt_xy, gt_valid):
    """The same numpy state, frame and GT through both packages."""
    st_np = to_np(st)
    jst = jax.tree.map(jnp.asarray, st_np)
    want = jtp.assign_track_points(cfg, jst.surfels, frame, track,
                                   jnp.asarray(gt_xy), jnp.asarray(gt_valid))
    want = jtp.record_track_coords(jst.surfels, want)
    pst = port_state(st_np)
    ptrack = convert.tracker_state_from_numpy(
        st_np._replace(track=to_np(track)), device="cpu").track
    got = ttp.assign_track_points(port_config(cfg), pst.surfels,
                                  port_frame(frame), ptrack,
                                  torch.as_tensor(gt_xy),
                                  torch.as_tensor(gt_valid))
    got = ttp.record_track_coords(pst.surfels, got)
    return want, got


def _equal(want, got):
    close(want.track_id, got.track_id, atol=0, name="track_id")
    close(want.coord_valid, got.coord_valid, atol=0, name="coord_valid")
    # The coordinates are gathered, not computed: exactly equal.
    close(want.coords, got.coords, atol=0, name="coords")


@pytest.mark.parametrize("t", [0, 2])
def test_assign_and_record(states, t):
    cfg, seq, frames, sts = states
    st = sts[t]
    gt_xy = seq.gt_xy[t].astype(np.int32)
    gt_valid = seq.gt_valid[t]
    want, got = _assign_both(cfg, st, frames[t], st.track, gt_xy, gt_valid)
    _equal(want, got)
    assert (got.track_id.numpy() >= 0).sum() > 10


def test_assign_keeps_tracked_and_binds_new(states):
    """A track with some points bound already (from frame 0's binding) and
    the rest unbound, on the state after two steps: bound ids stay, the
    others bind excluding the bound slots."""
    cfg, seq, frames, sts = states
    first, _ = _assign_both(cfg, sts[0], frames[0], sts[0].track,
                            seq.gt_xy[0].astype(np.int32), seq.gt_valid[0])
    ids = np.asarray(first.track_id).copy()
    ids[::2] = -1
    track = sts[2].track._replace(track_id=jnp.asarray(ids))
    want, got = _assign_both(cfg, sts[2], frames[2], track,
                             seq.gt_xy[2].astype(np.int32), seq.gt_valid[2])
    _equal(want, got)


def test_assign_edge_cases(states):
    """Two GT points on one pixel (the second must not take the first's
    surfel), a GT point at pixel 0, one whose candidate lies beyond th,
    and one invisible."""
    cfg, seq, frames, sts = states
    st = sts[0]
    frame = frames[0]
    xy = seq.gt_xy[0].astype(np.int32).copy()
    valid = np.ones(len(xy), bool)
    xy[1] = xy[0]                       # same pixel as point 0
    xy[2] = (0, 0)                      # pixel 0
    valid[4] = False
    far = int(xy[3, 1]) * cfg.width + int(xy[3, 0])
    pts = np.asarray(frame.points).copy()
    pts[:, far] += 1.0                  # 1 m from every surfel
    frame = frame._replace(points=jnp.asarray(pts))
    want, got = _assign_both(cfg, st, frame, st.track, xy, valid)
    _equal(want, got)
    ids = got.track_id.numpy()
    assert ids[0] >= 0 and ids[1] >= 0 and ids[0] != ids[1]
    assert ids[2] == -1 and ids[3] == -1 and ids[4] == -1


def test_evaluation_matches_jax():
    rng = np.random.default_rng(0)
    gt = np.concatenate([rng.uniform(0, 60, (20, 2)),
                         (rng.random((20, 1)) > 0.2).astype(np.float64)], 1)
    est = np.concatenate([gt[:, :2] + rng.normal(size=(20, 2)),
                          np.ones((20, 1))], 1)
    for ignored in ((), (1, 5)):
        np.testing.assert_array_equal(
            jev.reprojection_errors(gt, est, ignored),
            tev.reprojection_errors(gt, est, ignored))
    frames = {t: jev.reprojection_errors(gt, est + t) for t in range(4)}
    bundle = {"gt": {str(t): gt for t in range(3)},
              "super_cpp": {str(t): est for t in range(2)}}
    a = jev.baseline_errors_from_bundle(bundle)
    b = tev.baseline_errors_from_bundle(bundle)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert tev.baseline_errors_from_bundle({"gt": {}}) == {}
    for edge in ((), (2, 3, 7)):
        assert jev.summarize(frames, edge) == tev.summarize(frames, edge)
    assert tev.summarize({}) == {}
    d_gt = rng.uniform(0.5, 2.0, 100)
    d_pred = d_gt * rng.uniform(0.8, 1.25, 100)
    assert jev.compute_depth_errors(d_gt, d_pred) == \
        tev.compute_depth_errors(d_gt, d_pred)


def test_frame0_tracks_match_on_tiny_default_config():
    """tiny_config's own defaults (per-iteration, Cholesky): frame 0's
    binding on each package's own frame-0 state, from the same depth and
    colour."""
    from helpers import tiny_config
    from super_tpu_torch.core.preprocess import preprocess_frame
    from super_tpu_torch.core.tracker import init_tracker as tinit
    from super_tpu_torch.data.synthetic import default_intrinsics

    cfg = tiny_config()
    intr, seq, frames = scene(1, cfg, seed=2)
    st = jax.jit(lambda f: init_tracker(cfg, f))(frames[0])
    want = jtp.assign_track_points(cfg, st.surfels, frames[0], st.track,
                                   jnp.asarray(seq.gt_xy[0]),
                                   jnp.asarray(seq.gt_valid[0]))
    pcfg = port_config(cfg)
    pintr = default_intrinsics(cfg.height, cfg.width, device="cpu")
    pf = preprocess_frame(pcfg, pintr, seq.depths[0],
                          seq.colors[0].transpose(2, 0, 1), 0.0,
                          device="cpu")
    pst = tinit(pcfg, pf)
    got = ttp.assign_track_points(pcfg, pst.surfels, pf, pst.track,
                                  torch.as_tensor(seq.gt_xy[0]),
                                  torch.as_tensor(seq.gt_valid[0]))
    close(want.track_id, got.track_id, atol=0, name="track_id")
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(
        port_config(tiny_config()))
