"""The stereo SSIM confidence (``disable_ssim_conf=False``) of the port
against the JAX package, on the tiny synthetic scene (48 x 64): the stereo
warp, the confidence map with invalid (NaN) depth pixels at the default
baseline and at a small one, the preprocess blend with and without a
given ``disp_conf``, fusion's candidate view, which then gathers the
confidence as a bank row, and a 3-frame track.

Both packages sample with (floor, floor + 1) corners clamped into the
image and SSIM with the same 3x3 reflection-padded pools, so the maps agree
to float32 rounding: 1e-5, except on pixels whose warped sample lies within
a few ULPs of a pixel line, where the floor can differ (bilinear sampling
is continuous there, so those too stay small).  At most LINE_SHARE of the
pixels may exceed 1e-5, and only where that holds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import (
    check_track,
    option_tracks,
    port_config,
    port_frame,
    port_intr,
    slice_config,
)

from super_tpu.core import fusion as jfusion
from super_tpu.core import preprocess as jpre
from super_tpu.data.synthetic import default_intrinsics, generate
from super_tpu.geometry import camera as jcam
from super_tpu_torch.core import fusion as tfusion
from super_tpu_torch.core import preprocess as tpre
from super_tpu_torch.geometry import camera as tcam

H, W = 48, 64
TOL = 1e-5
LINE_SHARE = 0.01


@pytest.fixture(scope="module")
def scene():
    """(cfg, intr, port intr, depth with NaN holes, colour (3, H, W))."""
    cfg = slice_config().replace(disable_ssim_conf=False)
    intr = default_intrinsics(H, W)
    seq = generate(2, H, W, intr=intr)
    depth = seq.depths[1].astype(np.float32).copy()
    rng = np.random.default_rng(0)
    depth[rng.random((H, W)) < 0.05] = np.nan
    depth[10:20, 30:40] = np.nan
    color = np.ascontiguousarray(seq.colors[1].transpose(2, 0, 1))
    return cfg, intr, port_intr(intr), depth, color


def _points(intr, pintr, depth):
    return (jcam.backproject_depth(jnp.asarray(depth), intr),
            tcam.backproject_depth(torch.as_tensor(depth), pintr))


@pytest.mark.parametrize("baseline", [-0.01, -0.1])
def test_warp_stereo_coords(scene, baseline):
    cfg, intr, pintr, depth, _ = scene
    pj, pt = _points(intr, pintr, depth)
    want = np.asarray(jcam.warp_stereo_coords(pj, intr, baseline, H, W))
    got = tcam.warp_stereo_coords(pt, pintr, baseline, H, W).numpy()
    assert got.shape == want.shape == (H, W, 2)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-6, atol=1e-6)


def _line_pixels(u, v):
    """Pixels whose 3x3 SSIM window holds a sample within a few ULPs of a
    pixel line."""
    near = np.zeros(u.shape, bool)
    for c in (u, v):
        c = np.nan_to_num(c, nan=-10.0)
        near |= np.abs(c - np.round(c)) <= 4 * np.spacing(np.abs(c) + 1)
    out = near.copy()
    pad = np.pad(near, 1)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            out |= pad[1 + dy:1 + dy + u.shape[0], 1 + dx:1 + dx + u.shape[1]]
    return out


@pytest.mark.parametrize("baseline", [-0.01, -0.1])
def test_stereo_ssim_confidence(scene, baseline):
    cfg, intr, pintr, depth, color = scene
    pj, pt = _points(intr, pintr, depth)
    want = np.asarray(jpre.stereo_ssim_confidence(
        cfg, intr, pj, jnp.asarray(color), baseline_tx=baseline))
    got = tpre.stereo_ssim_confidence(
        port_config(cfg), pintr, pt, torch.as_tensor(color),
        baseline_tx=baseline).numpy()
    assert got.shape == (H, W) and np.isfinite(got).all()
    grid = np.asarray(jcam.warp_stereo_coords(pj, intr, baseline, H, W))
    u = (grid[..., 0] + 1.0) * 0.5 * (W - 1)
    v = (grid[..., 1] + 1.0) * 0.5 * (H - 1)
    bad = np.abs(got - want) > TOL
    assert bad.mean() <= LINE_SHARE, bad.mean()
    assert not (bad & ~_line_pixels(u, v)).any(), np.abs(got - want).max()
    # At the default baseline the warp leaves the image for part of it:
    # the clamped edge samples must match too (checked above).
    if baseline == -0.1:
        assert ((u < 0) | (u > W - 1)).mean() > 0.05


def test_ssim_confidence_prefers_consistent_depth(scene):
    """tests/test_models.py's check on the port: depth consistent with the
    image scores higher than depth with a ripple."""
    cfg, _, pintr, _, _ = scene
    tcfg = port_config(cfg)
    seq = generate(1, H, W, intr=default_intrinsics(H, W))
    depth = torch.as_tensor(seq.depths[0])
    color = torch.as_tensor(seq.colors[0].transpose(2, 0, 1).copy())
    good = tpre.stereo_ssim_confidence(
        tcfg, pintr, tcam.backproject_depth(depth, pintr), color,
        baseline_tx=-0.01)
    ripple = 1 + 0.3 * torch.sin(torch.arange(H * W).reshape(H, W) * 0.37)
    bad = tpre.stereo_ssim_confidence(
        tcfg, pintr, tcam.backproject_depth(depth * ripple, pintr), color,
        baseline_tx=-0.01)
    assert float(good[8:-8, 8:-8].mean()) > float(bad[8:-8, 8:-8].mean())


@pytest.mark.parametrize("given", [False, True])
def test_preprocess_confs(scene, given):
    """preprocess_frame's blended confidences, computed (given=False) or
    from a given disp_conf, against the JAX package's, and every other
    field of the frame unchanged by the blend."""
    cfg, intr, pintr, depth, color = scene
    disp_conf = (np.random.default_rng(1).normal(size=(H, W))
                 .astype(np.float32) if given else None)
    want = jpre.preprocess_frame(
        cfg, intr, jnp.asarray(depth), jnp.asarray(color), 1.0,
        disp_conf=None if disp_conf is None else jnp.asarray(disp_conf))
    got = tpre.preprocess_frame(port_config(cfg), pintr, depth, color, 1.0,
                                disp_conf=disp_conf, device="cpu")
    np.testing.assert_allclose(got.confs.numpy(), np.asarray(want.confs),
                               atol=TOL)
    plain = tpre.preprocess_frame(
        port_config(cfg.replace(disable_ssim_conf=True)), pintr, depth,
        color, 1.0, device="cpu")
    assert not np.allclose(got.confs.numpy(), plain.confs.numpy())
    for name in ("points", "norms", "radii", "valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      getattr(plain, name).numpy(), name)


@pytest.mark.parametrize("method", ["super", "semantic-super"])
def test_candidate_view_rows(scene, method):
    """Fusion's view of the candidate at each surfel's pixel, from the same
    frame (the JAX package's, converted): the confidence is gathered, as
    a row before the class rows."""
    cfg, intr, pintr, depth, color = scene
    cfg = cfg.replace(method=method, num_classes=2)
    seg = (np.arange(H)[:, None] * 2 > H).astype(np.int32) + \
        np.zeros((H, W), np.int32)
    seg_conf = np.random.default_rng(2).normal(
        size=(2, H, W)).astype(np.float32)
    frame = jpre.preprocess_frame(
        cfg, intr, jnp.asarray(depth), jnp.asarray(color), 1.0,
        seg=jnp.asarray(seg), seg_conf=jnp.asarray(seg_conf))
    sf_pix = np.random.default_rng(3).integers(0, H * W, 500).astype(np.int32)
    want = jfusion._candidate_view(cfg, intr, frame, jnp.asarray(sf_pix))
    got = tfusion._candidate_view(port_config(cfg), pintr, port_frame(frame),
                                  torch.as_tensor(sf_pix))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-6, err_msg=k)
    # The gathered row is the frame's blended confidence, not the
    # centre-weighted formula.
    np.testing.assert_array_equal(got["confs"].numpy(),
                                  np.asarray(frame.confs)[sf_pix])


def test_track_with_ssim_conf():
    """3 tracked frames with the confidence on, held to the option tracks'
    bands (tests/test_torch_options_track.py)."""
    check_track(option_tracks({}, dict(disable_ssim_conf=False)))
