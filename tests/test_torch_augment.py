"""The port's augmentation (data/augment.py, a numpy copy) against the
JAX package's: tests/test_augment.py's checks on the port, and one
``np.random.Generator`` seed giving both packages bitwise the same
outputs."""

import numpy as np
import pytest

from super_tpu.data import augment as jaug
from super_tpu_torch.data.augment import (AugmentConfig,
                                          augment_stereo_frame,
                                          color_jitter)


def test_color_jitter_bounds(rng):
    img = rng.uniform(size=(16, 24, 3)).astype(np.float32)
    out = color_jitter(rng, img)
    assert out.shape == img.shape
    assert out.min() >= 0.0 and out.max() <= 1.0
    assert not np.allclose(out, img)


def test_augment_stereo_identical_jitter(rng):
    cfg = AugmentConfig(p_color=1.0, p_hflip=0.0, p_vflip=0.0,
                        p_side_swap=0.0)
    img = rng.uniform(size=(16, 24, 3)).astype(np.float32)
    l, r, d = augment_stereo_frame(rng, img.copy(), img.copy(),
                                   np.ones((16, 24), np.float32), cfg)
    np.testing.assert_allclose(l, r, atol=1e-6)


def test_augment_flips_depth(rng):
    cfg = AugmentConfig(p_color=0.0, p_hflip=1.0, p_vflip=0.0,
                        p_side_swap=0.0)
    depth = np.arange(12, dtype=np.float32).reshape(3, 4)
    img = np.zeros((3, 4, 3), np.float32)
    _, _, d = augment_stereo_frame(rng, img, None, depth, cfg)
    np.testing.assert_array_equal(d, depth[:, ::-1])


@pytest.mark.parametrize("seed", range(6))
def test_same_seed_same_outputs(seed):
    """Stereo pairs with depth through both packages' augment_stereo_frame
    (every branch at p = 0.5, so the seeds cover swaps, jitter and both
    flips), and color_jitter alone: bitwise equal."""
    data = np.random.default_rng(100 + seed)
    left = data.uniform(size=(12, 20, 3)).astype(np.float32)
    right = data.uniform(size=(12, 20, 3)).astype(np.float32)
    depth = data.uniform(0.3, 1.0, (12, 20)).astype(np.float32)
    outs = []
    for mod in (jaug, None):
        rng = np.random.default_rng(seed)
        if mod is None:
            outs.append((augment_stereo_frame(rng, left, right, depth),
                         color_jitter(rng, left)))
        else:
            outs.append((mod.augment_stereo_frame(rng, left, right, depth),
                         mod.color_jitter(rng, left)))
    (want, want_j), (got, got_j) = outs
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got_j, want_j)
