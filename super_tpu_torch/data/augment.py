"""Train-time data augmentation (host-side numpy; a copy of
super_tpu/data/augment.py, so that one ``np.random.Generator`` seed gives
both packages the same outputs bit for bit).

Parity targets: the reference's training augmentations -- color jitter /
horizontal + vertical flips / stereo side swap gated by phase=='train'
(utils/data_loader.py:94-147) and the RAFT augmentor's photometric +
spatial transforms (depth/raft_core/utils/augmentor.py).  The tracking
pipeline itself never augments (phase=='test'); these feed model
fine-tuning on new rigs.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np


class AugmentConfig(NamedTuple):
    brightness: Tuple[float, float] = (0.8, 1.2)
    contrast: Tuple[float, float] = (0.8, 1.2)
    saturation: Tuple[float, float] = (0.8, 1.2)
    hue: Tuple[float, float] = (-0.1, 0.1)
    p_color: float = 0.5
    p_hflip: float = 0.5
    p_vflip: float = 0.5
    p_side_swap: float = 0.5


def color_jitter(rng: np.random.Generator, img: np.ndarray,
                 cfg: AugmentConfig = AugmentConfig()) -> np.ndarray:
    """Brightness/contrast/saturation/hue jitter on (H, W, 3) in [0, 1]."""
    out = img.astype(np.float32).copy()
    out *= rng.uniform(*cfg.brightness)
    mean = out.mean()
    out = (out - mean) * rng.uniform(*cfg.contrast) + mean
    gray = out.mean(axis=-1, keepdims=True)
    out = (out - gray) * rng.uniform(*cfg.saturation) + gray
    # Hue: rotate chroma around the gray axis (small-angle approximation of
    # an HSV hue shift).
    theta = rng.uniform(*cfg.hue) * 2 * np.pi
    u = np.array([1.0, 1.0, 1.0]) / np.sqrt(3)
    k = np.array([[0, -u[2], u[1]], [u[2], 0, -u[0]], [-u[1], u[0], 0]])
    rot = np.eye(3) + np.sin(theta) * k + (1 - np.cos(theta)) * (k @ k)
    out = out @ rot.T.astype(np.float32)
    return np.clip(out, 0.0, 1.0).astype(np.float32)


def augment_stereo_frame(
    rng: np.random.Generator,
    left: np.ndarray,            # (H, W, 3)
    right: Optional[np.ndarray],
    depth: Optional[np.ndarray],  # (H, W)
    cfg: AugmentConfig = AugmentConfig(),
):
    """One training sample's augmentation (data_loader.py:94-153 semantics):
    optional side swap, color jitter applied identically to both views,
    horizontal flip (which also swaps+mirrors the stereo pair), vertical
    flip.  Depth follows the spatial transforms."""
    if right is not None and rng.random() < cfg.p_side_swap:
        left, right = right, left
    if rng.random() < cfg.p_color:
        # The same jitter parameters must hit both views: reuse one rng
        # state snapshot.
        state = rng.bit_generator.state
        left = color_jitter(rng, left, cfg)
        if right is not None:
            rng.bit_generator.state = state
            right = color_jitter(rng, right, cfg)
    if rng.random() < cfg.p_hflip:
        left = left[:, ::-1]
        right = right[:, ::-1] if right is not None else None
        if right is not None:
            left, right = right, left  # mirrored stereo swaps eyes
        depth = depth[:, ::-1] if depth is not None else None
    if rng.random() < cfg.p_vflip:
        left = left[::-1]
        right = right[::-1] if right is not None else None
        depth = depth[::-1] if depth is not None else None
    return left, right, depth
