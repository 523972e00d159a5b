"""Stereo-training dataset index + batcher for RAFT-Stereo fine-tuning.

Parity target: the reference's stereo training data plumbing
(depth/raft_core/stereo_datasets.py -- StereoDataset and the SceneFlow /
KITTI / Middlebury / ETH3D / SintelStereo / FallingThings / TartanAir
directory readers, and fetch_dataloader).  Unused by the tracking runtime
(there, RAFT-Stereo runs inference-only with converted weights); these feed
model fine-tuning on new rigs.

A copy of super_tpu/data/stereo.py (numpy and PIL; the card machine has
both): the *index* is plain host data (lists of path triples built by
layout rules), and the batcher emits fixed-shape (B, 3, crop_h, crop_w)
numpy batches, so every training step sees one static shape.  Disparity
is returned as the reference's flow convention: one channel, sign-negated
disparity, with a validity mask.
"""

from __future__ import annotations

import glob as _glob
import os
import re
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from super_tpu_torch.data.augment import AugmentConfig, color_jitter


class StereoIndex(NamedTuple):
    """Host-side sample index: parallel path lists (left, right, disparity)."""

    left: List[str]
    right: List[str]
    disp: List[str]
    sparse: bool = False     # sparse GT (KITTI/ETH3D-style): mask from file

    def __len__(self):
        return len(self.left)

    def __add__(self, other: "StereoIndex") -> "StereoIndex":
        return StereoIndex(self.left + other.left, self.right + other.right,
                           self.disp + other.disp,
                           self.sparse or other.sparse)

    def repeat(self, k: int) -> "StereoIndex":
        return StereoIndex(self.left * k, self.right * k, self.disp * k,
                           self.sparse)


def read_pfm(path: str) -> np.ndarray:
    """Portable float map reader (SceneFlow/Middlebury disparity GT)."""
    with open(path, "rb") as f:
        header = f.readline().strip()
        if header not in (b"Pf", b"PF"):
            raise ValueError(f"not a PFM file: {path}")
        channels = 3 if header == b"PF" else 1
        dims = f.readline()
        while dims.startswith(b"#"):
            dims = f.readline()
        w, h = map(int, re.findall(rb"\d+", dims))
        scale = float(f.readline().strip())
        data = np.frombuffer(f.read(),
                             dtype="<f4" if scale < 0 else ">f4")
        img = data.reshape(h, w, channels) if channels > 1 else \
            data.reshape(h, w)
        return np.ascontiguousarray(img[::-1]).astype(np.float32)  # bottom-up


def _read_image(path: str) -> np.ndarray:
    """(H, W, 3) float32 in [0, 1]; grayscale broadcast to 3 channels."""
    from PIL import Image

    img = np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0
    return img


def read_disparity(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Disparity (H, W) + validity mask, by file type.

    Mirrors the conventions of the reference readers
    (raft_core/utils/frame_utils.py): PFM floats with non-finite/huge
    values invalid, 16-bit PNGs scaled by 1/256 with 0 = missing, npy
    depth maps passed through.
    """
    if path.endswith(".pfm"):
        d = read_pfm(path)
        if d.ndim == 3:
            d = d[..., 0]
        valid = np.isfinite(d) & (np.abs(d) < 512)
        return np.where(valid, d, 0.0).astype(np.float32), valid
    if path.endswith(".npy"):
        d = np.load(path).astype(np.float32)
        return d, np.isfinite(d) & (d > 0)
    # 16-bit PNG (KITTI/Sintel convention): value / 256, zero = invalid.
    from PIL import Image

    raw = np.asarray(Image.open(path)).astype(np.float32)
    if raw.ndim == 3:   # Sintel RGB packing: d = R*4 + G/64 + B/16384
        d = (raw[..., 0] * 4.0 + raw[..., 1] / 64.0 + raw[..., 2] / 16384.0)
        return d, (d > 0) & (d < 512)
    d = raw / 256.0
    return d, raw > 0


class LayoutRule(NamedTuple):
    """One dataset family's directory convention, as data: a glob for the
    left images plus path rewrites deriving the right image and the
    disparity GT from each left path."""

    left_glob: str
    to_right: Callable[[str], str]
    to_disp: Callable[[str], str]
    sparse: bool = False


_LAYOUTS: Dict[str, LayoutRule] = {
    # SceneFlow (FlyingThings3D/Monkaa/Driving merged): pass dstype via
    # root, e.g. root="datasets/FlyingThings3D/frames_cleanpass".
    "sceneflow": LayoutRule(
        left_glob="**/left/*.png",
        to_right=lambda p: p.replace("/left/", "/right/"),
        to_disp=lambda p: re.sub(r"/frames_(clean|final)pass/",
                                 "/disparity/", p)[:-4] + ".pfm"),
    "kitti": LayoutRule(
        left_glob="image_2/*_10.png",
        to_right=lambda p: p.replace("image_2", "image_3"),
        to_disp=lambda p: p.replace("image_2", "disp_occ_0"),
        sparse=True),
    "middlebury": LayoutRule(
        left_glob="*/im0.png",
        to_right=lambda p: p.replace("im0.png", "im1.png"),
        to_disp=lambda p: p.replace("im0.png", "disp0GT.pfm"),
        sparse=True),
    "eth3d": LayoutRule(
        left_glob="*/im0.png",
        to_right=lambda p: p.replace("im0.png", "im1.png"),
        to_disp=lambda p: p.replace("im0.png", "disp0GT.pfm"),
        sparse=True),
    "sintel_stereo": LayoutRule(
        left_glob="*_left/*/frame_*.png",
        to_right=lambda p: p.replace("_left", "_right"),
        to_disp=lambda p: re.sub(r"[^/]*_left", "disparities", p),
        sparse=True),
    "falling_things": LayoutRule(
        left_glob="**/*left.jpg",
        to_right=lambda p: p.replace("left.jpg", "right.jpg"),
        to_disp=lambda p: p.replace("left.jpg", "left.depth.png")),
    "tartan_air": LayoutRule(
        left_glob="**/image_left/*_left.png",
        to_right=lambda p: p.replace("image_left", "image_right")
        .replace("_left.png", "_right.png"),
        to_disp=lambda p: p.replace("image_left", "depth_left")
        .replace("_left.png", "_left_depth.npy")),
}


def build_index(name: str, root: str) -> StereoIndex:
    """Walk one dataset root by its family's layout rule; keep only samples
    whose right image and disparity GT actually exist on disk."""
    rule = _LAYOUTS[name]
    lefts = sorted(_glob.glob(os.path.join(root, rule.left_glob),
                              recursive=True))
    idx = StereoIndex([], [], [], rule.sparse)
    for lp in lefts:
        rp, dp = rule.to_right(lp), rule.to_disp(lp)
        if os.path.exists(rp) and os.path.exists(dp):
            idx.left.append(lp)
            idx.right.append(rp)
            idx.disp.append(dp)
    return idx


def fetch_training_index(datasets: Sequence[Tuple[str, str, int]]
                         ) -> StereoIndex:
    """Compose (family, root, repeat) triples into one training index --
    the equivalent of the reference's fetch_dataloader dataset mixing
    (stereo_datasets.py:283-316), with repeats as explicit weights."""
    total: Optional[StereoIndex] = None
    for name, root, rep in datasets:
        part = build_index(name, root).repeat(rep)
        total = part if total is None else total + part
    if total is None or len(total) == 0:
        raise ValueError("empty stereo training index")
    return total


class StereoBatch(NamedTuple):
    img1: np.ndarray    # (B, 3, ch, cw) float32 in [0, 1]
    img2: np.ndarray    # (B, 3, ch, cw)
    flow: np.ndarray    # (B, 1, ch, cw) = -disparity (reference convention)
    valid: np.ndarray   # (B, ch, cw) float32 {0, 1}


def _load_sample(idx: StereoIndex, i: int):
    img1 = _read_image(idx.left[i])
    img2 = _read_image(idx.right[i])
    disp, valid = read_disparity(idx.disp[i])
    if not idx.sparse:
        valid = valid & (np.abs(disp) < 512)
    return img1, img2, disp, valid


def iter_batches(idx: StereoIndex, batch_size: int,
                 crop: Tuple[int, int] = (320, 512), *,
                 rng: Optional[np.random.Generator] = None,
                 augment: Optional[AugmentConfig] = AugmentConfig(),
                 steps: Optional[int] = None):
    """Yield fixed-shape training batches: random crop to ``crop`` (padding
    small images), identical photometric jitter on both views, disparity
    as single-channel negated flow.  Spatial flips are NOT applied here --
    a horizontal flip breaks the stereo epipolar sign; the reference's
    y-jitter is subsumed by the random crop row offset."""
    rng = rng or np.random.default_rng(0)
    ch, cw = crop
    n = len(idx)
    step = 0
    while steps is None or step < steps:
        order = rng.permutation(n)
        for start in range(0, n - batch_size + 1, batch_size):
            b1, b2, bf, bv = [], [], [], []
            for i in order[start:start + batch_size]:
                img1, img2, disp, valid = _load_sample(idx, int(i))
                h, w = img1.shape[:2]
                ph, pw = max(0, ch - h), max(0, cw - w)
                if ph or pw:
                    pad = ((0, ph), (0, pw))
                    img1 = np.pad(img1, pad + ((0, 0),))
                    img2 = np.pad(img2, pad + ((0, 0),))
                    disp = np.pad(disp, pad)
                    valid = np.pad(valid, pad)
                    h, w = img1.shape[:2]
                y0 = int(rng.integers(0, h - ch + 1))
                x0 = int(rng.integers(0, w - cw + 1))
                sl = np.s_[y0:y0 + ch, x0:x0 + cw]
                img1, img2 = img1[sl], img2[sl]
                disp, valid = disp[sl], valid[sl]
                if augment is not None and rng.random() < augment.p_color:
                    img1 = color_jitter(rng, img1, augment)
                    img2 = color_jitter(rng, img2, augment)
                b1.append(img1.transpose(2, 0, 1))
                b2.append(img2.transpose(2, 0, 1))
                bf.append(-disp[None])
                bv.append(valid.astype(np.float32))
            yield StereoBatch(np.stack(b1), np.stack(b2), np.stack(bf),
                              np.stack(bv))
            step += 1
            if steps is not None and step >= steps:
                return
