"""Synthetic deforming-surface sequences with exact tracking ground truth
(numpy-only copy of super_tpu/data/synthetic.py: same arrays for the same
seed).

The reference is evaluated on endoscopic stereo trials with a 20-point GT
file (README.md:179-199); those datasets are not redistributable, so tests
and benches here use a procedurally deformed surface:

  rest surface:   z = f(x, y)       (time-independent height field, ~0.5 m)
  deformation:    D_t(p) = p + [dx, dy, dz](p, t), smooth in material
                  coordinates, D_0 = identity.

The depth map at time t is the rendering of { D_t(p) : p on the rest
surface }, obtained by per-pixel fixed-point inversion of the (small,
smooth) deformation -- so depth sequences and GT trajectories are
*consistent by construction* and the tracker's reprojection error against
the GT is a real accuracy metric.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from super_tpu_torch.geometry.camera import Intrinsics


class SyntheticSequence(NamedTuple):
    depths: np.ndarray       # (T, H, W) float32
    colors: np.ndarray       # (T, H, W, 3) float32
    gt_xy: np.ndarray        # (T, P, 2) float32 GT screen coords of tracked pts
    gt_valid: np.ndarray     # (T, P) bool
    track0_xy: np.ndarray    # (P, 2) int tracked pixels at frame 0
    segs: np.ndarray = None       # (T, H, W) int32 class labels (material-tied)
    seg_confs: np.ndarray = None  # (T, C, H, W) float32 class scores


_A = 0.0015   # lateral drift per frame (m)
_W = 0.0010   # non-rigid warp amplitude (m)


def _rest_z(x, y, base=0.55, amp=0.02):
    """Time-independent height field: broad folds + fine wrinkle relief.

    The fine detail matters for evaluation realism: point-to-plane ICP only
    constrains motion along surface normals, so a surface with no
    small-scale relief leaves lateral motion unobservable (as it is for
    any geometry-only tracker, including the reference)."""
    return (base
            + amp * np.sin(6.0 * x) * np.cos(5.0 * y)
            + 0.5 * amp * np.sin(9.0 * y)
            + 0.25 * amp * np.sin(31.0 * x + 2.0) * np.cos(27.0 * y)
            + 0.15 * amp * np.sin(53.0 * x) * np.sin(47.0 * y + 1.0)
            + 0.1 * amp * np.cos(89.0 * x + 71.0 * y))


def _disp(x0, y0, t):
    """Material displacement field [dx, dy, dz](material coords, t);
    zero at t = 0."""
    dx = _A * t + _W * np.sin(8.0 * y0 + 3.0 * x0) * np.sin(0.5 * t)
    dy = 0.5 * _A * t + _W * np.cos(7.0 * x0) * np.sin(0.4 * t)
    dz = 0.3 * _A * t * np.sin(4.0 * x0) + _W * np.sin(5.0 * y0) * np.sin(0.35 * t)
    return dx, dy, dz


def _deform(points, t):
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    dx, dy, dz = _disp(x, y, t)
    return np.stack([x + dx, y + dy, z + dz], axis=-1)


def generate(num_frames: int, height: int, width: int,
             intr: Intrinsics = None, num_track: int = 20,
             seed: int = 0, num_classes: int = 0,
             variant: str = "clean") -> SyntheticSequence:
    """When num_classes > 0, also emit material-tied semantic labels (regions
    move with the surface, like tissue classes in Semantic-SuPer).

    ``variant`` hardens the scene toward real endoscopic conditions
    (SURVEY section 6 workload anchors; the clean scene is too easy to
    defend accuracy claims on):
      - "clean":     exact rendering (default).
      - "occlusion": a foreground tool-like disk sweeps the view; depth and
                     color are replaced, occluded GT points marked invalid.
      - "noise":     depth-dependent Gaussian depth noise + dropout holes
                     (NaN), like stereo-matching failures.
      - "specular":  saturated moving highlights with blown-out depth (NaN
                     cores), like wet-tissue specularities.
      - "hard":      all three combined.
    """
    if intr is None:
        fx = fy = 500.0
        cx, cy = width / 2 - 0.37, height / 2 + 0.21  # off-integer principal pt
    else:
        fx, fy = float(intr.fx), float(intr.fy)
        cx, cy = float(intr.cx), float(intr.cy)
    rng = np.random.default_rng(seed)

    uu, vv = np.meshgrid(np.arange(width, dtype=np.float64),
                         np.arange(height, dtype=np.float64))

    def material_coords_and_depth(t):
        """Fixed-point solve: pixel ray -> material point on rest surface."""
        z = np.full((height, width), 0.55)
        x0 = (uu - cx) * z / fx
        y0 = (vv - cy) * z / fy
        for _ in range(10):
            x_def = (uu - cx) * z / fx   # deformed-frame lateral coords
            y_def = (vv - cy) * z / fy
            for _ in range(3):           # invert the lateral displacement
                dx, dy, _ = _disp(x0, y0, t)
                x0 = x_def - dx
                y0 = y_def - dy
            _, _, dz = _disp(x0, y0, t)
            z = _rest_z(x0, y0) + dz
        return x0, y0, z

    def color_from_material(x0, y0):
        r = 0.5 + 0.5 * np.sin(40 * x0) * np.cos(37 * y0)
        g = 0.5 + 0.5 * np.cos(23 * x0 + 31 * y0)
        b = 0.5 + 0.3 * np.sin(17 * (x0 + y0))
        return np.stack([r, g, b], axis=-1).astype(np.float32)

    # Tracked material points: random interior pixels at t=0.
    margin = min(40, width // 4, height // 4)
    tx = rng.integers(margin, width - margin, size=num_track)
    ty = rng.integers(margin, height - margin, size=num_track)
    x0g, y0g, z0g = material_coords_and_depth(0.0)
    px0 = np.stack([x0g[ty, tx], y0g[ty, tx],
                    _rest_z(x0g[ty, tx], y0g[ty, tx])], axis=-1)

    def seg_from_material(x0, y0):
        """Smooth material-tied class field -> labels + soft confidences."""
        score = np.sin(14.0 * x0 + 9.0 * y0) + 0.6 * np.cos(11.0 * y0)
        if num_classes == 2:
            logits = np.stack([score, -score]) * 4.0
        else:
            s2 = np.cos(13.0 * x0 - 7.0 * y0)
            logits = np.stack([score, -score + s2, -s2 - 0.2]) * 4.0
            logits = logits[:num_classes]
        e = np.exp(logits - logits.max(0, keepdims=True))
        conf = e / e.sum(0, keepdims=True)
        return conf.argmax(0).astype(np.int32), conf.astype(np.float32)

    occlude = variant in ("occlusion", "hard")
    noisy = variant in ("noise", "hard")
    specular = variant in ("specular", "hard")

    def occluder_center(t):
        """Foreground disk center (pixels): sweeps across the view."""
        cu = width * (0.15 + 0.35 * (1.0 + np.sin(0.11 * t + 1.0)))
        cv = height * (0.25 + 0.25 * (1.0 + np.sin(0.07 * t)))
        return cu, cv

    occ_r = 0.11 * min(height, width)
    occ_z = 0.32  # well in front of the ~0.55 m surface

    def spec_centers(t):
        """Two drifting specular highlight centers (pixels)."""
        return [
            (width * (0.5 + 0.3 * np.sin(0.23 * t)),
             height * (0.5 + 0.3 * np.cos(0.19 * t))),
            (width * (0.5 + 0.35 * np.cos(0.13 * t + 2.0)),
             height * (0.5 + 0.25 * np.sin(0.29 * t + 1.0))),
        ]

    spec_r = 0.045 * min(height, width)

    depths, colors, gts, gtv, segs, confs = [], [], [], [], [], []
    for t in range(num_frames):
        x0, y0, z = material_coords_and_depth(float(t))
        col = color_from_material(x0, y0)
        if specular:
            for (su, sv) in spec_centers(float(t)):
                r2 = (uu - su) ** 2 + (vv - sv) ** 2
                glow = np.exp(-0.5 * r2 / spec_r ** 2)
                col = col + (1.0 - col) * np.minimum(
                    2.0 * glow, 1.0)[..., None].astype(np.float32)
                z = np.where(r2 < (0.6 * spec_r) ** 2, np.nan, z)  # blown core
        if noisy:
            z = z + rng.normal(0.0, 8e-4, z.shape) * (z / 0.55) ** 2
            z = np.where(rng.random(z.shape) < 0.01, np.nan, z)  # dropout
        if occlude:
            cu, cv = occluder_center(float(t))
            occ = (uu - cu) ** 2 + (vv - cv) ** 2 < occ_r ** 2
            z = np.where(occ, occ_z, z)
            col = np.where(occ[..., None], np.float32(0.35), col)
        depths.append(z.astype(np.float32))
        colors.append(np.clip(col, 0.0, 1.0).astype(np.float32))
        if num_classes > 0:
            s, cmap = seg_from_material(x0, y0)
            segs.append(s)
            confs.append(cmap)
        pt = _deform(px0, float(t))
        gu = pt[:, 0] * fx / pt[:, 2] + cx
        gv = pt[:, 1] * fy / pt[:, 2] + cy
        gts.append(np.stack([gu, gv], axis=-1).astype(np.float32))
        gv_ok = (gu > 1) & (gu < width - 2) & (gv > 1) & (gv < height - 2)
        if occlude:
            cu, cv = occluder_center(float(t))
            gv_ok &= (gu - cu) ** 2 + (gv - cv) ** 2 > (occ_r + 2.0) ** 2
        gtv.append(gv_ok)

    return SyntheticSequence(
        depths=np.stack(depths),
        colors=np.stack(colors),
        gt_xy=np.stack(gts),
        gt_valid=np.stack(gtv),
        track0_xy=np.stack([tx, ty], axis=-1).astype(np.int32),
        segs=np.stack(segs) if segs else None,
        seg_confs=np.stack(confs) if confs else None,
    )


def default_intrinsics(height: int, width: int, device="cuda") -> Intrinsics:
    return Intrinsics.make(500.0, 500.0, width / 2 - 0.37, height / 2 + 0.21,
                           device=device)
