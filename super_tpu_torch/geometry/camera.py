"""Pinhole projection / backprojection (counterpart of
super_tpu/geometry/camera.py)."""

from __future__ import annotations

from typing import NamedTuple

import torch


class Intrinsics(NamedTuple):
    """Pinhole intrinsics as 0-d float32 tensors on the compute device."""

    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor

    @classmethod
    def make(cls, fx, fy, cx, cy, device="cuda"):
        """From four numbers; each is rounded to float32 as in the JAX
        package's ``Intrinsics`` (f32 scalar arrays)."""
        f = lambda x: torch.tensor(x, dtype=torch.float32,  # noqa: E731
                                   device=device)
        return cls(fx=f(fx), fy=f(fy), cx=f(cx), cy=f(cy))

    @classmethod
    def from_matrix(cls, k, device="cuda"):
        """From a (3, 3) or (4, 4) K matrix (the reference's layout):
        fx = K[0, 0], fy = K[1, 1], cx = K[0, 2], cy = K[1, 2]."""
        k = torch.as_tensor(k, dtype=torch.float64)
        return cls.make(float(k[0, 0]), float(k[1, 1]), float(k[0, 2]),
                        float(k[1, 2]), device=device)

    @classmethod
    def superv1(cls, device="cuda"):
        """The SuPer-V1 trials' fixed intrinsics."""
        return cls.from_matrix([[883.0, 0.0, 445.06], [0.0, 883.0, 190.24],
                                [0.0, 0.0, 1.0]], device=device)

    @classmethod
    def superv2(cls, device="cuda"):
        """The SuPer-V2 (Semantic-SuPer) trials' fixed intrinsics."""
        return cls.from_matrix([[768.98551924, 0.0, 292.8861567],
                                [0.0, 768.98551924, 291.61479526],
                                [0.0, 0.0, 1.0]], device=device)


def project_points(points, intr: Intrinsics, height: int, width: int,
                   valid_margin: int = 0):
    """Project feature-major (3, ...) camera points.

    Returns (v, u, coords, valid) with ``coords = round(v) * W + round(u)``
    (round half to even) and the margin test on the rounded coordinates.
    """
    x, y, z = points[0], points[1], points[2] + 1e-8
    u = x * intr.fx / z + intr.cx
    v = y * intr.fy / z + intr.cy
    ui = torch.round(u).to(torch.int32)
    vi = torch.round(v).to(torch.int32)
    coords = vi * width + ui
    valid = ((vi >= valid_margin) & (vi < height - 1 - valid_margin)
             & (ui >= valid_margin) & (ui < width - 1 - valid_margin))
    return v, u, coords, valid


def pixel_grid(height: int, width: int, device, dtype=torch.float32):
    """(u, v) pixel-coordinate grids, each (H, W)."""
    u = torch.arange(width, dtype=dtype, device=device)
    v = torch.arange(height, dtype=dtype, device=device)
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    return uu, vv


def backproject_depth(depth, intr: Intrinsics):
    """Depth (H, W) -> feature-major camera points (3, H, W)."""
    h, w = depth.shape[-2], depth.shape[-1]
    uu, vv = pixel_grid(h, w, depth.device, dtype=depth.dtype)
    x = (uu - intr.cx) * depth / intr.fx
    y = (vv - intr.cy) * depth / intr.fy
    return torch.stack([x, y, depth], dim=0)


def warp_stereo_coords(points_h, intr: Intrinsics, baseline_tx, height: int,
                       width: int, eps: float = 1e-7):
    """Camera points (3, H, W) shifted along x by the stereo baseline and
    projected: the (H, W, 2) sampling grid (x, y) normalised to [-1, 1]
    (monodepth2's ``Project3D`` with a pure x translation)."""
    x = points_h[0] + baseline_tx
    y = points_h[1]
    z = points_h[2] + eps
    u = x * intr.fx / z + intr.cx
    v = y * intr.fy / z + intr.cy
    gx = u / (width - 1) * 2.0 - 1.0
    gy = v / (height - 1) * 2.0 - 1.0
    return torch.stack([gx, gy], dim=-1)
