"""The benchmark's clip: a deforming surface with exact ground truth, made on
the device in PyTorch.

A copy of the port's ``data/synthetic.py`` (same surface, deformation,
colours, classes and variants), rewritten so that a 480 x 640 clip is made
on the card in well under a second; the numpy original takes seconds a
frame.  Everything runs in float64, as numpy does, and is rounded to
float32 at the end.  Two things differ from the original, both chosen by
the caller: the clip starts at time ``t0`` of the deformation (the original
starts at 0), and the tracked pixels are given (the original draws them).
The noise variants draw from a ``torch.Generator``, not from numpy.

  rest surface:   z = f(x, y)
  deformation:    D_t(p) = p + [dx, dy, dz](p, t), D_0 = identity
  depth at t:     per-pixel fixed-point inversion of D_t
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

A = 0.0015   # lateral drift per unit of time (m)
W = 0.0010   # non-rigid warp amplitude (m)
VARIANTS = ("clean", "occlusion", "noise", "specular", "hard")


class Clip(NamedTuple):
    depths: torch.Tensor     # (T, H, W) float32
    colors: torch.Tensor     # (T, H, W, 3) float32
    gt_xy: torch.Tensor      # (T, P, 2) float32
    gt_valid: torch.Tensor   # (T, P) bool
    segs: Optional[torch.Tensor]       # (T, H, W) int32
    seg_confs: Optional[torch.Tensor]  # (T, C, H, W) float32


def intrinsics(height: int, width: int):
    """(fx, fy, cx, cy) of the generator's camera."""
    return 500.0, 500.0, width / 2 - 0.37, height / 2 + 0.21


def rest_z(x, y, base=0.55, amp=0.02):
    return (base
            + amp * torch.sin(6.0 * x) * torch.cos(5.0 * y)
            + 0.5 * amp * torch.sin(9.0 * y)
            + 0.25 * amp * torch.sin(31.0 * x + 2.0) * torch.cos(27.0 * y)
            + 0.15 * amp * torch.sin(53.0 * x) * torch.sin(47.0 * y + 1.0)
            + 0.1 * amp * torch.cos(89.0 * x + 71.0 * y))


def disp(x0, y0, t):
    """Material displacement [dx, dy, dz] at material coords and time t
    (a number or a tensor broadcast against the coords)."""
    dx = A * t + W * torch.sin(8.0 * y0 + 3.0 * x0) * _sin(0.5 * t)
    dy = 0.5 * A * t + W * torch.cos(7.0 * x0) * _sin(0.4 * t)
    dz = 0.3 * A * t * torch.sin(4.0 * x0) + W * torch.sin(5.0 * y0) * \
        _sin(0.35 * t)
    return dx, dy, dz


def _sin(x):
    return torch.sin(x) if isinstance(x, torch.Tensor) else np.sin(x)


def make_clip(height: int, width: int, num_frames: int, t0: float,
              track_xy, num_classes: int = 0, variant: str = "clean",
              device="cuda", noise_seed: int = 0) -> Clip:
    """Frames at times ``t0 + k``, k < ``num_frames``, with the material
    points under pixels ``track_xy`` (P, 2) int (x, y) at time ``t0`` as
    the tracked points."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
    f64 = torch.float64
    fx, fy, cx, cy = intrinsics(height, width)
    times = t0 + torch.arange(num_frames, dtype=f64, device=device)
    tt = times[:, None, None]
    uu = torch.arange(width, dtype=f64, device=device)[None, None, :]
    vv = torch.arange(height, dtype=f64, device=device)[None, :, None]

    def material_coords_and_depth(t, u, v):
        z = torch.full(torch.broadcast_shapes(t.shape, u.shape, v.shape),
                       0.55, dtype=f64, device=device)
        x0 = (u - cx) * z / fx
        y0 = (v - cy) * z / fy
        for _ in range(10):
            x_def = (u - cx) * z / fx
            y_def = (v - cy) * z / fy
            for _ in range(3):
                dx, dy, _ = disp(x0, y0, t)
                x0 = x_def - dx
                y0 = y_def - dy
            _, _, dz = disp(x0, y0, t)
            z = rest_z(x0, y0) + dz
        return x0, y0, z

    x0, y0, z = material_coords_and_depth(tt, uu, vv)       # (T, H, W)
    col = torch.stack([
        0.5 + 0.5 * torch.sin(40 * x0) * torch.cos(37 * y0),
        0.5 + 0.5 * torch.cos(23 * x0 + 31 * y0),
        0.5 + 0.3 * torch.sin(17 * (x0 + y0))], dim=-1).float()

    track = torch.as_tensor(np.asarray(track_xy), device=device).long()
    tx, ty = track[:, 0], track[:, 1]
    t0v = torch.full((1,), float(t0), dtype=f64, device=device)
    xg, yg, _ = material_coords_and_depth(t0v, tx.to(f64), ty.to(f64))
    px0 = torch.stack([xg, yg, rest_z(xg, yg)], dim=-1)     # (P, 3)

    occlude = variant in ("occlusion", "hard")
    noisy = variant in ("noise", "hard")
    specular = variant in ("specular", "hard")
    tau = times[:, None, None]
    if specular:
        spec_r = 0.045 * min(height, width)
        centers = [
            (width * (0.5 + 0.3 * torch.sin(0.23 * tau)),
             height * (0.5 + 0.3 * torch.cos(0.19 * tau))),
            (width * (0.5 + 0.35 * torch.cos(0.13 * tau + 2.0)),
             height * (0.5 + 0.25 * torch.sin(0.29 * tau + 1.0)))]
        for su, sv in centers:
            r2 = (uu - su) ** 2 + (vv - sv) ** 2
            glow = torch.exp(-0.5 * r2 / spec_r ** 2)
            col = col + (1.0 - col) * torch.clamp(2.0 * glow, max=1.0)[
                ..., None].float()
            z = torch.where(r2 < (0.6 * spec_r) ** 2, float("nan"), z)
    if noisy:
        gen = torch.Generator(device=device)
        gen.manual_seed(noise_seed)
        z = z + torch.randn(z.shape, generator=gen, dtype=f64,
                            device=device) * 8e-4 * (z / 0.55) ** 2
        z = torch.where(torch.rand(z.shape, generator=gen, dtype=f64,
                                   device=device) < 0.01, float("nan"), z)
    occ_r = 0.11 * min(height, width)
    if occlude:
        cu = width * (0.15 + 0.35 * (1.0 + torch.sin(0.11 * tau + 1.0)))
        cv = height * (0.25 + 0.25 * (1.0 + torch.sin(0.07 * tau)))
        occ = (uu - cu) ** 2 + (vv - cv) ** 2 < occ_r ** 2
        z = torch.where(occ, 0.32, z)
        col = torch.where(occ[..., None], 0.35, col)

    segs = confs = None
    if num_classes > 0:
        score = torch.sin(14.0 * x0 + 9.0 * y0) + 0.6 * torch.cos(11.0 * y0)
        if num_classes == 2:
            logits = torch.stack([score, -score], dim=1) * 4.0
        else:
            s2 = torch.cos(13.0 * x0 - 7.0 * y0)
            logits = torch.stack([score, -score + s2, -s2 - 0.2],
                                 dim=1)[:, :num_classes] * 4.0
        conf = torch.softmax(logits, dim=1)
        segs = torch.argmax(conf, dim=1).to(torch.int32)
        confs = conf.float()

    d = (px0[None] + torch.stack(disp(px0[None, :, 0], px0[None, :, 1],
                                      times[:, None]), dim=-1))
    gu = d[..., 0] * fx / d[..., 2] + cx
    gv = d[..., 1] * fy / d[..., 2] + cy
    gt_xy = torch.stack([gu, gv], dim=-1).float()
    ok = (gu > 1) & (gu < width - 2) & (gv > 1) & (gv < height - 2)
    if occlude:
        cu = width * (0.15 + 0.35 * (1.0 + torch.sin(0.11 * times + 1.0)))
        cv = height * (0.25 + 0.25 * (1.0 + torch.sin(0.07 * times)))
        ok &= (gu - cu[:, None]) ** 2 + (gv - cv[:, None]) ** 2 > \
            (occ_r + 2.0) ** 2
    return Clip(depths=z.float(), colors=torch.clamp(col, 0.0, 1.0),
                gt_xy=gt_xy, gt_valid=ok, segs=segs, seg_confs=confs)
