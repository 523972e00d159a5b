"""Surfel splatting renderers (counterpart of super_tpu/render/splat.py).

:func:`render_zbuffer` is the hard nearest-depth splat of the logger's
images.  The nearest depth of each pixel is a scatter-min, which no order
changes.  Its winners are the surfels at that depth; where two of them
share a pixel at equal depth the JAX package's colour write
(``.at[].set``) leaves the order to XLA, which on the CPU applies the
updates in order, so the last slot wins.  The port defines that winner
(a CUDA scatter with repeated indices would not): a scatter-max of the
winners' slot ids picks each pixel's highest slot, whose colour is then
gathered.

:func:`render_soft` is the differentiable splat of the render loss.
Each surfel deposits ``w = bilinear(u, v) * exp(-(z - z_min) / (gamma
|z_min|))`` into its 4 neighbouring pixels; the image is the
weight-normalised colour blend over the background.  The per-pixel depth
minimum is a scatter-min of detached depths, which no order changes.  The
weight and colour sums add into shared pixels, so they go through the
fixed-order segment sum (:func:`kernels.segsum.segment_reduce`) under a
plan made at each call, since the pixels move with the points; the
backward pass of those sums gathers.
"""

from __future__ import annotations

import torch

from super_tpu_torch.geometry.camera import Intrinsics, project_points
from super_tpu_torch.kernels.segsum import segment_plan, segment_reduce
from super_tpu_torch.ops.bilinear import hinge, tent


def render_zbuffer(points, colors, mask, intr: Intrinsics, height: int,
                   width: int, bg_color: float = 0.0):
    """(3, H, W) hard z-buffer splat of surfels ``points`` (3, N) with
    ``colors`` (3, N) where ``mask`` (N,): each pixel the colour of its
    nearest surfel, of the highest slot among equals."""
    p = height * width
    n = points.shape[1]
    _, _, coords, valid = project_points(points, intr, height, width)
    valid = valid & mask
    inf = torch.full((), float("inf"), dtype=points.dtype,
                     device=points.device)
    z = torch.where(valid, points[2], inf)
    pix = torch.where(valid, coords, p).long()
    zbuf = torch.full((p + 1,), float("inf"), dtype=points.dtype,
                      device=points.device).scatter_reduce(0, pix, z, "amin")
    win = valid & (z <= zbuf[pix])
    slot = torch.arange(n, device=points.device)
    owner = torch.full((p + 1,), -1, dtype=torch.long,
                       device=points.device).scatter_reduce(
        0, torch.where(win, pix, p), torch.where(win, slot, -1), "amax")[:p]
    img = torch.where(owner >= 0, colors[:, owner.clamp(min=0)],
                      torch.full((), bg_color, dtype=colors.dtype,
                                 device=colors.device))
    return img.reshape(3, height, width)


def render_soft(points, colors, mask, intr: Intrinsics, height: int,
                width: int, gamma: float = 1e-2, bg_color: float = 0.0):
    """(3, H, W) render of surfels ``points`` (3, N) with ``colors`` (3, N)
    where ``mask`` (N,); differentiable in the points and the colours."""
    p = height * width
    v, u, _, _ = project_points(points, intr, height, width)
    z = points[2]
    fl_v = torch.floor(v)
    fl_u = torch.floor(u)
    n_blk = torch.stack([fl_v, fl_v, fl_v + 1, fl_v + 1])     # (4, N)
    m_blk = torch.stack([fl_u, fl_u + 1, fl_u, fl_u + 1])
    wn = tent(n_blk - v[None])
    wm = tent(m_blk - u[None])
    in_b = ((n_blk >= 0) & (n_blk < height) & (m_blk >= 0)
            & (m_blk < width) & mask[None])
    ni = torch.nan_to_num(n_blk, nan=0.0).clamp(0, height - 1).long()
    mi = torch.nan_to_num(m_blk, nan=0.0).clamp(0, width - 1).long()
    cpix = torch.where(in_b, ni * width + mi, p).reshape(-1)  # (4N,)

    # Per-pixel nearest depth (detached) for the exponential weights.
    inf = torch.full((), float("inf"), dtype=points.dtype,
                     device=points.device)
    zd = torch.where(in_b, z.detach()[None], inf).reshape(-1)
    zbuf = torch.full((p + 1,), float("inf"), dtype=points.dtype,
                      device=points.device).scatter_reduce(0, cpix, zd,
                                                           "amin")
    zmin = zbuf[cpix].reshape(in_b.shape)                    # (4, N)
    scale = gamma * torch.clamp(torch.abs(zmin), min=1e-6)
    # The nearest surfel of a pixel sits on the kink (z == zmin): hinge's
    # gradient there, as the JAX package's.
    wdepth = torch.exp(-hinge(z[None] - zmin) / scale)
    wfull = torch.where(in_b, wn * wm * wdepth, 0.0).to(colors.dtype)

    # Rows [w, w r, w g, w b] of every (corner, surfel), summed per pixel.
    rows = torch.cat([wfull[:, None], wfull[:, None] * colors[None]], dim=1)
    sums = segment_reduce(rows.permute(0, 2, 1).reshape(-1, 4),
                          segment_plan(cpix, p + 1))          # (p + 1, 4)
    den = sums[:p, 0]
    img = sums[:p, 1:].T / torch.clamp(den, min=1e-8)[None]
    # One surfel on a pixel centre deposits exactly 1: the clip takes the
    # JAX package's half gradient at its bounds.
    alpha = torch.minimum(torch.maximum(den, den.new_zeros(())),
                          den.new_ones(()))
    img = img * alpha[None] + bg_color * (1.0 - alpha[None])
    return img.reshape(3, height, width)
