"""Bilinear sampling of the per-pixel corner bank (counterpart of the z-bank
functions of super_tpu/ops/bilinear.py).

The bank holds, per pixel, [z, nx, ny, nz] of its four bilinear corners
(16, H*W).  The sampler rebuilds each corner's x and y from its pixel
coordinate and z with the backprojection's formula; corner validity is a
unit normal (invalid corners carry a zero normal).
"""

from __future__ import annotations

import torch

_CORNERS = ((0, 0), (0, 1), (1, 0), (1, 1))


def build_corner_bank_z(points_fm, norms_fm, index_map):
    """(16, H*W): per pixel, [z, n(3)] at (y, x), (y, x+1), (y+1, x) and
    (y+1, x+1), zeroed where the corner is invalid or off the image."""
    h, w = index_map.shape
    valid = index_map >= 0
    zrow = torch.where(valid, points_fm.reshape(3, h, w)[2], 0.0)[None]
    nms = torch.where(valid[None], norms_fm.reshape(3, h, w), 0.0)
    base = torch.cat([zrow, nms], dim=0)                  # (4, h, w)
    right = torch.zeros_like(base)
    right[:, :, :-1] = base[:, :, 1:]
    down = torch.zeros_like(base)
    down[:, :-1, :] = base[:, 1:, :]
    downright = torch.zeros_like(base)
    downright[:, :, :-1] = down[:, :, 1:]
    return torch.cat([base, right, down, downright], dim=0).reshape(16, h * w)


def _zbank_corners(bank, intr, h, w, v, u):
    """Gather the bank at floor(v, u) and rebuild each corner's point."""
    fl_v = torch.floor(v)
    fl_u = torch.floor(u)
    # Clamp in float before the cast, so NaN and huge values index safely.
    vi = torch.clamp(torch.nan_to_num(fl_v, nan=-1.0), 0, h - 1).long()
    ui = torch.clamp(torch.nan_to_num(fl_u, nan=-1.0), 0, w - 1).long()
    g = bank[:, vi * w + ui]                              # (16, N)
    corners = []
    for j, (jn, jm) in enumerate(_CORNERS):
        blk = g[4 * j:4 * j + 4]
        z = blk[0]
        n = blk[1:4]
        c_ok = torch.sum(n * n, dim=0) > 0.5
        x = (fl_u + jm - intr.cx) * z / intr.fx
        y = (fl_v + jn - intr.cy) * z / intr.fy
        corners.append(((jn, jm), torch.stack([x, y, z]), n, c_ok))
    return corners, fl_v, fl_u


def bilinear_sample_bank_z_fm(bank, intr, h: int, w: int, v, u, *,
                              compute_grad=False):
    """Feature-major sample at (v, u): (o (3, N), n (3, N), ok (N,)), plus
    the sampling gradients (go_u, go_v, gn_u, gn_v) with ``compute_grad``.
    ``ok`` needs all four corners in the image and valid."""
    corners, fl_v, fl_u = _zbank_corners(bank, intr, h, w, v, u)
    dn = (fl_v - v, fl_v + 1.0 - v)
    dm = (fl_u - u, fl_u + 1.0 - u)
    wn = tuple(torch.clamp(1.0 - torch.abs(x), min=0.0) for x in dn)
    wm = tuple(torch.clamp(1.0 - torch.abs(x), min=0.0) for x in dm)
    # The JAX package tests the int-cast corners; on floats this is the same
    # test for every finite coordinate and false for NaN.
    ok = (fl_v >= 0) & (fl_v + 1 < h) & (fl_u >= 0) & (fl_u + 1 < w)
    va = 0.0
    vb = 0.0
    if compute_grad:
        sn = tuple(torch.where(x >= 0, 1.0, -1.0) for x in dn)
        sm = tuple(torch.where(x >= 0, 1.0, -1.0) for x in dm)
        ga_u = ga_v = gb_u = gb_v = 0.0
    for (jn, jm), o, n, c_ok in corners:
        ok = ok & c_ok
        wc = (wn[jn] * wm[jm])[None]
        va = va + wc * o
        vb = vb + wc * n
        if compute_grad:
            wu = (wn[jn] * sm[jm])[None]
            wv = (wm[jm] * sn[jn])[None]
            ga_u = ga_u + wu * o
            ga_v = ga_v + wv * o
            gb_u = gb_u + wu * n
            gb_v = gb_v + wv * n
    if not compute_grad:
        return va, vb, ok
    return va, vb, ok, ga_u, ga_v, gb_u, gb_v


def bilinear_sample_bank_z(bank, intr, h: int, w: int, v, u, *,
                           compute_grad=False):
    """Row-major form: ((N, 3) points, (N, 3) norms, ok, grad_a (N, 3, 2),
    grad_b (N, 3, 2)); the gradients are None without ``compute_grad``."""
    out = bilinear_sample_bank_z_fm(bank, intr, h, w, v, u,
                                    compute_grad=compute_grad)
    va, vb, ok = out[0].T, out[1].T, out[2]
    if not compute_grad:
        return va, vb, ok, None, None
    ga_u, ga_v, gb_u, gb_v = out[3:]
    return (va, vb, ok, torch.stack([ga_u.T, ga_v.T], dim=2),
            torch.stack([gb_u.T, gb_v.T], dim=2))
