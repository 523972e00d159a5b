"""Bilinear sampling of per-pixel corner banks and index maps (counterpart
of super_tpu/ops/bilinear.py).

The z-bank holds, per pixel, [z, nx, ny, nz] of its four bilinear corners
(16, H*W); the extended z-bank adds E feature rows per corner (the class
confidences of the semantic data term).  The samplers rebuild each
corner's x and y from its pixel coordinate and z with the backprojection's
formula; corner validity is a unit normal (invalid corners carry a zero
normal).  The image bank holds a dense (F, H, W) image's four corners per
pixel, edge-replicated.  Each sampler is differentiable in the query
coordinates (v, u) through the bilinear weights; the banks are constants
of the frame, so their gathers have no backward pass.
"""

from __future__ import annotations

import torch

_CORNERS = ((0, 0), (0, 1), (1, 0), (1, 1))


def hinge(x):
    """max(x, 0) with the JAX package's gradient: ``jnp.maximum`` (as
    ``torch.maximum``) gives half the gradient to each side of a tie, so the
    gradient at x = 0 is 1/2; ``torch.clamp`` would pass all of it."""
    return torch.maximum(x, x.new_zeros(()))


def tent(d):
    """The bilinear weight max(1 - |d|, 0).  A query on a pixel line puts
    corners exactly on the kinks; where the weight is differentiated it
    takes the JAX package's gradients there: |d|' = +1 at d = 0 (JAX's
    ``where(d >= 0, 1, -1)``, where ``torch.abs`` gives 0) and
    :func:`hinge`'s 1/2 at 1 - |d| = 0."""
    if not d.requires_grad:
        return torch.clamp(1.0 - torch.abs(d), min=0.0)
    return hinge(1.0 - torch.where(d >= 0, d, -d))


def build_corner_bank_z(points_fm, norms_fm, index_map):
    """(16, H*W): per pixel, [z, n(3)] at (y, x), (y, x+1), (y+1, x) and
    (y+1, x+1), zeroed where the corner is invalid or off the image."""
    h, w = index_map.shape
    valid = index_map >= 0
    zrow = torch.where(valid, points_fm.reshape(3, h, w)[2], 0.0)[None]
    nms = torch.where(valid[None], norms_fm.reshape(3, h, w), 0.0)
    return _shift_zero(torch.cat([zrow, nms], dim=0))


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
    wn = tuple(tent(x) for x in dn)
    wm = tuple(tent(x) for x in dm)
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


def _shift_zero(base):
    """[base, right, down, down-right]: (4F, H*W), shifted-out cells 0."""
    f, h, w = base.shape
    right = torch.zeros_like(base)
    right[:, :, :-1] = base[:, :, 1:]
    down = torch.zeros_like(base)
    down[:, :-1, :] = base[:, 1:, :]
    downright = torch.zeros_like(base)
    downright[:, :, :-1] = down[:, :, 1:]
    return torch.cat([base, right, down, downright], dim=0).reshape(
        4 * f, h * w)


def build_corner_bank_zx(points_fm, norms_fm, extra_fm, index_map):
    """((4+E)*4, H*W): per pixel, [z, n(3), extra(E)] of its 4 bilinear
    corners, zeroed where a corner is invalid or off the image (the
    extras as ``bilinear_sample_indexed`` masks its corners)."""
    h, w = index_map.shape
    e = extra_fm.shape[0]
    valid = index_map >= 0
    zrow = torch.where(valid, points_fm.reshape(3, h, w)[2], 0.0)[None]
    nms = torch.where(valid[None], norms_fm.reshape(3, h, w), 0.0)
    ext = torch.where(valid[None], extra_fm.reshape(e, h, w), 0.0)
    return _shift_zero(torch.cat([zrow, nms, ext], dim=0))


def bilinear_sample_bank_zx_fm(bank, n_extra: int, intr, h: int, w: int, v,
                               u):
    """Sample a :func:`build_corner_bank_zx` bank at (v, u): (o (3, N),
    n (3, N), extra (E, N), ok (N,)); o, n and ok as
    :func:`bilinear_sample_bank_z_fm`."""
    f = 4 + n_extra
    fl_v = torch.floor(v)
    fl_u = torch.floor(u)
    vi = torch.clamp(torch.nan_to_num(fl_v, nan=-1.0), 0, h - 1).long()
    ui = torch.clamp(torch.nan_to_num(fl_u, nan=-1.0), 0, w - 1).long()
    g = bank[:, vi * w + ui]                               # (4F, N)
    dn = (fl_v - v, fl_v + 1.0 - v)
    dm = (fl_u - u, fl_u + 1.0 - u)
    wn = tuple(tent(x) for x in dn)
    wm = tuple(tent(x) for x in dm)
    ok = (fl_v >= 0) & (fl_v + 1 < h) & (fl_u >= 0) & (fl_u + 1 < w)
    va = vb = ve = 0.0
    for j, (jn, jm) in enumerate(_CORNERS):
        blk = g[f * j:f * j + f]
        z = blk[0]
        n = blk[1:4]
        ok = ok & (torch.sum(n * n, dim=0) > 0.5)
        x = (fl_u + jm - intr.cx) * z / intr.fx
        y = (fl_v + jn - intr.cy) * z / intr.fy
        wc = (wn[jn] * wm[jm])[None]
        va = va + wc * torch.stack([x, y, z])
        vb = vb + wc * n
        ve = ve + wc * blk[4:]
    return va, vb, ve, ok


def _index_corners(v, u, h, w):
    """The four corners (floor, floor + 1) of each query as (N, 4) float
    rows and columns, their clamped indices and the in-image test."""
    fl_v, fl_u = torch.floor(v), torch.floor(u)
    n_blk = torch.stack([fl_v, fl_v, fl_v + 1.0, fl_v + 1.0], dim=1)
    m_blk = torch.stack([fl_u, fl_u + 1.0, fl_u, fl_u + 1.0], dim=1)
    in_bounds = (n_blk >= 0) & (n_blk < h) & (m_blk >= 0) & (m_blk < w)
    ni = torch.clamp(torch.nan_to_num(n_blk, nan=0.0), 0, h - 1).long()
    mi = torch.clamp(torch.nan_to_num(m_blk, nan=0.0), 0, w - 1).long()
    return n_blk, m_blk, ni, mi, in_bounds


def bilinear_sample_indexed(features_fm, index_map, v, u):
    """Sample per-surfel features (F, M) through ``index_map`` (H, W; -1
    invalid) at (v, u): ((N, F) values, zeros at invalid corners; (N,)
    valid: all four corners in the image and valid)."""
    h, w = index_map.shape
    m = features_fm.shape[1]
    n_blk, m_blk, ni, mi, in_bounds = _index_corners(v, u, h, w)
    sf_idx = index_map[ni, mi]                             # (N, 4)
    corner_valid = (sf_idx >= 0) & in_bounds
    safe = torch.clamp(sf_idx, 0, m - 1).long()
    gathered = features_fm[:, safe].permute(1, 2, 0)       # (N, 4, F)
    gathered = torch.where(corner_valid[..., None], gathered, 0.0)
    wn = tent(n_blk - v[:, None])
    wm = tent(m_blk - u[:, None])
    values = torch.sum(gathered * (wn * wm)[..., None], dim=1)
    return values, torch.all(corner_valid, dim=1)


def build_corner_bank_image(image_fm):
    """(F, H, W) image -> (4F, H*W) bank: row block c holds corner c of the
    bilinear stencil anchored at each pixel, edge-replicated (the clamped
    corners of a query whose floor cell is in the image)."""
    f, h, w = image_fm.shape
    right = torch.cat([image_fm[:, :, 1:], image_fm[:, :, -1:]], dim=2)
    down = torch.cat([image_fm[:, 1:], image_fm[:, -1:]], dim=1)
    down_right = torch.cat([down[:, :, 1:], down[:, :, -1:]], dim=2)
    return torch.cat([x.reshape(f, h * w)
                      for x in (image_fm, right, down, down_right)], dim=0)


def bilinear_sample_bank_image(bank, f: int, h: int, w: int, v, u, *,
                               stop_grad_rows=None):
    """Sample a :func:`build_corner_bank_image` bank at (v, u): ((F, N)
    values, (N,) in-image mask).  Exact against clamped-corner sampling
    where floor(v, u) lies in the image; the caller masks the rest.

    ``stop_grad_rows``: a (start, end) row range combined with detached
    bilinear weights (a class gate sampled beside a differentiable field
    from the same gather)."""
    n0 = torch.floor(v)
    m0 = torch.floor(u)
    ni = torch.clamp(torch.nan_to_num(n0, nan=0.0), 0, h - 1).long()
    mi = torch.clamp(torch.nan_to_num(m0, nan=0.0), 0, w - 1).long()
    g = bank[:, ni * w + mi]                               # (4F, N)
    av = v - n0
    au = u - m0
    ws = ((1.0 - av) * (1.0 - au), (1.0 - av) * au, av * (1.0 - au),
          av * au)

    def combine(weights, lo, hi):
        return sum(weights[c] * g[c * f + lo:c * f + hi] for c in range(4))

    if stop_grad_rows is None:
        vals = combine(ws, 0, f)
    else:
        s, e = stop_grad_rows
        sg = tuple(x.detach() for x in ws)
        vals = torch.cat([combine(ws, 0, s), combine(sg, s, e),
                          combine(ws, e, f)], dim=0)
    in_bounds = (v >= 0) & (v <= h - 1) & (u >= 0) & (u <= w - 1)
    return vals, in_bounds
