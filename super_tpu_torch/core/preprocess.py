"""Depth map -> surfel candidates (counterpart of
super_tpu/core/preprocess.py).

Dense and pixel-indexed: NaN marks missing depth inside the stage, and the
FrameData boundary carries (mask, zeros).  The stereo SSIM confidence is not
ported yet: ``disable_ssim_conf=True`` (the default) never reaches it.
"""

from __future__ import annotations

import math

import torch

from super_tpu_torch.config import SuPerConfig
from super_tpu_torch.core.state import FrameData
from super_tpu_torch.geometry.camera import (
    Intrinsics,
    backproject_depth,
    pixel_grid,
)
from super_tpu_torch.ops.morphology import dilate, erode, find_edge_region

DIVTERM = 1.0 / (2.0 * 0.6 * 0.6)


def disp_to_depth(disp, min_depth: float, max_depth: float):
    """Monodepth2 sigmoid disparity -> (scaled disparity, depth)."""
    min_disp = 1.0 / max_depth
    max_disp = 1.0 / min_depth
    scaled_disp = min_disp + (max_disp - min_disp) * disp
    return scaled_disp, 1.0 / scaled_disp


def _pad_nan(x):
    """Pad the two spatial dims by 1 with NaN."""
    return torch.nn.functional.pad(x, (1, 1, 1, 1), value=float("nan"))


def _shift(p, dy, dx):
    h = p.shape[-2] - 2
    w = p.shape[-1] - 2
    return p[..., 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]


def _cross0(a, b):
    """Cross product over axis 0 of (3, H, W) fields."""
    return torch.stack([a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
                        a[0] * b[1] - a[1] * b[0]])


def _normalize0(n):
    nrm = torch.sqrt(torch.sum(n * n, dim=0, keepdim=True))
    n = n / nrm
    valid = ~torch.any(torch.isnan(n), dim=0)
    return torch.where(valid[None], n, 0.0), valid


def normals_naive(points):
    """Central-difference normals of a (3, H, W) vertex map."""
    p = _pad_nan(points)
    n = _cross0(_shift(p, 0, 1) - _shift(p, 0, -1),
                _shift(p, -1, 0) - _shift(p, 1, 0))
    return _normalize0(n)


def normals_8neighbors(points, colors):
    """Colour-weighted 8-neighbour normals; neighbour order L, LU, U, RU,
    R, RD, D, DL as in the reference."""
    cp = _pad_nan(colors)
    pp = _pad_nan(points)
    cen_c = _shift(cp, 0, 0)
    cen_p = _shift(pp, 0, 0)
    offsets = [(0, -1), (-1, -1), (-1, 0), (-1, 1), (0, 1), (1, 1), (1, 0),
               (1, -1)]
    disps = []
    for dy, dx in offsets:
        wgt = torch.exp(-torch.mean(torch.abs(_shift(cp, dy, dx) - cen_c),
                                    dim=0, keepdim=True))
        disps.append((_shift(pp, dy, dx) - cen_p) * wgt)
    suffix = disps[-1]
    acc = torch.zeros_like(cen_p)
    for i in range(len(disps) - 2, -1, -1):
        acc = acc + _cross0(disps[i], suffix)
        suffix = suffix + disps[i]
    return _normalize0(acc)


def chamfer_distance_transform(mask, step_x: float, step_y: float,
                               iterations: int = 48):
    """Min-plus 3x3 chamfer distance to the nearest True pixel of each
    (..., H, W) mask.  The steps stay Python numbers (rounded to f32 where
    they meet the map), so no host copy reaches the device."""
    big = 1e8
    d = torch.where(mask, 0.0, big).to(torch.float32)
    diag = math.sqrt(step_x * step_x + step_y * step_y)
    kern = [[diag, step_y, diag], [step_x, 0.0, step_x],
            [diag, step_y, diag]]
    h, w = d.shape[-2:]
    for _ in range(iterations):
        p = torch.nn.functional.pad(d, (1, 1, 1, 1), value=big)
        best = None
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                c = (p[..., 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
                     + kern[dy + 1][dx + 1])
                best = c if best is None else torch.minimum(best, c)
        d = torch.minimum(d, best)
    return d


def compute_invalid_mask(cfg: SuPerConfig, depth, seg=None, valid_mask=None):
    """Dataset-specific invalid-region rules; (H, W) bool."""
    h, w = depth.shape
    dev = depth.device
    inval = torch.zeros((h, w), dtype=torch.bool, device=dev)
    if cfg.data == "superv1":
        if valid_mask is not None:
            inval = ~valid_mask
        if seg is not None:
            for cid in cfg.del_seg_classes:
                inval = inval | (seg == cid)
        k = cfg.dilate_invalid_kernel
        if cfg.depth_model == "raft_stereo":
            if k > 0:
                inval = dilate(inval, k)
            inval = inval.clone()
            inval[:, : int(0.05 * w)] = True
        elif k > 0:
            inval = erode(inval, k)
            inval = dilate(inval, 2 * k)
        depth_th = 1.5
        inval = inval | ~(depth > 0) | (depth > depth_th) | torch.isnan(depth)
    else:
        if cfg.load_depth:
            inval = inval | (depth == 0) | torch.isnan(depth)
            inval[:, : int(0.1 * w)] = True
        else:
            inval[:, : int(cfg.depth_width_range[0] * w)] = True
            inval[:, int(cfg.depth_width_range[1] * w):] = True
            inval = inval | torch.isnan(depth)
        if seg is not None:
            for cid in cfg.del_seg_classes:
                inval = inval | (seg == cid)
    return inval


def preprocess_frame(cfg: SuPerConfig, intr: Intrinsics, depth, color, time,
                     seg=None, seg_conf=None, valid_mask=None,
                     disp_conf=None, *, device="cuda") -> FrameData:
    """Depth (H, W) + colour (3, H, W) -> pixel-indexed FrameData on
    ``device``.  The images may be numpy arrays or tensors."""
    h, w = cfg.height, cfg.width
    dev = torch.device(device)
    depth, color, seg, seg_conf, valid_mask, disp_conf = (
        None if x is None else torch.as_tensor(x, device=dev)
        for x in (depth, color, seg, seg_conf, valid_mask, disp_conf))
    if not cfg.disable_ssim_conf and disp_conf is None:
        raise NotImplementedError(
            "stereo SSIM confidence is not ported; pass disp_conf or keep "
            "disable_ssim_conf=True")

    inval = compute_invalid_mask(cfg, depth, seg=seg, valid_mask=valid_mask)
    depth = torch.where(inval, float("nan"), depth)

    points = backproject_depth(depth, intr)
    if cfg.normal_model == "naive":
        norms, nvalid = normals_naive(points)
    else:
        norms, nvalid = normals_8neighbors(points, color)
    valid = nvalid & ~torch.any(torch.isnan(points), dim=0)

    nz = torch.clamp(torch.abs(norms[2]), 0.26, 1.0)
    radii = torch.abs(depth) / (math.sqrt(2.0) * intr.fx * nz)

    uu, vv = pixel_grid(h, w, dev)
    dc2 = (2.0 * uu / w - 1.0) ** 2 + (2.0 * vv / h - 1.0) ** 2
    confs = torch.exp(-dc2 * DIVTERM)
    if disp_conf is not None and not cfg.disable_ssim_conf:
        confs = 0.5 * confs + 0.5 * torch.sigmoid(disp_conf)

    c = cfg.num_classes
    if seg is None:
        seg_flat = torch.zeros((h * w,), dtype=torch.int32, device=dev)
        seg_conf_flat = torch.zeros((c, h * w), dtype=torch.float32,
                                    device=dev)
        dist2edge = torch.zeros((h * w,), dtype=torch.float32, device=dev)
    else:
        seg_flat = seg.reshape(-1).to(torch.int32)
        if seg_conf is not None:
            sc = torch.softmax(seg_conf, dim=0)
        else:
            sc = torch.nn.functional.one_hot(seg.long(), c).permute(
                2, 0, 1).to(torch.float32)
        seg_conf_flat = sc.reshape(c, -1)
        d2e = torch.zeros((h, w), dtype=torch.float32, device=dev)
        for cid in range(c):
            edge = find_edge_region(seg, c, class_list=[cid], kernel=3)
            dt = chamfer_distance_transform(edge, 1.0 / w, 1.0 / h)
            d2e = torch.where(seg == cid, dt, d2e)
        dist2edge = d2e.reshape(-1)

    vflat = valid.reshape(-1)
    return FrameData(
        points=torch.where(vflat[None, :], points.reshape(3, -1), 0.0),
        norms=torch.where(vflat[None, :], norms.reshape(3, -1), 0.0),
        colors=color.reshape(3, -1),
        radii=torch.where(vflat, radii.reshape(-1), 0.0),
        confs=confs.reshape(-1),
        valid=vflat,
        seg=seg_flat,
        seg_conf=seg_conf_flat,
        dist2edge=dist2edge,
        # A number is filled in on the device: a copy from host memory
        # would wait for the card.
        time=(torch.as_tensor(time, dtype=torch.float32, device=dev)
              if isinstance(time, torch.Tensor) else
              torch.full((), time, dtype=torch.float32, device=dev)),
        color_image=color,
    )
