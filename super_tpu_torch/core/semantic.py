"""Semantic-SuPer and appearance losses of the autograd fit (counterpart of
super_tpu/core/semantic.py).

- :func:`bn_morph_loss`: surfels whose warped projection lands in another
  class are pulled toward their own class's segmentation boundary: the
  squared per-class distance transform sampled at the projection.
- :func:`render_loss`: squared SSIM between the soft splat of the surfels
  and the frame, masked to rendered pixels and clipped at 0.1.
- :func:`corr_loss`, the optical-flow correspondence term, needs the flow
  network, which is not ported: it raises (and the extras carry no flow).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from super_tpu_torch.config import SuPerConfig
from super_tpu_torch.core.preprocess import chamfer_distance_transform
from super_tpu_torch.geometry.camera import Intrinsics, project_points
from super_tpu_torch.ops.bilinear import (
    bilinear_sample_bank_image,
    build_corner_bank_image,
)
from super_tpu_torch.ops.morphology import find_edge_region
from super_tpu_torch.ops.ssim import ssim


class SemanticExtras(NamedTuple):
    """Per-frame dense inputs of the semantic and appearance losses."""

    seg_conf_image: torch.Tensor    # (C, H, W) class confidences
    edge_dt: torch.Tensor           # (C, H, W) boundary DT (pixels)
    color_image: torch.Tensor       # (3, H, W)
    # (4 * 2C, H*W) image bank of [seg_conf_image; edge_dt]: bn_morph
    # samples the class gate and the distance with one gather.
    morph_bank: torch.Tensor


def build_semantic_extras(cfg: SuPerConfig, frame_seg, frame_seg_conf,
                          color_image) -> SemanticExtras:
    """Per-class boundary distance transforms (pixel metric, kernel-3
    edges, 64 chamfer sweeps) and the morph bank."""
    c = cfg.num_classes
    edges = torch.stack([find_edge_region(frame_seg, c, class_list=[cid],
                                          kernel=3) for cid in range(c)])
    edge_dt = chamfer_distance_transform(edges, 1.0, 1.0, iterations=64)
    return SemanticExtras(
        seg_conf_image=frame_seg_conf, edge_dt=edge_dt,
        color_image=color_image,
        morph_bank=build_corner_bank_image(
            torch.cat([frame_seg_conf, edge_dt], dim=0)))


def bn_morph_loss(cfg: SuPerConfig, extras: SemanticExtras, warped_points,
                  sf_seg, sf_mask, intr: Intrinsics):
    """Boundary-morph pull of the misclassified surfels: warped_points
    (3, Np), sf_seg (Np,), sf_mask (Np,)."""
    h, w = cfg.height, cfg.width
    v, u, _, _ = project_points(warped_points, intr, h, w)
    inb = (u > -1) & (u < w) & (v > -1) & (v < h)
    # The class gate combines with detached weights (it does not pull);
    # the distance rows combine with live ones.
    c = extras.edge_dt.shape[0]
    vals, _ = bilinear_sample_bank_image(extras.morph_bank, 2 * c, h, w, v,
                                         u, stop_grad_rows=(0, c))
    new_seg = torch.argmax(vals[:c].detach(), dim=0)
    morph = sf_mask & inb & (new_seg != sf_seg)
    # The own class's distance, selected (no scatter in the backward pass).
    dt_own = vals[c]
    for cid in range(1, c):
        dt_own = torch.where(sf_seg == cid, vals[c + cid], dt_own)
    # Surfels nearer the image border than the boundary are left out, as
    # are pulls of 15 px^2 or less (the reference's threshold).
    dist_img_edge = torch.minimum(torch.minimum(u, w - u),
                                  torch.minimum(v, h - v))
    valid_match = dt_own <= dist_img_edge.detach()
    sq = dt_own * dt_own
    keep = morph & valid_match & (sq.detach() > 15.0)
    cnt = torch.clamp(torch.sum(keep), min=1)
    return torch.sum(torch.where(keep, sq, 0.0)) / cnt


def render_loss(cfg: SuPerConfig, extras: SemanticExtras, rendered):
    """Squared-SSIM appearance loss of the soft render (3, H, W)."""
    m = torch.mean(ssim(rendered, extras.color_image, kernel=11), dim=0) ** 2
    # Valid pixels: every channel positive in an 11 x 11 window (the
    # reference's maxpool(-min) < 0).
    neg = -torch.amin(rendered.detach(), dim=0)
    win = F.max_pool2d(neg[None, None], 11, stride=1, padding=5)[0, 0]
    keep = (win < 0) & (m < 0.1)
    return torch.sum(torch.where(keep, m, 0.0))


def corr_loss(*args, **kwargs):
    """The optical-flow correspondence loss (``sf_corr``)."""
    raise NotImplementedError(
        "sf_corr needs the optical-flow network, which is not ported")
