"""Semantic-SuPer and appearance losses of the autograd fit (counterpart of
super_tpu/core/semantic.py).

- :func:`bn_morph_loss`: surfels whose warped projection lands in another
  class are pulled toward their own class's segmentation boundary: the
  squared per-class distance transform sampled at the projection.
- :func:`render_loss`: squared SSIM between the soft splat of the surfels
  and the frame, masked to rendered pixels and clipped at 0.1.
- :func:`corr_loss`: the optical-flow correspondence term: the flow
  sampled at each surfel's projection displaces it into the frame, and
  the warped surfel is pulled to the target sampled there (point-point or
  point-plane).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from super_tpu_torch.config import SuPerConfig
from super_tpu_torch.core.preprocess import chamfer_distance_transform
from super_tpu_torch.geometry.camera import Intrinsics, project_points
from super_tpu_torch.ops.bilinear import (
    bilinear_sample_bank_image,
    bilinear_sample_image,
    bilinear_sample_indexed,
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
    flow: Optional[torch.Tensor] = None      # (2, H, W) optical flow (u, v)
    # (2, Np) source (pre-deformation) projections (u, v) that anchor the
    # corr match of a per-frame flow; None anchors it at the current
    # warped projection (the flow re-inferred from the render).
    src_uv: Optional[torch.Tensor] = None


def build_semantic_extras(cfg: SuPerConfig, frame_seg, frame_seg_conf,
                          color_image, flow=None,
                          src_uv=None) -> SemanticExtras:
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
            torch.cat([frame_seg_conf, edge_dt], dim=0)),
        flow=flow, src_uv=src_uv)


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


def corr_loss(cfg: SuPerConfig, extras: SemanticExtras, warped_points,
              trg_points, trg_norms, trg_index_map, sf_mask,
              intr: Intrinsics, loss_type: str = "point-point"):
    """Optical-flow correspondence loss of warped_points (3, Np): each
    surfel's match is its anchor displaced by the flow sampled there, and
    the target map (trg_points / trg_norms (3, P) through trg_index_map)
    sampled at the match; point-point or point-plane residuals.

    The JAX package's two deviations from the reference, which both fix
    degeneracies of its formulation: the match coordinates carry no
    gradient (each evaluation pulls toward a fixed matched target, where
    the reference's target-chasing term cancels the pull on planar
    geometry), and with a per-frame flow the match is anchored at the
    source projection ``extras.src_uv`` (the flow says where the
    pre-deformation content went; re-sampling it at the moving projection
    overshoots without bound).  With the flow re-inferred from the render
    (``src_uv`` None) the current warped projection is the anchor."""
    if extras.flow is None:
        return warped_points.new_zeros(())
    h, w = cfg.height, cfg.width
    if extras.src_uv is not None:
        u, v = extras.src_uv[0], extras.src_uv[1]
    else:
        v, u, _, _ = project_points(warped_points, intr, h, w)
    u, v = u.detach(), v.detach()
    fl, _ = bilinear_sample_image(extras.flow.detach(), v, u)   # (Np, 2)
    u2 = u + fl[:, 0]
    v2 = v + fl[:, 1]
    margin = 1
    valid = sf_mask & (v2 >= margin) & (v2 < h - 1 - margin) & \
        (u2 >= margin) & (u2 < w - 1 - margin)
    o, svalid = bilinear_sample_indexed(trg_points, trg_index_map, v2, u2)
    if loss_type == "point-plane":
        n, _ = bilinear_sample_indexed(trg_norms, trg_index_map, v2, u2)
        r = torch.sum(n * (warped_points.T - o), dim=-1)
        sq = r * r
    else:
        sq = torch.sum((warped_points.T - o) ** 2, dim=-1)
    return torch.sum(torch.where(valid & svalid, sq, 0.0))
