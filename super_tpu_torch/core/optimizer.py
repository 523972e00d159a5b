"""Autograd warp-field fit, the reference's GraphFit (counterpart of
super_tpu/core/optimizer.py).

The deformation ``deform`` (J+1, 7), whose last row is the global rigid
transform T_g, is fit by SGD (momentum 0.9) or Adam, optax's updates
written as device ops (:func:`fit_update`), on the autograd faces
of the losses: point-plane ICP with hard or soft semantic weights,
knn_w-weighted ARAP, the rotation term over every row, triangle-area
preservation, and the semantic boundary-morph and render terms
(core/semantic.py), and the optical-flow correspondence term (``sf_corr``)
with the flow of the flow net in ``models``: once a frame from the
previous frame's colour, or (``sf_corr_match_renderimg``) at every
evaluation from the soft render.  The T_g row's gradient is divided by
the number of active nodes before each step.

Every sum of the backward pass that adds into shared rows goes through the
fixed-order segment sum, so the fit repeats bit for bit on the card: the
anchor parameters are fetched per G-block of the tuple layout by
:func:`kernels.segsum.segment_gather` (one row per block and anchor, then
broadcast over the block, whose backward pass is a plain reduction), as
are the ED neighbours of the ARAP term and the triangle corners of the
face term, each under a plan made once a frame; the soft splat sums its
pixels the same way (render/splat.py).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from super_tpu_torch.config import SuPerConfig
from super_tpu_torch.core import losses as lm_losses
from super_tpu_torch.core import semantic as sem
from super_tpu_torch.core.losses import LMContext, prepare_lm
from super_tpu_torch.core.state import FrameData, GraphState, SurfelState
from super_tpu_torch.geometry.camera import Intrinsics, project_points
from super_tpu_torch.geometry.divergence import jsd
from super_tpu_torch.geometry.quaternion import cross, transform_quat_t
from super_tpu_torch.kernels.segsum import (
    SegmentPlan,
    segment_gather,
    segment_plan,
)
from super_tpu_torch.ops.bilinear import (
    bilinear_sample_bank_z_fm,
    bilinear_sample_bank_zx_fm,
    bilinear_sample_indexed,
    build_corner_bank_zx,
)
from super_tpu_torch.render.splat import render_soft
from super_tpu_torch.utils.profiling import span


class AutogradContext(NamedTuple):
    """Frame constants of the autograd fit."""

    base: LMContext
    sf_seg: torch.Tensor            # (Np,) int32, padded slot order
    sf_seg_conf: torch.Tensor       # (C, Np)
    sf_colors: torch.Tensor         # (3, Np)
    trg_seg_conf: torch.Tensor      # (C, P)
    num_active_nodes: torch.Tensor  # () int, at least 1
    extras: Optional[sem.SemanticExtras]
    # ((4+C)*4, P) z-bank with per-corner class confidences: the data
    # term's point, normal and confidence sample in one gather.
    trg_bank_zx: Optional[torch.Tensor]
    # Segment plans of the row gathers whose gradients add into nodes:
    # each G-block's anchors (B*K ids), the ED neighbours (J*K_ed) and the
    # triangle corners (3T).
    block_plan: SegmentPlan
    ed_plan: Optional[SegmentPlan] = None
    tri_plan: Optional[SegmentPlan] = None


def prepare_autograd(cfg: SuPerConfig, surfels: SurfelState,
                     graph: GraphState, frame: FrameData, flow=None,
                     intr: Optional[Intrinsics] = None) -> AutogradContext:
    """The LM context of the tuple layout (the surfels in padded tuple-
    sorted slots, so the per-surfel classes and colours are permuted with
    it), the semantic extras and the gradient sums' plans.  A per-frame
    ``flow`` (2, H, W) goes into the extras with the surfels' source
    projections under ``intr``, the anchors of its corr match."""
    losses = cfg.losses
    base = prepare_lm(cfg, surfels, graph, frame)
    layout = base.layout
    ebank = torch.cat([surfels.seg.to(surfels.points.dtype)[None],
                       surfels.seg_conf, surfels.colors])
    packed = ebank[:, layout.sort_perm.long()][:, layout.src_pos.long()]
    c = surfels.seg_conf.shape[0]
    h, w = cfg.height, cfg.width
    extras = None
    if losses.sf_bn_morph or losses.render_loss or losses.sf_corr:
        src_uv = None
        if flow is not None:
            v0, u0, _, _ = project_points(base.sf_points, intr, h, w)
            src_uv = torch.stack([u0, v0])
        extras = sem.build_semantic_extras(
            cfg, frame.seg.reshape(h, w), frame.seg_conf.reshape(-1, h, w),
            frame.color_image, flow=flow, src_uv=src_uv)
    bank_zx = None
    if losses.sf_hard_seg_point_plane or losses.sf_soft_seg_point_plane:
        bank_zx = build_corner_bank_zx(frame.points, frame.norms,
                                       frame.seg_conf,
                                       frame.index_map(h, w))
    j_cap = graph.capacity
    block_nodes = layout.tuple_nodes[layout.block_tuple.long()]  # (B, K)
    return AutogradContext(
        base=base,
        sf_seg=packed[0].to(torch.int32),
        sf_seg_conf=packed[1:1 + c],
        sf_colors=packed[1 + c:4 + c],
        trg_seg_conf=frame.seg_conf,
        num_active_nodes=torch.clamp(graph.num_active, min=1),
        extras=extras,
        trg_bank_zx=bank_zx,
        block_plan=segment_plan(block_nodes, j_cap),
        ed_plan=(segment_plan(graph.knn_idx, j_cap) if losses.mesh_arap
                 else None),
        tri_plan=(segment_plan(graph.triangles, j_cap) if losses.mesh_face
                  else None),
    )


def _warp_all(cfg: SuPerConfig, ctx: AutogradContext, deform):
    """Warped surfels (3, Np) in the context's slot order: each slot's
    blended anchor warp, then the full global transform.  The anchor
    parameters are fetched once per G-block and broadcast over it (the JAX
    package's tuple-layout branch; the port's contexts always carry the
    tuple layout)."""
    base = ctx.base
    node_beta = deform[:-1]
    t_g = deform[-1]
    _, w_fm, knn_fm, diff_fm = lm_losses._geom(base)
    k, np_ = w_fm.shape
    nb = base.layout.block_tuple.shape[0]
    bb = segment_gather(node_beta, ctx.block_plan).reshape(nb, k, 7)
    beta_kfm = bb.permute(1, 2, 0)[..., None].expand(
        k, 7, nb, np_ // nb).reshape(k, 7, np_)
    tp = _warp_fm(w_fm, knn_fm, diff_fm, beta_kfm)
    return (transform_quat_t(tp.T, t_g[0:4]) + t_g[4:7]).T


def _cross_blocks(x, y):
    """Cross products of the anchor-blocked (3K, C) stacks, each anchor's 3
    rows rotated by ``torch.roll`` (where the LM path gathers them)."""
    k3, c = x.shape
    x3, y3 = x.reshape(k3 // 3, 3, c), y.reshape(k3 // 3, 3, c)
    return (torch.roll(x3, -1, dims=1) * torch.roll(y3, 1, dims=1)
            - torch.roll(x3, 1, dims=1) * torch.roll(y3, -1, dims=1)
            ).reshape(k3, c)


def _warp_fm(w_fm, knn_fm, diff_fm, beta_kfm):
    """The blended warp (3, C) of core/losses.py:_warp_fm_batched, bit for
    bit, in a form whose backward pass adds no rows together: the rotation
    scalar is broadcast over each anchor's 3 rows by ``expand`` (a plain
    reduction backward) and the cross products rotate rows (a rotation
    backward), where the LM path's row gathers would backward-add them
    with ``index_put_``."""
    k, _, c = beta_kfm.shape
    v = diff_fm
    qw = beta_kfm[:, 0:1].expand(k, 3, c).reshape(3 * k, c)
    qv = beta_kfm[:, 1:4].reshape(3 * k, c)
    cr = _cross_blocks(qv, v)
    tv = v + 2.0 * qw * cr + 2.0 * _cross_blocks(qv, cr) + \
        beta_kfm[:, 4:7].reshape(3 * k, c)
    w3 = w_fm[:, None].expand(k, 3, c).reshape(3 * k, c)
    return lm_losses._sum_k(w3 * (tv + knn_fm), k)


def point_plane_autograd(cfg: SuPerConfig, ctx: AutogradContext, deform,
                         intr: Intrinsics, warped=None):
    """Point-plane ICP against the target sampled at the warped points,
    with the optional residual clip, Huber-style reweighting and hard or
    soft semantic weights (exp(-0.1 JSD) of the surfel's and the softmaxed
    sampled target's class confidences); the weights are detached."""
    base = ctx.base
    losses = cfg.losses
    seg_icp = losses.sf_hard_seg_point_plane or losses.sf_soft_seg_point_plane
    if warped is None:
        warped = _warp_all(cfg, ctx, deform)
    h, w = cfg.height, cfg.width
    v, u, _, valid = project_points(warped, intr, h, w, valid_margin=1)
    mask = base.sf_mask & valid
    tconf_fm = None
    if seg_icp and ctx.trg_bank_zx is not None:
        o, n, tconf_fm, svalid = bilinear_sample_bank_zx_fm(
            ctx.trg_bank_zx, ctx.trg_seg_conf.shape[0], intr, h, w, v, u)
    else:
        o, n, svalid = bilinear_sample_bank_z_fm(base.trg_corner_bank, intr,
                                                 h, w, v, u)
    mask = mask & svalid
    r = torch.sum(n * (warped - o), dim=0)
    sq = torch.where(mask, r * r, 0.0)
    if losses.sf_point_plane_max > 0:
        sq = torch.where(sq.detach() < losses.sf_point_plane_max, sq, 0.0)
    if losses.huber_th > 0:
        hw = torch.clamp(losses.huber_th / torch.exp(torch.abs(sq) + 1e-20),
                         max=1.0)
        sq = sq * hw.detach()
    if seg_icp:
        if tconf_fm is not None:
            tconf, cvalid = tconf_fm.detach().T, svalid
        else:
            tconf, cvalid = bilinear_sample_indexed(
                ctx.trg_seg_conf, base.trg_index_map, v.detach(), u.detach())
        tconf = torch.softmax(tconf, dim=-1)
        if losses.sf_soft_seg_point_plane:
            weights = torch.exp(-0.1 * jsd(ctx.sf_seg_conf.T, tconf))
        else:
            weights = (ctx.sf_seg == torch.argmax(tconf, dim=-1)).to(sq.dtype)
        sq = sq * torch.where(mask & cvalid, weights, 0.0)
    return torch.sum(sq)


def arap_autograd(graph: GraphState, ctx: AutogradContext, deform):
    """knn_w-weighted ARAP over the ED edges."""
    base = ctx.base
    beta = deform[:-1]
    nb = segment_gather(beta, ctx.ed_plan).reshape(base.ed_knn_idx.shape
                                                   + (7,))
    r = transform_quat_t(base.d_eds, nb) - base.d_eds - beta[:, None, 4:7]
    r = torch.where(base.ed_pair_mask[..., None], r, 0.0)
    return torch.sum(graph.knn_w * torch.sum(r * r, dim=-1))


def rot_autograd(deform, active):
    """(1 - |q|^2)^2 over the active node rows and the global row."""
    q = deform[:, 0:4]
    r = 1.0 - torch.sum(q * q, dim=-1)
    gate = torch.cat([active, active.new_ones((1,))])
    return torch.sum(torch.where(gate, r * r, 0.0))


def face_autograd(graph: GraphState, ctx: AutogradContext, deform):
    """Triangle-area preservation on the warped nodes."""
    beta = deform[:-1]
    t_g = deform[-1]
    new_nodes = graph.points + beta[:, 4:7]
    new_nodes = transform_quat_t(new_nodes, t_g[0:4]) + t_g[4:7]
    tri = segment_gather(new_nodes, ctx.tri_plan).reshape(-1, 3, 3)
    c = cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    areas = 0.5 * torch.sqrt(torch.sum(c * c, dim=1) + 1e-13)
    d = torch.where(graph.tri_active, areas - graph.tri_areas, 0.0)
    return torch.sum(d * d)


def autograd_total(cfg: SuPerConfig, ctx: AutogradContext,
                   graph: GraphState, deform, intr: Intrinsics,
                   flow_fn=None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Sum of the enabled autograd losses, and each weighted face.
    ``flow_fn``: (3, H, W) render -> (2, H, W) flow; when given, the corr
    term takes the flow of the current soft render instead of the
    context's per-frame flow."""
    losses = cfg.losses
    parts = {}
    seg_icp = losses.sf_hard_seg_point_plane or losses.sf_soft_seg_point_plane
    need_warp = (losses.sf_point_plane or seg_icp or losses.sf_bn_morph
                 or losses.render_loss or losses.sf_corr)
    warped = _warp_all(cfg, ctx, deform) if need_warp else None
    if losses.sf_point_plane or seg_icp:
        parts["point_plane"] = losses.sf_point_plane_weight * \
            point_plane_autograd(cfg, ctx, deform, intr, warped=warped)
    if losses.mesh_arap:
        parts["arap"] = losses.mesh_arap_weight * arap_autograd(graph, ctx,
                                                                deform)
    if losses.mesh_rot:
        parts["rot"] = losses.mesh_rot_weight * rot_autograd(
            deform, ctx.base.ed_mask)
    if losses.mesh_face:
        parts["face"] = losses.mesh_face_weight * face_autograd(graph, ctx,
                                                                deform)
    if ctx.extras is not None:
        if losses.sf_bn_morph:
            parts["bn_morph"] = losses.sf_bn_morph_weight * sem.bn_morph_loss(
                cfg, ctx.extras, warped, ctx.sf_seg, ctx.base.sf_mask, intr)
        if losses.render_loss or (losses.sf_corr and flow_fn is not None):
            rendered = render_soft(warped, ctx.sf_colors, ctx.base.sf_mask,
                                   intr, cfg.height, cfg.width)
        if losses.render_loss:
            parts["render"] = losses.render_loss_weight * sem.render_loss(
                cfg, ctx.extras, rendered)
        if losses.sf_corr:
            extras = ctx.extras
            if flow_fn is not None:
                extras = extras._replace(flow=flow_fn(rendered))
            base = ctx.base
            parts["corr"] = losses.sf_corr_weight * sem.corr_loss(
                cfg, extras, warped, base.trg_points, base.trg_norms,
                base.trg_index_map, base.sf_mask, intr,
                loss_type=losses.sf_corr_loss_type)
    total = deform.new_zeros(())
    for part in parts.values():
        total = total + part
    return total, parts


class FitState(NamedTuple):
    """The optimizer's state: optax's ``scale_by_adam`` (count, mu, nu) or
    ``trace`` (the momentum, in ``mu``; ``count`` and ``nu`` unused)."""

    count: torch.Tensor   # () int32, steps taken
    mu: torch.Tensor
    nu: torch.Tensor


ADAM_B1, ADAM_B2, ADAM_EPS, SGD_MOMENTUM = 0.9, 0.999, 1e-8, 0.9


def fit_init(deform) -> FitState:
    """optax's ``init`` of Adam or SGD for ``deform``, on its device."""
    return FitState(count=torch.zeros((), dtype=torch.int32,
                                      device=deform.device),
                    mu=torch.zeros_like(deform), nu=torch.zeros_like(deform))


def fit_update(optimizer: str, lr: float, grad, state: FitState, deform):
    """One step of ``optax.adam(lr)`` or ``optax.sgd(lr, momentum=0.9)``
    and ``optax.apply_updates``, op by op in optax's order, as device ops
    only (no host value, so a CUDA graph holds it): (deform, state)."""
    if optimizer == "Adam":
        mu = (1 - ADAM_B1) * grad + ADAM_B1 * state.mu
        nu = (1 - ADAM_B2) * (grad * grad) + ADAM_B2 * state.nu
        count = state.count + 1
        mu_hat = mu / (1 - torch.pow(ADAM_B1, count))
        nu_hat = nu / (1 - torch.pow(ADAM_B2, count))
        update = -lr * (mu_hat / (torch.sqrt(nu_hat) + ADAM_EPS))
        return deform + update, FitState(count, mu, nu)
    if optimizer == "SGD":
        mu = grad + SGD_MOMENTUM * state.mu
        return deform + -lr * mu, state._replace(mu=mu)
    raise ValueError(f"unknown optimizer {optimizer!r}")


def graph_fit(cfg: SuPerConfig, surfels: SurfelState, graph: GraphState,
              frame: FrameData, intr: Intrinsics, models=None,
              prev_color=None):
    """Fit the deformation: (deform (J+1, 7), the loss of the last
    evaluation, made before the last step).

    ``num_iterations`` steps of SGD (momentum 0.9) or Adam from the
    identity (:func:`fit_update`, optax's updates), each on the gradient
    of :func:`autograd_total` with the T_g row's divided by the active
    node count.  A fixed number of steps and no host read: the step never
    waits for the card, and a CUDA graph holds it whole (core/tracker.py:
    make_jit_step).

    With ``sf_corr`` and a flow net in ``models`` (factory.Models), the
    flow is inferred once from ``prev_color`` (3, H, W) to the frame's
    colour, or with ``sf_corr_match_renderimg`` at every evaluation from
    the soft render; either way under ``torch.no_grad`` (the flow carries
    no gradient, and the render that feeds it does)."""
    sol = cfg.solver
    losses = cfg.losses
    flow0 = flow_fn = None
    flow_model = getattr(models, "flow_model", None)
    if losses.sf_corr and flow_model is not None:
        def infer(src, trg):
            with torch.no_grad(), span("graph_fit.flow"):
                return flow_model(src[None], trg[None])[0]

        if losses.sf_corr_match_renderimg:
            flow_fn = lambda rendered: infer(  # noqa: E731
                rendered, frame.color_image)
        elif prev_color is not None:
            flow0 = infer(prev_color, frame.color_image)
    with span("graph_fit.prepare"):
        ctx = prepare_autograd(cfg, surfels, graph, frame, flow=flow0,
                               intr=intr)
    dev = surfels.points.device
    # The identity, made on the device (a copy from host memory would wait
    # for the card).
    deform = torch.zeros((graph.capacity + 1, 7), dtype=torch.float32,
                         device=dev)
    deform[:, 0] = 1.0
    state = fit_init(deform)
    loss = deform.new_zeros(())
    for _ in range(sol.num_iterations):
        deform.requires_grad_(True)
        with span("graph_fit.loss"):
            loss = autograd_total(cfg, ctx, graph, deform, intr,
                                  flow_fn=flow_fn)[0]
        with span("graph_fit.backward"):
            grad, = torch.autograd.grad(loss, deform)
        with span("graph_fit.step"), torch.no_grad():
            grad[-1] = grad[-1] / ctx.num_active_nodes
            deform, state = fit_update(sol.optimizer, sol.learning_rate,
                                       grad, state, deform.detach())
    return deform, loss.detach()
