"""Residuals and normal equations of the LM warp solve (counterpart of the
tuple-mode, pairs_fused parts of super_tpu/core/losses.py).

The data term is point-to-plane ICP against a frozen per-frame association
(``association="per_frame"``): each iteration re-linearises only the warp.
Per LM trip the gradient rows ``h`` (Np, 28) and residuals ``r`` (Np,) are
computed for every padded slot in one feature-major pass, kernel K2 reduces
them to per-tuple Grams (kernels/gram.py), and :func:`assembly.reduce_pairs`
folds those into the pair-sparse normal equations -- the form of the JAX
package's ``assembly_backend="pallas"`` branch.  The ARAP and rotation terms
are graph-sized and add their blocks in the same pair form.

All slots are computed (no stop at ``layout.live_end``): sink and padding
slots are masked to exact zeros, and no device count has to reach the host.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from super_tpu_torch.config import SuPerConfig
from super_tpu_torch.core import assembly
from super_tpu_torch.core.state import FrameData, GraphState, SurfelState
from super_tpu_torch.geometry.camera import Intrinsics, project_points
from super_tpu_torch.geometry.quaternion import (
    skew,
    transform_quat_t,
    transform_quat_t_jac,
)
from super_tpu_torch.kernels.gram import tuple_gram
from super_tpu_torch.ops.bilinear import (
    bilinear_sample_bank_z_fm,
    build_corner_bank_z,
)


class LMContext(NamedTuple):
    """Per-frame constants of the LM solve (tuple layout)."""

    sf_mask: torch.Tensor          # (Np,) active surfels, padded slot order
    sf_knn_w: torch.Tensor         # (K, Np)
    sf_points: torch.Tensor        # (3, Np)
    tuple_knn: torch.Tensor        # (K*3, T) anchor positions per tuple
    trg_points: torch.Tensor       # (3, P)
    trg_norms: torch.Tensor        # (3, P)
    trg_index_map: torch.Tensor    # (H, W)
    trg_corner_bank: torch.Tensor  # (16, P)
    ed_mask: torch.Tensor          # (J,)
    ed_knn_idx: torch.Tensor       # (J, K_ed)
    ed_pair_mask: torch.Tensor     # (J, K_ed)
    d_eds: torch.Tensor            # (J, K_ed, 3) g_i - g_j
    ed_skew: torch.Tensor          # (J, K_ed, 3, 3)
    layout: assembly.TupleLayout
    slot_tuple: torch.Tensor       # (Np,) tuple id of every padded slot


class Assoc(NamedTuple):
    """Frozen per-frame association: target point/normal per slot."""

    o: torch.Tensor     # (3, Np)
    n: torch.Tensor     # (3, Np)
    mask: torch.Tensor  # (Np,)


def _check_supported(cfg: SuPerConfig):
    sol = cfg.solver
    if sol.assembly_mode != "tuple" or cfg.num_neighbors != 4 or \
            sol.linear_solver != "pairs_fused":
        raise NotImplementedError(
            "the port runs the tuple assembly (K=4) with the pairs_fused "
            "solver; other assembly modes and solvers are not ported")


def prepare_lm(cfg: SuPerConfig, surfels: SurfelState, graph: GraphState,
               frame: FrameData) -> LMContext:
    _check_supported(cfg)
    sol = cfg.solver
    dev = surfels.points.device
    j_cap = graph.capacity
    self_idx = torch.arange(j_cap, dtype=torch.int32, device=dev)
    nb = graph.knn_idx.to(torch.int32)
    self_b = self_idx[:, None].expand(nb.shape)
    # Graph-term pairs (ED edges + node diagonals) must exist in the table.
    extra_pairs = torch.cat([
        torch.stack([self_b.reshape(-1), nb.reshape(-1)], dim=1),
        torch.stack([self_idx, self_idx], dim=1)])
    layout = assembly.build_tuple_layout(
        surfels.knn_idx, surfels.active, j_cap,
        tuple_cap=sol.assembly_tuple_cap, pad_group=sol.assembly_pad_group,
        chunk=sol.assembly_chunk, pair_cap=sol.assembly_pair_cap,
        extra_pairs=extra_pairs)
    pk = layout.pair_key
    lookup = assembly.pair_rank_lookup
    layout = layout._replace(
        diag_rank=lookup(pk, j_cap, torch.stack([self_idx, self_idx], -1)),
        arap_rank=torch.stack([
            lookup(pk, j_cap, torch.stack([nb, nb], -1)),
            lookup(pk, j_cap, torch.stack([self_b, self_b], -1)),
            lookup(pk, j_cap, torch.stack([nb, self_b], -1))], dim=-1),
        arap_swap=self_b < nb)

    bank = torch.cat([surfels.active[None].to(surfels.points.dtype),
                      surfels.knn_w, surfels.points])
    packed = bank[:, layout.sort_perm.long()][:, layout.src_pos.long()]
    k = surfels.knn_w.shape[0]
    t_cap = layout.tuple_nodes.shape[0]
    tk = graph.points.T[:, layout.tuple_nodes.T.long()]       # (3, K, T)
    g = sol.assembly_pad_group

    ed_idx = graph.knn_idx.long()
    d_eds = graph.points[:, None, :] - graph.points[ed_idx]
    index_map = frame.index_map(cfg.height, cfg.width)
    return LMContext(
        sf_mask=layout.slot_valid & (packed[0] > 0.5),
        sf_knn_w=packed[1:1 + k],
        sf_points=packed[1 + k:4 + k],
        tuple_knn=tk.movedim(0, 1).reshape(3 * k, t_cap),
        trg_points=frame.points,
        trg_norms=frame.norms,
        trg_index_map=index_map,
        trg_corner_bank=build_corner_bank_z(frame.points, frame.norms,
                                            index_map),
        ed_mask=graph.active,
        ed_knn_idx=graph.knn_idx,
        ed_pair_mask=graph.active[:, None] & graph.active[ed_idx],
        d_eds=d_eds,
        ed_skew=skew(d_eds),
        layout=layout,
        slot_tuple=layout.block_tuple.long().repeat_interleave(g),
    )


@functools.lru_cache(maxsize=None)
def _k_perms(k: int, device):
    """Index constants of the all-anchor batched row math: ``p1/p2`` build
    an anchor-blocked cross product on (3K, C) stacks, ``rep3`` repeats
    per-anchor scalars onto their 3 rows, ``hperm`` orders the rows
    anchor-major as [ndqw, ndqv(3), w n(3)].  Made on the device (a copy
    from host memory would synchronise the step with the card), once."""
    r = torch.arange(3 * k, device=device)
    a, i = r // 3, r % 3
    x = torch.arange(7 * k, device=device)
    xa, xo = x // 7, x % 7                   # anchor, row within its 7
    hperm = torch.where(xo == 0, xa, torch.where(
        xo < 4, k + 3 * xa + xo - 1, 4 * k + 3 * xa + xo - 4))
    return 3 * a + (i + 1) % 3, 3 * a + (i + 2) % 3, a, hperm


def _cross_batched(x, y, p1, p2):
    return x[p1] * y[p2] - x[p2] * y[p1]


def _gsum3(x, k):
    """(3K, C) -> (K, C): each anchor's 3 rows summed in order."""
    x3 = x.reshape(k, 3, x.shape[-1])
    return x3[:, 0] + x3[:, 1] + x3[:, 2]


def _sum_k(s, k):
    """(3K, C) -> (3, C): the K anchors' 3-row blocks summed in order."""
    s3 = s.reshape(k, 3, s.shape[-1])
    out = s3[0]
    for a in range(1, k):
        out = out + s3[a]
    return out


def _geom(ctx: LMContext):
    """Per-slot (mask, w (K, Np), knn (3K, Np), diff (3K, Np)); the anchor
    positions come from the per-tuple table."""
    k = ctx.sf_knn_w.shape[0]
    knn_fm = ctx.tuple_knn[:, ctx.slot_tuple]
    diff_fm = ctx.sf_points.repeat(k, 1) - knn_fm
    return ctx.sf_mask, ctx.sf_knn_w, knn_fm, diff_fm


def _beta_fm(ctx: LMContext, beta):
    """Per-slot anchor parameters (K, 7, Np) via the tuple table."""
    beta_t = beta[ctx.layout.tuple_nodes.long()]              # (T, K, 7)
    return beta_t[ctx.slot_tuple].permute(1, 2, 0)


def _warp_fm_batched(w_fm, knn_fm, diff_fm, beta_kfm):
    """Blended warp of every slot with the K anchors batched: (3, C)."""
    k = w_fm.shape[0]
    p1, p2, rep3, _ = _k_perms(k, w_fm.device)
    v = diff_fm
    qw = beta_kfm[:, 0][rep3]
    qv = beta_kfm[:, 1:4].reshape(3 * k, -1)
    bb = beta_kfm[:, 4:7].reshape(3 * k, -1)
    c = _cross_batched(qv, v, p1, p2)
    tv = v + 2.0 * qw * c + 2.0 * _cross_batched(qv, c, p1, p2) + bb
    return _sum_k(w_fm[rep3] * (tv + knn_fm), k)


def _rows_fm_batched(m_fm, w_fm, diff_fm, beta_kfm):
    """Point-plane gradient rows (7K, C), anchor-major [ndqw, ndqv(3),
    w m(3)] -- the column order K2 and reduce_pairs read -- weights
    applied.  n^T dT/dqw = 2 n.(qv x v);
    n^T dT/dqv = 2 [(qv.v) n + (n.qv) v - 2 (n.v) qv - qw (n x v)]."""
    k = w_fm.shape[0]
    p1, p2, rep3, hperm = _k_perms(k, w_fm.device)
    v = diff_fm
    qw = beta_kfm[:, 0][rep3]
    qv = beta_kfm[:, 1:4].reshape(3 * k, -1)
    m_b = m_fm.repeat(k, 1)
    c = _cross_batched(qv, v, p1, p2)
    ndq_w = 2.0 * _gsum3(m_b * c, k)
    qv_v = _gsum3(qv * v, k)
    m_qv = _gsum3(m_b * qv, k)
    m_v = _gsum3(m_b * v, k)
    nxv = _cross_batched(m_b, v, p1, p2)
    ndq_v = 2.0 * (qv_v[rep3] * m_b + m_qv[rep3] * v
                   - 2.0 * m_v[rep3] * qv - qw * nxv)
    w12 = w_fm[rep3]
    return torch.cat([w_fm * ndq_w, w12 * ndq_v, w12 * m_b], dim=0)[hperm]


def associate(cfg: SuPerConfig, ctx: LMContext, intr: Intrinsics) -> Assoc:
    """Projective association at the identity warp (the JAX package's
    ``associate(..., identity=True)``): the blend returns each surfel's own
    point, so the pass is projection plus corner-bank sampling."""
    _, w_fm, knn_fm, diff_fm = _geom(ctx)
    k = w_fm.shape[0]
    _, _, rep3, _ = _k_perms(k, w_fm.device)
    tp = _sum_k(w_fm[rep3] * (diff_fm + knn_fm), k)
    v, u, _, proj_valid = project_points(tp, intr, cfg.height, cfg.width)
    o, n, svalid = bilinear_sample_bank_z_fm(ctx.trg_corner_bank, intr,
                                             cfg.height, cfg.width, v, u)
    return Assoc(o=o, n=n, mask=ctx.sf_mask & proj_valid & svalid)


def _frozen_residual(ctx, beta, assoc: Assoc, weight: float, geom=None):
    """Masked residuals r = lambda n^T (T(p) - o) of every slot."""
    mask_c, w_fm, knn_fm, diff_fm = geom if geom is not None else _geom(ctx)
    beta_kfm = _beta_fm(ctx, beta)
    tp = _warp_fm_batched(w_fm, knn_fm, diff_fm, beta_kfm)
    mask = mask_c & assoc.mask
    r = weight * torch.sum(assoc.n * (tp - assoc.o), dim=0)
    return torch.where(mask, r, 0.0), mask, beta_kfm


def data_term_cost(cfg: SuPerConfig, ctx: LMContext, beta, intr: Intrinsics,
                   weight: float, assoc: Assoc):
    """sum(r^2) of the point-plane term against the frozen association."""
    r, _, _ = _frozen_residual(ctx, beta, assoc, weight)
    return torch.sum(r * r)


def data_rows(ctx: LMContext, beta, weight: float, assoc: Assoc):
    """Gradient rows h (Np, 28) and residuals r (Np,) of every padded slot,
    masked to zeros: kernel K2's input."""
    geom = _geom(ctx)
    r, mask, beta_kfm = _frozen_residual(ctx, beta, assoc, weight, geom)
    rows = _rows_fm_batched(assoc.n, geom[1], geom[3], beta_kfm)
    h = torch.where(mask[None], weight * rows, 0.0)
    return h.T.contiguous(), r


def data_normal_equations(cfg: SuPerConfig, ctx: LMContext, beta,
                          weight: float, assoc: Assoc):
    """Data term in pair form: (acc (P, 49), jtr (J, 7), cost).

    Rows and residuals of every slot, then kernel K2 (tuple Grams), then the
    pair reduction.
    """
    sol = cfg.solver
    h, r = data_rows(ctx, beta, weight, assoc)
    layout = ctx.layout
    gram, jtr_t = tuple_gram(h, r, layout.block_tuple,
                             tuple_cap=layout.tuple_nodes.shape[0],
                             block=sol.assembly_pad_group)
    acc, jtr7 = assembly.reduce_pairs(
        layout, gram, jtr_t, ctx.ed_mask.shape[0],
        sum_dtype=sol.gram_sum_dtype if sol.gram_sum_dtype != "f32" else None)
    return acc, jtr7, torch.sum(r * r)


def arap_term_residual(ctx: LMContext, beta, weight: float):
    """Masked ARAP residuals (J, K_ed, 3)."""
    nb_beta = beta[ctx.ed_knn_idx.long()]
    r = transform_quat_t(ctx.d_eds, nb_beta) - ctx.d_eds - beta[:, None, 4:7]
    return torch.where(ctx.ed_pair_mask[..., None], weight * r, 0.0)


def arap_term_jacobian(ctx: LMContext, beta, weight: float):
    """ARAP residuals + blocks: r = R(q_j)(g_i - g_j) + b_j - (g_i - g_j)
    - b_i touches node j with [dq (3x4), +I] and node i with [0, -I].
    Returns (r (J, K, 3), g (J, K, 3, 2, 7), idx (J, K, 2), mask)."""
    nb_beta = beta[ctx.ed_knn_idx.long()]
    tv, dq = transform_quat_t_jac(ctx.d_eds, nb_beta, skew_v=ctx.ed_skew)
    r = tv - ctx.d_eds - beta[:, None, 4:7]
    j_cap, k = ctx.ed_knn_idx.shape
    eye3 = torch.eye(3, dtype=beta.dtype, device=beta.device).expand(
        j_cap, k, 3, 3)
    zeros34 = beta.new_zeros((j_cap, k, 3, 4))
    g = torch.stack([torch.cat([dq, eye3], dim=-1),
                     torch.cat([zeros34, -eye3], dim=-1)], dim=-2)
    self_idx = torch.arange(j_cap, device=beta.device)[:, None].expand(
        j_cap, k)
    idx = torch.stack([ctx.ed_knn_idx.long(), self_idx], dim=-1)
    mask = ctx.ed_pair_mask
    r = torch.where(mask[..., None], weight * r, 0.0)
    g = torch.where(mask[..., None, None, None], weight * g, 0.0)
    return r, g, idx, mask


def rot_term_residual(beta, active, weight: float):
    q = beta[:, 0:4]
    r = weight * (1.0 - torch.sum(q * q, dim=-1))
    return torch.where(active, r, 0.0)


def rot_term_jacobian(beta, active, weight: float):
    q = beta[:, 0:4]
    r = weight * (1.0 - torch.sum(q * q, dim=-1))
    g = torch.cat([-2.0 * weight * q, torch.zeros_like(beta[:, 4:7])], dim=-1)
    return (torch.where(active, r, 0.0), torch.where(active[:, None], g, 0.0),
            active)


def assemble_normal_equations(cfg: SuPerConfig, ctx: LMContext, beta,
                              intr: Intrinsics, assoc: Assoc):
    """Pair-form normal equations and cost at ``beta``:
    (jtj (P, 49) symmetric-half pair blocks, jtr (7J,), cost)."""
    _check_supported(cfg)
    j_cap = ctx.ed_mask.shape[0]
    losses = cfg.losses
    layout = ctx.layout
    pcap = layout.pair_dest.shape[0]
    jtj = beta.new_zeros((pcap, 49))
    jtr = beta.new_zeros((j_cap, 7))
    cost = beta.new_zeros(())
    if losses.sf_point_plane:
        jtj, jtr, cost = data_normal_equations(
            cfg, ctx, beta, losses.sf_point_plane_weight, assoc)

    graph_rows, graph_ranks = [], []
    if losses.mesh_arap:
        r, g, idx, _ = arap_term_jacobian(ctx, beta, losses.mesh_arap_weight)
        cost = cost + torch.sum(r * r)
        jk = r.shape[0] * r.shape[1]
        r2 = r.reshape(jk, 3)
        g2 = g.reshape(jk, 3, 2, 7)
        idx2 = idx.reshape(jk, 2)
        for a in range(2):
            jtr = jtr.index_add(0, idx2[:, a], -torch.einsum(
                "rci,rc->ri", g2[:, :, a, :], r2))
        b00 = torch.einsum("rci,rcj->rij", g2[:, :, 0], g2[:, :, 0])
        b11 = torch.einsum("rci,rcj->rij", g2[:, :, 1], g2[:, :, 1])
        b01 = torch.einsum("rci,rcj->rij", g2[:, :, 0], g2[:, :, 1])
        swap = layout.arap_swap.reshape(jk)
        boff = torch.where(swap[:, None, None], b01.transpose(1, 2), b01)
        graph_rows += [0.5 * b00.reshape(jk, 49), 0.5 * b11.reshape(jk, 49),
                       boff.reshape(jk, 49)]
        ar = layout.arap_rank.reshape(jk, 3)
        graph_ranks += [ar[:, 0], ar[:, 1], ar[:, 2]]
    if losses.mesh_rot:
        r, g, _ = rot_term_jacobian(beta, ctx.ed_mask, losses.mesh_rot_weight)
        cost = cost + torch.sum(r * r)
        jtr = jtr - g * r[:, None]
        graph_rows.append((0.5 * g[:, :, None] * g[:, None, :]).reshape(
            j_cap, 49))
        graph_ranks.append(layout.diag_rank)
    if graph_rows:
        jtj = jtj + assembly.segment_sum(torch.cat(graph_rows),
                                         torch.cat(graph_ranks), pcap)
    return jtj, jtr.reshape(7 * j_cap), cost


def total_cost(cfg: SuPerConfig, ctx: LMContext, beta, intr: Intrinsics,
               assoc: Assoc):
    """Scalar objective of the LM accept/reject test."""
    losses = cfg.losses
    total = beta.new_zeros(())
    if losses.sf_point_plane:
        total = total + data_term_cost(cfg, ctx, beta, intr,
                                       losses.sf_point_plane_weight, assoc)
    if losses.mesh_arap:
        r = arap_term_residual(ctx, beta, losses.mesh_arap_weight)
        total = total + torch.sum(r * r)
    if losses.mesh_rot:
        r = rot_term_residual(beta, ctx.ed_mask, losses.mesh_rot_weight)
        total = total + torch.sum(r * r)
    return total
