"""Residuals and normal equations of the LM warp solve (counterpart of the
tuple-mode parts of super_tpu/core/losses.py).

The data term is point-to-plane ICP.  Against a frozen association (an
:class:`Assoc`: once a frame at the identity warp for ``association=
"per_frame"``, at every candidate for ``"per_iteration_frozen"``) each
trip re-linearises only the warp: kernel K2 computes the gradient row and
residual of every padded slot in registers and reduces them to per-tuple
Grams (kernels/gram.py:data_gram) -- the JAX package's ``assembly_backend=
"pallas"`` branch with its row math (``frozen_chunk_partial_fm``) fused
in; :func:`data_rows` gives the same rows in plain PyTorch.  With no
association (``"per_iteration"``, the moving target) each trip projects
the warped surfels, samples the target bank with its gradients and writes
the full-chain rows to memory (:func:`moving_rows`, the algebra of the JAX
package's ``moving_chunk_partial_fm``), which K2's memory form
(kernels/gram.py:tuple_gram) reduces.  With the ``pairs_fused`` solver
:func:`assembly.reduce_pairs` folds the Grams into the pair-sparse normal
equations and the graph-sized ARAP and rotation terms add their blocks in
the same pair form; the dense solvers (``cholesky``, ``pcg``,
``pcg_pallas``) get the (7J, 7J) matrix from :func:`assembly.expand_pairs`
with the graph terms' blocks added into it.  Every sum over rows that
share a destination goes through the fixed-order segmented sum
(kernels/segsum.py), sorted once a frame in :func:`prepare_lm`.

The plain versions compute all slots (no stop at ``layout.live_end``):
sink and padding slots are masked to exact zeros.  The kernel finds the
sink tuple's blocks on the device and skips them: no device count has to
reach the host.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

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
from super_tpu_torch.kernels.gram import data_gram, tuple_gram
from super_tpu_torch.kernels.segsum import SegmentPlan, segment_plan, \
    segment_sum
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
    # Fixed-order sums of the graph terms, sorted once a frame: the ARAP
    # J^T r rows by node; with pairs_fused the graph rows by pair rank,
    # else the graph blocks' rows by (matrix row, node column).
    arap_plan: Optional[SegmentPlan] = None
    graph_plan: Optional[SegmentPlan] = None
    block_plan: Optional[SegmentPlan] = None


class Assoc(NamedTuple):
    """Frozen association: target point/normal per slot."""

    o: torch.Tensor     # (3, Np)
    n: torch.Tensor     # (3, Np)
    mask: torch.Tensor  # (Np,)


def _check_supported(cfg: SuPerConfig):
    sol = cfg.solver
    dense = sol.linear_solver in ("cholesky", "pcg", "pcg_pallas")
    if sol.assembly_mode != "tuple" or cfg.num_neighbors != 4 or \
            sol.jtj_dtype != "f32" or \
            not (sol.linear_solver == "pairs_fused" or dense) or \
            (dense and sol.assembly_expand != "pairs"):
        raise NotImplementedError(
            "the port runs the tuple assembly (K=4) in f32 with the "
            "pairs_fused solver, or with the pair expansion and the "
            "cholesky, pcg or pcg_pallas solver; other assembly modes, "
            "expansions and solvers are not ported")


def prepare_lm(cfg: SuPerConfig, surfels: SurfelState, graph: GraphState,
               frame: FrameData) -> LMContext:
    _check_supported(cfg)
    sol = cfg.solver
    dev = surfels.points.device
    j_cap = graph.capacity
    pairs_fused = sol.linear_solver == "pairs_fused"
    self_idx = torch.arange(j_cap, dtype=torch.int32, device=dev)
    nb = graph.knn_idx.to(torch.int32)
    self_b = self_idx[:, None].expand(nb.shape)
    extra_pairs = None
    if pairs_fused:
        # The sparse solve keeps the graph terms in pair form too: their
        # pairs (ED edges + node diagonals) must exist in the table.
        extra_pairs = torch.cat([
            torch.stack([self_b.reshape(-1), nb.reshape(-1)], dim=1),
            torch.stack([self_idx, self_idx], dim=1)])
    layout = assembly.build_tuple_layout(
        surfels.knn_idx, surfels.active, j_cap,
        tuple_cap=sol.assembly_tuple_cap, pad_group=sol.assembly_pad_group,
        chunk=sol.assembly_chunk, pair_cap=sol.assembly_pair_cap,
        extra_pairs=extra_pairs)
    if pairs_fused:
        pk = layout.pair_key
        lookup = assembly.pair_rank_lookup
        layout = layout._replace(
            diag_rank=lookup(pk, j_cap, torch.stack([self_idx, self_idx],
                                                    -1)),
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
    arap_plan, graph_plan, block_plan = _graph_plans(cfg, layout, nb, self_b)
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
        arap_plan=arap_plan, graph_plan=graph_plan, block_plan=block_plan,
    )


def _graph_blocks(cfg: SuPerConfig, nb, self_b):
    """The graph terms' (row node, column node) blocks in the order
    :func:`assemble_normal_equations` adds them: the ARAP term's (a, b) in
    (0, 0), (0, 1), (1, 0), (1, 1), with node 0 the ED neighbour and node 1
    the node itself, then the rotation term's diagonal."""
    nodes = (nb.reshape(-1), self_b.reshape(-1))
    rows, cols = [], []
    if cfg.losses.mesh_arap:
        for a in range(2):
            for b in range(2):
                rows.append(nodes[a])
                cols.append(nodes[b])
    if cfg.losses.mesh_rot:
        diag = self_b[:, 0]
        rows.append(diag)
        cols.append(diag)
    return rows, cols


def _graph_plans(cfg: SuPerConfig, layout, nb, self_b):
    """The graph terms' segment plans (:class:`LMContext`)."""
    j_cap = nb.shape[0]
    arap_plan = graph_plan = block_plan = None
    if cfg.losses.mesh_arap:
        arap_plan = segment_plan(torch.cat([nb.reshape(-1),
                                            self_b.reshape(-1)]), j_cap)
    rows, cols = _graph_blocks(cfg, nb, self_b)
    if not rows:
        return arap_plan, graph_plan, block_plan
    if cfg.solver.linear_solver == "pairs_fused":
        ranks = []
        if cfg.losses.mesh_arap:
            ranks += list(layout.arap_rank.reshape(-1, 3).T)
        if cfg.losses.mesh_rot:
            ranks.append(layout.diag_rank)
        graph_plan = segment_plan(torch.cat(ranks),
                                  layout.pair_dest.shape[0])
    else:
        # Row i of block (r, c) is 7 entries of matrix row 7 r + i at
        # column 7 c: segment (7 r + i) J + c of the matrix as (7J J, 7).
        r = torch.cat(rows).long()
        c = torch.cat(cols).long()
        seven = torch.arange(7, device=r.device)
        ids = (7 * r[:, None] + seven[None, :]) * j_cap + c[:, None]
        block_plan = segment_plan(ids, 7 * j_cap * j_cap)
    return arap_plan, graph_plan, block_plan


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


def _blend_warp(ctx: LMContext, beta):
    """(3, Np) warped points of every slot; ``beta=None`` is the identity
    warp, where the blend returns each surfel's own point."""
    _, w_fm, knn_fm, diff_fm = _geom(ctx)
    if beta is not None:
        return _warp_fm_batched(w_fm, knn_fm, diff_fm, _beta_fm(ctx, beta))
    k = w_fm.shape[0]
    _, _, rep3, _ = _k_perms(k, w_fm.device)
    return _sum_k(w_fm[rep3] * (diff_fm + knn_fm), k)


def _project_sample(cfg: SuPerConfig, ctx: LMContext, tp, intr: Intrinsics,
                    grad: bool = False):
    """Project (3, Np) warped points and sample the target bank there:
    (o, n, mask), plus the sampling gradients (go_u, go_v, gn_u, gn_v) with
    ``grad`` (the JAX package's ``_project_sample_fm``)."""
    v, u, _, proj_valid = project_points(tp, intr, cfg.height, cfg.width)
    out = bilinear_sample_bank_z_fm(ctx.trg_corner_bank, intr, cfg.height,
                                    cfg.width, v, u, compute_grad=grad)
    return (out[0], out[1], ctx.sf_mask & proj_valid & out[2]) + out[3:]


def associate(cfg: SuPerConfig, ctx: LMContext, intr: Intrinsics,
              beta=None) -> Assoc:
    """Projective association at ``beta`` (the JAX package's
    ``associate``); the default is the identity warp (``identity=True``
    there), where the pass is projection plus corner-bank sampling."""
    o, n, mask = _project_sample(cfg, ctx, _blend_warp(ctx, beta), intr)
    return Assoc(o=o, n=n, mask=mask)


def _frozen_residual(ctx, beta, assoc: Assoc, weight: float, geom=None):
    """Masked residuals r = lambda n^T (T(p) - o) of every slot."""
    mask_c, w_fm, knn_fm, diff_fm = geom if geom is not None else _geom(ctx)
    beta_kfm = _beta_fm(ctx, beta)
    tp = _warp_fm_batched(w_fm, knn_fm, diff_fm, beta_kfm)
    mask = mask_c & assoc.mask
    r = weight * torch.sum(assoc.n * (tp - assoc.o), dim=0)
    return torch.where(mask, r, 0.0), mask, beta_kfm


def data_term_cost(cfg: SuPerConfig, ctx: LMContext, beta, intr: Intrinsics,
                   weight: float, assoc: Optional[Assoc] = None):
    """sum(r^2) of the point-plane term: against the frozen association,
    or with none by sampling the target bank at the warped points (the
    JAX package's ``_residual_of``)."""
    if assoc is None:
        tp = _blend_warp(ctx, beta)
        o, n, mask = _project_sample(cfg, ctx, tp, intr)
        r = torch.where(mask, weight * torch.sum(n * (tp - o), dim=0), 0.0)
    else:
        r, _, _ = _frozen_residual(ctx, beta, assoc, weight)
    return torch.sum(r * r)


def data_rows(ctx: LMContext, beta, weight: float, assoc: Assoc):
    """Gradient rows h (Np, 28) and residuals r (Np,) of every padded slot,
    masked to zeros: what kernel K2 computes in registers
    (kernels/gram.py:data_gram), and the input of its memory form."""
    geom = _geom(ctx)
    r, mask, beta_kfm = _frozen_residual(ctx, beta, assoc, weight, geom)
    rows = _rows_fm_batched(assoc.n, geom[1], geom[3], beta_kfm)
    h = torch.where(mask[None], weight * rows, 0.0)
    return h.T.contiguous(), r


def moving_rows(cfg: SuPerConfig, ctx: LMContext, beta, intr: Intrinsics,
                weight: float):
    """Moving-target gradient rows h (Np, 28) and residuals r (Np,) of
    every padded slot, masked to zeros (the input of K2's memory form).

    The JAX package's ``moving_chunk_partial_fm`` algebra: the full chain
    through the projection and the bilinear sample collapses to the
    frozen-target rows with the effective normal
    m = n + dpi^T [(tp - o) . dn/dpi - n . dp/dpi]; r = w n . (tp - o)."""
    geom = _geom(ctx)
    _, w_fm, _, diff_fm = geom
    beta_kfm = _beta_fm(ctx, beta)
    tp = _warp_fm_batched(w_fm, geom[2], diff_fm, beta_kfm)
    o, n, mask, go_u, go_v, gn_u, gn_v = _project_sample(cfg, ctx, tp, intr,
                                                         grad=True)
    d = tp - o
    y0 = torch.sum(d * gn_u, dim=0) - torch.sum(n * go_u, dim=0)
    y1 = torch.sum(d * gn_v, dim=0) - torch.sum(n * go_v, dim=0)
    z = tp[2] + 1e-8
    m = torch.stack([
        n[0] + intr.fx / z * y0,
        n[1] + intr.fy / z * y1,
        n[2] - intr.fx * tp[0] / (z * z) * y0
        - intr.fy * tp[1] / (z * z) * y1,
    ])
    r = torch.where(mask, weight * torch.sum(n * d, dim=0), 0.0)
    rows = _rows_fm_batched(m, w_fm, diff_fm, beta_kfm)
    h = torch.where(mask[None], weight * rows, 0.0)
    return h.T.contiguous(), r


def data_normal_equations(cfg: SuPerConfig, ctx: LMContext, beta,
                          weight: float, assoc: Optional[Assoc],
                          intr: Intrinsics):
    """Data term: (jtj, jtr (J, 7), cost), with jtj the (P, 49) pair form
    for ``pairs_fused`` and the dense (7J, 7J) matrix otherwise.

    Against a frozen association kernel K2 computes each slot's row and
    residual and their per-tuple Grams in one pass (kernels/gram.py:
    data_gram); with none the moving-target rows go to memory and K2's
    memory form reduces them (kernels/gram.py:tuple_gram).  Then the pair
    reduction or the pair expansion.
    """
    sol = cfg.solver
    if assoc is None:
        h, r = moving_rows(cfg, ctx, beta, intr, weight)
        layout = ctx.layout
        gram, jtr_t = tuple_gram(h, r, layout.block_tuple,
                                 tuple_cap=layout.tuple_nodes.shape[0],
                                 block=sol.assembly_pad_group)
        cost = torch.sum(r * r)
    else:
        gram, jtr_t, cost = data_gram(ctx, beta, weight, assoc,
                                      block=sol.assembly_pad_group)
    fold = assembly.reduce_pairs if sol.linear_solver == "pairs_fused" \
        else assembly.expand_pairs
    jtj, jtr7 = fold(
        ctx.layout, gram, jtr_t, ctx.ed_mask.shape[0],
        sum_dtype=sol.gram_sum_dtype if sol.gram_sum_dtype != "f32" else None)
    return jtj, jtr7, cost


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
                              intr: Intrinsics, assoc: Optional[Assoc]):
    """Normal equations and cost at ``beta``: (jtj, jtr (7J,), cost).

    jtj is the (P, 49) pair form (symmetric-half pair blocks) for the
    ``pairs_fused`` solver, the dense (7J, 7J) matrix for the others.
    ``assoc=None``: the data term's moving target (see
    :func:`data_normal_equations`).  The graph terms' blocks and J^T r rows
    are summed in a fixed order by the plans of :func:`prepare_lm`.
    """
    _check_supported(cfg)
    j_cap = ctx.ed_mask.shape[0]
    losses = cfg.losses
    layout = ctx.layout
    pairs_fused = cfg.solver.linear_solver == "pairs_fused"
    if pairs_fused:
        jtj = beta.new_zeros((layout.pair_dest.shape[0], 49))
    else:
        jtj = beta.new_zeros((7 * j_cap, 7 * j_cap))
    jtr = beta.new_zeros((j_cap, 7))
    cost = beta.new_zeros(())
    if losses.sf_point_plane:
        jtj, jtr, cost = data_normal_equations(
            cfg, ctx, beta, losses.sf_point_plane_weight, assoc, intr)

    graph_rows, blocks = [], []
    if losses.mesh_arap:
        r, g, idx, _ = arap_term_jacobian(ctx, beta, losses.mesh_arap_weight)
        cost = cost + torch.sum(r * r)
        jk = r.shape[0] * r.shape[1]
        r2 = r.reshape(jk, 3)
        g2 = g.reshape(jk, 3, 2, 7)
        jtr = segment_sum(torch.cat([
            -torch.einsum("rci,rc->ri", g2[:, :, a, :], r2)
            for a in range(2)]), ctx.arap_plan, base=jtr)
        if pairs_fused:
            # Distinct-pair rows under the symmetric-half convention
            # (diagonal pairs halved, off-diagonal oriented min -> max).
            b00 = torch.einsum("rci,rcj->rij", g2[:, :, 0], g2[:, :, 0])
            b11 = torch.einsum("rci,rcj->rij", g2[:, :, 1], g2[:, :, 1])
            b01 = torch.einsum("rci,rcj->rij", g2[:, :, 0], g2[:, :, 1])
            swap = layout.arap_swap.reshape(jk)
            boff = torch.where(swap[:, None, None], b01.transpose(1, 2), b01)
            graph_rows += [0.5 * b00.reshape(jk, 49),
                           0.5 * b11.reshape(jk, 49), boff.reshape(jk, 49)]
        else:
            blocks += [torch.einsum("rci,rcj->rij", g2[:, :, a], g2[:, :, b])
                       for a in range(2) for b in range(2)]
    if losses.mesh_rot:
        r, g, _ = rot_term_jacobian(beta, ctx.ed_mask, losses.mesh_rot_weight)
        cost = cost + torch.sum(r * r)
        jtr = jtr - g * r[:, None]
        ggt = g[:, :, None] * g[:, None, :]
        if pairs_fused:
            graph_rows.append(0.5 * ggt.reshape(j_cap, 49))
        else:
            blocks.append(ggt)
    if graph_rows:
        jtj = jtj + segment_sum(torch.cat(graph_rows), ctx.graph_plan)
    if blocks:
        # The blocks' rows added at (matrix row, node column): the JAX
        # package's ``jtj.at[r, c].add(blocks)``, in the same order.
        dim = 7 * j_cap
        jtj = segment_sum(torch.cat(blocks).reshape(-1, 7), ctx.block_plan,
                          base=jtj.reshape(dim * j_cap, 7)).reshape(dim, dim)
    return jtj, jtr.reshape(7 * j_cap), cost


def total_cost(cfg: SuPerConfig, ctx: LMContext, beta, intr: Intrinsics,
               assoc: Optional[Assoc]):
    """Scalar objective of the LM accept/reject test; the data term by
    sampling the target at ``beta`` where ``assoc`` is None."""
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
