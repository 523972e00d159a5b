"""KNN anchoring: node-node weights and surfel-node anchors (counterpart of
super_tpu/core/anchoring.py).

Weights are ``softmax(exp(-d / r))`` over the finite-distance neighbours;
surfels farther than every anchor's radius are de-stabilised.  The
"semantic-super" method (soft segmentation) blends in the class agreement
of surfel and node: ``softmax(exp(-JSD)^0.5 exp(-d / r)^0.5)``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from super_tpu_torch.config import SuPerConfig
from super_tpu_torch.core.state import GraphState, SurfelState
from super_tpu_torch.ops.knn import masked_knn, self_knn

_JSD_EPS = 1e-13  # the reference's epsilon convention (geometry/divergence)


def _stable_softmax0(z):
    """Softmax over axis 0 with -inf masking."""
    zmax = torch.amax(z, dim=0, keepdim=True)
    zmax = torch.where(torch.isfinite(zmax), zmax, 0.0)
    e = torch.exp(z - zmax)
    e = torch.where(torch.isfinite(z), e, 0.0)
    return e / torch.clamp(torch.sum(e, dim=0, keepdim=True), min=1e-20)


def _softmax_exp_neg0(scores, finite_mask):
    """softmax(exp(-scores)) over axis 0, restricted to finite entries."""
    z = torch.where(finite_mask, torch.exp(-scores), float("-inf"))
    return _stable_softmax0(z)


def _jsd_channelwise(graph_conf_t, idx, q_conf, ps=None):
    """JSD (K, N) between the anchor nodes' class confidences (graph_conf_t
    (C, J) gathered at idx (K, N), or ``ps`` (C, K, N) given) and the
    points' q_conf (C, N)."""
    if ps is None:
        ps = graph_conf_t[:, idx.long()]
    kl_pm = kl_qm = 0.0
    for ch in range(graph_conf_t.shape[0]):
        p = ps[ch]
        q = q_conf[ch][None, :]
        m = 0.5 * (p + q)
        kl_pm = kl_pm + p * torch.log(p / (m + _JSD_EPS) + _JSD_EPS)
        kl_qm = kl_qm + q * torch.log(q / (m + _JSD_EPS) + _JSD_EPS)
    return 0.5 * (kl_pm + kl_qm)


def _anchor_weights(cfg, graph, idx, dists, radii, finite, seg_conf,
                    conf_ps=None):
    nd = dists / torch.clamp(radii, min=1e-12)
    if cfg.method == "semantic-super" and not cfg.hard_seg and \
            seg_conf is not None:
        div = _jsd_channelwise(graph.seg_conf.T, idx, seg_conf, ps=conf_ps)
        return _softmax_exp_neg0(0.5 * div + 0.5 * nd, finite)
    return _softmax_exp_neg0(nd, finite)


def update_graph_knn(cfg: SuPerConfig, graph: GraphState) -> GraphState:
    """Node-node neighbour graph + ARAP blend weights."""
    k = cfg.num_ed_neighbors
    dists, idx = self_knn(graph.points.T, k, mask=graph.active,
                          seg=graph.seg if cfg.hard_seg else None)
    nd = dists / torch.clamp(graph.radii[None, :], min=1e-12)
    w = _softmax_exp_neg0(nd, torch.isfinite(dists))
    return graph._replace(knn_idx=idx.T.contiguous(), knn_w=w.T.contiguous())


# Compare-exchange sorting networks for small K (swap rows a, b when
# key_a > key_b), as in the JAX package.
_SORT_NETS = {
    2: [(0, 1)],
    3: [(0, 1), (1, 2), (0, 1)],
    4: [(0, 1), (2, 3), (0, 2), (1, 3), (1, 2)],
    5: [(0, 1), (3, 4), (2, 4), (2, 3), (1, 4), (0, 3), (0, 2), (1, 3),
        (1, 2)],
    6: [(1, 2), (4, 5), (0, 2), (3, 5), (0, 1), (3, 4), (2, 5), (0, 3),
        (1, 4), (2, 4), (1, 3), (2, 3)],
}


def _sort_anchors_by_id(idx, dists):
    """Sort the K anchor rows by node id, carrying distances along (ids are
    distinct per query, so the ascending order is unique)."""
    k = idx.shape[0]
    if k not in _SORT_NETS:
        order = torch.argsort(idx, dim=0)
        return (torch.take_along_dim(idx, order, dim=0),
                torch.take_along_dim(dists, order, dim=0))
    ids = [idx[i] for i in range(k)]
    ds = [dists[i] for i in range(k)]
    for a, b in _SORT_NETS[k]:
        swap = ids[a] > ids[b]
        ids[a], ids[b] = (torch.where(swap, ids[b], ids[a]),
                          torch.where(swap, ids[a], ids[b]))
        ds[a], ds[b] = (torch.where(swap, ds[b], ds[a]),
                        torch.where(swap, ds[a], ds[b]))
    return torch.stack(ids), torch.stack(ds)


def anchor_points(cfg: SuPerConfig, graph: GraphState, points, mask,
                  seg=None, seg_conf=None) -> Tuple[torch.Tensor,
                                                    torch.Tensor,
                                                    torch.Tensor]:
    """K nearest ED nodes per point (ascending node id), blend weights and
    the stability mask: (knn_idx (K, N), knn_w (K, N), stable (N,)).
    ``seg`` (N,) gates the KNN with ``hard_seg``; ``seg_conf`` (C, N) takes
    part in the semantic weights."""
    k = cfg.num_neighbors
    dists, idx = masked_knn(
        points, graph.points.T, k, query_mask=mask, ref_mask=graph.active,
        query_seg=seg if cfg.hard_seg else None,
        ref_seg=graph.seg if cfg.hard_seg else None)
    idx, dists = _sort_anchors_by_id(idx, dists)
    radii = graph.radii[idx.long()]
    finite = torch.isfinite(dists)
    stable = mask & torch.any(finite & (dists <= radii), dim=0)
    return idx, _anchor_weights(cfg, graph, idx, dists, radii, finite,
                                seg_conf), stable


def recompute_surfel_weights(cfg: SuPerConfig, surfels: SurfelState,
                             graph: GraphState) -> SurfelState:
    """Refresh knn_w from the current positions, keeping anchor ids."""
    idx = surfels.knn_idx.long()                           # (K, N)
    rows = [graph.points.T, graph.radii[None]]             # (4, J)
    semantic = cfg.method == "semantic-super" and not cfg.hard_seg
    if semantic:
        rows.append(graph.seg_conf.T)                      # + (C, J)
    g = torch.cat(rows, dim=0)[:, idx]                     # (F, K, N)
    diff = surfels.points[:, None, :] - g[:3]
    dists = torch.sqrt(torch.sum(diff * diff, dim=0))
    w = _anchor_weights(cfg, graph, idx, dists, g[3],
                        torch.ones_like(dists, dtype=torch.bool),
                        surfels.seg_conf, conf_ps=g[4:] if semantic else None)
    return surfels._replace(knn_w=w)
