"""Apply the solved deformation to the surfel map and the ED graph
(counterpart of super_tpu/core/warp.py, LM path).

Keeps the reference's quirk (nodes.py:207-210): the surfel normal blend uses
the full 7-vector, so node translations land on the normals before
renormalisation; node normals are rotated only.
"""

from __future__ import annotations

from typing import Tuple

import torch

from super_tpu_torch.config import SuPerConfig
from super_tpu_torch.core.state import GraphState, SurfelState
from super_tpu_torch.geometry.quaternion import transform_quat_t


def _cross_fm(x, y):
    return torch.stack([x[1] * y[2] - x[2] * y[1], x[2] * y[0] - x[0] * y[2],
                        x[0] * y[1] - x[1] * y[0]])


def _rot_fm(qw, qv, v):
    """R(q) v for feature-major (3, C) vectors (qw: (1, C))."""
    c = _cross_fm(qv, v)
    return v + 2.0 * qw * c + 2.0 * _cross_fm(qv, c)


def _warp_chunk(bank, pts_fm, nrm_fm, idx_fm, w_fm):
    """Feature-major warp of a set of surfels.

    bank: (10, J) packed [node xyz; q(4); b(3)]; returns (new_points,
    new_norms), each (3, C).
    """
    k = idx_fm.shape[0]
    g = bank[:, idx_fm.long()]                             # (10, K, C)
    p_acc = 0.0
    n_acc = 0.0
    for a in range(k):
        ga = g[0:3, a]
        qw = g[3:4, a]
        qv = g[4:7, a]
        b = g[7:10, a]
        wa = w_fm[a][None]
        v = pts_fm - ga
        p_acc = p_acc + wa * (_rot_fm(qw, qv, v) + b + ga)
        n_acc = n_acc + wa * (_rot_fm(qw, qv, nrm_fm) + b)
    n_acc = n_acc / torch.clamp(
        torch.sqrt(torch.sum(n_acc * n_acc, dim=0, keepdim=True)), min=1e-12)
    return p_acc, n_acc


def apply_deformation(cfg: SuPerConfig, surfels: SurfelState,
                      graph: GraphState, beta) -> Tuple[SurfelState,
                                                        GraphState]:
    """Warp the active surfels and move the ED nodes by ``beta`` (J, 7)."""
    bank = torch.cat([graph.points.T, beta.T.to(surfels.points.dtype)])
    new_p, new_n = _warp_chunk(bank, surfels.points, surfels.norms,
                               surfels.knn_idx, surfels.knn_w)
    act = surfels.active[None, :]
    surfels = surfels._replace(
        points=torch.where(act, new_p, surfels.points),
        norms=torch.where(act, new_n, surfels.norms))

    new_node_points = graph.points + beta[:, 4:7]
    nn = transform_quat_t(graph.norms, beta[:, 0:4])
    nn = nn / torch.clamp(torch.sqrt(torch.sum(nn * nn, dim=-1, keepdim=True)),
                          min=1e-12)
    gact = graph.active[:, None]
    graph = graph._replace(
        points=torch.where(gact, new_node_points, graph.points),
        norms=torch.where(gact, nn, graph.norms))
    return surfels, graph
