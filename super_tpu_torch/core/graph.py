"""ED-graph construction on the grid mesh (counterpart of
super_tpu/core/graph.py).

The anchor grid, edge list and triangle list are static for a given
(height, width, mesh_step_size); per-frame validity only toggles masks.
``grid_layout`` is a numpy copy of the JAX package's function.
"""

from __future__ import annotations

import numpy as np
import torch

from super_tpu_torch.config import SuPerConfig
from super_tpu_torch.core.state import FrameData, GraphState
from super_tpu_torch.geometry.quaternion import cross
from super_tpu_torch.kernels.segsum import segment_plan, segment_sum


def grid_layout(height: int, width: int, step: int):
    """Static anchor/edge/triangle topology of the grid mesh (numpy).

    Returns (anchor_pix (G,), edges (E0, 2), triangles (T0, 3)), int32.
    Anchors sit at u in range(0, width-1, step), v in range(0, height-1,
    step).
    """
    us = np.arange(0, width - 1, step)
    vs = np.arange(0, height - 1, step)
    gw, gh = len(us), len(vs)
    gx, gy = np.meshgrid(np.arange(gw), np.arange(gh))
    anchor_pix = (vs[gy] * width + us[gx]).reshape(-1).astype(np.int32)

    def nid(y, x):
        return (y * gw + x).astype(np.int32)

    y, x = gy, gx
    has_r = x + 1 < gw
    has_d = y + 1 < gh
    has_rd = has_r & has_d
    edges = np.concatenate([
        np.stack([nid(y, x)[has_r], nid(y, x + 1)[has_r]], axis=1),
        np.stack([nid(y, x)[has_rd], nid(y + 1, (x + 1) % gw)[has_rd]],
                 axis=1),
        np.stack([nid(y, x)[has_d], nid(y + 1, x)[has_d]], axis=1),
        np.stack([nid(y, (x + 1) % gw)[has_rd], nid(y + 1, x)[has_rd]],
                 axis=1),
    ], axis=0)
    s = nid(y, x)[has_rd]
    p1 = nid(y, (x + 1) % gw)[has_rd]
    p2 = nid(y + 1, (x + 1) % gw)[has_rd]
    p3 = nid(y + 1, x)[has_rd]
    tris = np.concatenate([np.stack([s, p1, p2], axis=1),
                           np.stack([s, p2, p3], axis=1)], axis=0)
    return anchor_pix, edges.astype(np.int32), tris.astype(np.int32)


def _pad_rows(x, n):
    pad = torch.zeros((n - x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    return torch.cat([x, pad], dim=0)


def build_graph(cfg: SuPerConfig, frame: FrameData) -> GraphState:
    """ED graph from a frame's valid map: node attributes at the anchor
    pixels, edge rest lengths, radius = mean incident active edge length
    (mean of the rest where a node has none), triangle rest areas."""
    cap = cfg.capacity
    dev = frame.points.device
    anchor_pix, edges_np, tris_np = grid_layout(cfg.height, cfg.width,
                                                cfg.mesh_step_size)
    g = len(anchor_pix)
    if g > cap.node_capacity:
        raise ValueError(
            f"grid has {g} anchors > node_capacity {cap.node_capacity}; "
            f"raise capacity or mesh_step_size")
    if len(edges_np) > cap.edge_capacity or \
            len(tris_np) > cap.triangle_capacity:
        raise ValueError("edge/triangle capacity too small for this grid")

    pix = torch.as_tensor(anchor_pix, device=dev).long()
    active = frame.valid[pix]
    points = frame.points[:, pix].T.contiguous()
    norms = frame.norms[:, pix].T.contiguous()
    seg_conf = frame.seg_conf[:, pix].T.contiguous()
    if cfg.method == "semantic-super":
        seg = torch.argmax(seg_conf, dim=1).to(torch.int32)
    else:
        seg = frame.seg[pix]

    e = torch.as_tensor(edges_np, device=dev)
    el = e.long()
    edge_active = active[el[:, 0]] & active[el[:, 1]]
    t = torch.as_tensor(tris_np, device=dev)
    tl = t.long()
    tri_active = active[tl[:, 0]] & active[tl[:, 1]] & active[tl[:, 2]]
    if cfg.hard_seg and cfg.losses.mesh_face:
        edge_active = edge_active & (seg[el[:, 0]] == seg[el[:, 1]])
        tri_active = (tri_active & (seg[tl[:, 0]] == seg[tl[:, 1]])
                      & (seg[tl[:, 0]] == seg[tl[:, 2]]))

    dtype = points.dtype
    dvec = points[el[:, 0]] - points[el[:, 1]]
    edge_lens = torch.sqrt(torch.sum(dvec * dvec, dim=1))
    edge_lens = torch.where(edge_active, edge_lens, 0.0).to(dtype)

    # Incident edge lengths and counts per node, both ends, in a fixed
    # order.
    ends = torch.stack([edge_lens, edge_active.to(dtype)], dim=1)
    sums = segment_sum(torch.cat([ends, ends]),
                       segment_plan(torch.cat([el[:, 0], el[:, 1]]), g))
    len_sum, cnt = sums[:, 0], sums[:, 1]
    radii = len_sum / torch.clamp(cnt, min=1.0)
    has_r = (cnt > 0) & active
    mean_r = torch.sum(torch.where(has_r, radii, 0.0)) / torch.clamp(
        torch.sum(has_r.to(dtype)), min=1.0)
    radii = torch.where(has_r, radii, mean_r)

    cr = cross(points[tl[:, 1]] - points[tl[:, 0]],
               points[tl[:, 2]] - points[tl[:, 0]])
    tri_areas = 0.5 * torch.sqrt(torch.sum(cr * cr, dim=1) + 1e-13)
    tri_areas = torch.where(tri_active, tri_areas, 0.0)

    jcap = cap.node_capacity
    k = cfg.num_ed_neighbors
    return GraphState(
        points=_pad_rows(points, jcap),
        norms=_pad_rows(norms, jcap),
        radii=_pad_rows(radii, jcap),
        active=_pad_rows(active, jcap),
        knn_idx=torch.zeros((jcap, k), dtype=torch.int32, device=dev),
        knn_w=torch.zeros((jcap, k), dtype=dtype, device=dev),
        edges=_pad_rows(e, cap.edge_capacity),
        edge_active=_pad_rows(edge_active, cap.edge_capacity),
        edge_lens=_pad_rows(edge_lens, cap.edge_capacity),
        triangles=_pad_rows(t, cap.triangle_capacity),
        tri_active=_pad_rows(tri_active, cap.triangle_capacity),
        tri_areas=_pad_rows(tri_areas, cap.triangle_capacity),
        seg=_pad_rows(seg, jcap),
        seg_conf=_pad_rows(seg_conf, jcap),
    )
