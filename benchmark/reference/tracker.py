"""Plain reference of one SuPer frame: preprocessing, the frame-0 start, the
LM warp solve, the warp, fusion and pruning, and the tracked points.

Written from the configuration (a dict of the port's config fields) and
SuPer's published algorithm, in float64 by default.  Each stage is plain
tensor code: the data term's Jacobian rows come from autograd, the normal
equations are one dense (7J, 7J) matrix, the damped system is solved by
the configuration's block-Jacobi preconditioned CG on that matrix, and the
fusion's layers, merges and adds are sorts and masks over the whole map.

The configuration's one precision step below float32 is kept: with
``gram_sum_dtype`` "bf16" each anchor tuple's Gram (the surfels sharing
one set of anchors) is rounded to bfloat16 before the tuples are summed,
as the configuration states.

A :class:`Prec` says how the reference computes: ``dtype``, and ``store``,
applied to every floating value a stage hands on (the identity for the
reference; bfloat16 rounding for the control, which stands in for a port
that keeps its map and frames in bfloat16).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

DIVTERM = 1.0 / (2.0 * 0.6 * 0.6)


def _keep(x):
    return x


def bf16_store(x):
    return x.to(torch.bfloat16).to(x.dtype)


class Prec(NamedTuple):
    dtype: torch.dtype = torch.float64
    store: Callable = _keep


REF = Prec()


CONTROL = Prec(dtype=torch.float32, store=bf16_store)


def fields(nt, prec: Prec) -> dict:
    """A state's fields (a NamedTuple of tensors) as a dict, floats in the
    reference's precision."""
    out = {}
    for k, v in nt._asdict().items():
        if isinstance(v, torch.Tensor) and v.is_floating_point():
            v = prec.store(v.to(prec.dtype))
        elif isinstance(v, torch.Tensor):
            v = v.clone()
        out[k] = v
    return out


def _store(d: dict, prec: Prec) -> dict:
    return {k: prec.store(v) if isinstance(v, torch.Tensor)
            and v.is_floating_point() else v for k, v in d.items()}


# --------------------------------------------------------------------------
# geometry

def cross(a, b, dim=0):
    a0, a1, a2 = a.unbind(dim)
    b0, b1, b2 = b.unbind(dim)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=dim)


def rotate(q, v, dim=0):
    """R(q) v = v + 2 qw (qv x v) + 2 qv x (qv x v), SuPer's non-unit
    quaternion form; q has 4 entries along ``dim``, v 3."""
    qw = q.narrow(dim, 0, 1)
    qv = q.narrow(dim, 1, 3)
    c = cross(qv, v, dim)
    return v + 2.0 * qw * c + 2.0 * cross(qv, c, dim)


def project(points, intr):
    """(u, v) of (3, N) camera points."""
    fx, fy, cx, cy = intr
    z = points[2] + 1e-8
    return points[0] * fx / z + cx, points[1] * fy / z + cy


def pixel_of(u, v, height, width):
    """(pixel id, in-frame) of projected coordinates, rounded half to even;
    in frame means 0 <= row < H - 1 and 0 <= column < W - 1."""
    ui, vi = torch.round(u).long(), torch.round(v).long()
    ok = (vi >= 0) & (vi < height - 1) & (ui >= 0) & (ui < width - 1)
    return vi * width + ui, ok


# --------------------------------------------------------------------------
# preprocessing

def _nan_pad(x):
    return torch.nn.functional.pad(x, (1, 1, 1, 1), value=float("nan"))


def _nb(p, dy, dx):
    h, w = p.shape[-2] - 2, p.shape[-1] - 2
    return p[..., 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]


def preprocess(cfg: dict, intr, depth, color, time: float, seg=None,
               seg_conf=None, prec: Prec = REF) -> dict:
    """Depth (H, W) and colour (H, W, 3) -> the frame's surfel candidates,
    pixel-indexed: points, norms, colors (3, P), radii, confs (P,), valid
    (P,), seg (P,), seg_conf (C, P), dist2edge (P,), time."""
    dt = prec.dtype
    h, w = cfg["height"], cfg["width"]
    fx, fy, cx, cy = intr
    depth = depth.to(dt)
    color = color.to(dt).permute(2, 0, 1)
    if cfg["data"] != "superv1":
        raise NotImplementedError("the reference covers the superv1 rules")
    invalid = ~(depth > 0) | (depth > 1.5) | torch.isnan(depth)
    depth = torch.where(invalid, float("nan"), depth)
    vv, uu = torch.meshgrid(torch.arange(h, dtype=dt, device=depth.device),
                            torch.arange(w, dtype=dt, device=depth.device),
                            indexing="ij")
    points = torch.stack([(uu - cx) * depth / fx, (vv - cy) * depth / fy,
                          depth])
    # Colour-weighted 8-neighbour normal: the sum over neighbour pairs
    # i < j (order L, LU, U, RU, R, RD, D, DL) of d_i x d_j.
    pp, cp = _nan_pad(points), _nan_pad(color)
    offs = [(0, -1), (-1, -1), (-1, 0), (-1, 1), (0, 1), (1, 1), (1, 0),
            (1, -1)]
    ds = []
    for dy, dx in offs:
        wgt = torch.exp(-torch.mean(torch.abs(_nb(cp, dy, dx) - color), 0))
        ds.append((_nb(pp, dy, dx) - points) * wgt)
    n = torch.zeros_like(points)
    for i in range(8):
        for j in range(i + 1, 8):
            n = n + cross(ds[i], ds[j])
    n = n / torch.linalg.vector_norm(n, dim=0)
    valid = ~torch.isnan(n).any(0) & ~torch.isnan(points).any(0)
    nz = torch.clamp(torch.abs(n[2]), 0.26, 1.0)
    radii = torch.abs(depth) / (math.sqrt(2.0) * fx * nz)
    dc2 = (2.0 * uu / w - 1.0) ** 2 + (2.0 * vv / h - 1.0) ** 2
    confs = torch.exp(-dc2 * DIVTERM)
    if not cfg["disable_ssim_conf"]:
        raise NotImplementedError("the reference has no SSIM confidence")
    c = cfg["num_classes"]
    p = h * w
    out = dict(points=torch.where(valid, points, 0.0).reshape(3, p),
               norms=torch.where(valid, n, 0.0).reshape(3, p),
               colors=color.reshape(3, p),
               radii=torch.where(valid, radii, 0.0).reshape(p),
               confs=confs.reshape(p), valid=valid.reshape(p),
               time=float(time))
    if seg is None:
        out.update(seg=torch.zeros(p, dtype=torch.int32, device=depth.device),
                   seg_conf=torch.zeros((c, p), dtype=dt,
                                        device=depth.device),
                   dist2edge=torch.zeros(p, dtype=dt, device=depth.device))
    else:
        raise NotImplementedError("the reference has no class maps")
    return _store(out, prec)


# --------------------------------------------------------------------------
# anchoring and the frame-0 start

def _softmax_exp_neg(d_over_r, finite):
    z = torch.where(finite, torch.exp(-d_over_r), float("-inf"))
    zmax = torch.amax(z, 0, keepdim=True)
    zmax = torch.where(torch.isfinite(zmax), zmax, 0.0)
    e = torch.where(finite, torch.exp(z - zmax), 0.0)
    return e / torch.clamp(e.sum(0, keepdim=True), min=1e-20)


def knn(points, mask, nodes, node_active, k: int, chunk: int = 16384):
    """The k nearest active nodes (J, 3) of each masked point (3, N):
    (dists (k, N), ids (k, N)), ids ascending; inf and 0 where unmasked."""
    ds, ids = [], []
    for s in range(0, points.shape[1], chunk):
        q = points[:, s:s + chunk].T
        d = torch.linalg.vector_norm(q[:, None, :] - nodes[None], dim=-1)
        d = torch.where(node_active[None], d, float("inf"))
        dk, ik = torch.topk(d, k, dim=1, largest=False)
        ds.append(dk.T)
        ids.append(ik.T)
    d, i = torch.cat(ds, 1), torch.cat(ids, 1)
    d = torch.where(mask, d, float("inf"))
    i = torch.where(mask, i, 0)
    i, order = torch.sort(i, dim=0)
    return torch.gather(d, 0, order), i


def anchor(cfg: dict, graph: dict, points, mask, seg_conf=None):
    """Anchors (k, N), blend weights (k, N) and the stability mask (N,) of
    points (3, N): weights softmax(exp(-d / r)) over the anchors, stable
    where some anchor lies within its radius."""
    d, idx = knn(points, mask, graph["points"], graph["active"],
                 cfg["num_neighbors"])
    r = graph["radii"][idx]
    finite = torch.isfinite(d)
    stable = mask & (finite & (d <= r)).any(0)
    return idx, weights(cfg, graph, idx, d, r, finite, seg_conf), stable


def weights(cfg, graph, idx, d, r, finite, seg_conf):
    if cfg["method"] != "super":
        raise NotImplementedError("the reference covers SuPer's weights")
    return _softmax_exp_neg(d / torch.clamp(r, min=1e-12), finite)


def grid(height: int, width: int, step: int, device):
    """Anchor pixels (G,) and edges (E, 2) of the ED grid: nodes row-major
    at columns range(0, W-1, step) and rows range(0, H-1, step), edges to
    the right, down-right, down, and between (y, x+1) and (y+1, x)."""
    us = list(range(0, width - 1, step))
    vs = list(range(0, height - 1, step))
    gw, gh = len(us), len(vs)
    pix = torch.tensor([v * width + u for v in vs for u in us],
                       device=device)
    edges = []
    for kind in range(4):
        for y in range(gh):
            for x in range(gw):
                if kind == 0 and x + 1 < gw:
                    edges.append((y * gw + x, y * gw + x + 1))
                elif kind == 1 and x + 1 < gw and y + 1 < gh:
                    edges.append((y * gw + x, (y + 1) * gw + x + 1))
                elif kind == 2 and y + 1 < gh:
                    edges.append((y * gw + x, (y + 1) * gw + x))
                elif kind == 3 and x + 1 < gw and y + 1 < gh:
                    edges.append((y * gw + x + 1, (y + 1) * gw + x))
    return pix, torch.tensor(edges, device=device)


def init(cfg: dict, frame: dict, prec: Prec = REF):
    """The frame-0 start: the ED graph at the grid's anchor pixels (radius
    the mean length of a node's edges to active nodes), its node
    neighbours and ARAP weights, and every valid candidate a surfel in its
    own pixel's slot.  Returns (surfels, graph) dicts."""
    cap = cfg["capacity"]
    dev = frame["points"].device
    pix, edges = grid(cfg["height"], cfg["width"], cfg["mesh_step_size"],
                      dev)
    g, jcap = pix.shape[0], cap["node_capacity"]
    active = frame["valid"][pix]
    pts = frame["points"][:, pix].T
    e_act = active[edges[:, 0]] & active[edges[:, 1]]
    lens = torch.where(e_act, torch.linalg.vector_norm(
        pts[edges[:, 0]] - pts[edges[:, 1]], dim=1), 0.0)
    ends = torch.cat([edges[:, 0], edges[:, 1]])
    lsum = torch.zeros(g, dtype=pts.dtype, device=dev).index_add_(
        0, ends, torch.cat([lens, lens]))
    cnt = torch.zeros(g, dtype=pts.dtype, device=dev).index_add_(
        0, ends, torch.cat([e_act, e_act]).to(pts.dtype))
    radii = lsum / torch.clamp(cnt, min=1.0)
    has = (cnt > 0) & active
    radii = torch.where(has, radii, radii[has].mean())

    def pad(x):
        return torch.cat([x, x.new_zeros((jcap - g,) + x.shape[1:])])

    graph = dict(points=pad(pts), norms=pad(frame["norms"][:, pix].T),
                 radii=pad(radii), active=pad(active),
                 seg_conf=pad(frame["seg_conf"][:, pix].T))
    k = cfg["num_ed_neighbors"]
    d, idx = knn(graph["points"].T, graph["active"], graph["points"],
                 graph["active"], k + 1)
    # The nearest is the node itself: drop it, keep ascending distance.
    d, order = torch.sort(torch.where(graph["active"], d, float("inf")), 0)
    idx = torch.gather(idx, 0, order)[1:]
    d = d[1:]
    nd = d / torch.clamp(graph["radii"][None], min=1e-12)
    graph.update(knn_idx=idx.T, knn_w=_softmax_exp_neg(
        nd, torch.isfinite(d)).T)

    n = cap["surfel_capacity"]
    p = frame["valid"].shape[0]
    sidx, sw, stable = anchor(cfg, graph, frame["points"], frame["valid"],
                              frame["seg_conf"])

    def spad(x):
        return torch.cat([x, x.new_zeros(x.shape[:-1] + (n - p,))], -1)

    sf = dict(points=spad(frame["points"]), norms=spad(frame["norms"]),
              colors=spad(frame["colors"]), radii=spad(frame["radii"]),
              confs=spad(torch.where(frame["valid"], frame["confs"], 0.0)),
              time_stamp=spad(torch.full_like(frame["confs"], frame["time"])),
              active=spad(stable), knn_idx=spad(sidx), knn_w=spad(sw),
              seg=spad(frame["seg"]), seg_conf=spad(frame["seg_conf"]),
              dist2edge=spad(frame["dist2edge"]))
    # A surfel's projection is its own pixel.
    pid = torch.arange(p, device=dev)
    sf["proj_uv"] = spad(torch.stack([pid % cfg["width"],
                                      pid // cfg["width"]]).to(
                                          frame["points"].dtype))
    return _store(sf, prec), _store(graph, prec)


# --------------------------------------------------------------------------
# the LM warp solve

def identity_beta(j, dt, dev):
    beta = torch.zeros((j, 7), dtype=dt, device=dev)
    beta[:, 0] = 1.0
    return beta


def sample_target(cfg, frame, u, v):
    """Bilinear sample of the frame's points and normals at (u, v): (o (3,
    N), n (3, N), ok (N,)); ok needs all four corners inside the image and
    valid.  Each corner's point is rebuilt from its pixel and depth."""
    h, w = cfg["height"], cfg["width"]
    fx, fy, cx, cy = cfg["_intr"]
    fu, fv = torch.floor(u), torch.floor(v)
    ok = (fv >= 0) & (fv + 1 < h) & (fu >= 0) & (fu + 1 < w)
    o = n = 0.0
    for dy in (0, 1):
        for dx in (0, 1):
            cu, cv = fu + dx, fv + dy
            inside = (cu >= 0) & (cu < w) & (cv >= 0) & (cv < h)
            pix = torch.where(inside, cv * w + cu, 0).long()
            good = inside & frame["valid"][pix]
            ok = ok & good
            z = torch.where(good, frame["points"][2, pix], 0.0)
            nc = torch.where(good, frame["norms"][:, pix], 0.0)
            pc = torch.stack([(cu - cx) * z / fx, (cv - cy) * z / fy, z])
            wgt = torch.clamp(1 - torch.abs(cv - v), min=0) * \
                torch.clamp(1 - torch.abs(cu - u), min=0)
            o = o + wgt * pc
            n = n + wgt * nc
    return o, n, ok


def warp_points(points, gpts, anchors, wts, beta):
    """Blended warp sum_k w_k (R(q_k)(p - g_k) + g_k + b_k) of (3, N)
    points with anchors (k, N) and per-point anchor parameters beta (k, 7,
    N)."""
    out = 0.0
    for a in range(anchors.shape[0]):
        g = gpts[anchors[a]].T
        out = out + wts[a] * (rotate(beta[a, 0:4], points - g) + g
                              + beta[a, 4:7])
    return out


class LMProblem:
    """The LM data, ARAP and rotation terms of one frame, against the
    association made once at the identity warp."""

    def __init__(self, cfg: dict, sf: dict, graph: dict, frame: dict):
        self.cfg = cfg
        self.j = graph["points"].shape[0]
        act = sf["active"]
        self.pts = sf["points"][:, act]
        self.anchors = sf["knn_idx"][:, act].long()
        self.w = sf["knn_w"][:, act]
        self.gpts = graph["points"]
        self.gact = graph["active"]
        u, v = project(self.pts, cfg["_intr"])
        _, inframe = pixel_of(u, v, cfg["height"], cfg["width"])
        o, n, ok = sample_target(cfg, frame, u, v)
        self.o, self.n, self.mask = o, n, ok & inframe
        nb = graph["knn_idx"].long()
        self.nb = nb
        self.pair = self.gact[:, None] & self.gact[nb]
        self.d_eds = self.gpts[:, None, :] - self.gpts[nb]
        # Anchor tuples: the surfels that share one set of anchors.
        a = self.anchors
        key = ((a[0] * self.j + a[1]) * self.j + a[2]) * self.j + a[3]
        self.tuple_nodes_key, self.tid = torch.unique(key,
                                                      return_inverse=True)
        self.tnodes = torch.zeros((self.tuple_nodes_key.shape[0], 4),
                                  dtype=torch.long, device=key.device)
        self.tnodes[self.tid] = a.T
        losses = cfg["losses"]
        self.wpp = losses["sf_point_plane_weight"]
        self.warap = losses["mesh_arap_weight"]
        self.wrot = losses["mesh_rot_weight"]
        self.bf16_sums = cfg["solver"]["gram_sum_dtype"] == "bf16"

    def data_residual(self, bk):
        tp = warp_points(self.pts, self.gpts, self.anchors, self.w, bk)
        r = self.wpp * torch.sum(self.n * (tp - self.o), 0)
        return torch.where(self.mask, r, 0.0)

    def arap_residual(self, b_nb, b_self):
        r = rotate(b_nb[..., 0:4], self.d_eds, -1) + b_nb[..., 4:7] \
            - self.d_eds - b_self[..., 4:7]
        return torch.where(self.pair[..., None], self.warap * r, 0.0)

    def rot_residual(self, beta):
        r = self.wrot * (1.0 - torch.sum(beta[:, 0:4] ** 2, -1))
        return torch.where(self.gact, r, 0.0)

    def cost(self, beta):
        bk = beta[self.anchors].permute(0, 2, 1)
        return (torch.sum(self.data_residual(bk) ** 2)
                + torch.sum(self.arap_residual(beta[self.nb],
                                               beta[:, None]) ** 2)
                + torch.sum(self.rot_residual(beta) ** 2))

    def normal_equations(self, beta):
        """(H (7J, 7J), g = -J^T r (7J,), cost) at beta."""
        j, dim = self.j, 7 * self.j
        dt, dev = beta.dtype, beta.device
        hm = torch.zeros((j, j, 7, 7), dtype=dt, device=dev)
        g = torch.zeros((j, 7), dtype=dt, device=dev)
        # Data term: each surfel's row over its anchors' 28 parameters
        # (autograd: each residual depends on its own copy of them).
        bk = beta[self.anchors].permute(0, 2, 1).clone().requires_grad_()
        r = self.data_residual(bk)
        (rows,) = torch.autograd.grad(r.sum(), bk)
        r = r.detach()
        rows = rows.permute(2, 0, 1)                          # (N, k, 7)
        cost = torch.sum(r * r)
        nt = self.tnodes.shape[0]
        gram = torch.zeros((nt, 4, 7, 4, 7), dtype=dt, device=dev)
        for s in range(0, rows.shape[0], 32768):
            h = rows[s:s + 32768].reshape(-1, 28)
            gram.index_add_(0, self.tid[s:s + 32768],
                            (h[:, :, None] * h[:, None, :]).reshape(
                                -1, 4, 7, 4, 7))
        if self.bf16_sums:
            gram = gram.to(torch.bfloat16).to(dt)
        for a in range(4):
            for b in range(4):
                hm.index_put_((self.tnodes[:, a], self.tnodes[:, b]),
                              gram[:, a, :, b, :], accumulate=True)
        g.index_add_(0, self.anchors.reshape(-1),
                     -(rows * r[:, None, None]).permute(1, 0, 2).reshape(
                         -1, 7))
        # ARAP: residual (J, K, 3) touches the neighbour (its q and b) and
        # the node itself (its b).
        b_nb = beta[self.nb].clone().requires_grad_()
        b_self = beta[:, None].expand(self.nb.shape + (7,)).clone() \
            .requires_grad_()
        ra = self.arap_residual(b_nb, b_self)
        cost = cost + torch.sum(ra.detach() ** 2)
        jac = []
        for c in range(3):
            jac.append(torch.autograd.grad(ra[..., c].sum(),
                                           (b_nb, b_self),
                                           retain_graph=c < 2))
        ra = ra.detach()
        nodes = (self.nb, torch.arange(j, device=dev)[:, None].expand(
            self.nb.shape))
        for a in range(2):
            ja = torch.stack([jac[c][a] for c in range(3)], -2)  # (J,K,3,7)
            g.index_add_(0, nodes[a].reshape(-1), -torch.einsum(
                "jkci,jkc->jki", ja, ra).reshape(-1, 7))
            for b in range(2):
                jb = torch.stack([jac[c][b] for c in range(3)], -2)
                hm.index_put_((nodes[a].reshape(-1), nodes[b].reshape(-1)),
                              torch.einsum("jkci,jkcl->jkil", ja,
                                           jb).reshape(-1, 7, 7),
                              accumulate=True)
        # Rotation term: r = w (1 - |q|^2), gradient -2 w q.
        rr = self.rot_residual(beta)
        cost = cost + torch.sum(rr ** 2)
        gr = torch.where(self.gact[:, None], torch.cat(
            [-2.0 * self.wrot * beta[:, 0:4],
             torch.zeros_like(beta[:, 4:7])], 1), 0.0)
        g = g - gr * rr[:, None]
        idx = torch.arange(j, device=dev)
        hm[idx, idx] += gr[:, :, None] * gr[:, None, :]
        return (hm.permute(0, 2, 1, 3).reshape(dim, dim), g.reshape(dim),
                cost)


def block_jacobi_cg(hm, rhs, u, x0, iterations: int):
    """CG on (H + u I) x = rhs, preconditioned by the inverse of each
    node's 7x7 diagonal block plus (u + 1e-8) I, from x0."""
    dim = rhs.shape[0]
    j = dim // 7
    eye = torch.eye(7, dtype=rhs.dtype, device=rhs.device)
    diag = hm.reshape(j, 7, j, 7).diagonal(dim1=0, dim2=2).permute(2, 0, 1)
    minv = torch.linalg.inv(diag + (u + 1e-8) * eye)

    def mv(p):
        return hm @ p + u * p

    def pre(r):
        return torch.einsum("jab,jb->ja", minv, r.reshape(j, 7)).reshape(dim)

    x = x0
    r = rhs - mv(x)
    z = pre(r)
    p = z
    rz = r @ z
    for _ in range(iterations):
        ap = mv(p)
        pap = p @ ap
        alpha = rz / pap if abs(float(pap)) > 1e-30 else 0.0
        x = x + alpha * p
        r = r - alpha * ap
        z = pre(r)
        rz_new = r @ z
        beta = rz_new / rz if abs(float(rz)) > 1e-30 else 0.0
        p = z + beta * p
        rz = rz_new
    return x


def lm_solve(cfg: dict, sf: dict, graph: dict, frame: dict):
    """The deferred LM schedule: num_iterations trips, each assembling the
    normal equations at the candidate (trip 0 at the identity, never
    judged), accepting it if its cost beats the best, and solving the
    damped system from the last accepted equations (warm-started after an
    accept, cold after a reject); the last candidate judged by its cost.
    Returns the (J, 7) warp parameters [q, b] per node."""
    sol = cfg["solver"]
    if sol["linear_solver"] != "pairs_fused" or \
            sol["association"] != "per_frame" or \
            sol["lm_schedule"] != "deferred" or sol["lm_hypotheses"] != 1:
        raise NotImplementedError("the reference covers the headline's "
                                  "per-frame deferred LM with K1's solve")
    prob = LMProblem(cfg, sf, graph, frame)
    j = prob.j
    dt, dev = sf["points"].dtype, sf["points"].device
    v = sol["lm_damping_factor"]
    beta_cand = best_beta = identity_beta(j, dt, dev)
    best_cost = 1e10
    u = sol["lm_damping_init"] * v
    delta_prev = torch.zeros(7 * j, dtype=dt, device=dev)
    best_h = best_g = None
    for i in range(sol["num_iterations"]):
        h, g, cost = prob.normal_equations(beta_cand)
        if i == 0:
            accept = True
            best_h, best_g = h, g
        else:
            accept = bool(torch.isfinite(g).all()) and float(cost) < best_cost
            if accept:
                best_cost, best_h, best_g = float(cost), h, g
        if accept:
            best_beta = beta_cand
        u = u / v if accept else u * v
        x0 = delta_prev if accept else torch.zeros_like(delta_prev)
        delta = block_jacobi_cg(best_h, best_g, u, x0,
                                sol["pcg_iterations"])
        if not bool(torch.isfinite(delta).all()):
            delta = torch.zeros_like(delta)
        beta_cand = best_beta + delta.reshape(j, 7)
        delta_prev = delta
    cost = float(prob.cost(beta_cand))
    if math.isfinite(cost) and cost < best_cost:
        best_beta = beta_cand
    return best_beta


# --------------------------------------------------------------------------
# the warp

def apply_warp(sf: dict, graph: dict, beta):
    """The warped map and graph: active surfels' points by the blended
    warp; their normals by the blend of R(q_k) n + b_k (SuPer's normal
    blend takes the translation too), renormalised; nodes moved by b and
    their normals rotated by q."""
    act = sf["active"]
    bk = beta[sf["knn_idx"].long()].permute(0, 2, 1)
    p = warp_points(sf["points"], graph["points"], sf["knn_idx"].long(),
                    sf["knn_w"], bk)
    nrm = 0.0
    for a in range(bk.shape[0]):
        nrm = nrm + sf["knn_w"][a] * (rotate(bk[a, 0:4], sf["norms"])
                                      + bk[a, 4:7])
    gp = graph["points"] + beta[:, 4:7]
    gn = rotate(beta[:, 0:4], graph["norms"], -1)
    nrm = nrm / torch.clamp(torch.linalg.vector_norm(nrm, dim=0), min=1e-12)
    gn = gn / torch.clamp(torch.linalg.vector_norm(gn, dim=1, keepdim=True),
                          min=1e-12)
    sf = dict(sf, points=torch.where(act, p, sf["points"]),
              norms=torch.where(act, nrm, sf["norms"]))
    ga = graph["active"][:, None]
    graph = dict(graph, points=torch.where(ga, gp, graph["points"]),
                 norms=torch.where(ga, gn, graph["norms"]))
    return sf, graph


# --------------------------------------------------------------------------
# fusion

MERGE_KEYS = ("points", "norms", "colors", "radii", "confs", "time_stamp",
              "seg", "seg_conf")


def _gate(cfg, a, b):
    d2 = torch.sum((a["points"] - b["points"]) ** 2, 0)
    dot = torch.sum(a["norms"] * b["norms"], 0)
    ok = (d2 < cfg["th_dist"] ** 2) & (dot > cfg["th_cosine_ang"])
    if cfg["hard_seg"] or cfg["data"] == "superv1":
        ok = ok & (a["seg"] == b["seg"])
    return ok


def _merge(cfg, a, b, time, triple_new_color):
    """b merged into a, weighted by confidence."""
    w_sum = a["confs"] + b["confs"]
    a1 = a["confs"] / torch.clamp(w_sum, min=1e-20)
    a2 = b["confs"] / torch.clamp(w_sum, min=1e-20)
    nrm = a1 * a["norms"] + a2 * b["norms"]
    nrm = nrm / torch.clamp(torch.linalg.vector_norm(nrm, dim=0), min=1e-12)
    if triple_new_color:
        cs = torch.clamp(a1 + 3.0 * a2, min=1e-20)
        colors = a1 / cs * a["colors"] + 3.0 * a2 / cs * b["colors"]
    else:
        colors = a1 * a["colors"] + a2 * b["colors"]
    out = dict(points=a1 * a["points"] + a2 * b["points"], norms=nrm,
               colors=colors, radii=a1 * a["radii"] + a2 * b["radii"],
               confs=w_sum, time_stamp=torch.full_like(w_sum, time),
               seg=a["seg"], seg_conf=a["seg_conf"])
    return out


def _take(sf, idx):
    return {k: sf[k][..., idx] for k in MERGE_KEYS}


def _put(sf, idx, vals, do):
    for k in MERGE_KEYS:
        cur = sf[k][..., idx]
        sf[k][..., idx] = torch.where(do, vals[k].to(cur.dtype), cur)


def fuse(cfg: dict, sf: dict, graph: dict, frame: dict, prec: Prec = REF):
    """Merge the frame into the warped map.  Returns (map, remap, added):
    remap[s] is the slot that slot s merged into (s where it did not);
    added, the slots that new surfels took."""
    cap = cfg["capacity"]
    h, w = cfg["height"], cfg["width"]
    p = h * w
    depth_l = cap["proj_map_depth"]
    n = sf["points"].shape[1]
    dev = sf["points"].device
    time = frame["time"]
    sf = {k: v.clone() for k, v in sf.items()}
    # 1. Layers: the surfels of each pixel in order of confidence,
    #    descending, then slot; past proj_map_depth layers they go.
    u, v = project(sf["points"], cfg["_intr"])
    pix, inframe = pixel_of(u, v, h, w)
    live = inframe & sf["active"]
    slots = torch.nonzero(live)[:, 0]
    o = torch.sort(-sf["confs"][slots], stable=True).indices
    slots = slots[o]
    slots = slots[torch.sort(pix[slots], stable=True).indices]
    spix = pix[slots]
    start = torch.ones_like(spix, dtype=torch.bool)
    start[1:] = spix[1:] != spix[:-1]
    pos = torch.arange(slots.shape[0], device=dev)
    layer = pos - torch.cummax(torch.where(start, pos, 0), 0).values
    sf["active"][slots[layer >= depth_l]] = False
    keep = layer < depth_l
    slots, spix, layer = slots[keep], spix[keep], layer[keep]
    remap = torch.arange(n, device=dev)
    consumed = torch.zeros(p, dtype=torch.bool, device=dev)
    # 2. Each pixel's candidate merges into the lowest layer that passes
    #    the gate (position within th_dist, normals within th_cosine_ang).
    if not cfg["disable_merging_new_surfels"]:
        cand = {k: frame[k][..., spix] for k in ("points", "norms", "colors",
                                                 "radii", "confs", "seg",
                                                 "seg_conf")}
        cand["time_stamp"] = torch.zeros_like(cand["confs"])
        cur = _take(sf, slots)
        ok = _gate(cfg, cur, cand)
        first = torch.full((p,), depth_l, dtype=torch.long, device=dev)
        first.scatter_reduce_(0, spix, torch.where(ok, layer, depth_l),
                              "amin")
        win = ok & (layer == first[spix])
        _put(sf, slots, _merge(cfg, cur, cand, time, True), win)
        consumed = first < depth_l
    # 3. Surfels sharing a pixel merge layer pair by layer pair, (0, 1),
    #    (0, 2), ..., in that order, for the first dup_pixel_cap pixels.
    if not cfg["disable_merging_exist_surfels"] and depth_l > 1:
        cap8 = cap["dup_pixel_cap"] or max(p // 128, 1024)
        table = torch.full((depth_l, p), -1, dtype=torch.long, device=dev)
        table[layer, spix] = slots
        multi = torch.nonzero(table[1] >= 0)[:, 0][:cap8]
        ids = table[:, multi]                                 # (L, M)
        alive = [ids[i] >= 0 for i in range(depth_l)]
        vals = [_take(sf, ids[i].clamp(min=0)) for i in range(depth_l)]
        into = [ids[i].clone() for i in range(depth_l)]
        changed = [torch.zeros_like(alive[0]) for _ in range(depth_l)]
        for i in range(depth_l):
            for j in range(i + 1, depth_l):
                do = alive[i] & alive[j] & _gate(cfg, vals[i], vals[j])
                mv = _merge(cfg, vals[i], vals[j], time, False)
                vals[i] = {k: torch.where(do, mv[k], vals[i][k])
                           for k in vals[i]}
                alive[j] = alive[j] & ~do
                into[j] = torch.where(do, ids[i], into[j])
                changed[i] |= do
                changed[j] |= do
        for i in range(depth_l):
            sel = changed[i] & (ids[i] >= 0)
            _put(sf, ids[i].clamp(min=0), vals[i], sel)
            dead = (ids[i] >= 0) & ~alive[i]
            sf["active"][ids[i][dead]] = False
            remap[ids[i][dead]] = into[i][dead]
    # 3.5 Blend weights from the current positions, anchors kept.
    idx = sf["knn_idx"].long()
    d = torch.linalg.vector_norm(sf["points"][:, None] -
                                 graph["points"][idx].permute(2, 0, 1), dim=0)
    sf["knn_w"] = weights(cfg, graph, idx, d, graph["radii"][idx],
                          torch.ones_like(d, dtype=torch.bool),
                          sf["seg_conf"])
    # 4. Unmatched valid candidates, the first new_surfel_capacity in pixel
    #    order, anchored; the stable ones into the free slots in order.
    if not cfg["disable_adding_new_surfels"]:
        add = frame["valid"] & ~consumed \
            if not cfg["disable_merging_new_surfels"] else frame["valid"]
        cand = torch.nonzero(add)[:, 0][:cap["new_surfel_capacity"]]
        cidx, cw, stable = anchor(cfg, graph, frame["points"][:, cand],
                                  torch.ones_like(cand, dtype=torch.bool),
                                  frame["seg_conf"][:, cand])
        cand, cidx, cw = cand[stable], cidx[:, stable], cw[:, stable]
        free = torch.nonzero(~sf["active"])[:, 0][:cand.shape[0]]
        m = free.shape[0]
        cand, cidx, cw = cand[:m], cidx[:, :m], cw[:, :m]
        for k in ("points", "norms", "colors", "radii", "confs",
                  "dist2edge", "seg", "seg_conf"):
            sf[k][..., free] = frame[k][..., cand].to(sf[k].dtype)
        sf["time_stamp"][free] = time
        sf["knn_idx"][:, free] = cidx.to(sf["knn_idx"].dtype)
        sf["knn_w"][:, free] = cw
        sf["active"][free] = True
    else:
        free = torch.zeros(0, dtype=torch.long, device=dev)
    return _store(sf, prec), remap, free


def prune(cfg: dict, sf: dict, track: dict, time: float, remap):
    """Tracked points follow their surfels' merges; surfels not seen for
    th_time_steps go, except tracked ones (of the track entries that name
    a slot, the last decides); tracks whose surfel is gone are lost (-2).
    Then every slot's projection is refreshed."""
    n = sf["points"].shape[1]
    tid = track["track_id"].long()
    tid = torch.where(tid >= 0, remap[tid.clamp(0, n - 1)], tid)
    active = sf["active"]
    if not cfg["disable_removing_unstable_surfels"]:
        fresh = (time - sf["time_stamp"]) < cfg["th_time_steps"]
        kept = torch.zeros_like(active)
        last = {}
        for e, s in enumerate(tid.clamp(0, n - 1).tolist()):
            last[s] = e
        for s, e in last.items():
            kept[s] = bool(tid[e] >= 0)
        active = (active & fresh) | kept
    lost = (tid >= 0) & ~active[tid.clamp(0, n - 1)]
    tid = torch.where(lost, -2, tid)
    u, v = project(sf["points"], cfg["_intr"])
    sf = dict(sf, active=active, proj_uv=torch.stack([u, v]))
    return sf, dict(track, track_id=tid)


# --------------------------------------------------------------------------
# tracked points and the step

def bind_and_read(cfg: dict, sf: dict, frame: dict, track: dict, gt_xy,
                  gt_valid, th: float = 0.2):
    """Untracked GT points (id -1) bind, in order, to the nearest active
    surfel that no point holds, measured to the frame's candidate at the
    GT pixel (truncated coordinates), if that candidate is valid, the pixel
    is not 0 and the distance is below ``th``.  Returns the track with
    ``coords`` (P, 2), the tracked surfels' projections, and
    ``coord_valid``."""
    w = cfg["width"]
    n = sf["points"].shape[1]
    npix = frame["valid"].shape[0]
    tid = track["track_id"].clone().long()
    used = torch.zeros(n, dtype=torch.bool, device=tid.device)
    used[tid[tid >= 0]] = True
    xy = torch.as_tensor(gt_xy, device=tid.device).to(torch.int64)
    for i in range(tid.shape[0]):
        pix = int(torch.clamp(xy[i, 1] * w + xy[i, 0], 0, npix - 1))
        if not (tid[i] == -1 and bool(gt_valid[i]) and pix > 0
                and bool(frame["valid"][pix])):
            continue
        d = torch.linalg.vector_norm(sf["points"] -
                                     frame["points"][:, pix, None], dim=0)
        d = torch.where(sf["active"] & ~used, d, float("inf"))
        best = int(torch.argmin(d))
        if float(d[best]) < th:
            tid[i] = best
            used[best] = True
    coords = sf["proj_uv"][:, tid.clamp(0, n - 1)].T
    return dict(track_id=tid, coords=coords, coord_valid=tid >= 0)


def step(cfg: dict, sf: dict, graph: dict, track: dict, frame: dict,
         prec: Prec = REF):
    """One tracked frame from the state before it: the LM warp solve, the
    warp, fusion and pruning.  Returns (surfels, graph, track, the slots
    that new surfels took)."""
    if not cfg["solver"]["use_derived_gradient"]:
        raise NotImplementedError("the reference covers the LM solve")
    beta = lm_solve(cfg, sf, graph, frame)
    sf, graph = apply_warp(sf, graph, prec.store(beta))
    sf, graph = _store(sf, prec), _store(graph, prec)
    sf, remap, added = fuse(cfg, sf, graph, frame, prec)
    sf, track = prune(cfg, sf, track, frame["time"], remap)
    return _store(sf, prec), graph, track, added
