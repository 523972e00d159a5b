"""Plain reference of one SuPer frame with the moving target
(``solver.association`` "per_iteration"), Python-SuPer's own association:
every LM trip projects the warped surfels and samples the frame there.

The data residual of a surfel is r = w n . (tp - o), tp its blended warp,
and o and n the frame's point and normal sampled bilinearly at tp's
projection, at every candidate warp, so its row (from autograd) runs the
full chain through the projection and the bilinear weights.  Everything
else (preprocessing, the start, the deferred LM schedule and its CG, the
warp, fusion, pruning and the tracked points) is :mod:`tracker`'s.

**Pixel lines.**  The bilinear weights are not differentiable where a
projection falls on a pixel line: there a corner's offset d = c - x (c
the corner's column or row, x the projection's) is 0, or 1 for the corner
past it.  The rule here: the corners are those of the cell [floor(x),
floor(x) + 1), and each corner's weight 1 - |d| is differentiated with
d|d|/dd taken from the right at d = 0 (+1) and from inside the cell at
|d| = 1.  So on a line at n both corners' weights have the derivative +1
in x, and d/dx of a sample there is the sum of the two corners' values,
not their difference.  That is the program's rule (its sampler's
derivative of |d| at 0 is +1).  It is applied at the program's
projection: the program projects in float32, the configuration's
precision, so x lies on a line where its float32 rounding is a whole
number; a float64 projection of the same float32 surfel lands a few
float32 ulps aside.
"""

from __future__ import annotations

import torch

from benchmark.reference import tracker
from benchmark.reference.tracker import (CONTROL, REF, Prec,  # noqa: F401
                                         bind_and_read, fields, init,
                                         preprocess)


def on_lines(x):
    """x, with the values whose float32 rounding is a whole number put on
    that number; the gradient of x passes unchanged."""
    whole = torch.round(x)
    on = x.to(torch.float32) == whole
    return x + torch.where(on, whole - x, 0.0).detach()


def _right_sign(d):
    return torch.where(d >= 0, 1.0, -1.0).to(d.dtype).detach()


def sample_moving(cfg: dict, frame: dict, u, v):
    """Bilinear sample of the frame's points and normals at (u, v),
    differentiable in (u, v) by the pixel-line rule above: (o (3, N), n
    (3, N), ok (N,)); ok needs all four corners inside the image and
    valid.  Each corner's point is rebuilt from its pixel and depth."""
    h, w = cfg["height"], cfg["width"]
    fx, fy, cx, cy = cfg["_intr"]
    u, v = on_lines(u), on_lines(v)
    fu, fv = torch.floor(u).detach(), torch.floor(v).detach()
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
            du, dv = cu - u, cv - v
            wgt = (1.0 - _right_sign(dv) * dv) * (1.0 - _right_sign(du) * du)
            o = o + wgt * pc
            n = n + wgt * nc
    return o, n, ok


class MovingProblem(tracker.LMProblem):
    """The LM terms of one frame with the moving target: no association is
    kept; the data residual samples the frame at each candidate."""

    association = "per_iteration"

    def associate(self, frame: dict):
        self.frame = frame

    def data_residual(self, bk):
        cfg = self.cfg
        tp = tracker.warp_points(self.pts, self.gpts, self.anchors, self.w,
                                 bk)
        u, v = tracker.project(tp, cfg["_intr"])
        _, inframe = tracker.pixel_of(u, v, cfg["height"], cfg["width"])
        o, n, ok = sample_moving(cfg, self.frame, u, v)
        r = self.wpp * torch.sum(n * (tp - o), 0)
        return torch.where(ok & inframe, r, 0.0)


def covers(cfg: dict) -> list:
    """What :func:`tracker.covers` refuses, but the moving target for the
    per-frame association."""
    return tracker.covers(cfg, MovingProblem)


def step(cfg: dict, sf: dict, graph: dict, track: dict, frame: dict,
         prec: Prec = REF):
    """:func:`tracker.step` with the moving target's LM problem."""
    return tracker.step(cfg, sf, graph, track, frame, prec, MovingProblem)
