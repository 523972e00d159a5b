"""The comparison that decides ``correct``: the program's own outputs of the
window's frames against the plain reference that the configuration names
(benchmark/reference).

The tracker carries its state from frame to frame, and a frame's solve is
chaotic at rounding size over a clip, so the reference follows the program
frame by frame: for a checked frame it starts from the program's state
before that frame and recomputes everything else from the frame's raw
depth, colour and GT: the preprocessing, the warp solve, the warp, fusion
and pruning, and the tracked points.  Frame 0, the start, is checked by
itself: the reference builds its own graph and map from the raw frame.

Fusion puts a frame's new surfels into the free slots in pixel order, so
one candidate merged on one side only (a surfel within rounding of a
pixel's edge, or of a merge's gate) shifts every later new surfel by a
slot: slot by slot the two maps then differ in thousands of slots that
hold the same surfels.  So the maps are compared as sets.  A slot is
*off* where the two sides disagree on it (active on one side only, or on
both with different anchors or points more than ``OFF_UM`` apart); a
surfel in an off slot is *matched* where the other side holds, in some
off slot, a surfel within ``OFF_UM`` of it (with the same anchors, for
the reference's).  What neither agrees nor is matched is *unmatched*.

The numbers, each the worst over the checked frames (streams included):

- ``prep_points_um``: the largest gap of a candidate point (um) over the
  pixels valid on either side (a pixel valid on one side only: inf);
- ``prep_normals``: the largest gap of a candidate normal (unit vectors);
- ``nodes_um``: the largest gap of an ED node after the step (um), over the
  nodes active on either side (inf where one side only);
- ``slots_off_pct``: the unmatched surfels of both sides, plus the
  difference of their counts in the off slots, over the slots active on
  either side, %;
- ``new_slots_off_pct``: the share of the reference's new surfels of the
  frame (at the start, every surfel) that are unmatched, %: a frame's adds
  are a few percent of the map, so they are held by themselves;
- ``surfels_um``: the 99th percentile of the point gap (um) over the slots
  where the two sides agree;
- ``weights``: the 99th percentile, over the same slots, of the largest
  gap of a surfel's anchor weights;
- ``track_px``: the largest gap of a reported tracked point (px) over the
  points tracked on both sides, but for a point that one side keeps on the
  surfel it followed before the frame while the other hands it on with a
  merge (a merge decided within rounding); inf where a point is tracked
  on one side only.
"""

from __future__ import annotations

import math

import torch

NUMBERS = ("prep_points_um", "prep_normals", "nodes_um", "slots_off_pct",
           "new_slots_off_pct", "surfels_um", "weights", "track_px")
OFF_UM = 20.0
MATCH_CAP = 50_000          # off slots a side past which none is matched
INF = float("inf")


def _f(x):
    return x.to(torch.float64)


def _max(x) -> float:
    return float(x.max()) if x.numel() else 0.0


def _q(x, q: float) -> float:
    return float(torch.quantile(x, q)) if x.numel() else 0.0


def _nearest(a, b, rows: int = 2048):
    """For each row of a (N, 3): the distance to its nearest row of b
    (M, 3) and that row's index (inf and 0 where b is empty)."""
    if not b.shape[0]:
        return (torch.full((a.shape[0],), INF, dtype=a.dtype,
                           device=a.device),
                torch.zeros(a.shape[0], dtype=torch.long, device=a.device))
    ds, ids = [], []
    for i in range(0, a.shape[0], rows):
        d, j = torch.cdist(a[i:i + rows], b).min(1)
        ds.append(d)
        ids.append(j)
    return torch.cat(ds), torch.cat(ids)


def match_maps(ps: dict, rs: dict, ref_added):
    """The program's map ``ps`` against the reference's ``rs``: (agree, the
    slots where both sides agree; the point gaps, um; unmatched, the
    count ``slots_off_pct`` takes; new_bad, the reference's new surfels
    unmatched; counts for the diagnostics)."""
    pts_p, pts_r = _f(ps["points"]), _f(rs["points"])
    sgap = torch.linalg.vector_norm(pts_p - pts_r, dim=0) * 1e6
    anchors = (ps["knn_idx"].long() == rs["knn_idx"].long()).all(0)
    agree = ps["active"] & rs["active"] & anchors & (sgap <= OFF_UM)
    off = (ps["active"] | rs["active"]) & ~agree
    r_off = torch.nonzero(off & rs["active"])[:, 0]
    p_off = torch.nonzero(off & ps["active"])[:, 0]
    r_ok = torch.zeros(r_off.shape[0], dtype=torch.bool, device=off.device)
    p_ok = torch.zeros(p_off.shape[0], dtype=torch.bool, device=off.device)
    if p_off.numel() and r_off.numel() and \
            max(r_off.numel(), p_off.numel()) <= MATCH_CAP:
        a, b = pts_r[:, r_off].T, pts_p[:, p_off].T
        d, j = _nearest(a, b)
        same = (rs["knn_idx"][:, r_off].long() ==
                ps["knn_idx"][:, p_off[j]].long()).all(0)
        r_ok = (d * 1e6 <= OFF_UM) & same
        p_ok = _nearest(b, a)[0] * 1e6 <= OFF_UM
    unmatched = int((~r_ok).sum()) + int((~p_ok).sum()) + \
        abs(r_off.numel() - p_off.numel())
    bad = off.clone()
    bad[r_off[r_ok]] = False
    counts = {"off": int(off.sum()), "r_off": int(r_off.numel()),
              "p_off": int(p_off.numel()),
              "one_side": int((ps["active"] != rs["active"]).sum()),
              "r_unmatched": int((~r_ok).sum()),
              "p_unmatched": int((~p_ok).sum())}
    return agree, sgap, unmatched, int(bad[ref_added].sum()), counts


def frame_numbers(prog_frame, prog_state, ref_frame, ref_sf, ref_graph,
                  ref_track, ref_added, prev_track_id=None,
                  diag: bool = False) -> dict:
    """The numbers of one checked frame of one stream: the program's
    preprocessed frame and its state after the frame (the tracked points
    bound and read) against the reference's; ``prev_track_id``, the
    tracked slots before the frame (None at the start).  With ``diag``
    also the counts and quantiles the limits are set from
    (benchmark/calibrate.py)."""
    out = {}
    pv, rv = prog_frame["valid"], ref_frame["valid"]
    both = pv & rv
    gap = torch.linalg.vector_norm(_f(prog_frame["points"]) -
                                   _f(ref_frame["points"]), dim=0)
    out["prep_points_um"] = INF if bool((pv != rv).any()) else \
        _max(gap[both]) * 1e6
    out["prep_normals"] = _max(torch.linalg.vector_norm(
        _f(prog_frame["norms"]) - _f(ref_frame["norms"]), dim=0)[both])

    pg, rg = prog_state["graph"], ref_graph
    ga = pg["active"] | rg["active"]
    out["nodes_um"] = INF if bool((pg["active"] != rg["active"]).any()) \
        else _max(torch.linalg.vector_norm(_f(pg["points"]) -
                                           _f(rg["points"]), dim=1)[ga]) * 1e6

    ps, rs = prog_state["surfels"], ref_sf
    agree, sgap, unmatched, new_bad, counts = match_maps(ps, rs, ref_added)
    either = int((ps["active"] | rs["active"]).sum())
    out["slots_off_pct"] = 100.0 * unmatched / max(either, 1)
    out["new_slots_off_pct"] = 100.0 * new_bad / max(ref_added.numel(), 1)
    out["surfels_um"] = _q(sgap[agree], 0.99)
    wgap = (_f(ps["knn_w"]) - _f(rs["knn_w"])).abs().amax(0)[agree]
    out["weights"] = _q(wgap, 0.99)

    pt, rt = prog_state["track"], ref_track
    pvalid, rvalid = pt["coord_valid"], rt["coord_valid"]
    pid, rid = pt["track_id"].long(), rt["track_id"].long()
    tracked = pvalid & rvalid
    tie = torch.zeros_like(tracked)
    if prev_track_id is not None:
        prev = prev_track_id.long()
        tie = tracked & (pid != rid) & ((pid == prev) | (rid == prev))
    tgap = torch.linalg.vector_norm(_f(pt["coords"]) - _f(rt["coords"]),
                                    dim=1)
    out["track_px"] = INF if bool((pvalid != rvalid).any()) else \
        _max(tgap[tracked & ~tie])
    if diag:
        g = sgap[agree]
        out["diag"] = dict(
            counts, either=either, added=int(ref_added.numel()),
            new_bad=new_bad, unmatched=unmatched,
            surfels_um_q={q: _q(g, q) for q in (0.5, 0.9, 0.99, 0.999)},
            surfels_um_max=_max(g),
            weights_q={q: _q(wgap, q) for q in (0.5, 0.9, 0.99, 0.999)},
            weights_max=_max(wgap),
            track_ties_px=[float(x) for x in tgap[tie]],
            track_other_px=[float(x) for x in
                            tgap[tracked & (pid != rid) & ~tie]])
    return out


def state_dict(state) -> dict:
    """A tracker state (the program's NamedTuples) as nested dicts."""
    return {k: getattr(state, k)._asdict() for k in ("surfels", "graph",
                                                     "track")}


def reference_frame(ref, rcfg, intr, raw: dict, prog_prev, prec=None):
    """The outputs of the reference module ``ref`` (benchmark/reference,
    the configuration's: ``spec.load_reference``) for one frame, from the
    raw inputs ``raw`` (depth, color, gt_xy, gt_valid, time) and the
    program's state before it (None at the start), in ``ref.REF`` unless
    ``prec`` is given: (frame, surfels, graph, track, the slots that the
    frame's new surfels took)."""
    prec = ref.REF if prec is None else prec
    rf = ref.preprocess(rcfg, intr, raw["depth"], raw["color"],
                        raw["time"], prec=prec)
    if prog_prev is None:
        sf, graph = ref.init(rcfg, rf, prec)
        p = raw["gt_xy"].shape[0]
        track = dict(track_id=torch.full((p,), -1, dtype=torch.long,
                                         device=rf["points"].device))
        added = torch.nonzero(sf["active"])[:, 0]
    else:
        sf, graph, track, added = ref.step(
            rcfg, ref.fields(prog_prev.surfels, prec),
            ref.fields(prog_prev.graph, prec),
            ref.fields(prog_prev.track, prec), rf, prec)
    track = ref.bind_and_read(rcfg, sf, rf, track, raw["gt_xy"],
                              raw["gt_valid"])
    return rf, sf, graph, track, added


def worst(rows) -> dict:
    """Each number's worst value over the checked frames."""
    return {n: max((r[n] for r in rows), default=0.0) for n in NUMBERS}


def verdict(numbers: dict, limits: dict):
    """(correct, [[name, number, limit], ...]): correct when every number
    is finite and at most its limit."""
    lines = [[n, numbers[n], limits[n]] for n in NUMBERS]
    ok = all(math.isfinite(v) and v <= lim for _, v, lim in lines)
    return ok, lines
