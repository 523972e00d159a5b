"""The table of peaks and the least time a kernel's work can take on one
card, by the arithmetic of the port's ``chip_smoke.py:bound()``: the larger
of its bytes over the memory bandwidth and its float32 operations over the
float32 rate outside the tensor cores.

The work is counted from the cell's own problem, read off the tracker's
state in the traced stretch (live nodes, live node pairs, live slots and
anchor tuples, the configuration's CG iterations and LM trips), never from
a kernel's launch arguments: so it is the same whatever implements it.
Each input byte is counted once and each output byte once.  A roofline's
reader (benchmark/metrics) names the device operations it times, counts
one launch's work with the functions here, and hands both to
:func:`share`.
"""

from __future__ import annotations

import torch

# One NVIDIA H100 SXM (data sheet; dense rates, the full 700 W).
PEAKS = {"NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12,
                                   "f32_flop_per_s": 67e12}}
DEFAULT_PEAK = PEAKS["NVIDIA H100 80GB HBM3"]

ROW_FLOPS = 470                      # a slot's point-plane row (28 entries)
GRAM_FLOPS = 2 * (28 * 29 // 2 + 28)  # its Gram's upper half and J^T r


def bound(nbytes: float, flops: float, peak=DEFAULT_PEAK):
    """(least seconds, "bytes" or "operations")."""
    t_bytes = nbytes / peak["bytes_per_s"]
    t_ops = flops / peak["f32_flop_per_s"]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def pairs_cg_work(nodes: int, pairs: int, iterations: int):
    """(bytes, flops) of one damped block-Jacobi CG solve of ``iterations``
    on ``pairs`` distinct node pairs (diagonals included) of ``nodes``
    nodes: per matvec two 7x7 block products a pair, the preconditioner's
    one a node, ~10 vector operations an entry; the pair blocks and their
    transposes, the pair node ids, the preconditioner, b, x0, x and u."""
    flops = (iterations + 1) * (2 * 2 * 49 * pairs + 2 * 49 * nodes
                                + 10 * 7 * nodes)
    nbytes = 2 * 49 * pairs * 4 + 2 * pairs * 4 + 49 * nodes * 4 \
        + 3 * 7 * nodes * 4 + 4
    return nbytes, flops


def data_gram_work(slots: int, rows: int, tuples: int):
    """(bytes, flops) of one assembly of the point-plane term's per-tuple
    Grams: each live slot's mask, point, four weights and target point and
    normal read once; each tuple's four node ids, their parameters and
    anchor positions read once, its 28 x 28 Gram and 28 J^T r entries
    written once; ``rows`` slots make a row and its Gram."""
    nbytes = slots * (1 + 12 + 16 + 24) + tuples * (16 + 28 * 4 + 12 * 4) \
        + tuples * (28 * 28 + 28) * 4 + 4
    flops = rows * (ROW_FLOPS + GRAM_FLOPS + 2)
    return nbytes, flops


def problem_sizes(state, intr, height: int, width: int) -> dict:
    """Live nodes, node pairs, slots, in-frame slots and anchor tuples of a
    tracker state (one stream's, the port's NamedTuples).  The node pairs
    are those the normal equations couple: each active surfel's anchor
    pairs and each node's with itself, and the ARAP pairs of active
    nodes."""
    sf, g = state.surfels, state.graph
    act = sf.active
    j = g.points.shape[0]
    anchors = sf.knn_idx[:, act].long()
    a, b = torch.triu_indices(4, 4, device=anchors.device)
    lo = torch.minimum(anchors[a], anchors[b]).reshape(-1)
    hi = torch.maximum(anchors[a], anchors[b]).reshape(-1)
    nb = g.knn_idx.long()
    self_ = torch.arange(j, device=nb.device)[:, None].expand_as(nb)
    ok = g.active[:, None] & g.active[nb]
    keys = torch.cat([lo * j + hi,
                      (torch.minimum(self_, nb) * j
                       + torch.maximum(self_, nb))[ok],
                      torch.nonzero(g.active)[:, 0] * (j + 1)])
    tuples = torch.unique(((anchors[0] * j + anchors[1]) * j + anchors[2])
                          * j + anchors[3]).numel()
    pts = sf.points[:, act]
    z = pts[2] + 1e-8
    u = pts[0] * intr[0] / z + intr[2]
    v = pts[1] * intr[1] / z + intr[3]
    ui, vi = torch.round(u), torch.round(v)
    inframe = (vi >= 0) & (vi < height - 1) & (ui >= 0) & (ui < width - 1)
    return {"nodes": int(g.active.sum()), "pairs": torch.unique(keys).numel(),
            "slots": int(act.sum()), "rows": int(inframe.sum()),
            "tuples": tuples}


def stretch_problem(st) -> dict:
    """The sizes of one stream's problem in the stretch: the mean of
    :func:`problem_sizes` over the stream states at the stretch's two ends
    (worked out once a stretch)."""
    if "problem" not in st.context:
        sizes = [problem_sizes(s, st.intr, st.config.height,
                               st.config.width) for s in st.states]
        st.context["problem"] = {k: sum(d[k] for d in sizes) / len(sizes)
                                 for k in sizes[0]}
    return st.context["problem"]


def share(st, name: str, is_op, work, launches_per_frame: int):
    """The least time of ``launches_per_frame`` launches a stream's frame,
    each of ``work`` (bytes, flops), over the stretch's traced time of the
    device operations whose names ``is_op`` accepts, %; None where none
    ran.  Notes the bound (bytes or operations) under context["bounds"]."""
    traced = sum(e - s for s, e, n in st.device if is_op(n)) * 1e-6
    if traced <= 0:
        return None
    least, by = bound(*work, st.context["peak"])
    st.context.setdefault("bounds", {})[name] = by
    launches = launches_per_frame * st.frames * st.streams
    return 100.0 * least * launches / traced
