"""Surfel fusion: merge a frame's observations into the fixed-capacity map
(counterpart of super_tpu/core/fusion.py, ``proj_map_mode="sort"``).

1. Projection order: active surfels sorted by (pixel, confidence descending,
   slot id); a surfel's layer is its position in its pixel's run, and
   surfels beyond ``proj_map_depth`` layers are deleted.
2. New candidates merge into the first layer surfel at their pixel that
   passes the position/normal gate (confidence-weighted values).
3. Duplicate surfels of one pixel merge layer pair by layer pair, in the
   reference's sequential order; merged-away slots are remapped.
4. Unmatched candidates are anchored, stability-gated and written into free
   slots.

The JAX package runs stages 2-3 under ``lax.cond``: the full layer branch
(``_stage23_slow``) only when some pixel holds two surfels, a shortcut
otherwise.  PyTorch has no device-side branch, and deciding on the host
would cost a sync every frame, so this port always runs the full branch.
It gives the shortcut's result when no pixel holds two surfels
(tests/test_fusion.py::test_fast_path_matches_eager_when_single_layer).

JAX's ``.at[].set(mode="drop")`` becomes :func:`state.set_columns_drop`:
dropped ids go to a scratch column that is sliced off.  Every in-range
target of such a write is unique, so no write races another.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch

from super_tpu_torch.config import SuPerConfig
from super_tpu_torch.core.anchoring import (
    anchor_points,
    recompute_surfel_weights,
)
from super_tpu_torch.core.preprocess import DIVTERM
from super_tpu_torch.core.state import (
    FrameData,
    GraphState,
    SurfelState,
    TrackState,
    set_columns_drop,
)
from super_tpu_torch.geometry.camera import Intrinsics, project_points


class FusionDiag(NamedTuple):
    """Capacity-overflow counters of one fusion step (() int32 each)."""

    proj_overflow: torch.Tensor   # surfels deleted beyond proj_map_depth
    add_overflow: torch.Tensor    # add candidates beyond new_surfel_capacity
    free_exhausted: torch.Tensor  # stability-gated adds with no free slot
    dup_skipped: torch.Tensor     # multi-layer pixels beyond dup_pixel_cap


def _proj_sort_products(p: int, confs, valid, coords):
    """Surfels ordered by (pixel, conf desc, slot id) and the layer of each
    sorted position: (sorted_coords, layer, order), all (N,) int64.

    Two stable sorts give the JAX package's 3-key total order: by -conf
    first, then by pixel (ties keep the earlier order, ties of that keep
    slot order)."""
    n = confs.shape[0]
    key_coords = torch.where(valid, coords.long(), p)
    o1 = torch.sort(-confs, stable=True).indices
    o2 = torch.sort(key_coords[o1], stable=True).indices
    order = o1[o2]
    sorted_coords = key_coords[order]
    iota = torch.arange(n, device=confs.device)
    new_run = torch.ones((n,), dtype=torch.bool, device=confs.device)
    new_run[1:] = sorted_coords[1:] != sorted_coords[:-1]
    first_idx = torch.cummax(torch.where(new_run, iota, 0), dim=0).values
    return sorted_coords, iota - first_idx, order


def _pack_bank(points, norms, colors, radii, confs, seg, time_stamp):
    """The merge-relevant fields as one (13, N) bank (outside semantic mode
    the merges never touch class confidences, so none ride along)."""
    return torch.cat([points, norms, colors, radii[None], confs[None],
                      seg.to(points.dtype)[None], time_stamp[None]], dim=0)


def _unpack_bank(bank) -> Dict:
    return dict(points=bank[0:3], norms=bank[3:6], colors=bank[6:9],
                radii=bank[9], confs=bank[10], seg=bank[11].to(torch.int32),
                time_stamp=bank[12])


def _pack_vals(v: Dict):
    return _pack_bank(v["points"], v["norms"], v["colors"], v["radii"],
                      v["confs"], v["seg"], v["time_stamp"])


def _merge_gate(cfg: SuPerConfig, a: Dict, b: Dict):
    """Close in position and in normal (and in class for superv1)."""
    d2 = torch.sum((a["points"] - b["points"]) ** 2, dim=0)
    dot = torch.sum(a["norms"] * b["norms"], dim=0)
    ok = (d2 < cfg.th_dist ** 2) & (dot > cfg.th_cosine_ang)
    if cfg.hard_seg or cfg.data == "superv1":
        ok = ok & (a["seg"] == b["seg"])
    return ok


def _merged_values(a: Dict, b: Dict, time, triple_new_color: bool) -> Dict:
    """Confidence-weighted merge of b into a."""
    w1, w2 = a["confs"], b["confs"]
    w_sum = w1 + w2
    a1 = w1 / torch.clamp(w_sum, min=1e-20)
    a2 = w2 / torch.clamp(w_sum, min=1e-20)
    points = a1 * a["points"] + a2 * b["points"]
    norms = a1 * a["norms"] + a2 * b["norms"]
    norms = norms / torch.clamp(
        torch.sqrt(torch.sum(norms * norms, dim=0, keepdim=True)), min=1e-12)
    radii = a1 * a["radii"] + a2 * b["radii"]
    if triple_new_color:
        wc1, wc2 = a1, 3.0 * a2
        cs = torch.clamp(wc1 + wc2, min=1e-20)
        colors = wc1 / cs * a["colors"] + wc2 / cs * b["colors"]
    else:
        colors = a1 * a["colors"] + a2 * b["colors"]
    return dict(points=points, norms=norms, radii=radii, colors=colors,
                confs=w_sum, time_stamp=torch.zeros_like(w_sum) + time,
                seg=a["seg"])


def _candidate_view(cfg: SuPerConfig, intr: Intrinsics, frame: FrameData,
                    sf_pix) -> Dict:
    """The frame candidate at each surfel's pixel: z, normal and colour are
    gathered, the rest is rebuilt from the pixel as preprocess_frame builds
    it (invalid candidates carry zero normals, so they fail the gate)."""
    h, w = cfg.height, cfg.width
    fdt = frame.points.dtype
    need_seg = cfg.hard_seg or cfg.data == "superv1"
    rows = [frame.points[2:3], frame.norms, frame.colors]
    if need_seg:
        rows.append(frame.seg.to(fdt)[None])
    fv = torch.cat(rows, dim=0)[:, sf_pix.long()]
    z, n, colors = fv[0], fv[1:4], fv[4:7]
    seg = fv[7].to(torch.int32) if need_seg else \
        torch.zeros(z.shape, dtype=torch.int32, device=z.device)
    pix = sf_pix.long()
    vf = (pix // w).to(fdt)
    uf = (pix - (pix // w) * w).to(fdt)
    x = (uf - intr.cx) * z / intr.fx
    y = (vf - intr.cy) * z / intr.fy
    nz = torch.clamp(torch.abs(n[2]), 0.26, 1.0)
    radii = torch.abs(z) / (math.sqrt(2.0) * intr.fx * nz)
    if not cfg.disable_ssim_conf:
        raise NotImplementedError("SSIM-blended confidences are not ported")
    dc2 = (2.0 * uf / w - 1.0) ** 2 + (2.0 * vf / h - 1.0) ** 2
    confs = torch.exp(-dc2 * DIVTERM)
    return dict(points=torch.stack([x, y, z]), norms=n, colors=colors,
                radii=radii, confs=confs, seg=seg,
                time_stamp=torch.zeros_like(z))


def add_candidates(cfg: SuPerConfig, intr: Intrinsics, surfels: SurfelState,
                   graph: GraphState, frame: FrameData, add_mask, time):
    """Stage 4: compact the unmatched candidates to new_surfel_capacity,
    anchor them, and write the stable ones into free slots.

    Returns (surfels, add_overflow, free_exhausted)."""
    p = cfg.image_pixels
    dev = add_mask.device
    a_cap = cfg.capacity.new_surfel_capacity
    # r-th candidate by searchsorted over the cumsum (no rank scatter).
    cand_cs = torch.cumsum(add_mask.to(torch.int64), 0)
    add_overflow = torch.clamp(cand_cs[-1] - a_cap, min=0).to(torch.int32)
    cand_r1 = torch.arange(1, a_cap + 1, device=dev)
    comp_src = torch.searchsorted(cand_cs, cand_r1)
    comp_valid = cand_r1 <= cand_cs[-1]
    comp_src = torch.where(comp_valid, torch.clamp(comp_src, 0, p - 1), 0)

    fdt = frame.points.dtype
    fbank = torch.cat([frame.points, frame.norms, frame.colors,
                       frame.radii[None], frame.confs[None],
                       frame.dist2edge[None], frame.seg.to(fdt)[None],
                       frame.seg_conf], dim=0)
    cvals = fbank[:, comp_src]                      # (13 + C, a_cap)
    knn_idx, knn_w, stable = anchor_points(
        cfg, graph, cvals[0:3], comp_valid, seg=cvals[12].to(torch.int32))
    add = comp_valid & stable

    n = surfels.capacity
    free_cs = torch.cumsum((~surfels.active).to(torch.int64), 0)
    add_rank1 = torch.cumsum(add.to(torch.int64), 0)
    fits = add & (add_rank1 <= free_cs[-1])
    target = torch.where(fits, torch.searchsorted(free_cs, add_rank1), n)
    free_exhausted = torch.sum(add & ~fits).to(torch.int32)

    # One packed column write (ints carried as f32: node ids and labels
    # are far below 2^24); distinct ranks give distinct free slots.
    src = torch.cat([cvals,
                     torch.zeros((1, a_cap), dtype=fdt, device=dev) + time,
                     knn_idx.to(fdt), knn_w,
                     torch.ones((1, a_cap), dtype=fdt, device=dev)], dim=0)
    dst = torch.cat([surfels.points, surfels.norms, surfels.colors,
                     surfels.radii[None], surfels.confs[None],
                     surfels.dist2edge[None], surfels.seg.to(fdt)[None],
                     surfels.seg_conf, surfels.time_stamp[None],
                     surfels.knn_idx.to(fdt), surfels.knn_w,
                     surfels.active.to(fdt)[None]], dim=0)
    new = set_columns_drop(dst, target, src)
    c = frame.seg_conf.shape[0]
    k = surfels.knn_idx.shape[0]
    surfels = surfels._replace(
        points=new[0:3], norms=new[3:6], colors=new[6:9], radii=new[9],
        confs=new[10], dist2edge=new[11], seg=new[12].to(torch.int32),
        seg_conf=new[13:13 + c], time_stamp=new[13 + c],
        knn_idx=new[14 + c:14 + c + k].to(surfels.knn_idx.dtype),
        knn_w=new[14 + c + k:14 + c + 2 * k],
        active=new[14 + c + 2 * k] > 0.5)
    return surfels, add_overflow, free_exhausted


def _stage23(cfg: SuPerConfig, bank, active0, sorted_coords, layer, order,
             sf_pix, gate_raw, vals_packed, time):
    """Overflow deletion, min-layer candidate winners and the duplicate
    merges (the JAX package's ``_stage23_slow`` behind ``_slow_lazy``).

    Returns (bank, active, remap, consumed, n_overflow, dup_skipped)."""
    p = cfg.image_pixels
    depth_l = cfg.capacity.proj_map_depth
    n_cap = bank.shape[1]
    p8 = cfg.capacity.dup_pixel_cap or max(p // 128, 1024)
    dev = bank.device
    merge_new = not cfg.disable_merging_new_surfels
    merge_dup = not cfg.disable_merging_exist_surfels and depth_l > 1

    # Layer structures from the sorted runs: (L, P) map and per-slot layer.
    in_map_s = (sorted_coords < p) & (layer < depth_l)
    flat_idx = torch.where(in_map_s, layer * p + sorted_coords, depth_l * p)
    proj_id = set_columns_drop(
        torch.full((depth_l * p,), -1, dtype=torch.int64, device=dev),
        flat_idx, order).reshape(depth_l, p)
    layer_sorted = torch.where(sorted_coords < p,
                               torch.clamp(layer, max=depth_l), -1)
    sf_layer = torch.empty((n_cap,), dtype=torch.int64, device=dev)
    sf_layer[order] = layer_sorted

    remap = torch.arange(n_cap, dtype=torch.int32, device=dev)
    consumed = torch.zeros((p,), dtype=torch.bool, device=dev)
    overflow = sf_layer == depth_l
    active0 = active0 & ~overflow
    pix = sf_pix.long()
    if merge_new:
        in_map = (sf_layer >= 0) & (sf_layer < depth_l)
        gate_n = in_map & gate_raw
        min_layer = torch.full((p,), depth_l, dtype=torch.int64,
                               device=dev).scatter_reduce(
            0, pix, torch.where(gate_n, sf_layer, depth_l), reduce="amin")
        do = gate_n & (sf_layer == min_layer[pix])
        bank = torch.where(do[None], vals_packed, bank)
        consumed = min_layer < depth_l
    dup_skipped = torch.zeros((), dtype=torch.int32, device=dev)
    if merge_dup:
        # One clique pass over the multi-layer pixel list, pair merges in
        # the reference's sequential (i, j) order.
        cs = torch.cumsum((proj_id[1] >= 0).to(torch.int64), 0)
        dup_skipped = torch.clamp(cs[-1] - p8, min=0).to(torch.int32)
        ranks1 = torch.arange(1, p8 + 1, device=dev)
        compact_pix = torch.searchsorted(cs, ranks1)
        compact_valid = ranks1 <= cs[-1]
        compact_pix = torch.where(compact_valid,
                                  torch.clamp(compact_pix, 0, p - 1), 0)
        pid_all = proj_id[:, compact_pix]                      # (L, p8)
        sls = [torch.clamp(pid_all[li], 0, n_cap - 1) for li in range(depth_l)]
        occ_c = [compact_valid & (pid_all[li] >= 0) for li in range(depth_l)]
        gath = bank[:, torch.cat(sls)]
        vals = [_unpack_bank(v) for v in torch.split(gath, p8, dim=1)]
        alive = list(occ_c)
        merged_into = [torch.zeros((p8,), dtype=torch.int64, device=dev)
                       for _ in range(depth_l)]
        changed = [torch.zeros((p8,), dtype=torch.bool, device=dev)
                   for _ in range(depth_l)]
        for i in range(depth_l):
            for j in range(i + 1, depth_l):
                do = alive[i] & alive[j] & _merge_gate(cfg, vals[i], vals[j])
                mv = _merged_values(vals[i], vals[j], time,
                                    triple_new_color=False)
                vals[i] = {k: torch.where(do, mv[k], vals[i][k])
                           for k in vals[i]}
                changed[i] = changed[i] | do
                alive[j] = alive[j] & ~do
                merged_into[j] = torch.where(do, sls[i], merged_into[j])
                changed[j] = changed[j] | do
        wcols = torch.cat([torch.where(ch & oc, sl, n_cap)
                           for ch, oc, sl in zip(changed, occ_c, sls)])
        wvals = torch.cat([_pack_vals(v) for v in vals], dim=1)
        bank = set_columns_drop(bank, wcols, wvals)
        dead = torch.cat([torch.where(oc & ~al, sl, n_cap)
                          for oc, al, sl in zip(occ_c, alive, sls)])
        active0 = set_columns_drop(active0, dead,
                                   torch.zeros_like(dead, dtype=torch.bool))
        remap = set_columns_drop(remap, dead,
                                 torch.cat(merged_into).to(torch.int32))
    n_overflow = torch.sum(overflow).to(torch.int32)
    return bank, active0, remap, consumed, n_overflow, dup_skipped


def fuse_frame(cfg: SuPerConfig, intr: Intrinsics, surfels: SurfelState,
               graph: GraphState, frame: FrameData
               ) -> Tuple[SurfelState, torch.Tensor, FusionDiag]:
    """Stages 1-4 of the fusion (pruning is :func:`prune_surfels`).

    Returns (surfels, remap, diag): ``remap[j] = i`` where surfel j merged
    into i, identity elsewhere."""
    if cfg.proj_map_mode != "sort" or cfg.method == "semantic-super":
        raise NotImplementedError(
            "the port fuses in proj_map_mode='sort' for method='super'")
    h, w = cfg.height, cfg.width
    p = cfg.image_pixels
    time = frame.time
    merge_new = not cfg.disable_merging_new_surfels

    # --- stage 1: projection ordering ------------------------------------
    _, _, coords, in_bounds = project_points(surfels.points, intr, h, w)
    valid = in_bounds & surfels.active
    sf_pix = torch.where(valid, coords, 0).to(torch.int32)
    sorted_coords, layer, order = _proj_sort_products(p, surfels.confs,
                                                      valid, coords)

    # --- stage 2: every surfel gates against the candidate at its pixel ---
    bank = _pack_bank(surfels.points, surfels.norms, surfels.colors,
                      surfels.radii, surfels.confs, surfels.seg,
                      surfels.time_stamp)
    gate_raw = vals_packed = None
    if merge_new:
        fview = _candidate_view(cfg, intr, frame, sf_pix)
        sview = _unpack_bank(bank)
        gate_raw = _merge_gate(cfg, sview, fview)
        vals_packed = _pack_vals(_merged_values(sview, fview, time,
                                                triple_new_color=True))

    # --- stages 2-3: layer winners and duplicate merges -------------------
    bank, active, remap, consumed, n_overflow, dup_skipped = _stage23(
        cfg, bank, surfels.active, sorted_coords, layer, order, sf_pix,
        gate_raw, vals_packed, time)
    add_mask = (frame.valid & ~consumed) if merge_new else frame.valid
    merged = _unpack_bank(bank)
    surfels = surfels._replace(
        active=active, points=merged["points"], norms=merged["norms"],
        colors=merged["colors"], radii=merged["radii"],
        confs=merged["confs"], seg=merged["seg"],
        time_stamp=merged["time_stamp"])

    # --- stage 3.5: refresh anchor weights --------------------------------
    surfels = recompute_surfel_weights(cfg, surfels, graph)

    # --- stage 4: add unmatched candidates into free slots ---------------
    zero = torch.zeros((), dtype=torch.int32, device=bank.device)
    add_overflow = free_exhausted = zero
    if not cfg.disable_adding_new_surfels:
        surfels, add_overflow, free_exhausted = add_candidates(
            cfg, intr, surfels, graph, frame, add_mask, time)
    diag = FusionDiag(proj_overflow=n_overflow, add_overflow=add_overflow,
                      free_exhausted=free_exhausted, dup_skipped=dup_skipped)
    return surfels, remap, diag


def prune_surfels(cfg: SuPerConfig, surfels: SurfelState, track: TrackState,
                  time) -> Tuple[SurfelState, TrackState]:
    """Deactivate surfels stale for th_time_steps (tracked ones are kept,
    slot 0 only where its last entry in track order is tracked) and mark
    tracks whose surfel is gone as lost (-2)."""
    n = surfels.capacity
    if not cfg.disable_removing_unstable_surfels:
        fresh = (time - surfels.time_stamp) < cfg.th_time_steps
        # The JAX package writes active.at[clip(track_id)].set(tracked ?
        # True : active[slot]): every entry writes, the untracked ones
        # (clipped to slot 0) their slot's own value, and on each slot the
        # last entry in track order wins.  That entry is found explicitly
        # (the largest entry index per slot), since a write with repeated
        # indices has no defined winner on CUDA.
        slot = torch.clamp(track.track_id, 0, n - 1).long()
        entry = torch.arange(slot.shape[0], device=slot.device)
        last = torch.full((n,), -1, dtype=torch.int64,
                          device=slot.device).scatter_reduce(0, slot, entry,
                                                             "amax")
        kept = (last >= 0) & (track.track_id >= 0)[last.clamp(min=0)]
        surfels = surfels._replace(active=(surfels.active & fresh) | kept)
    tid = torch.clamp(track.track_id, 0, n - 1).long()
    lost = (track.track_id >= 0) & ~surfels.active[tid]
    return surfels, track._replace(
        track_id=torch.where(lost, -2, track.track_id).to(torch.int32))
