"""Tracked control points: bind ground-truth points to surfels and read
their screen coordinates (counterpart of super_tpu/core/track_points.py).

Slot ids are stable, so a tracked id stays valid until its surfel is pruned
or merged away (the step follows merges).  Both functions run on the
device with no host sync: the binding is a loop of one device step a GT
point, with the ``used`` mask kept on the device.
"""

from __future__ import annotations

import torch

from super_tpu_torch.config import SuPerConfig
from super_tpu_torch.core.state import (
    FrameData,
    SurfelState,
    TrackState,
    set_columns_drop,
)


def assign_track_points(cfg: SuPerConfig, surfels: SurfelState,
                        frame: FrameData, track: TrackState, gt_xy, gt_valid,
                        th: float = 0.2) -> TrackState:
    """Bind untracked GT points (track_id == -1) to the nearest surfel.

    gt_xy: (P, 2) integer GT screen coordinates (x, y) of this frame;
    gt_valid: (P,) bool GT visibility.  A GT point binds to the closest
    active surfel that no point tracks yet, measured to the frame's
    candidate at its pixel, if the candidate is valid, the pixel is not 0
    and the distance is below ``th``.  In order of the points: an earlier
    binding excludes its surfel from the later ones.
    """
    w = cfg.width
    n = surfels.capacity
    dev = surfels.points.device
    npix = frame.valid.shape[0]
    tid = track.track_id
    # The slots the tracked ids hold (every write sets True).
    used = set_columns_drop(torch.zeros((n,), dtype=torch.bool, device=dev),
                            torch.where(tid >= 0, tid, n),
                            torch.ones_like(tid, dtype=torch.bool))
    xy = gt_xy.to(device=dev, dtype=torch.int64)
    gv = gt_valid.to(device=dev, dtype=torch.bool)
    sp = surfels.points
    new_ids = []
    for p in range(tid.shape[0]):
        pix = torch.clamp(xy[p, 1] * w + xy[p, 0], 0, npix - 1)
        cand_ok = frame.valid[pix] & (pix > 0)
        target = frame.points[:, pix]
        d = torch.sqrt((sp[0] - target[0]) ** 2 + (sp[1] - target[1]) ** 2
                       + (sp[2] - target[2]) ** 2)
        d = torch.where(surfels.active & ~used, d, float("inf"))
        best = torch.argmin(d)
        assign = (tid[p] == -1) & gv[p] & cand_ok & (d[best] < th)
        new_ids.append(torch.where(assign, best.to(torch.int32), tid[p]))
        used = used.index_put((best.reshape(1),),
                              (used[best] | assign).reshape(1))
    return track._replace(track_id=torch.stack(new_ids))


def record_track_coords(surfels: SurfelState,
                        track: TrackState) -> TrackState:
    """Store the current screen coordinates of the tracked surfels."""
    tid = torch.clamp(track.track_id, 0, surfels.capacity - 1).long()
    return track._replace(coords=surfels.proj_uv[:, tid].T,
                          coord_valid=track.track_id >= 0)
