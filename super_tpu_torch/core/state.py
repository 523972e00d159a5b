"""Fixed-capacity, mask-carried state (counterpart of super_tpu/core/state.py).

The layout is the JAX package's: fixed capacities with ``active`` masks and
feature-major ``(F, N)`` per-surfel arrays, the small ED graph row-major.  So
a test can hold every field against the reference array for array.  All
states are NamedTuples of tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from super_tpu_torch.config import SuPerConfig


class GraphState(NamedTuple):
    """Embedded-deformation graph, row-major (J is small)."""

    points: torch.Tensor        # (J, 3) node positions
    norms: torch.Tensor         # (J, 3)
    radii: torch.Tensor         # (J,) mean incident edge length
    active: torch.Tensor        # (J,) bool
    knn_idx: torch.Tensor       # (J, K_ed) neighbour node ids
    knn_w: torch.Tensor         # (J, K_ed) ARAP blend weights
    edges: torch.Tensor         # (E, 2)
    edge_active: torch.Tensor   # (E,) bool
    edge_lens: torch.Tensor     # (E,)
    triangles: torch.Tensor     # (T, 3)
    tri_active: torch.Tensor    # (T,) bool
    tri_areas: torch.Tensor     # (T,)
    seg: torch.Tensor           # (J,) int32
    seg_conf: torch.Tensor      # (J, C)

    @property
    def capacity(self) -> int:
        return self.points.shape[0]

    @property
    def num_active(self):
        return torch.sum(self.active).to(torch.int32)


class SurfelState(NamedTuple):
    """Surfel map, feature-major."""

    points: torch.Tensor      # (3, N)
    norms: torch.Tensor       # (3, N)
    colors: torch.Tensor      # (3, N)
    radii: torch.Tensor       # (N,)
    confs: torch.Tensor       # (N,)
    time_stamp: torch.Tensor  # (N,)
    active: torch.Tensor      # (N,) bool
    knn_idx: torch.Tensor     # (K, N) int32 anchor node ids
    knn_w: torch.Tensor       # (K, N)
    proj_uv: torch.Tensor     # (2, N)
    seg: torch.Tensor         # (N,) int32
    seg_conf: torch.Tensor    # (C, N)
    dist2edge: torch.Tensor   # (N,)

    @property
    def capacity(self) -> int:
        return self.points.shape[-1]

    @property
    def num_active(self):
        return torch.sum(self.active).to(torch.int32)


class TrackState(NamedTuple):
    """Tracked control points: -1 not yet tracking, -2 lost, >= 0 slot."""

    track_id: torch.Tensor     # (P,) int32
    coords: torch.Tensor       # (P, 2)
    coord_valid: torch.Tensor  # (P,) bool


class TrackerState(NamedTuple):
    surfels: SurfelState
    graph: GraphState
    track: TrackState
    time: torch.Tensor         # ()


class FrameData(NamedTuple):
    """Per-frame surfel candidates, pixel-indexed (P = H*W), feature-major."""

    points: torch.Tensor       # (3, P)
    norms: torch.Tensor        # (3, P)
    colors: torch.Tensor       # (3, P)
    radii: torch.Tensor        # (P,)
    confs: torch.Tensor        # (P,)
    valid: torch.Tensor        # (P,) bool
    seg: torch.Tensor          # (P,) int32
    seg_conf: torch.Tensor     # (C, P)
    dist2edge: torch.Tensor    # (P,)
    time: torch.Tensor         # ()
    color_image: torch.Tensor  # (3, H, W)

    def index_map(self, height: int, width: int):
        """(H, W) int32 pixel -> candidate id, -1 where invalid."""
        ids = torch.arange(self.valid.shape[0], dtype=torch.int32,
                           device=self.valid.device)
        return torch.where(self.valid, ids, -1).reshape(height, width)


def empty_surfels(cfg: SuPerConfig, device, dtype=torch.float32):
    n = cfg.capacity.surfel_capacity
    k = cfg.num_neighbors
    c = cfg.num_classes

    def z(*s):
        return torch.zeros(s, dtype=dtype, device=device)

    return SurfelState(
        points=z(3, n), norms=z(3, n), colors=z(3, n),
        radii=z(n), confs=z(n), time_stamp=z(n),
        active=torch.zeros((n,), dtype=torch.bool, device=device),
        knn_idx=torch.zeros((k, n), dtype=torch.int32, device=device),
        knn_w=z(k, n), proj_uv=z(2, n),
        seg=torch.zeros((n,), dtype=torch.int32, device=device),
        seg_conf=z(c, n), dist2edge=z(n))


def empty_graph(cfg: SuPerConfig, device, dtype=torch.float32) -> GraphState:
    j = cfg.capacity.node_capacity
    e = cfg.capacity.edge_capacity
    t = cfg.capacity.triangle_capacity
    k = cfg.num_ed_neighbors
    c = cfg.num_classes

    def z(*s, dt=dtype):
        return torch.zeros(s, dtype=dt, device=device)

    i32, b = torch.int32, torch.bool
    return GraphState(
        points=z(j, 3), norms=z(j, 3), radii=z(j), active=z(j, dt=b),
        knn_idx=z(j, k, dt=i32), knn_w=z(j, k), edges=z(e, 2, dt=i32),
        edge_active=z(e, dt=b), edge_lens=z(e), triangles=z(t, 3, dt=i32),
        tri_active=z(t, dt=b), tri_areas=z(t), seg=z(j, dt=i32),
        seg_conf=z(j, c))


def empty_track(cfg: SuPerConfig, device, dtype=torch.float32) -> TrackState:
    p = cfg.capacity.track_capacity
    return TrackState(
        track_id=torch.full((p,), -1, dtype=torch.int32, device=device),
        coords=torch.zeros((p, 2), dtype=dtype, device=device),
        coord_valid=torch.zeros((p,), dtype=torch.bool, device=device))


def gather_rows(fm_array, idx):
    """Columns of a feature-major (F, N) array at ``idx`` (any shape):
    returns (F,) + idx.shape."""
    return fm_array[:, idx.long()]


def set_columns_drop(fm_array, idx, values):
    """``fm_array.at[:, idx].set(values, mode="drop")`` of the JAX package.

    ``index_put_`` has no drop mode, so out-of-range targets go to one extra
    scratch column, which is sliced off.  With a repeated in-range index
    the winning write is unspecified on the card, so callers keep in-range
    targets unique or write equal values to them.  ``fm_array`` is (F, N)
    or (N,); ``values`` is (F,) + idx.shape or idx.shape.
    """
    n = fm_array.shape[-1]
    flat = fm_array.ndim == 1
    arr = fm_array[None] if flat else fm_array
    vals = values[None] if flat else values
    ext = torch.cat([arr, arr.new_zeros(arr.shape[:-1] + (1,))], dim=-1)
    tgt = idx.long()
    tgt = torch.where((tgt >= 0) & (tgt < n), tgt, n)
    ext[:, tgt] = vals.to(ext.dtype)
    out = ext[:, :n]
    return out[0] if flat else out


def scatter_set_rows(fm_array, idx, values, do=None):
    """Set columns of (F, N) ``fm_array`` at ``idx`` to ``values``, gated by
    ``do``; out-of-range indices are dropped."""
    if do is not None:
        cur = fm_array[:, idx.long().clamp(0, fm_array.shape[1] - 1)]
        values = torch.where(do, values, cur)
    return set_columns_drop(fm_array, idx, values)
