"""Parity of the port's warp application, fusion and pruning with the JAX
package: apply_deformation, fuse_frame (every FusionDiag counter, the remap)
and prune_surfels, on the tiny scene and on a crowded map that drives the
layer overflow, the duplicate merges and both add-capacity limits."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import close, port_config, port_frame, port_intr, \
    port_state, scene, slice_config, to_np

from super_tpu.core import fusion as jfus
from super_tpu.core.tracker import init_tracker
from super_tpu.core.warp import apply_deformation as j_apply
from super_tpu.geometry.quaternion import IDENTITY_DQ
from super_tpu_torch.core import fusion as tfus
from super_tpu_torch.core.warp import apply_deformation as t_apply

# Surfel fields after fusion.  Merged values are confidence-weighted means
# of f32 values (a few ULP apart between the frameworks), and the anchor
# weights are refreshed from f32 distances (ROADMAP queue 3 on the
# distance cancellation): per-field absolute tolerances.
FLOAT_ATOL = dict(points=1e-6, norms=1e-5, colors=1e-6, radii=1e-8,
                  confs=1e-5, time_stamp=0.0, proj_uv=0.0, seg_conf=0.0,
                  dist2edge=0.0)
EXACT = ("active", "seg")


@pytest.fixture(scope="module")
def base():
    cfg = slice_config()
    intr, _, frames = scene(3, cfg)
    st = jax.jit(lambda f: init_tracker(cfg, f))(frames[0])
    return cfg, intr, frames, st


def _beta(cfg, seed, scale=1e-3):
    rng = np.random.default_rng(seed)
    beta = np.tile(np.asarray(IDENTITY_DQ, np.float32),
                   (cfg.capacity.node_capacity, 1))
    beta += (scale * rng.normal(size=beta.shape)).astype(np.float32)
    return beta


def _compare_surfels(want, got):
    act = np.asarray(want.active)
    close(want.active, got.active, atol=0, name="active")
    for field in EXACT:
        close(np.asarray(getattr(want, field))[..., act],
              getattr(got, field).numpy()[..., act], atol=0, name=field)
    for field, atol in FLOAT_ATOL.items():
        close(np.asarray(getattr(want, field))[..., act],
              getattr(got, field).numpy()[..., act], atol=atol, name=field)
    # Added surfels are anchored by KNN, whose near-ties may pick another
    # node (test_torch_preprocess.py::test_init_tracker_surfels): under 1%
    # of the anchor sets may differ; the weights of the others agree to
    # the distance cancellation's 1e-2 (99% of them to 1e-3).
    ids_j = np.asarray(want.knn_idx)[:, act]
    ids_t = got.knn_idx.numpy()[:, act]
    same = np.all(ids_j == ids_t, axis=0)
    assert same.mean() > 0.99, same.mean()
    dw = np.abs(np.asarray(want.knn_w)[:, act][:, same]
                - got.knn_w.numpy()[:, act][:, same])
    assert dw.max() < 1e-2, dw.max()
    assert np.quantile(dw, 0.99) < 1e-3, np.quantile(dw, 0.99)


def test_apply_deformation(base):
    cfg, _, _, st = base
    beta = _beta(cfg, 0)
    s_j, g_j = j_apply(cfg, st.surfels, st.graph, jnp.asarray(beta))
    ps = port_state(st)
    s_t, g_t = t_apply(port_config(cfg), ps.surfels, ps.graph,
                       torch.as_tensor(beta))
    # The blend of 4 anchors' rigid motions, in the same order: 1e-7 m on
    # points (~0.5 m), 1e-6 on the renormalised normals.
    close(s_j.points, s_t.points, atol=1e-7, name="points")
    close(s_j.norms, s_t.norms, atol=1e-6, name="norms")
    close(g_j.points, g_t.points, atol=0, name="node points")
    close(g_j.norms, g_t.norms, atol=1e-6, name="node norms")


def _fuse_both(cfg, intr, st, frame):
    s_j, remap_j, diag_j = jax.jit(
        lambda s, g, f: jfus.fuse_frame(cfg, intr, s, g, f))(
        st.surfels, st.graph, frame)
    ps = port_state(st)
    s_t, remap_t, diag_t = tfus.fuse_frame(port_config(cfg), port_intr(intr),
                                           ps.surfels, ps.graph,
                                           port_frame(frame))
    return (s_j, remap_j, diag_j), (s_t, remap_t, diag_t)


def test_fuse_frame_after_deformation(base):
    cfg, intr, frames, st = base
    s, g = jax.jit(lambda s, g, b: j_apply(cfg, s, g, b))(
        st.surfels, st.graph, jnp.asarray(_beta(cfg, 1)))
    st = st._replace(surfels=s, graph=g)
    (s_j, remap_j, diag_j), (s_t, remap_t, diag_t) = _fuse_both(
        cfg, intr, st, frames[1])
    _compare_surfels(s_j, s_t)
    close(remap_j, remap_t, atol=0, name="remap")
    for name in diag_j._fields:
        close(getattr(diag_j, name), getattr(diag_t, name), atol=0, name=name)


def _crowded(cfg, st, copies=5, seed=2):
    """Copies of a band of active surfels into free slots, nudged by
    ~0.1 mm with shuffled confidences: pixels with up to 1 + copies layers
    (beyond proj_map_depth = 4), duplicates that pass the merge gate.  A
    few other surfels are dropped, so their pixels' candidates go unmatched
    and are added."""
    rng = np.random.default_rng(seed)
    s = to_np(st.surfels)
    on = np.flatnonzero(s.active)
    act = on[::3][:400]
    free = np.flatnonzero(~s.active)
    arrays = {f: np.array(getattr(s, f)) for f in s._fields}
    arrays["active"][on[1::7][:100]] = False
    for c in range(copies):
        dst = free[c * len(act):(c + 1) * len(act)]
        for f, a in arrays.items():
            a[..., dst] = a[..., act]
        arrays["points"][:, dst] += (1e-4 * rng.normal(size=(3, len(act)))
                                     ).astype(np.float32)
        arrays["confs"][dst] *= rng.uniform(0.5, 1.5, len(act)).astype(
            np.float32)
    return st._replace(surfels=type(st.surfels)(
        **{f: jnp.asarray(a) for f, a in arrays.items()}))


def test_fuse_frame_crowded_map(base):
    cfg, intr, frames, st = base
    # Few add slots and a short duplicate list: both overflow counters.
    cfg = cfg.replace(capacity=dataclasses.replace(
        cfg.capacity, new_surfel_capacity=8, dup_pixel_cap=64))
    st = _crowded(cfg, st)
    (s_j, remap_j, diag_j), (s_t, remap_t, diag_t) = _fuse_both(
        cfg, intr, st, frames[1])
    assert int(diag_j.proj_overflow) > 0 and int(diag_j.add_overflow) > 0
    assert int(diag_j.dup_skipped) > 0
    assert np.sum(np.asarray(remap_j) != np.arange(remap_j.shape[0])) > 0
    for name in diag_j._fields:
        close(getattr(diag_j, name), getattr(diag_t, name), atol=0, name=name)
    close(remap_j, remap_t, atol=0, name="remap")
    _compare_surfels(s_j, s_t)


def test_fuse_frame_free_slots_exhausted(base):
    cfg, intr, frames, st = base
    # Fill all but 4 free slots with surfels far outside the view (they
    # project nowhere), and move 100 real surfels out of view too: their
    # pixels' candidates go unmatched, and the adds run out of slots.
    s = to_np(st.surfels)
    active = np.array(s.active)
    free = np.flatnonzero(~active)
    active[free[4:]] = True
    pts = np.array(s.points)
    far = np.array([[10.0], [10.0], [1.0]], np.float32)
    pts[:, free[4:]] = far
    pts[:, np.flatnonzero(s.active)[::20][:100]] = far
    st = st._replace(surfels=st.surfels._replace(
        active=jnp.asarray(active), points=jnp.asarray(pts)))
    (s_j, remap_j, diag_j), (s_t, remap_t, diag_t) = _fuse_both(
        cfg, intr, st, frames[2])
    assert int(diag_j.free_exhausted) > 0
    for name in diag_j._fields:
        close(getattr(diag_j, name), getattr(diag_t, name), atol=0, name=name)
    _compare_surfels(s_j, s_t)


def test_prune_surfels(base):
    cfg, _, _, st = base
    rng = np.random.default_rng(4)
    n = cfg.capacity.surfel_capacity
    ts = np.array(to_np(st.surfels).time_stamp)
    ts[rng.random(n) < 0.3] = -40.0          # stale
    surfels = st.surfels._replace(time_stamp=jnp.asarray(ts))
    active = np.asarray(surfels.active)
    on = np.flatnonzero(active)
    track_id = np.full((cfg.capacity.track_capacity,), -1, np.int32)
    track_id[:6] = on[:6]                    # some tracked, some stale
    # A tracked slot that is already inactive is kept (reactivated).  Slot
    # 0, where the untracked (-1, clipped to 0) entries write too, is
    # test_prune_surfels_slot0_write_order's.
    track_id[6] = np.flatnonzero(~active)[1]
    track_id[7] = on[0]                      # two tracks on one slot
    track = st.track._replace(track_id=jnp.asarray(track_id))
    s_j, tr_j = jfus.prune_surfels(cfg, surfels, track, jnp.float32(5.0))
    ps = port_state(st._replace(surfels=surfels, track=track))
    s_t, tr_t = tfus.prune_surfels(port_config(cfg), ps.surfels, ps.track,
                                   torch.tensor(5.0))
    close(s_j.active, s_t.active, atol=0, name="active")
    close(tr_j.track_id, tr_t.track_id, atol=0, name="track_id")
    assert np.sum(np.asarray(s_j.active)) < active.sum()


# Track tables around slot 0 (stale there): the entries given, then the
# rest untracked (-1) or tracking other live slots; and whether slot 0
# stays, which is the last slot-0 entry's (tracked or not) in track order.
SLOT0_ORDERS = {
    "tracked_first": ([0, -1], "untracked", False),
    "tracked_last": ([-1] * 19 + [0], "untracked", True),
    "untracked_after": ([-1, 0, -1], "untracked", False),
    "two_tracks_untracked_between": ([0, -1, 0], "others", True),
    "two_tracks_then_untracked": ([-1, 0, -1, 0], "untracked", False),
}


@pytest.mark.parametrize("order", list(SLOT0_ORDERS))
def test_prune_surfels_slot0_write_order(base, order):
    cfg, _, _, st = base
    head, tail, kept = SLOT0_ORDERS[order]
    n = cfg.capacity.surfel_capacity
    ts = np.array(to_np(st.surfels).time_stamp)
    ts[0] = -40.0                            # slot 0 stale
    surfels = st.surfels._replace(time_stamp=jnp.asarray(ts))
    active = np.asarray(surfels.active)
    cap = cfg.capacity.track_capacity
    others = np.flatnonzero(active[1:])[:cap] + 1
    track_id = np.full((cap,), -1, np.int32)
    if tail == "others":
        track_id[:] = others
    track_id[:len(head)] = head
    track = st.track._replace(track_id=jnp.asarray(track_id))
    s_j, tr_j = jfus.prune_surfels(cfg, surfels, track, jnp.float32(5.0))
    ps = port_state(st._replace(surfels=surfels, track=track))
    s_t, tr_t = tfus.prune_surfels(port_config(cfg), ps.surfels, ps.track,
                                   torch.tensor(5.0))
    assert bool(s_j.active[0]) == kept
    close(s_j.active, s_t.active, atol=0, name="active")
    close(tr_j.track_id, tr_t.track_id, atol=0, name="track_id")
