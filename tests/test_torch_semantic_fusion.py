"""Parity of the port's semantic fusion (``method="semantic-super"``) and of
the autograd path's warp application with the JAX package: apply_deformation
with the global row, fuse_frame (class confidences in the merge bank, their
renormalisation and argmax, the candidates' confidences, the JSD-blended
anchor weights of the refresh and the adds) and prune_surfels, on the
semantic tiny scene and on a crowded map; at test_torch_fusion.py's
tolerances, with the merged class confidences at 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_fusion import FLOAT_ATOL, _beta, _crowded
from torch_helpers import close, port_config, port_frame, port_intr, \
    port_state, semantic_config, semantic_scene

from super_tpu.core import fusion as jfus
from super_tpu.core.tracker import init_tracker
from super_tpu.core.warp import apply_deformation as j_apply
from super_tpu_torch.core import fusion as tfus
from super_tpu_torch.core.warp import apply_deformation as t_apply

# Merged class confidences are confidence-weighted means of f32 values,
# renormalised: 1e-6 on values in [0, 1].
SEM_ATOL = dict(FLOAT_ATOL, seg_conf=1e-6)


@pytest.fixture(scope="module", params=["semantic", "bench"])
def base(request):
    cfg = semantic_config(render=request.param == "semantic")
    intr, _, frames = semantic_scene(3, cfg)
    st = jax.jit(lambda f: init_tracker(cfg, f))(frames[0])
    return cfg, intr, frames, st


def _compare(want, got):
    act = np.asarray(want.active)
    close(want.active, got.active, atol=0, name="active")
    close(np.asarray(want.seg)[act], got.seg.numpy()[act], atol=0,
          name="seg")
    for field, atol in SEM_ATOL.items():
        close(np.asarray(getattr(want, field))[..., act],
              getattr(got, field).numpy()[..., act], atol=atol, name=field)
    # KNN near-ties of the added surfels (test_torch_fusion.py).
    ids_j = np.asarray(want.knn_idx)[:, act]
    ids_t = got.knn_idx.numpy()[:, act]
    same = np.all(ids_j == ids_t, axis=0)
    assert same.mean() > 0.99, same.mean()
    dw = np.abs(np.asarray(want.knn_w)[:, act][:, same]
                - got.knn_w.numpy()[:, act][:, same])
    assert dw.max() < 1e-2, dw.max()
    assert np.quantile(dw, 0.99) < 1e-3, np.quantile(dw, 0.99)


def test_apply_deformation_global(base):
    """The autograd path's warp: node rows, then the global row's
    translation on positions and its rotation on normals."""
    cfg, _, _, st = base
    beta = _beta(cfg, 0)
    gdq = np.array([1, 0, 0, 0, 0, 0, 0], np.float32) + \
        (1e-2 * np.random.default_rng(1).normal(size=7)).astype(np.float32)
    s_j, g_j = j_apply(cfg, st.surfels, st.graph, jnp.asarray(beta),
                       global_dq=jnp.asarray(gdq))
    ps = port_state(st)
    s_t, g_t = t_apply(port_config(cfg), ps.surfels, ps.graph,
                       torch.as_tensor(beta), global_dq=torch.as_tensor(gdq))
    # test_torch_fusion.py's tolerances, one rotation more on the normals.
    close(s_j.points, s_t.points, atol=1e-7, name="points")
    close(s_j.norms, s_t.norms, atol=1e-6, name="norms")
    close(g_j.points, g_t.points, atol=1e-7, name="node points")
    close(g_j.norms, g_t.norms, atol=1e-6, name="node norms")


def _fuse_both(cfg, intr, st, frame):
    s_j, remap_j, diag_j = jax.jit(
        lambda s, g, f: jfus.fuse_frame(cfg, intr, s, g, f))(
        st.surfels, st.graph, frame)
    ps = port_state(st)
    s_t, remap_t, diag_t = tfus.fuse_frame(port_config(cfg), port_intr(intr),
                                           ps.surfels, ps.graph,
                                           port_frame(frame))
    close(remap_j, remap_t, atol=0, name="remap")
    for name in diag_j._fields:
        close(getattr(diag_j, name), getattr(diag_t, name), atol=0, name=name)
    _compare(s_j, s_t)
    return s_j


def test_fuse_frame_semantic(base):
    cfg, intr, frames, st = base
    s, g = jax.jit(lambda s, g, b: j_apply(cfg, s, g, b))(
        st.surfels, st.graph, jnp.asarray(_beta(cfg, 1)))
    s_j = _fuse_both(cfg, intr, st._replace(surfels=s, graph=g), frames[1])
    # The merges moved class confidences and kept them distributions.
    act = np.asarray(s_j.active)
    conf = np.asarray(s_j.seg_conf)[:, act]
    np.testing.assert_allclose(conf.sum(0), 1.0, atol=1e-5)
    assert np.any(np.abs(conf - np.asarray(st.surfels.seg_conf)[:, act])
                  > 1e-3)


def test_fuse_frame_semantic_crowded(base):
    """Duplicates merged across layers blend their class confidences
    (stage 3), with both add limits and the duplicate list overflowing."""
    import dataclasses

    cfg, intr, frames, st = base
    cfg = cfg.replace(capacity=dataclasses.replace(
        cfg.capacity, new_surfel_capacity=8, dup_pixel_cap=64))
    st = _crowded(cfg, st)
    # Shuffle the copies' class confidences so the merges blend them.
    sc = np.array(st.surfels.seg_conf)
    rng = np.random.default_rng(3)
    sc = rng.dirichlet(np.ones(sc.shape[0]), sc.shape[1]).T.astype(
        np.float32)
    st = st._replace(surfels=st.surfels._replace(seg_conf=jnp.asarray(sc)))
    _fuse_both(cfg, intr, st, frames[1])


def test_prune_surfels_semantic(base):
    cfg, _, _, st = base
    rng = np.random.default_rng(4)
    ts = np.array(st.surfels.time_stamp)
    ts[rng.random(ts.shape[0]) < 0.3] = -40.0
    surfels = st.surfels._replace(time_stamp=jnp.asarray(ts))
    track_id = np.full((cfg.capacity.track_capacity,), -1, np.int32)
    track_id[:6] = np.flatnonzero(np.asarray(surfels.active))[:6]
    track = st.track._replace(track_id=jnp.asarray(track_id))
    s_j, tr_j = jfus.prune_surfels(cfg, surfels, track, jnp.float32(5.0))
    ps = port_state(st._replace(surfels=surfels, track=track))
    s_t, tr_t = tfus.prune_surfels(port_config(cfg), ps.surfels, ps.track,
                                   torch.tensor(5.0))
    close(s_j.active, s_t.active, atol=0, name="active")
    close(tr_j.track_id, tr_t.track_id, atol=0, name="track_id")
