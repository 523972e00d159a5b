"""Parity of the port's frame preprocessing and frame-0 initialisation
(preprocess_frame, build_graph, update_graph_knn, init_tracker) with the
JAX package on tiny_scene frames."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import close, port_config, port_frame, port_intr, scene, \
    slice_config

from super_tpu.core.preprocess import preprocess_frame as j_preprocess
from super_tpu.core.tracker import init_tracker as j_init
from super_tpu_torch.core.preprocess import preprocess_frame as t_preprocess
from super_tpu_torch.core.tracker import init_tracker as t_init

# Per-field tolerance of preprocess_frame.  Points and radii are single
# products/quotients in the same order (exact but for an FMA); normals are
# normalised sums of 7 cross products, whose f32 sum order may differ
# between the frameworks: 1e-5 on unit vectors (a few hundred ULP of a
# difference of nearly equal products).  Masks and labels are exact.
ATOL = dict(points=1e-6, norms=1e-5, radii=1e-7, confs=1e-6)


@pytest.fixture(scope="module")
def ref():
    cfg = slice_config()
    intr, seq, frames = scene(2, cfg)
    return cfg, intr, seq, frames


def _port_preprocess(cfg, intr, depth, color, t, **kw):
    return t_preprocess(port_config(cfg), port_intr(intr), depth, color, t,
                        device="cpu", **kw)


@pytest.mark.parametrize("field", ["points", "norms", "colors", "radii",
                                   "confs", "valid", "seg", "seg_conf",
                                   "dist2edge", "time", "color_image"])
def test_preprocess_frame_field(ref, field):
    cfg, intr, seq, frames = ref
    color = np.ascontiguousarray(seq.colors[1].transpose(2, 0, 1))
    got = _port_preprocess(cfg, intr, seq.depths[1], color, 1.0)
    close(getattr(frames[1], field), getattr(got, field),
          atol=ATOL.get(field, 0.0), name=field)


@pytest.mark.parametrize("normal_model", ["naive", "8neighbors"])
def test_preprocess_with_segmentation(ref, normal_model):
    """Labels, class scores and the chamfer dist2edge, with both normal
    models; the labels mark a diagonal band whose edges the DT measures."""
    cfg, intr, seq, _ = ref
    cfg = cfg.replace(normal_model=normal_model, num_classes=3,
                      del_seg_classes=(2,))
    h, w = cfg.height, cfg.width
    yy, xx = np.mgrid[0:h, 0:w]
    seg = ((xx + yy) // 20 % 3).astype(np.int32)
    rng = np.random.default_rng(0)
    seg_conf = rng.normal(size=(3, h, w)).astype(np.float32)
    color = np.ascontiguousarray(seq.colors[0].transpose(2, 0, 1))
    want = j_preprocess(cfg, intr, jnp.asarray(seq.depths[0]),
                        jnp.asarray(color), jnp.float32(0.0),
                        seg=jnp.asarray(seg), seg_conf=jnp.asarray(seg_conf))
    got = _port_preprocess(cfg, intr, seq.depths[0], color, 0.0, seg=seg,
                           seg_conf=seg_conf)
    for field in want._fields:
        # seg_conf is a softmax over 3 scores (exp/sum order): 1e-6;
        # dist2edge sums chamfer steps of 1/w, 1/h in one order: exact.
        close(getattr(want, field), getattr(got, field),
              atol=dict(ATOL, seg_conf=1e-6).get(field, 0.0), name=field)


@pytest.fixture(scope="module")
def init_pair(ref):
    cfg, intr, _, frames = ref
    return j_init(cfg, frames[0]), t_init(port_config(cfg),
                                          port_frame(frames[0]))


def test_init_tracker_graph(init_pair):
    want, got = init_pair
    g_j, g_t = want.graph, got.graph
    # Node attributes are gathered from the same frame: exact.  Rest
    # lengths and radii are sums of at most 6 edge lengths: 1e-7 m.
    for field in ("points", "norms", "active", "edges", "edge_active",
                  "triangles", "tri_active", "seg", "seg_conf"):
        close(getattr(g_j, field), getattr(g_t, field), atol=0, name=field)
    for field in ("radii", "edge_lens", "tri_areas"):
        close(getattr(g_j, field), getattr(g_t, field), atol=1e-7, name=field)
    # topk may order equal distances differently: compare the neighbour
    # sets sorted by id, with their weights carried along.
    act = np.asarray(g_j.active)
    ij = np.asarray(g_j.knn_idx)[act]
    it = g_t.knn_idx.numpy()[act]
    oj, ot = np.argsort(ij, axis=1), np.argsort(it, axis=1)
    np.testing.assert_array_equal(np.take_along_axis(ij, oj, 1),
                                  np.take_along_axis(it, ot, 1))
    # Weights are softmax(exp(-d/r)).  Both packages take d from
    # |q|^2 + |r|^2 - 2 q.r in f32: at |q|^2 ~ 0.3 m^2 and node spacing
    # ~9 mm the cancellation leaves ~1e-4 relative error in d, whose
    # rounding differs between the two products: rtol 1e-3.
    np.testing.assert_allclose(
        np.take_along_axis(g_t.knn_w.numpy()[act], ot, 1),
        np.take_along_axis(np.asarray(g_j.knn_w)[act], oj, 1), rtol=1e-3)


def test_init_tracker_surfels(init_pair):
    want, got = init_pair
    s_j, s_t = want.surfels, got.surfels
    for field in ("points", "norms", "colors", "radii", "confs",
                  "time_stamp", "active", "proj_uv", "seg", "seg_conf",
                  "dist2edge"):
        close(getattr(s_j, field), getattr(s_t, field), atol=0, name=field)
    # Anchors are canonicalised to ascending node id in both packages, so
    # the sorted ids agree unless two nodes lie at nearly the same
    # distance: the f32 cancellation in |q|^2 + |r|^2 - 2 q.r (~1e-4
    # relative in d) then lets the two products pick different nodes.
    # That happens for ~0.2% of the surfels here (ROADMAP queue 3); hold
    # it under 1%.
    act = np.asarray(s_j.active)
    assert act.sum() > 2000
    np.testing.assert_array_equal(act, s_t.active.numpy())
    ids_j = np.sort(np.asarray(s_j.knn_idx)[:, act], 0)
    ids_t = np.sort(s_t.knn_idx.numpy()[:, act], 0)
    same = np.all(ids_j == ids_t, axis=0)
    assert same.mean() > 0.99, same.mean()
    # Weights of the surfels whose anchors agree.  The same cancellation
    # leaves an absolute error of ~2 ULP of |q|^2 in d^2: for a surfel
    # sitting on a node (d ~ 0) that is up to ~2.5e-4 m in d, 3% of the
    # 9 mm node radius, or up to ~1e-2 in a weight.  Most surfels are far
    # from that case: 99% of the weights agree to 1e-3, half to 1e-5.
    dw = np.abs(s_t.knn_w.numpy()[:, act][:, same]
                - np.asarray(s_j.knn_w)[:, act][:, same])
    assert dw.max() < 1e-2, dw.max()
    assert np.quantile(dw, 0.99) < 1e-3, np.quantile(dw, 0.99)
    assert np.median(dw) < 1e-5, np.median(dw)
    close(want.track.track_id, got.track.track_id, atol=0)
    assert dataclasses.is_dataclass(port_config(slice_config()))
