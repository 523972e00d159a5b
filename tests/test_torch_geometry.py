"""Parity of the port's geometry, data and small ops with the JAX package.

Elementwise float32 math in the same order gives the same bits on the
CPU; where the two frameworks may fuse or reorder a sum the tolerance is a
few ULP of the values involved, stated per test.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import close, port_config, port_intr, to_np

from super_tpu.config import SuPerConfig
from super_tpu.data import synthetic as jsyn
from super_tpu.geometry import camera as jcam
from super_tpu.geometry import quaternion as jq
from super_tpu.ops import bilinear as jbil
from super_tpu.ops.knn import masked_knn as j_masked_knn
from super_tpu.ops.knn import self_knn as j_self_knn
from super_tpu.ops import morphology as jmorph
from super_tpu_torch import convert
from super_tpu_torch.data import synthetic as tsyn
from super_tpu_torch.geometry import camera as tcam
from super_tpu_torch.geometry import quaternion as tq
from super_tpu_torch.ops import bilinear as tbil
from super_tpu_torch.ops import knn as tknn
from super_tpu_torch.ops import morphology as tmorph


@pytest.mark.parametrize("variant,seed,classes", [
    ("clean", 0, 0), ("hard", 3, 2), ("clean", 1, 3)])
def test_synthetic_bit_identical(variant, seed, classes):
    h, w = 24, 32
    a = jsyn.generate(3, h, w, intr=jsyn.default_intrinsics(h, w), seed=seed,
                      num_classes=classes, variant=variant)
    b = tsyn.generate(3, h, w, intr=tsyn.default_intrinsics(h, w, "cpu"),
                      seed=seed, num_classes=classes, variant=variant)
    for name in a._fields:
        x, y = getattr(a, name), getattr(b, name)
        if x is None:
            assert y is None, name
            continue
        # Same numpy code, same seed: the arrays are identical, NaNs too.
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)


def test_quaternion_transform_and_jacobian():
    rng = np.random.default_rng(1)
    v = rng.normal(size=(50, 4, 3)).astype(np.float32)
    beta = rng.normal(size=(50, 4, 7)).astype(np.float32)
    tv_j, jac_j = jq.transform_quat_t_jac(jnp.asarray(v), jnp.asarray(beta))
    tv_t, jac_t = tq.transform_quat_t_jac(torch.as_tensor(v),
                                          torch.as_tensor(beta))
    # Same expression tree in f32; 1e-5 absorbs an FMA contraction at
    # values of order 10.
    close(tv_j, tv_t, atol=1e-5, name="tv")
    close(jac_j, jac_t, atol=1e-5, name="jac")
    close(jq.skew(jnp.asarray(v)), tq.skew(torch.as_tensor(v)), atol=0,
          name="skew")
    close(jq.transform_quat_t(jnp.asarray(v), jnp.asarray(beta[..., :4])),
          tq.transform_quat_t(torch.as_tensor(v),
                              torch.as_tensor(beta[..., :4])),
          atol=1e-5, name="rotate")
    assert tuple(tq.IDENTITY_DQ) == tuple(np.asarray(jq.IDENTITY_DQ).tolist())


def test_camera_project_and_backproject():
    h, w = 48, 64
    intr_j = jsyn.default_intrinsics(h, w)
    intr_t = port_intr(intr_j)
    rng = np.random.default_rng(2)
    pts = np.stack([rng.uniform(-0.3, 0.3, 500), rng.uniform(-0.3, 0.3, 500),
                    rng.uniform(0.2, 1.0, 500)]).astype(np.float32)
    out_j = jcam.project_points(jnp.asarray(pts), intr_j, h, w)
    out_t = tcam.project_points(torch.as_tensor(pts), intr_t, h, w)
    # Identical op order in f32: exact.
    for name, a, b in zip(("v", "u", "coords", "valid"), out_j, out_t):
        close(a, b, atol=0, name=name)
    depth = rng.uniform(0.3, 0.8, (h, w)).astype(np.float32)
    close(jcam.backproject_depth(jnp.asarray(depth), intr_j),
          tcam.backproject_depth(torch.as_tensor(depth), intr_t), atol=0,
          name="backproject")
    uu_j, vv_j = jcam.pixel_grid(h, w)
    uu_t, vv_t = tcam.pixel_grid(h, w, "cpu")
    close(uu_j, uu_t, atol=0)
    close(vv_j, vv_t, atol=0)


@pytest.mark.parametrize("kernel", [3, 5, 10])
def test_morphology(kernel):
    rng = np.random.default_rng(kernel)
    mask = rng.random((30, 40)) < 0.2
    seg = (rng.random((30, 40)) * 3).astype(np.int32)
    m_j, m_t = jnp.asarray(mask), torch.as_tensor(mask)
    close(jmorph.dilate(m_j, kernel), tmorph.dilate(m_t, kernel), atol=0)
    close(jmorph.erode(m_j, kernel), tmorph.erode(m_t, kernel), atol=0)
    close(jmorph.find_edge_region(jnp.asarray(seg), 3, kernel=kernel),
          tmorph.find_edge_region(torch.as_tensor(seg), 3, kernel=kernel),
          atol=0)


def test_knn_masked_and_self():
    rng = np.random.default_rng(3)
    q = rng.normal(size=(3, 700)).astype(np.float32)
    r = rng.normal(size=(3, 90)).astype(np.float32)
    qm = rng.random(700) < 0.9
    rm = rng.random(90) < 0.8
    d_j, i_j = j_masked_knn(jnp.asarray(q), jnp.asarray(r), 4,
                            query_mask=jnp.asarray(qm),
                            ref_mask=jnp.asarray(rm))
    d_t, i_t = tknn.masked_knn(torch.as_tensor(q), torch.as_tensor(r), 4,
                               query_mask=torch.as_tensor(qm),
                               ref_mask=torch.as_tensor(rm), chunk=256)
    # Random points have no distance ties: the same neighbours in the same
    # order.  Distances come from |q|^2 + |r|^2 - 2 q.r in f32, whose sum
    # order differs: 1e-5 at distances of order 1.
    close(i_j, i_t, atol=0, name="idx")
    close(d_j, d_t, atol=1e-5, name="dists")
    pts = rng.normal(size=(3, 60)).astype(np.float32)
    m = rng.random(60) < 0.9
    d_j, i_j = j_self_knn(jnp.asarray(pts), 4, mask=jnp.asarray(m))
    d_t, i_t = tknn.self_knn(torch.as_tensor(pts), 4, mask=torch.as_tensor(m))
    close(i_j, i_t, atol=0, name="self idx")
    close(d_j, d_t, atol=1e-5, name="self dists")


def test_bilinear_corner_bank_sampling():
    h, w = 20, 24
    rng = np.random.default_rng(4)
    intr_j = jsyn.default_intrinsics(h, w)
    intr_t = port_intr(intr_j)
    depth = rng.uniform(0.4, 0.6, (h, w)).astype(np.float32)
    pts = np.array(jcam.backproject_depth(jnp.asarray(depth), intr_j))
    pts = pts.reshape(3, -1)
    nrm = rng.normal(size=(3, h * w)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=0, keepdims=True)
    valid = rng.random(h * w) < 0.9
    index_map = np.where(valid, np.arange(h * w), -1).reshape(h, w)
    bank_j = jbil.build_corner_bank_z(jnp.asarray(pts), jnp.asarray(nrm),
                                      jnp.asarray(index_map))
    bank_t = tbil.build_corner_bank_z(torch.as_tensor(pts),
                                      torch.as_tensor(nrm),
                                      torch.as_tensor(index_map))
    close(bank_j, bank_t, atol=0, name="bank")
    v = rng.uniform(-2, h + 1, 400).astype(np.float32)
    u = rng.uniform(-2, w + 1, 400).astype(np.float32)
    out_j = jbil.bilinear_sample_bank_z_fm(bank_j, intr_j, h, w,
                                           jnp.asarray(v), jnp.asarray(u),
                                           compute_grad=True)
    out_t = tbil.bilinear_sample_bank_z_fm(bank_t, intr_t, h, w,
                                           torch.as_tensor(v),
                                           torch.as_tensor(u),
                                           compute_grad=True)
    ok = np.asarray(out_j[2])
    close(out_j[2], out_t[2], atol=0, name="ok")
    assert ok.sum() > 100
    # Same weights and corner sums in the same order; values compared at
    # the valid queries (the only ones any caller reads).
    for name, a, b in zip(("o", "n", "go_u", "go_v", "gn_u", "gn_v"),
                          out_j[:2] + out_j[3:], out_t[:2] + out_t[3:]):
        close(np.asarray(a)[:, ok], b.numpy()[:, ok], atol=1e-6, name=name)


def test_config_and_state_conversion():
    cfg = SuPerConfig(height=48, width=64, mesh_step_size=8,
                      del_seg_classes=(1, 2))
    pcfg = port_config(cfg)
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(cfg)
    intr = port_intr(jsyn.default_intrinsics(48, 64))
    assert intr.fx.dtype == torch.float32 and intr.fx.device.type == "cpu"
    rng = np.random.default_rng(5)
    frame = dict(points=rng.normal(size=(3, 12)), norms=np.zeros((3, 12)),
                 colors=np.ones((3, 12), np.float32), radii=np.ones(12),
                 confs=np.ones(12), valid=rng.random(12) < 0.5,
                 seg=np.arange(12, dtype=np.int64),
                 seg_conf=np.zeros((3, 12)), dist2edge=np.zeros(12),
                 time=np.float64(2.0), color_image=np.zeros((3, 3, 4)))
    f = convert.frame_from_numpy(frame, device="cpu")
    assert f.points.dtype == torch.float32 and f.seg.dtype == torch.int32
    assert f.valid.dtype == torch.bool
    back = convert.to_numpy(f)
    np.testing.assert_array_equal(back.valid, frame["valid"])
    np.testing.assert_allclose(back.points, frame["points"].astype(np.float32))
    assert to_np(jnp.zeros(2)).shape == (2,)


def test_state_helpers():
    """empty_* states, gather_rows and scatter_set_rows (with its gate and
    dropped out-of-range ids), disp_to_depth and the row-major z-bank
    sampler against the JAX package."""
    from super_tpu.core import preprocess as jpre
    from super_tpu.core import state as jst
    from super_tpu_torch.core import preprocess as tpre
    from super_tpu_torch.core import state as tst

    cfg = SuPerConfig(height=8, width=8)
    cfg = dataclasses.replace(cfg, capacity=dataclasses.replace(
        cfg.capacity, surfel_capacity=64, node_capacity=16,
        edge_capacity=32, triangle_capacity=24, track_capacity=5))
    pcfg = port_config(cfg)
    for name in ("empty_surfels", "empty_graph", "empty_track"):
        want = getattr(jst, name)(cfg)
        got = getattr(tst, name)(pcfg, "cpu")
        for field in want._fields:
            a, b = np.asarray(getattr(want, field)), getattr(got, field)
            assert a.dtype == b.numpy().dtype, (name, field)
            close(a, b, atol=0, name=f"{name}.{field}")
    rng = np.random.default_rng(6)
    arr = rng.normal(size=(3, 20)).astype(np.float32)
    idx = np.array([[0, 5, 19], [25, 7, 2]], np.int32)   # 25: dropped
    vals = rng.normal(size=(3, 2, 3)).astype(np.float32)
    do = np.array([[True, False, True], [True, True, False]])
    close(jst.gather_rows(jnp.asarray(arr), jnp.asarray(idx[:, :2] % 20)),
          tst.gather_rows(torch.as_tensor(arr),
                          torch.as_tensor(idx[:, :2] % 20)), atol=0)
    close(jst.scatter_set_rows(jnp.asarray(arr), jnp.asarray(idx),
                               jnp.asarray(vals), jnp.asarray(do)),
          tst.scatter_set_rows(torch.as_tensor(arr), torch.as_tensor(idx),
                               torch.as_tensor(vals), torch.as_tensor(do)),
          atol=0, name="scatter_set_rows")
    disp = rng.random((4, 5)).astype(np.float32)
    for a, b in zip(jpre.disp_to_depth(jnp.asarray(disp), 0.1, 80.0),
                    tpre.disp_to_depth(torch.as_tensor(disp), 0.1, 80.0)):
        close(a, b, atol=0, rtol=1e-6)
    h, w = 6, 7
    intr_j = jsyn.default_intrinsics(h, w)
    bank = rng.normal(size=(16, h * w)).astype(np.float32)
    v = rng.uniform(0, h - 1, 30).astype(np.float32)
    u = rng.uniform(0, w - 1, 30).astype(np.float32)
    out_j = jbil.bilinear_sample_bank_z(jnp.asarray(bank), intr_j, h, w,
                                        jnp.asarray(v), jnp.asarray(u),
                                        compute_grad=True)
    out_t = tbil.bilinear_sample_bank_z(torch.as_tensor(bank),
                                        port_intr(intr_j), h, w,
                                        torch.as_tensor(v),
                                        torch.as_tensor(u),
                                        compute_grad=True)
    for a, b in zip(out_j, out_t):
        close(a, b, atol=1e-5)
