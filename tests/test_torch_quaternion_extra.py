"""The port's geometry leftovers against the JAX package:
``blend_warp_jac``, ``quat_to_matrix``, ``matrix_to_quat`` (every one of
Shepperd's four cases), ``merge_transformation`` and
``ops/knn.py:class_masked_knn``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import close

from super_tpu.geometry import quaternion as jq
from super_tpu.ops.knn import class_masked_knn as j_class_knn
from super_tpu_torch.geometry import quaternion as tq
from super_tpu_torch.ops import knn as tknn


def _quats(rng, n, unit=True):
    q = rng.normal(size=(n, 4))
    if unit:
        q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return q.astype(np.float32)


def _both(fn_j, fn_t, *arrays):
    return (fn_j(*(jnp.asarray(a) for a in arrays)),
            fn_t(*(torch.as_tensor(a) for a in arrays)))


def test_blend_warp_jac():
    """Warped points and the weighted (N, K, 3, 4) Jacobian; the same f32
    formula, its products and sums rounded in other orders: 1e-6 of the
    largest value."""
    rng = np.random.default_rng(0)
    n, k = 64, 4
    pts = rng.normal(size=(n, 1, 3))
    anchors = rng.normal(size=(n, k, 3))
    beta = np.concatenate([_quats(rng, n * k, unit=False).reshape(n, k, 4),
                           rng.normal(size=(n, k, 3))], -1)
    w = rng.dirichlet(np.ones(k), size=n)
    args = [np.asarray(a, np.float32) for a in (pts - anchors, anchors, beta,
                                                w)]
    (wj, jj), (wt, jt) = _both(jq.blend_warp_jac, tq.blend_warp_jac, *args)
    close(wj, wt, atol=1e-6 * float(np.abs(wj).max()), name="warped")
    close(jj, jt, atol=1e-6 * float(np.abs(jj).max()), name="jac")
    close(wt, tq.blend_warp(*(torch.as_tensor(a) for a in args)), atol=0,
          name="warped vs blend_warp")


@pytest.mark.parametrize("unit", [True, False])
def test_quat_to_matrix(unit):
    """Rotation matrices of unit and non-unit quaternions (normalised by
    |q|^2) and of q = 0 (zero scale): f32, 1e-6."""
    q = _quats(np.random.default_rng(1), 200, unit=unit)
    q[0] = 0.0
    mj, mt = _both(jq.quat_to_matrix, tq.quat_to_matrix, q)
    close(mj, mt, atol=1e-6, name="matrix")


def test_matrix_to_quat_cases():
    """Matrices whose largest of (trace, m00, m11, m22) is each of the four
    in turn, and the rotations by pi about each axis (trace -1): the same
    quaternion as the JAX package's (1e-6), with w >= 0, and back to the
    matrix."""
    rng = np.random.default_rng(2)
    q = _quats(rng, 400)
    # Quaternions dominated by each component pick each of the cases.
    for c in range(4):
        q[100 * c:100 * c + 50, c] += 4.0 * np.sign(q[100 * c:100 * c + 50,
                                                      c])
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    q[:4] = np.eye(4, dtype=np.float32)
    m = np.asarray(jq.quat_to_matrix(jnp.asarray(q)))
    (qj, qt) = _both(jq.matrix_to_quat, tq.matrix_to_quat, m)
    close(qj, qt, atol=1e-6, name="quat")
    assert bool((qt[:, 0] >= 0).all())
    tr = np.trace(m, axis1=-2, axis2=-1)
    d = np.diagonal(m, axis1=-2, axis2=-1)
    case = np.where(tr > 0, 0, 1 + np.argmax(d, axis=-1))
    assert set(case.tolist()) == {0, 1, 2, 3}
    close(m, tq.quat_to_matrix(qt), atol=2e-6, name="round trip")


def test_merge_transformation():
    """Two [q; t] composed: the JAX package's result within 1e-5, and
    T(merged) v = T2(T1 v) within 1e-5."""
    rng = np.random.default_rng(3)
    n = 50
    dq1 = np.concatenate([_quats(rng, n), rng.normal(size=(n, 3))], -1)
    dq2 = np.concatenate([_quats(rng, n), rng.normal(size=(n, 3))], -1)
    dq1, dq2 = dq1.astype(np.float32), dq2.astype(np.float32)
    mj, mt = _both(jq.merge_transformation, tq.merge_transformation, dq1, dq2)
    close(mj, mt, atol=1e-5, name="merged")
    v = torch.as_tensor(rng.normal(size=(n, 3)).astype(np.float32))
    seq = tq.transform_quat_t(tq.transform_quat_t(v, torch.as_tensor(dq1)),
                              torch.as_tensor(dq2))
    close(seq, tq.transform_quat_t(v, mt), atol=1e-5, name="composition")


def test_class_masked_knn():
    """Neighbours of the query's own class among the valid refs: random
    points (no ties), so the same ids in the same order, distances within
    the f32 cancellation of test_torch_geometry.py (1e-5); a query whose
    class has fewer valid refs than k keeps its k eligible ones first."""
    rng = np.random.default_rng(4)
    q = rng.normal(size=(3, 500)).astype(np.float32)
    r = rng.normal(size=(3, 80)).astype(np.float32)
    qs = rng.integers(0, 3, 500).astype(np.int32)
    rs = rng.integers(0, 3, 80).astype(np.int32)
    rs[:3] = 3                                   # class 3: three refs
    qs[:5] = 3
    qm = rng.random(500) < 0.9
    rm = rng.random(80) < 0.85
    rm[:3] = True
    d_j, i_j = j_class_knn(jnp.asarray(q), jnp.asarray(r), 4,
                           jnp.asarray(qs), jnp.asarray(rs),
                           query_mask=jnp.asarray(qm),
                           ref_mask=jnp.asarray(rm))
    d_t, i_t = tknn.class_masked_knn(
        torch.as_tensor(q), torch.as_tensor(r), 4, torch.as_tensor(qs),
        torch.as_tensor(rs), query_mask=torch.as_tensor(qm),
        ref_mask=torch.as_tensor(rm))
    fin = np.isfinite(np.asarray(d_j))
    close(np.asarray(i_j)[fin], i_t.numpy()[fin], atol=0, name="idx")
    close(d_j, d_t, atol=1e-5, name="dists")
    same = rs[i_t.numpy()] == qs[None, :]
    assert bool(np.all(same[fin] & rm[i_t.numpy()][fin]))
    assert np.isinf(np.asarray(d_j)[3, :5][qm[:5]]).all()
