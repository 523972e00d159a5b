"""Quaternion warp-field math (counterpart of
super_tpu/geometry/quaternion.py).

Each ED node carries ``[qw, qx, qy, qz, tx, ty, tz]``; the rotation keeps the
reference's non-unit formula ``R(q)v = v + 2 qw (qv x v) + 2 qv x (qv x v)``.
"""

from __future__ import annotations

import torch

# Identity parameter [1,0,0,0, 0,0,0] (a tuple: tensors are made per device).
IDENTITY_DQ = (1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0)


def identity_dq(device, dtype=torch.float32):
    return torch.tensor(IDENTITY_DQ, dtype=dtype, device=device)


def cross(a, b):
    """Cross product over the last axis, written out (no broadcasting rules
    of ``torch.linalg.cross`` to think about)."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def skew(v):
    """``[v]x`` with ``[v]x @ u == cross(v, u)``: (..., 3) -> (..., 3, 3)."""
    a1, a2, a3 = v[..., 0], v[..., 1], v[..., 2]
    z = torch.zeros_like(a1)
    return torch.stack([
        torch.stack([z, -a3, a2], dim=-1),
        torch.stack([a3, z, -a1], dim=-1),
        torch.stack([-a2, a1, z], dim=-1),
    ], dim=-2)


def quat_rotate(q, v):
    """Rotate ``v`` (..., 3) by the possibly non-unit ``q`` (..., 4)."""
    qw = q[..., 0:1]
    qv = q[..., 1:4]
    c = cross(qv, v)
    return v + 2.0 * qw * c + 2.0 * cross(qv, c)


def transform_quat_t(v, beta):
    """``T(q, b) v = R(q) v + b``; beta (..., 7), or (..., 4) for q only."""
    tv = quat_rotate(beta[..., 0:4], v)
    if beta.shape[-1] == 7:
        tv = tv + beta[..., 4:7]
    return tv


def transform_quat_t_jac(v, beta, skew_v=None):
    """``T(q,b) v`` with the analytic Jacobian d(tv)/dq, (..., 3, 4)."""
    qw = beta[..., 0:1]
    qv = beta[..., 1:4]
    c = cross(qv, v)
    tv = v + 2.0 * qw * c + 2.0 * cross(qv, c)
    if beta.shape[-1] == 7:
        tv = tv + beta[..., 4:7]
    if skew_v is None:
        skew_v = skew(v)
    eye3 = torch.eye(3, dtype=v.dtype, device=v.device)
    d_qw = 2.0 * c[..., :, None]
    qv_dot_v = torch.sum(qv * v, dim=-1)[..., None, None]
    outer = qv[..., :, None] * v[..., None, :]
    d_qv = 2.0 * (qv_dot_v * eye3 + outer - 2.0 * outer.transpose(-1, -2)
                  - qw[..., :, None] * skew_v)
    return tv, torch.cat([d_qw, d_qv], dim=-1)


def blend_warp(d_points, anchors, beta, w):
    """Warp each point by its K anchor transforms: (N, 3) warped points
    ``sum_i w_i [T(q_i, b_i)(p - g_i) + g_i]`` from displacements and
    anchors (N, K, 3), gathered transforms (N, K, 7) and weights (N, K)."""
    tv = transform_quat_t(d_points, beta) + anchors
    return torch.sum(w[..., None] * tv, dim=-2)


def blend_warp_jac(d_points, anchors, beta, w, skew_v=None):
    """:func:`blend_warp` and the weighted per-anchor Jacobian
    ``w_i d(T_i v)/dq_i``, (N, K, 3, 4)."""
    tv, jac = transform_quat_t_jac(d_points, beta, skew_v=skew_v)
    warped = torch.sum(w[..., None] * (tv + anchors), dim=-2)
    return warped, w[..., None, None] * jac


def quat_to_matrix(q):
    """Quaternion (..., 4) [w, x, y, z] -> rotation matrix (..., 3, 3),
    normalised by |q|^2 (zero where q is zero)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    n = w * w + x * x + y * y + z * z
    s = torch.where(n > 0, 2.0 / n, 0.0)
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return torch.stack([
        torch.stack([1.0 - (yy + zz), xy - wz, xz + wy], dim=-1),
        torch.stack([xy + wz, 1.0 - (xx + zz), yz - wx], dim=-1),
        torch.stack([xz - wy, yz + wx, 1.0 - (xx + yy)], dim=-1),
    ], dim=-2)


def matrix_to_quat(m):
    """Rotation matrix (..., 3, 3) -> unit quaternion (..., 4) [w, x, y, z]
    with w >= 0: Shepperd's four cases, all computed and one selected per
    matrix (no branch on values)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=1e-24))

    sw = safe_sqrt(1.0 + tr) * 2.0
    sx = safe_sqrt(1.0 + m00 - m11 - m22) * 2.0
    sy = safe_sqrt(1.0 - m00 + m11 - m22) * 2.0
    sz = safe_sqrt(1.0 - m00 - m11 + m22) * 2.0
    cases = (  # [w, x, y, z] when w, x, y or z is the largest
        (0.25 * sw, (m21 - m12) / sw, (m02 - m20) / sw, (m10 - m01) / sw),
        ((m21 - m12) / sx, 0.25 * sx, (m01 + m10) / sx, (m02 + m20) / sx),
        ((m02 - m20) / sy, (m01 + m10) / sy, 0.25 * sy, (m12 + m21) / sy),
        ((m10 - m01) / sz, (m02 + m20) / sz, (m12 + m21) / sz, 0.25 * sz))
    cond_w = tr > 0
    cond_x = ~cond_w & (m00 >= m11) & (m00 >= m22)
    cond_y = ~cond_w & ~cond_x & (m11 >= m22)
    q = torch.stack([
        torch.where(cond_w, a, torch.where(cond_x, b, torch.where(cond_y, c,
                                                                  d)))
        for a, b, c, d in zip(*cases)], dim=-1)
    return q * torch.where(q[..., 0:1] < 0, -1.0, 1.0)


def merge_transformation(dq1, dq2):
    """Compose two [q; t] transforms (..., 7), dq1 first: R = R2 R1,
    t = t2 + R2 t1."""
    r1 = quat_to_matrix(dq1[..., 0:4])
    r2 = quat_to_matrix(dq2[..., 0:4])
    t = dq2[..., 4:7] + torch.einsum("...ij,...j->...i", r2, dq1[..., 4:7])
    return torch.cat([matrix_to_quat(r2 @ r1), t], dim=-1)
