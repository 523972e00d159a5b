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
