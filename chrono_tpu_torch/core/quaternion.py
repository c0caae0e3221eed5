"""Quaternion algebra for rigid-body rotations (scalar-first ``(w, x, y, z)``).

Counterpart of ``chrono_tpu/core/quaternion.py``: every function broadcasts
over leading axes, so a whole body population rotates in one batched op.

Conventions:
  * unit quaternion ``q`` maps body-local vectors to world: ``v_w = R(q) v_l``.
  * angular velocity is kept in the *body-local* frame throughout, so
    ``q_dot = 0.5 * q ⊗ (0, ω_l)``.

No function here builds a tensor from host data: each constant comes from
its inputs' device, so the step that calls them can be captured in a CUDA
graph.
"""

from __future__ import annotations

import torch
from torch import Tensor


def _cross(a: Tensor, b: Tensor) -> Tensor:
    """Cross product over the last axis, broadcasting the leading ones."""
    return torch.linalg.cross(*torch.broadcast_tensors(a, b), dim=-1)


def qidentity(shape=(), dtype=torch.float32, device=None) -> Tensor:
    """Identity quaternion(s) of batch shape ``shape`` → ``shape + (4,)``."""
    q = torch.zeros(tuple(shape) + (4,), dtype=dtype, device=device)
    q[..., 0].fill_(1.0)
    return q


def qmul(a: Tensor, b: Tensor) -> Tensor:
    """Hamilton product ``a ⊗ b`` (broadcasts over leading axes)."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def qconj(q: Tensor) -> Tensor:
    """Conjugate (= inverse for unit quaternions)."""
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def qnormalize(q: Tensor, eps: float = 1e-12) -> Tensor:
    n = torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True))
    return q / torch.clamp_min(n, eps)


def qrotate(q: Tensor, v: Tensor) -> Tensor:
    """Rotate vector(s) ``v`` by unit quaternion(s) ``q``: local → world
    (the 2-cross-product form)."""
    u = q[..., 1:]
    w = q[..., 0:1]
    t = 2.0 * _cross(u, v)
    return v + w * t + _cross(u, t)


def qrotate_inv(q: Tensor, v: Tensor) -> Tensor:
    """Rotate by the inverse: world → local."""
    return qrotate(qconj(q), v)


def q_to_matrix(q: Tensor) -> Tensor:
    """Unit quaternion → 3×3 rotation matrix (batched: ``(..., 3, 3)``)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def q_from_matrix(m: Tensor) -> Tensor:
    """3×3 rotation matrix → unit quaternion (batched, branch-free Shepperd)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    # four candidate 4·q·q_k formulations; pick the numerically largest pivot
    qw = torch.stack([1 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1 + m00 - m11 - m22, m01 + m10, m02 + m20],
                     dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1 - m00 + m11 - m22, m12 + m21],
                     dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1 - m00 - m11 + m22],
                     dim=-1)
    pivots = torch.stack([1 + tr, 1 + m00 - m11 - m22, 1 - m00 + m11 - m22,
                          1 - m00 - m11 + m22], dim=-1)
    case = torch.argmax(pivots, dim=-1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)  # (..., 4 cases, 4 comps)
    idx = case[..., None, None].expand(case.shape + (1, 4))
    return qnormalize(torch.gather(cands, -2, idx)[..., 0, :])


def q_from_axis_angle(axis: Tensor, angle) -> Tensor:
    """Unit quaternion from (unit) axis and angle (radians); broadcasts."""
    half = 0.5 * torch.as_tensor(angle, dtype=axis.dtype, device=axis.device)
    s = torch.sin(half)
    return torch.cat([torch.cos(half)[..., None], axis * s[..., None]],
                     dim=-1)


def q_from_euler_xyz(rpy: Tensor) -> Tensor:
    """Intrinsic X-Y-Z (roll, pitch, yaw) Euler angles → quaternion."""
    r, p, y = rpy[..., 0] * 0.5, rpy[..., 1] * 0.5, rpy[..., 2] * 0.5
    cr, sr = torch.cos(r), torch.sin(r)
    cp, sp = torch.cos(p), torch.sin(p)
    cy, sy = torch.cos(y), torch.sin(y)
    return torch.stack(
        [
            cr * cp * cy - sr * sp * sy,
            sr * cp * cy + cr * sp * sy,
            cr * sp * cy - sr * cp * sy,
            cr * cp * sy + sr * sp * cy,
        ],
        dim=-1,
    )


def qexp_half(w: Tensor, eps: float = 1e-12) -> Tensor:
    """Exponential map: rotation vector ``w`` (angle·axis) → exp([0, w/2]).

    Stable at ``|w| → 0``: the exact branch sees a sanitised angle² (the
    double-where pattern) and the small branch is a polynomial in angle², so
    every derivative order stays finite.
    """
    angle2 = torch.sum(w * w, dim=-1, keepdim=True)
    small = angle2 < 1e-12
    angle2_safe = torch.where(small, torch.ones_like(angle2), angle2)
    angle = torch.sqrt(angle2_safe)
    half = 0.5 * angle
    cos_half = torch.where(small, 1.0 - angle2 / 8.0
                           + angle2 * angle2 / 384.0, torch.cos(half))
    sinc = torch.where(small, 0.5 - angle2 / 48.0, torch.sin(half) / angle)
    return torch.cat([cos_half, w * sinc], dim=-1)


def qlog2(q: Tensor, eps: float = 1e-12) -> Tensor:
    """Inverse of :func:`qexp_half`: unit quaternion → rotation vector."""
    w = q[..., 0:1]
    v = q[..., 1:]
    n = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
    angle = 2.0 * torch.atan2(n, w)
    scale = torch.where(n < 1e-6, 2.0 / torch.clamp_min(w, eps),
                        angle / torch.clamp_min(n, eps))
    return v * scale


def qdot_from_local_omega(q: Tensor, w_local: Tensor) -> Tensor:
    """Kinematic equation ``q̇ = ½ q ⊗ (0, ω_local)``."""
    zero = torch.zeros_like(w_local[..., :1])
    return 0.5 * qmul(q, torch.cat([zero, w_local], dim=-1))


def integrate_quat(q: Tensor, w_local: Tensor, h) -> Tensor:
    """Geometric orientation update on SO(3): ``q ⊗ exp(½ h ω_l)``,
    renormalised."""
    return qnormalize(qmul(q, qexp_half(w_local * h)))
