"""Motors: driven rotational / linear constraints.

Counterpart of ``chrono_tpu/physics/motors.py`` (the reference's
``ChLinkMotorRotation{Speed,Angle}``, ``ChLinkMotorLinear{Speed,Position}``
and the torque/force variants).  Constraint motors add ONE velocity-level
row along the joint-frame z axis whose rhs is the motor set-point; the
guiding joint is added separately by the builder.  Torque/force motors apply
a pure load instead.  The profile is any ``core.functions`` MotionFunction.
"""

from __future__ import annotations

import math

import torch
from torch import Tensor

from chrono_tpu_torch.core import quaternion as Q
from chrono_tpu_torch.physics.constraints import ConstraintRows
from chrono_tpu_torch.physics.joints import _unit_z
from chrono_tpu_torch.utils.tree import tensor_dataclass


@tensor_dataclass
class MotorData:
    """Batched parameters of M motors of one kind (kind is the dict key in
    Model)."""

    body_a: Tensor  # (M,) int32  — the driven body
    body_b: Tensor  # (M,) int32  — the reference body
    fa_pos: Tensor  # (M, 3)
    fa_rot: Tensor  # (M, 4)
    fb_pos: Tensor  # (M, 3)
    fb_rot: Tensor  # (M, 4)
    profile: object  # MotionFunction at sim time (stacked parameters)

    @property
    def n(self) -> int:
        return self.body_a.shape[0]


def _axis_world(q, f_rot):
    return Q.qrotate(Q.qmul(q, f_rot), _unit_z(q))


def relative_angle_about_axis(x_a, q_a, x_b, q_b, fa_rot, fb_rot) -> Tensor:
    """Rotation of frame b relative to frame a about their common z axis
    (wrapped)."""
    Ra = Q.q_to_matrix(Q.qmul(q_a, fa_rot))
    xb_w = Q.q_to_matrix(Q.qmul(q_b, fb_rot))[..., :, 0]
    # project b's x axis into a's (x,y) plane
    return torch.atan2(
        torch.sum(Ra[..., :, 1] * xb_w, dim=-1),
        torch.sum(Ra[..., :, 0] * xb_w, dim=-1),
    )


def relative_displacement_along_axis(x_a, q_a, x_b, q_b, fa_pos, fa_rot,
                                     fb_pos):
    pa = x_a + Q.qrotate(q_a, fa_pos)
    pb = x_b + Q.qrotate(q_b, fb_pos)
    za = _axis_world(q_a, fa_rot)
    return torch.sum(za * (pb - pa), dim=-1)


def _per_motor(v, M, like):
    return torch.broadcast_to(
        torch.as_tensor(v, dtype=like.dtype, device=like.device), (M,))


def motor_rows(kind: str, data: MotorData, state_x, state_q, t, h,
               stab_factor=1.0, vel_scale=1.0) -> ConstraintRows:
    """Lower one motor kind to constraint rows.

    Kinds: ``rot_speed`` | ``rot_angle`` | ``lin_speed`` | ``lin_pos``.
    Row convention: positive γ drives body b forward relative to body a.
    ``vel_scale=0`` with ``h=1, stab_factor=1`` yields pure position-error
    rows (rhs = −err) for post-step position projection.
    """
    a, b = data.body_a, data.body_b
    x_a, q_a = state_x[a], state_q[a]
    x_b, q_b = state_x[b], state_q[b]
    za = _axis_world(q_a, data.fa_rot)  # (M, 3) world axis
    M = data.n

    if kind in ("rot_speed", "rot_angle"):
        # row: za·(ω_w_b - ω_w_a) = rhs;  ω_w = R(q) w_local
        Ja_w = -Q.qrotate_inv(q_a, za)
        Jb_w = Q.qrotate_inv(q_b, za)
        Ja_v = torch.zeros_like(za)
        Jb_v = torch.zeros_like(za)
        if kind == "rot_speed":
            rhs = vel_scale * _per_motor(data.profile.value(t), M, state_x)
        else:
            angle = relative_angle_about_axis(
                x_a, q_a, x_b, q_b, data.fa_rot, data.fb_rot)
            target = torch.as_tensor(data.profile.value(t),
                                     dtype=state_x.dtype)
            target_v = _per_motor(data.profile.deriv(t), M, state_x)
            # wrap error to (-pi, pi] so angle targets work across branch
            # cuts
            err = torch.remainder(angle - target + math.pi,
                                  2 * math.pi) - math.pi
            rhs = vel_scale * target_v - (stab_factor / h) * err
    elif kind in ("lin_speed", "lin_pos"):
        # row: za·(v_pb - v_pa) = rhs  with attachment-point velocities
        ra = Q.qrotate(q_a, data.fa_pos)  # world lever arms
        rb = Q.qrotate(q_b, data.fb_pos)
        Ja_v = -za
        Jb_v = za
        Ja_w = -Q.qrotate_inv(q_a, torch.linalg.cross(ra, za, dim=-1))
        Jb_w = Q.qrotate_inv(q_b, torch.linalg.cross(rb, za, dim=-1))
        if kind == "lin_speed":
            rhs = vel_scale * _per_motor(data.profile.value(t), M, state_x)
        else:
            disp = relative_displacement_along_axis(
                x_a, q_a, x_b, q_b, data.fa_pos, data.fa_rot, data.fb_pos)
            target = torch.as_tensor(data.profile.value(t),
                                     dtype=state_x.dtype)
            target_v = _per_motor(data.profile.deriv(t), M, state_x)
            rhs = vel_scale * target_v - (stab_factor / h) * (disp - target)
    else:
        raise ValueError(f"unknown motor kind {kind!r}")

    return ConstraintRows.two_body(
        body_a=a, body_b=b,
        Ja_v=Ja_v, Ja_w=Ja_w, Jb_v=Jb_v, Jb_w=Jb_w,
        rhs=rhs, active=torch.ones((M,), dtype=torch.bool,
                                   device=state_x.device),
    )


def motor_loads(kind: str, data: MotorData, state_x, state_q, t):
    """Torque/force motors: per-motor world-frame loads.

    Kinds: ``rot_torque`` (applies ±τ·axis) | ``lin_force`` (applies ±F·axis).
    Returns (force_a, torque_a, force_b, torque_b) each (M, 3) world frame.
    """
    za = _axis_world(state_q[data.body_a], data.fa_rot)
    val = _per_motor(data.profile.value(t), data.n, state_x)[:, None]
    zero = torch.zeros_like(za)
    if kind == "rot_torque":
        return zero, -val * za, zero, val * za
    if kind == "lin_force":
        return -val * za, zero, val * za, zero
    raise ValueError(f"unknown motor load kind {kind!r}")
