"""Joint (bilateral constraint) library.

Counterpart of ``chrono_tpu/physics/joints.py``: each joint type is a
position-level gap function, batched over leading axes (a joint's equations
on the last axis); exact velocity Jacobians come from forward-mode autodiff
(``constraints.lower_gap_function``).  Joints of one type are stored as
batched tensors and lowered in one batched pass.

Conventions: each joint stores a *joint frame* on each body, expressed in
that body's local coordinates.  The joint's functional axis is the frame's
**z axis**.
"""

from __future__ import annotations

import math

import torch
from torch import Tensor

from chrono_tpu_torch.core import quaternion as Q
from chrono_tpu_torch.physics.constraints import (
    ConstraintRows, lower_gap_function,
)
from chrono_tpu_torch.utils.tree import tensor_dataclass


@tensor_dataclass
class JointData:
    """Batched parameters of J joints of one type."""

    body_a: Tensor  # (J,) int32
    body_b: Tensor  # (J,) int32
    fa_pos: Tensor  # (J, 3) joint frame origin in body-a local coords
    fa_rot: Tensor  # (J, 4) joint frame rotation in body-a local coords
    fb_pos: Tensor  # (J, 3)
    fb_rot: Tensor  # (J, 4)
    aux: Tensor     # (J,) type-specific scalar (e.g. distance)

    @property
    def n(self) -> int:
        return self.body_a.shape[0]


def _dot(a: Tensor, b: Tensor) -> Tensor:
    return torch.sum(a * b, dim=-1)


def _joint_world(x, q, f_pos, f_rot):
    """World-space joint frame: origin p, axes (ex, ey, ez)."""
    p = x + Q.qrotate(q, f_pos)
    R = Q.q_to_matrix(Q.qmul(q, f_rot))  # columns are world axes
    return p, R[..., :, 0], R[..., :, 1], R[..., :, 2]


def _frames(x_a, q_a, x_b, q_b, p):
    return (_joint_world(x_a, q_a, p["fa_pos"], p["fa_rot"]),
            _joint_world(x_b, q_b, p["fb_pos"], p["fb_rot"]))


def _point(x, q, f_pos):
    return x + Q.qrotate(q, f_pos)


def _rows(cols):
    """Stack a joint's scalar equations as its last axis."""
    return torch.stack(cols, dim=-1)


def _cat(blocks):
    return torch.cat(blocks, dim=-1)


def _rotlock3(xa, ya, za, xb, yb, zb):
    """Three smooth scalar equations that vanish iff frames a, b are aligned
    (valid chart away from 180° relative rotation)."""
    return _rows([_dot(ya, zb), _dot(za, xb), _dot(xa, yb)])


# --- gap functions: c(x_a, q_a, x_b, q_b, params) -> (..., n_rows) -----------

def _gap_spherical(x_a, q_a, x_b, q_b, p):
    return _point(x_a, q_a, p["fa_pos"]) - _point(x_b, q_b, p["fb_pos"])


def _gap_revolute(x_a, q_a, x_b, q_b, p):
    (pa, xa, ya, za), (pb, xb, yb, zb) = _frames(x_a, q_a, x_b, q_b, p)
    return _cat([pa - pb, _rows([_dot(za, xb), _dot(za, yb)])])


def _gap_universal(x_a, q_a, x_b, q_b, p):
    # cross axes: x of a, y of b stay perpendicular (Hooke joint)
    (pa, xa, ya, za), (pb, xb, yb, zb) = _frames(x_a, q_a, x_b, q_b, p)
    return _cat([pa - pb, _rows([_dot(xa, yb)])])


def _gap_prismatic(x_a, q_a, x_b, q_b, p):
    (pa, xa, ya, za), (pb, xb, yb, zb) = _frames(x_a, q_a, x_b, q_b, p)
    dp = pb - pa
    return _cat([_rows([_dot(xa, dp), _dot(ya, dp)]),
                 _rotlock3(xa, ya, za, xb, yb, zb)])


def _gap_cylindrical(x_a, q_a, x_b, q_b, p):
    (pa, xa, ya, za), (pb, xb, yb, zb) = _frames(x_a, q_a, x_b, q_b, p)
    dp = pb - pa
    return _rows([_dot(xa, dp), _dot(ya, dp), _dot(za, xb), _dot(za, yb)])


def _gap_weld(x_a, q_a, x_b, q_b, p):
    (pa, xa, ya, za), (pb, xb, yb, zb) = _frames(x_a, q_a, x_b, q_b, p)
    return _cat([pa - pb, _rotlock3(xa, ya, za, xb, yb, zb)])


def _gap_distance(x_a, q_a, x_b, q_b, p):
    d = _point(x_b, q_b, p["fb_pos"]) - _point(x_a, q_a, p["fa_pos"])
    return _rows([torch.sqrt(torch.sum(d * d, dim=-1) + 1e-18) - p["aux"]])


def _gap_planar(x_a, q_a, x_b, q_b, p):
    # point of b confined to the z=0 plane of frame a; plane normals locked
    (pa, xa, ya, za), (pb, xb, yb, zb) = _frames(x_a, q_a, x_b, q_b, p)
    return _rows([_dot(za, pb - pa), _dot(za, xb), _dot(za, yb)])


def _gap_point_line(x_a, q_a, x_b, q_b, p):
    # point of b confined to the z axis of frame a
    pa, xa, ya, za = _joint_world(x_a, q_a, p["fa_pos"], p["fa_rot"])
    dp = _point(x_b, q_b, p["fb_pos"]) - pa
    return _rows([_dot(xa, dp), _dot(ya, dp)])


def _gap_point_plane(x_a, q_a, x_b, q_b, p):
    # point of b confined to the z=0 plane of frame a (ChLinkLockPointPlane)
    pa, xa, ya, za = _joint_world(x_a, q_a, p["fa_pos"], p["fa_rot"])
    return _rows([_dot(za, _point(x_b, q_b, p["fb_pos"]) - pa)])


def _gap_rev_spherical(x_a, q_a, x_b, q_b, p):
    # point of b at fixed distance aux from the revolute axis (z of frame a),
    # confined to the plane normal to that axis through the frame origin
    # (ChLinkRevoluteSpherical: 2 constraint rows)
    pa, xa, ya, za = _joint_world(x_a, q_a, p["fa_pos"], p["fa_rot"])
    d = _point(x_b, q_b, p["fb_pos"]) - pa
    dn = _dot(za, d)
    r2 = torch.clamp_min(_dot(d, d) - dn * dn, 1e-18)
    return _rows([dn, torch.sqrt(r2) - p["aux"]])


def _gap_oldham(x_a, q_a, x_b, q_b, p):
    # Oldham coupling (ChLinkLockOldham): frames stay aligned in rotation,
    # translation free only in the common x-y plane
    (pa, xa, ya, za), (pb, xb, yb, zb) = _frames(x_a, q_a, x_b, q_b, p)
    return _cat([_rows([_dot(za, pb - pa)]),
                 _rotlock3(xa, ya, za, xb, yb, zb)])


def _gap_parallel(x_a, q_a, x_b, q_b, p):
    (pa, xa, ya, za), (pb, xb, yb, zb) = _frames(x_a, q_a, x_b, q_b, p)
    return _rows([_dot(za, xb), _dot(za, yb)])


def _gap_perpendicular(x_a, q_a, x_b, q_b, p):
    (pa, xa, ya, za), (pb, xb, yb, zb) = _frames(x_a, q_a, x_b, q_b, p)
    return _rows([_dot(za, zb)])


def _gap_align(x_a, q_a, x_b, q_b, p):
    # orientation-only weld: rotations locked, translation free
    # (ChLinkLockAlign)
    (pa, xa, ya, za), (pb, xb, yb, zb) = _frames(x_a, q_a, x_b, q_b, p)
    return _rotlock3(xa, ya, za, xb, yb, zb)


def _gap_rev_prismatic(x_a, q_a, x_b, q_b, p):
    # free translation along x of frame a AND free rotation about z
    # (ChLinkLockRevolutePrismatic): 2 translation + 2 rotation rows
    (pa, xa, ya, za), (pb, xb, yb, zb) = _frames(x_a, q_a, x_b, q_b, p)
    dp = pb - pa
    return _rows([_dot(ya, dp), _dot(za, dp), _dot(za, xb), _dot(za, yb)])


def _gap_mate_xdistance(x_a, q_a, x_b, q_b, p):
    # point of b held at signed distance aux along frame a's z axis
    # (ChLinkMateXdistance role, a 1-row offset mate)
    pa, xa, ya, za = _joint_world(x_a, q_a, p["fa_pos"], p["fa_rot"])
    return _rows([_dot(za, _point(x_b, q_b, p["fb_pos"]) - pa) - p["aux"]])


#: joint type registry: name -> (gap_fn, n_rows)
JOINT_TYPES = {
    "spherical": (_gap_spherical, 3),
    "revolute": (_gap_revolute, 5),
    "universal": (_gap_universal, 4),
    "prismatic": (_gap_prismatic, 5),
    "cylindrical": (_gap_cylindrical, 4),
    "weld": (_gap_weld, 6),
    "distance": (_gap_distance, 1),
    "planar": (_gap_planar, 3),
    "point_line": (_gap_point_line, 2),
    "point_plane": (_gap_point_plane, 1),
    "rev_spherical": (_gap_rev_spherical, 2),
    "oldham": (_gap_oldham, 4),
    "parallel": (_gap_parallel, 2),
    "perpendicular": (_gap_perpendicular, 1),
    "align": (_gap_align, 3),
    "rev_prismatic": (_gap_rev_prismatic, 4),
    "mate_xdistance": (_gap_mate_xdistance, 1),
}

_LOWERERS = {
    name: lower_gap_function(fn, nr) for name, (fn, nr) in JOINT_TYPES.items()
}


def _params(data: JointData) -> dict:
    return {"fa_pos": data.fa_pos, "fa_rot": data.fa_rot,
            "fb_pos": data.fb_pos, "fb_rot": data.fb_rot, "aux": data.aux}


def joint_rows(kind: str, data: JointData, state_x, state_q, h,
               stab_factor=1.0, deadband=0.0) -> ConstraintRows:
    """Lower all joints of one type to stabilised constraint rows."""
    return _LOWERERS[kind](
        state_x, state_q, data.body_a, data.body_b, _params(data), h,
        stab_factor, deadband,
    )


# --- velocity-level couplers ---------------------------------------------------
#
# Transmission constraints (gear, pulley, rack-pinion, screw) couple RATES,
# not poses; lowering them at velocity level keeps them wrap-free across
# revolutions.  Data layout reuses JointData; `aux` carries the signed ratio /
# radius / pitch.  Each builder is written batched over the couplers of one
# kind (the JAX package maps a per-coupler function with vmap).

def _unit_z(like: Tensor) -> Tensor:
    """(0, 0, 1) on ``like``'s device, built there: an element set from a
    Python number is a host copy, which a CUDA graph cannot capture."""
    return (torch.arange(3, device=like.device) == 2).to(like.dtype)


def _local_z(rot: Tensor) -> Tensor:
    return Q.q_to_matrix(rot)[..., :, 2]


def _matT_vec(R: Tensor, v: Tensor) -> Tensor:
    """``Rᵀ v`` batched."""
    return torch.sum(R * v[..., :, None], dim=-2)


def _coupler_gear(xw, qw, data):
    """aux·(ω_a·za) + (ω_b·zb) = 0 — signed ratio aux = ±ra/rb
    (negative for internal gears / belt pulleys)."""
    za_l = _local_z(data.fa_rot)
    zb_l = _local_z(data.fb_rot)
    zero = torch.zeros_like(za_l)
    return (data.aux[:, None] * za_l, zero, zb_l, zero)


def _coupler_rack_pinion(xw, qw, data):
    """r·(ω_a·za) + zb·(v_b − v_a) = 0 — pinion a (radius aux) drives rack b
    translating along its joint-frame z axis."""
    za_l = _local_z(data.fa_rot)
    zb_w = Q.qrotate(Q.qmul(qw[data.body_b], data.fb_rot), _unit_z(xw))
    return (data.aux[:, None] * za_l, -zb_w, torch.zeros_like(za_l), zb_w)


def _coupler_screw(xw, qw, data):
    """za·(v_b − v_a) = (pitch/2π)·za·(ω_b − ω_a): translation/rotation
    coupling along the common z axis (combine with a cylindrical joint)."""
    qa, qb = qw[data.body_a], qw[data.body_b]
    c = (data.aux / (2.0 * math.pi))[:, None]
    za_w = Q.qrotate(Q.qmul(qa, data.fa_rot), _unit_z(xw))
    return (c * _matT_vec(Q.q_to_matrix(qa), za_w), -za_w,
            -c * _matT_vec(Q.q_to_matrix(qb), za_w), za_w)


#: coupler registry: name -> batched (Ja_w, Ja_v, Jb_w, Jb_v) builder
COUPLER_TYPES = {
    "gear": _coupler_gear,
    "pulley": _coupler_gear,          # identical row; sign convention in aux
    "rack_pinion": _coupler_rack_pinion,
    "screw": _coupler_screw,
}


def coupler_rows(kind: str, data: JointData, state_x, state_q
                 ) -> ConstraintRows:
    """Lower all couplers of one kind to single velocity-level rows
    (rhs = 0)."""
    Ja_w, Ja_v, Jb_w, Jb_v = COUPLER_TYPES[kind](state_x, state_q, data)
    return ConstraintRows.two_body(
        body_a=data.body_a, body_b=data.body_b,
        Ja_v=Ja_v, Ja_w=Ja_w, Jb_v=Jb_v, Jb_w=Jb_w,
        rhs=torch.zeros((data.n,), dtype=Ja_v.dtype, device=Ja_v.device),
        active=torch.ones((data.n,), dtype=torch.bool, device=Ja_v.device),
    )


def joint_violation(kind: str, data: JointData, state_x, state_q) -> Tensor:
    """Position-level constraint violation C for validation/tests
    (J, n_rows)."""
    gap_fn, _ = JOINT_TYPES[kind]
    a, b = data.body_a, data.body_b
    return gap_fn(state_x[a], state_q[a], state_x[b], state_q[b],
                  _params(data))
