"""Force elements: translational / rotational spring-damper-actuators and
bushings.

Counterpart of ``chrono_tpu/physics/force_elements.py`` (the reference's
``ChLinkTSDA`` / ``ChLinkRSDA`` / ``ChLinkBushing``): smooth force elements
that accumulate into per-body force/torque arrays (world-frame force at the
COM, body-local torque), batched over all elements.  The accumulation is
``utils.segment.scatter_add``: no atomics, a fixed sum order.
"""

from __future__ import annotations

import torch
from torch import Tensor

from chrono_tpu_torch.core import quaternion as Q
from chrono_tpu_torch.physics.joints import _unit_z
from chrono_tpu_torch.physics.motors import relative_angle_about_axis
from chrono_tpu_torch.utils.segment import scatter_add
from chrono_tpu_torch.utils.tree import tensor_dataclass


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


@tensor_dataclass
class TSDAData:
    """K translational spring-damper-actuators between body anchor points."""

    body_a: Tensor   # (K,) int32
    body_b: Tensor   # (K,) int32
    pa_loc: Tensor   # (K, 3) anchor in body-a local coords
    pb_loc: Tensor   # (K, 3)
    k: Tensor        # (K,) spring stiffness
    c: Tensor        # (K,) damping
    rest_len: Tensor  # (K,)
    f_act: Tensor    # (K,) constant actuation force (+ = repulsive)

    @property
    def n(self) -> int:
        return self.body_a.shape[0]


@tensor_dataclass
class RSDAData:
    """K rotational spring-damper-actuators about a joint-frame z axis."""

    body_a: Tensor
    body_b: Tensor
    fa_rot: Tensor   # (K, 4) axis frame in body a
    fb_rot: Tensor   # (K, 4)
    k: Tensor
    c: Tensor
    rest_angle: Tensor
    t_act: Tensor    # constant actuation torque

    @property
    def n(self) -> int:
        return self.body_a.shape[0]


def accumulate_tsda(data: TSDAData, state, f_world: Tensor,
                    tau_local: Tensor):
    """Add TSDA forces into accumulators; returns updated (f_world,
    tau_local)."""
    a, b = data.body_a, data.body_b
    ra = Q.qrotate(state.q[a], data.pa_loc)         # world lever arms
    rb = Q.qrotate(state.q[b], data.pb_loc)
    d = (state.x[b] + rb) - (state.x[a] + ra)
    length = torch.sqrt(torch.sum(d * d, dim=-1) + 1e-18)
    u = d / length[:, None]
    # anchor-point velocities (w is body-local → world angular velocity R w)
    va = state.v[a] + _cross(Q.qrotate(state.q[a], state.w[a]), ra)
    vb = state.v[b] + _cross(Q.qrotate(state.q[b], state.w[b]), rb)
    speed = torch.sum(u * (vb - va), dim=-1)
    # scalar force along u, positive pulls bodies together
    fmag = data.k * (length - data.rest_len) + data.c * speed + data.f_act
    f_on_a = u * fmag[:, None]
    f_on_b = -f_on_a
    f_world = scatter_add(scatter_add(f_world, a, f_on_a), b, f_on_b)
    tau_local = scatter_add(
        scatter_add(tau_local, a, Q.qrotate_inv(state.q[a],
                                                _cross(ra, f_on_a))),
        b, Q.qrotate_inv(state.q[b], _cross(rb, f_on_b)))
    return f_world, tau_local


def accumulate_rsda(data: RSDAData, state, f_world: Tensor,
                    tau_local: Tensor):
    """Add RSDA torques about the world axis za into the accumulators."""
    a, b = data.body_a, data.body_b
    za = Q.qrotate(Q.qmul(state.q[a], data.fa_rot), _unit_z(state.x))
    angle = relative_angle_about_axis(
        state.x[a], state.q[a], state.x[b], state.q[b], data.fa_rot,
        data.fb_rot)
    wa_w = Q.qrotate(state.q[a], state.w[a])
    wb_w = Q.qrotate(state.q[b], state.w[b])
    rate = torch.sum(za * (wb_w - wa_w), dim=-1)
    tmag = data.k * (angle - data.rest_angle) + data.c * rate - data.t_act
    tau_w_on_b = -za * tmag[:, None]
    tau_local = scatter_add(
        scatter_add(tau_local, b, Q.qrotate_inv(state.q[b], tau_w_on_b)),
        a, Q.qrotate_inv(state.q[a], -tau_w_on_b))
    return f_world, tau_local


def tsda_length(data: TSDAData, state) -> Tensor:
    a, b = data.body_a, data.body_b
    pa = state.x[a] + Q.qrotate(state.q[a], data.pa_loc)
    pb = state.x[b] + Q.qrotate(state.q[b], data.pb_loc)
    return torch.sqrt(torch.sum((pb - pa) ** 2, dim=-1))


@tensor_dataclass
class BushingData:
    """K compliant 6-DOF bushings between body frames (reference
    ChLinkBushing): diagonal translational/rotational stiffness + damping
    expressed in the body-a bushing frame."""

    body_a: Tensor   # (K,) int32
    body_b: Tensor   # (K,) int32
    fa_pos: Tensor   # (K, 3) frame origin in body-a local coords
    fa_rot: Tensor   # (K, 4)
    fb_pos: Tensor   # (K, 3)
    fb_rot: Tensor   # (K, 4)
    k_t: Tensor      # (K, 3) translational stiffness along frame axes
    c_t: Tensor      # (K, 3)
    k_r: Tensor      # (K, 3) rotational stiffness about frame axes
    c_r: Tensor      # (K, 3)


def accumulate_bushing(data: BushingData, state, f_world: Tensor,
                       tau_local: Tensor):
    """Add bushing forces/moments into the accumulators."""
    a, b = data.body_a, data.body_b
    qa = Q.qmul(state.q[a], data.fa_rot)          # world bushing frame (on a)
    qb = Q.qmul(state.q[b], data.fb_rot)
    ra = Q.qrotate(state.q[a], data.fa_pos)
    rb = Q.qrotate(state.q[b], data.fb_pos)

    # translational: displacement of b's anchor in a's bushing frame
    d_loc = Q.qrotate_inv(qa, (state.x[b] + rb) - (state.x[a] + ra))
    va = state.v[a] + _cross(Q.qrotate(state.q[a], state.w[a]), ra)
    vb = state.v[b] + _cross(Q.qrotate(state.q[b], state.w[b]), rb)
    dv_loc = Q.qrotate_inv(qa, vb - va)
    f_w = Q.qrotate(qa, -(data.k_t * d_loc + data.c_t * dv_loc))  # on b

    # rotational: small-rotation chart of the relative frame rotation
    q_rel = Q.qmul(Q.qconj(qa), qb)
    q_rel = torch.where(q_rel[..., 0:1] < 0, -q_rel, q_rel)
    th = 2.0 * q_rel[..., 1:4]                    # ≈ rotation vector
    w_rel = Q.qrotate_inv(qa, Q.qrotate(state.q[b], state.w[b])
                          - Q.qrotate(state.q[a], state.w[a]))
    m_w = Q.qrotate(qa, -(data.k_r * th + data.c_r * w_rel))  # on b, world

    f_world = scatter_add(scatter_add(f_world, b, f_w), a, -f_w)
    tau_b = Q.qrotate_inv(state.q[b], m_w + _cross(rb, f_w))
    tau_a = Q.qrotate_inv(state.q[a], -m_w + _cross(ra, -f_w))
    tau_local = scatter_add(scatter_add(tau_local, b, tau_b), a, tau_a)
    return f_world, tau_local
