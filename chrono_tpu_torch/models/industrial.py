"""Industrial robot arms: analytic and numerical kinematics, trajectory
interpolation, and a driven 6-dof dynamic model.

Counterpart of ``chrono_tpu/models/industrial.py`` (the reference's
chrono_models industrial family: the analytic 6R spherical-wrist and SCARA
kinematics, Newton IK over a Jacobian, operation-space trajectories and the
assembled MBS arm):

* the kinematics broadcast over leading axes, so a batch of targets is one
  call, and are differentiable end to end (``ik_newton`` takes the exact
  Jacobian with ``torch.func.jacrev``);
* the zero configuration is the straight-up arm with the tool along the
  forearm; joints: yaw(z) · shoulder(y) · elbow(y) · roll(z) · pitch(y) ·
  roll(z) — a spherical wrist, so position and orientation decouple and
  the wrist angles are a ZYZ Euler factorisation;
* the dynamic arm is a ``SystemBuilder`` chain of link bodies with
  angle-driven rotation motors.

Every entry point that builds tensors takes ``device`` (the card unless
told otherwise).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import Tensor

from chrono_tpu_torch.core import quaternion as Q
from chrono_tpu_torch.utils.device import resolve_device
from chrono_tpu_torch.utils.tree import static_field, tensor_dataclass


def _const(values, like: Tensor) -> Tensor:
    return torch.tensor(values, dtype=like.dtype, device=like.device)


# ---------------------------------------------------------------------------
# 6R spherical-wrist arm
# ---------------------------------------------------------------------------

@tensor_dataclass
class Arm6R:
    """Geometry of a 6R spherical-wrist arm (lengths in the zero/vertical
    configuration): base→shoulder ``H`` along z, upper arm ``L1``, forearm
    ``L2`` (shoulder and elbow both pitch about y), tool offset ``L3`` from
    the wrist centre along the tool z axis."""

    H: Tensor
    L1: Tensor
    L2: Tensor
    L3: Tensor
    base_pos: Tensor = None   # (3,) world position of the base
    base_rot: Tensor = None   # (4,) world orientation of the base

    @staticmethod
    def make(H, L1, L2, L3, base_pos=(0.0, 0.0, 0.0), base_rot=None, *,
             device=None):
        device = resolve_device(device, "Arm6R.make")

        def t(v):
            return torch.tensor(np.asarray(v, np.float32), device=device)

        return Arm6R(H=t(H), L1=t(L1), L2=t(L2), L3=t(L3),
                     base_pos=t(base_pos),
                     base_rot=t((1.0, 0.0, 0.0, 0.0) if base_rot is None
                                else base_rot))


def _rz(a: Tensor) -> Tensor:
    return Q.q_from_axis_angle(_const([0.0, 0.0, 1.0], a), a)


def _ry(a: Tensor) -> Tensor:
    return Q.q_from_axis_angle(_const([0.0, 1.0, 0.0], a), a)


def fk_6r(arm: Arm6R, q: Tensor):
    """Forward kinematics: joint angles (…, 6) → (tcp_pos (…, 3),
    tcp_rot (…, 4)); differentiable."""
    th1, th2, th3, th4, th5, th6 = [q[..., i] for i in range(6)]
    # orientation chain: Rz(1) Ry(2) Ry(3) Rz(4) Ry(5) Rz(6)
    q01 = _rz(th1)
    q03 = Q.qmul(q01, _ry(th2 + th3))
    q04 = Q.qmul(q03, _rz(th4))
    q05 = Q.qmul(q04, _ry(th5))
    q06 = Q.qmul(q05, _rz(th6))
    # positions: shoulder → elbow along the (yaw·pitch)-rotated z
    up = _const([0.0, 0.0, 1.0], q).expand(q.shape[:-1] + (3,))
    shoulder = arm.H[..., None] * up
    elbow = shoulder + arm.L1[..., None] * Q.qrotate(Q.qmul(q01, _ry(th2)),
                                                     up)
    wrist = elbow + arm.L2[..., None] * Q.qrotate(q03, up)
    tcp = wrist + arm.L3[..., None] * Q.qrotate(q06, up)
    pos = arm.base_pos + Q.qrotate(arm.base_rot, tcp)
    rot = Q.qmul(arm.base_rot, q06)
    return pos, rot


def ik_6r(arm: Arm6R, target_pos: Tensor, target_rot: Tensor,
          elbow_up: bool = True) -> Tensor:
    """Analytic inverse kinematics of the spherical-wrist 6R arm.

    Branch-free (gimbal lock handled with ``where``), batched over leading
    axes.  Returns joint angles (…, 6); an unreachable target is clamped
    to the workspace boundary (straight arm), as the reference's acos
    clamp does."""
    # target in base coordinates
    T = Q.qrotate_inv(arm.base_rot, target_pos - arm.base_pos)
    R06 = Q.qmul(Q.qconj(arm.base_rot), target_rot)
    # wrist centre: TCP minus the tool offset along the tool z axis
    W = T - arm.L3[..., None] * Q.qrotate(R06, _const([0.0, 0.0, 1.0], R06))

    wx, wy, wz = W[..., 0], W[..., 1], W[..., 2]
    th1 = torch.atan2(wy, wx)
    r2 = wx * wx + wy * wy
    s = wz - arm.H
    # elbow interior rotation e: law of cosines on (r, s)
    D = (r2 + s * s - arm.L1 ** 2 - arm.L2 ** 2) / (2.0 * arm.L1 * arm.L2)
    e = torch.arccos(torch.clamp(D, -1.0, 1.0))
    e = e if elbow_up else -e
    beta = torch.atan2(arm.L2 * torch.sin(e), arm.L1 + arm.L2 * torch.cos(e))
    phi = torch.atan2(torch.sqrt(r2), s)          # tilt from vertical
    th2 = phi - beta
    th3 = e

    # wrist: R36 = (Rz(th1) Ry(th2+th3))ᵀ R06 = Rz(th4) Ry(th5) Rz(th6)
    q03 = Q.qmul(_rz(th1), _ry(th2 + th3))
    R36 = Q.q_to_matrix(Q.qmul(Q.qconj(q03), R06))
    c5 = torch.clamp(R36[..., 2, 2], -1.0, 1.0)
    th5 = torch.arccos(c5)
    normal = torch.abs(torch.abs(c5) - 1.0) > 1e-6
    th4 = torch.where(normal,
                      torch.atan2(R36[..., 1, 2], R36[..., 0, 2]),
                      # gimbal lock: all roll into th4 (th6 := 0)
                      torch.atan2(torch.sign(c5) * R36[..., 1, 0],
                                  R36[..., 0, 0]))
    th6 = torch.where(normal,
                      torch.atan2(R36[..., 2, 1], -R36[..., 2, 0]),
                      torch.zeros_like(th4))
    return torch.stack([th1, th2, th3, th4, th5, th6], dim=-1)


# ---------------------------------------------------------------------------
# SCARA (RRRP) arm
# ---------------------------------------------------------------------------

@tensor_dataclass
class ArmSCARA:
    """SCARA geometry: column height ``H``, horizontal links ``L1``/``L2``
    (both revolute about z), tool-yaw joint with vertical drop ``D``, then a
    prismatic plunge ``d ≥ 0`` down to the TCP at ``z = H − D − d``."""

    H: Tensor
    L1: Tensor
    L2: Tensor
    D: Tensor
    right_elbow: bool = static_field(default=True)

    @staticmethod
    def make(H, L1, L2, D, right_elbow=True, *, device=None):
        device = resolve_device(device, "ArmSCARA.make")

        def t(v):
            return torch.tensor(np.float32(v), device=device)

        return ArmSCARA(H=t(H), L1=t(L1), L2=t(L2), D=t(D),
                        right_elbow=right_elbow)


def fk_scara(arm: ArmSCARA, u: Tensor):
    """u = (th1, th2, th3, d) → (tcp_pos, tcp_rot).  Planar 3R + plunge."""
    th1, th2, th3, d = [u[..., i] for i in range(4)]
    a12 = th1 + th2
    x = arm.L1 * torch.cos(th1) + arm.L2 * torch.cos(a12)
    y = arm.L1 * torch.sin(th1) + arm.L2 * torch.sin(a12)
    z = arm.H - arm.D - d + torch.zeros_like(x)
    return torch.stack([x, y, z], dim=-1), _rz(a12 + th3)


def ik_scara(arm: ArmSCARA, target_pos: Tensor, yaw: Tensor) -> Tensor:
    """Analytic RRRP inverse kinematics: (x, y, z, tool yaw) → (…, 4)."""
    x, y, z = target_pos[..., 0], target_pos[..., 1], target_pos[..., 2]
    D2 = (x * x + y * y - arm.L1 ** 2 - arm.L2 ** 2) / (2.0 * arm.L1
                                                       * arm.L2)
    th2 = torch.arccos(torch.clamp(D2, -1.0, 1.0))
    th2 = th2 if arm.right_elbow else -th2
    th1 = (torch.atan2(y, x)
           - torch.atan2(arm.L2 * torch.sin(th2),
                         arm.L1 + arm.L2 * torch.cos(th2)))
    th3 = yaw - th1 - th2
    d = arm.H - arm.D - z
    return torch.stack([th1, th2, th3, d], dim=-1)


# ---------------------------------------------------------------------------
# N-dof numerical IK (Newton over the autodiff Jacobian)
# ---------------------------------------------------------------------------

def ik_newton(fk_fn, q0: Tensor, target_pos: Tensor, target_rot: Tensor,
              tol: float = 1e-6, max_iter: int = 50, damping: float = 1e-6):
    """Damped-Newton IK for an arbitrary ``fk_fn(q) -> (pos, rot)``.

    The Jacobian is exact (``torch.func.jacrev``; this PyTorch's forward
    mode runs every op through Python decompositions and is far slower at
    these sizes).  Residual = [Δpos; rotation vector of q_err].  The loop
    runs while ``it < max_iter and err > tol``, reading ``err`` on the host
    each iteration.  Returns ``(q, converged)``, ``converged`` a bool
    tensor."""
    def resid(q):
        p, r = fk_fn(q)
        dr = Q.qlog2(Q.qmul(Q.qconj(target_rot), r))
        return torch.cat([p - target_pos, dr])

    jac = torch.func.jacrev(resid)
    eye = torch.eye(q0.shape[0], dtype=q0.dtype, device=q0.device)
    q = q0
    err = torch.linalg.norm(resid(q))
    it = 0
    while it < max_iter and float(err) > tol:
        r = resid(q)
        J = jac(q)
        # damped least squares (Levenberg): (JᵀJ + λI) dq = −Jᵀ r
        dq = torch.linalg.solve(J.T @ J + damping * eye, -J.T @ r)
        q = q + dq
        it += 1
        err = torch.linalg.norm(resid(q))
    return q, err <= tol


# ---------------------------------------------------------------------------
# Trajectory interpolation (operation space)
# ---------------------------------------------------------------------------

@tensor_dataclass
class Trajectory:
    """Operation-space trajectory through waypoints: piecewise-linear
    positions + slerp orientations, each segment time-scaled by a smooth
    motion law.  Durations are given or split in proportion to the segment
    chords."""

    pos: Tensor        # (K, 3) waypoints
    rot: Tensor        # (K, 4) waypoint quaternions
    t_cum: Tensor      # (K,) cumulative times, t_cum[0] = 0
    law: str = static_field(default="poly345")


def make_trajectory(waypoints_pos, waypoints_rot, total_time,
                    durations: Sequence[float] = None, law: str = "poly345",
                    *, device=None) -> Trajectory:
    device = resolve_device(device, "make_trajectory")
    pos = torch.as_tensor(waypoints_pos, dtype=torch.float32).to(device)
    rot = torch.as_tensor(waypoints_rot, dtype=torch.float32).to(device)
    K = pos.shape[0]
    if durations is None:
        # float32 on the host, as the JAX package computes them
        chords = np.linalg.norm(np.diff(pos.cpu().numpy(), axis=0), axis=1)
        chords = np.maximum(chords, 1e-9)
        durations = chords / chords.sum() * float(total_time)
    t_cum = torch.cat([torch.zeros((1,), dtype=torch.float32),
                       torch.cumsum(torch.as_tensor(
                           np.asarray(durations, np.float32)), 0)])
    if t_cum.shape[0] != K:
        raise ValueError(f"{K} waypoints need {K - 1} durations")
    return Trajectory(pos=pos, rot=rot, t_cum=t_cum.to(device), law=law)


def _law_s(law: str, x: Tensor) -> Tensor:
    """Normalised motion law s(x): s(0)=0, s(1)=1, ṡ(0)=ṡ(1)=0."""
    x = torch.clamp(x, 0.0, 1.0)
    if law == "linear":
        return x
    if law == "poly345":
        return x ** 3 * (10.0 - 15.0 * x + 6.0 * x * x)
    if law == "cycloidal":
        return x - torch.sin(2.0 * np.pi * x) / (2.0 * np.pi)
    raise ValueError(f"unknown motion law {law!r}")


def traj_eval(traj: Trajectory, t):
    """(pos (…, 3), rot (…, 4)) at time(s) ``t`` (clamped to the ends).
    The segment index is clamped as the JAX package clamps it, and the
    knots are read through a 1-D index."""
    t = torch.as_tensor(t, dtype=torch.float32).to(traj.t_cum.device)
    shape = t.shape
    t = t.reshape(-1)
    K = traj.pos.shape[0]
    i = torch.clamp(torch.searchsorted(traj.t_cum, t, right=True) - 1,
                    0, K - 2)
    t0 = traj.t_cum[i]
    t1 = traj.t_cum[i + 1]
    s = _law_s(traj.law, (t - t0) / torch.clamp_min(t1 - t0, 1e-9))
    p = traj.pos[i] + s[:, None] * (traj.pos[i + 1] - traj.pos[i])
    # slerp through the quaternion log/exp maps, on the shortest path
    qa, qb = traj.rot[i], traj.rot[i + 1]
    dot = torch.sum(qa * qb, dim=-1, keepdim=True)
    qb = torch.where(dot < 0, -qb, qb)
    dq = Q.qmul(Q.qconj(qa), qb)
    r = Q.qmul(qa, Q.qexp_half(s[:, None] * Q.qlog2(dq)))
    return p.reshape(shape + (3,)), Q.qnormalize(r).reshape(shape + (4,))


# ---------------------------------------------------------------------------
# Dynamic arm model (IndustrialRobot6dof role)
# ---------------------------------------------------------------------------

def create_arm_6dof(arm: Arm6R, joint_programs, link_mass=(12.0, 8.0, 5.0),
                    wrist_mass=1.5, dtype=torch.float32, device=None):
    """Assemble the 6R arm as an MBS: base column + upper arm + forearm +
    three wrist bodies, each joint an angle-driven rotation motor following
    its ``joint_programs[i]`` MotionFunction.  Returns (model, state,
    tool_body_id, tool_offset_local).  Zero configuration = straight up
    (matches ``fk_6r``).  On the card unless ``device`` names another."""
    from chrono_tpu_torch.physics.builder import SystemBuilder

    H, L1, L2, L3 = (float(arm.H), float(arm.L1), float(arm.L2),
                     float(arm.L3))
    b = SystemBuilder(dtype=dtype, device=device)
    ground = b.add_ground()
    # link bodies, COMs at segment midpoints (zero config: straight up)
    col = b.add_body(mass=link_mass[0], inertia=(0.3, 0.3, 0.1),
                     pos=(0, 0, 0.5 * H), name="column")
    upper = b.add_body(mass=link_mass[1], inertia=(0.2, 0.2, 0.05),
                       pos=(0, 0, H + 0.5 * L1), name="upper_arm")
    fore = b.add_body(mass=link_mass[2], inertia=(0.1, 0.1, 0.02),
                      pos=(0, 0, H + L1 + 0.5 * L2), name="forearm")
    wz = H + L1 + L2
    w1 = b.add_body(mass=wrist_mass, inertia=(0.01,) * 3, pos=(0, 0, wz),
                    name="wrist_roll")
    w2 = b.add_body(mass=wrist_mass, inertia=(0.01,) * 3, pos=(0, 0, wz),
                    name="wrist_pitch")
    tool = b.add_body(mass=wrist_mass, inertia=(0.01,) * 3,
                      pos=(0, 0, wz + 0.5 * L3), name="tool")

    for (pa, pb, anchor, axis), prog in zip(
            ((ground, col, (0, 0, 0), (0, 0, 1)),
             (col, upper, (0, 0, H), (0, 1, 0)),
             (upper, fore, (0, 0, H + L1), (0, 1, 0)),
             (fore, w1, (0, 0, wz), (0, 0, 1)),
             (w1, w2, (0, 0, wz), (0, 1, 0)),
             (w2, tool, (0, 0, wz), (0, 0, 1))), joint_programs):
        b.add_motor_rotation_angle(pa, pb, anchor, axis, prog)
    model, state = b.finalize()
    return model, state, tool, torch.tensor([0.0, 0.0, 0.5 * L3],
                                            dtype=torch.float32,
                                            device=b.device)


def joint_programs_from_trajectory(arm: Arm6R, traj: Trajectory,
                                   n_samples: int = 64, elbow_up=True):
    """Sample IK along the trajectory into per-joint ``FInterp`` programs,
    each joint unwrapped by 2π (``np.unwrap``) so its targets are
    continuous."""
    from chrono_tpu_torch.core.functions import FInterp, linspace

    ts = linspace(0.0, float(traj.t_cum[-1]), n_samples,
                  device=traj.t_cum.device)
    p, r = traj_eval(traj, ts)
    qs = ik_6r(arm, p, r, elbow_up=elbow_up)
    qs = torch.as_tensor(np.unwrap(qs.cpu().numpy(), axis=0)).to(ts.device)
    return [FInterp(ts=ts, ys=qs[:, j]) for j in range(6)]
