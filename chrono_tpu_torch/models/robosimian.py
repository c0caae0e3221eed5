"""RoboSimian-class limbed robot: 4 limbs × 8 driven joints on a free
chassis, wheels rolling on the ground through NSC contact, actuated from
recorded actuation tables.

Counterpart of ``chrono_tpu/models/robosimian.py`` (the reference's
RoboSimian model: its 8-motor limbs and its phase-sequenced driver):

* the limb is a data table (joint offsets and axes of the public JPL
  RoboSimian geometry) driven through one FK routine;
* all 32 motors are angle- or speed-driven rotation motors of one model, so
  the whole robot steps through one ``nsc_step``;
* the RS_Driver role (start → cycle × N, per-motor interpolation) is a
  stack of ``FInterp`` programs read from actuation tables in the
  reference's 33-column text format (time, then 4 limbs × 8 joints);
* contact: wheel spheres on a ground box through the NSC pipeline.
"""

from __future__ import annotations

import numpy as np
import torch

from chrono_tpu_torch.core import quaternion as Q
from chrono_tpu_torch.utils.device import resolve_device

# Driven-joint chain per limb (public RoboSimian kinematics): offset of the
# joint frame in the parent joint frame, URDF rpy of that frame, rotation
# axis in the joint frame.  Fixed force-torque adapter links are merged.
_LIMB_JOINTS = [
    # offset                    rpy                 axis
    ((0.17203, 0.0, 0.0), (np.pi, 0.0, 0.0), (1, 0, 0)),      # joint1 roll
    ((0.0, 0.0, 0.0), (0.0, 0.0, 0.0), (0, -1, 0)),           # joint2 pitch
    ((0.28650, -0.117, 0.0), (0.0, 0.0, 0.0), (1, 0, 0)),     # joint3 roll
    ((0.0, 0.0, 0.0), (0.0, 0.0, 0.0), (0, -1, 0)),           # joint4 pitch
    ((0.28650, -0.117, 0.0), (0.0, 0.0, 0.0), (1, 0, 0)),     # joint5 roll
    ((0.0, 0.0, 0.0), (0.0, 0.0, 0.0), (0, -1, 0)),           # joint6 pitch
    ((0.19250, -0.117, 0.0), (0.0, 0.0, 0.0), (1, 0, 0)),     # joint7 roll
    ((0.12024, 0.172, 0.0), (-np.pi / 2, 0.0, 0.0), (0, 0, 1)),  # joint8 whl
]

# limb mount frames on the chassis: FR, RR, RL, FL
_LIMB_MOUNTS = [
    ((+0.29326, +0.20940, 0.03650), (0.0, -1.5708, -0.26180)),
    ((-0.29326, +0.20940, 0.03650), (0.0, -1.5708, +0.26180)),
    ((-0.29326, -0.20940, 0.03650), (0.0, -1.5708, +2.87979)),
    ((+0.29326, -0.20940, 0.03650), (0.0, -1.5708, +3.40339)),
]

WHEEL_RADIUS = 0.12


def _f32(v) -> torch.Tensor:
    """A float32 CPU tensor: the frames are computed on the host in
    float32, as the JAX package computes them."""
    return torch.as_tensor(np.asarray(v, np.float32))


def _q_rpy_urdf(rpy) -> torch.Tensor:
    """URDF fixed-axis rpy: R = Rz(yaw) Ry(pitch) Rx(roll)."""
    r, p, y = rpy
    qz = Q.q_from_axis_angle(_f32([0.0, 0.0, 1.0]), _f32(y))
    qy = Q.q_from_axis_angle(_f32([0.0, 1.0, 0.0]), _f32(p))
    qx = Q.q_from_axis_angle(_f32([1.0, 0.0, 0.0]), _f32(r))
    return Q.qmul(Q.qmul(qz, qy), qx)


def limb_fk(mount_pos, mount_rpy, angles):
    """Chassis-frame frames of the 8 joint bodies of one limb at the given
    joint angles (float32, on the CPU).  Returns (pos (8,3), rot (8,4),
    axis (8,3))."""
    p = _f32(mount_pos)
    q = _q_rpy_urdf(mount_rpy)
    out_p, out_q, out_ax = [], [], []
    for (off, rpy, axis), th in zip(_LIMB_JOINTS, angles):
        p = p + Q.qrotate(q, _f32(off))
        q = Q.qmul(q, _q_rpy_urdf(rpy))
        ax_w = Q.qrotate(q, _f32(axis))
        q = Q.qmul(q, Q.q_from_axis_angle(_f32(axis), _f32(th)))
        out_p.append(p)
        out_q.append(q)
        out_ax.append(ax_w)
    return torch.stack(out_p), torch.stack(out_q), torch.stack(out_ax)


def load_actuation(path, n_limbs=4, n_joints=8):
    """Read an actuation table: (times (T,), angles (T, 32))."""
    data = np.loadtxt(path)
    if data.ndim != 2 or data.shape[1] != 1 + n_limbs * n_joints:
        raise ValueError(f"{path}: expected {1 + n_limbs * n_joints} "
                         f"columns, got shape {data.shape}")
    return data[:, 0], data[:, 1:]


def gait_programs(cycle_path, n_cycles=1, start_path=None, scale_time=1.0,
                  *, device=None):
    """RS_Driver role: per-motor ``FInterp`` programs from recorded phases
    (an optional start phase, then the cycle repeated ``n_cycles`` times).
    Angles are re-based so every program starts at 0 (the motors are added
    at the already-posed configuration).  Returns (32 programs, posture (32,)
    initial angles, total_time); the programs live on ``device`` (the card
    unless told otherwise)."""
    from chrono_tpu_torch.core.functions import FInterp

    device = resolve_device(device, "gait_programs")
    ts, qs = load_actuation(cycle_path)
    if start_path is not None:
        ts0, qs0 = load_actuation(start_path)
        t_parts, q_parts = [ts0], [qs0]
        t_off = ts0[-1] + (ts0[-1] - ts0[-2])
    else:
        t_parts, q_parts, t_off = [], [], 0.0
    for _ in range(n_cycles):
        t_parts.append(ts + t_off)
        q_parts.append(qs)
        t_off = t_parts[-1][-1] + (ts[1] - ts[0])
    T = np.concatenate(t_parts) * scale_time
    A = np.concatenate(q_parts, axis=0)
    posture = A[0].copy()
    A = np.unwrap(A - posture[None, :], axis=0)
    T32 = torch.as_tensor(T.astype(np.float32), device=device)
    progs = [FInterp(ts=T32, ys=torch.as_tensor(
        A[:, j].astype(np.float32), device=device))
        for j in range(A.shape[1])]
    return progs, posture, float(T[-1])


def create_robosimian(posture, wheel_speeds, joint_programs=None,
                      chassis_mass=45.0, link_mass=2.5, wheel_mass=1.5,
                      ground_mu=0.8, dtype=torch.float32, device=None):
    """Assemble the robot at the given 32-angle ``posture`` standing on the
    ground plane (z = 0).  Limb joints 1–7 are angle motors (holding the
    posture, or following ``joint_programs`` relative to it); joint 8 is a
    speed motor at ``wheel_speeds[limb]`` (the reference's driving mode).
    On the card unless ``device`` names another.

    Returns (model, state, coll, chassis_id, wheel_ids)."""
    from chrono_tpu_torch.collision.cell_list import GridSpec
    from chrono_tpu_torch.collision.pipeline import (
        BoxShapes, CollisionModel, SphereShapes,
    )
    from chrono_tpu_torch.core.functions import FConst
    from chrono_tpu_torch.physics.builder import SystemBuilder

    device = resolve_device(device, "create_robosimian")
    posture = np.asarray(posture, np.float32).reshape(4, 8)
    # the robot is deployed flipped π about x (limbs extend +z in chassis
    # coordinates, downward in the world), as the reference demos set it
    q_flip = _f32([0.0, 1.0, 0.0, 0.0])
    # chassis height: the wheels (lowest limb points) touch the ground
    max_z = max(float(limb_fk(m[0], m[1], posture[i])[0][-1, 2])
                for i, m in enumerate(_LIMB_MOUNTS))
    ch_z = WHEEL_RADIUS + max_z

    b = SystemBuilder(dtype=dtype, device=device)
    ground = b.add_ground()
    chassis = b.add_body(mass=chassis_mass, inertia=(2.0, 3.0, 4.0),
                         pos=(0.0, 0.0, ch_z),
                         rot=tuple(float(v) for v in q_flip),
                         name="chassis")
    wheel_ids = []
    sph_body = []
    for li, (mpos, mrpy) in enumerate(_LIMB_MOUNTS):
        pos, rot, axes = limb_fk(mpos, mrpy, posture[li])
        pos = Q.qrotate(q_flip, pos)
        rot = Q.qmul(q_flip, rot)
        axes = Q.qrotate(q_flip, axes)
        parent = chassis
        for j in range(8):
            is_wheel = j == 7
            wp = (float(pos[j][0]), float(pos[j][1]),
                  float(pos[j][2]) + ch_z)
            bid = b.add_body(mass=wheel_mass if is_wheel else link_mass,
                             inertia=(0.01, 0.01, 0.01), pos=wp,
                             rot=tuple(float(v) for v in rot[j]),
                             name=f"limb{li + 1}_link{j + 1}")
            wa = tuple(float(v) for v in axes[j])
            if is_wheel:
                b.add_motor_rotation_speed(
                    parent, bid, wp, wa,
                    FConst(c=torch.tensor(float(wheel_speeds[li]))))
                wheel_ids.append(bid)
                sph_body.append(bid)
            else:
                prog = (FConst(c=torch.tensor(0.0)) if joint_programs is None
                        else joint_programs[li * 8 + j])
                b.add_motor_rotation_angle(parent, bid, wp, wa, prog)
            parent = bid
    model, state = b.finalize()

    def t(v, dt=torch.float32):
        return torch.as_tensor(np.asarray(v), dtype=dt, device=device)

    n_sph = len(sph_body)
    spheres = SphereShapes(
        body=t(sph_body, torch.int32), offset=t(np.zeros((n_sph, 3))),
        radius=t([WHEEL_RADIUS] * n_sph), mu=t([ground_mu] * n_sph))
    boxes = BoxShapes(
        body=t([ground], torch.int32), pos=t([[0.0, 0.0, -0.5]]),
        rot=Q.qidentity((1,), device=device), half=t([[5.0, 5.0, 0.5]]),
        mu=t([ground_mu]))
    coll = CollisionModel(
        spheres=spheres, boxes=boxes,
        grid=GridSpec(origin=(-5.0, -5.0, -1.0), cell_size=0.5,
                      dims=(20, 20, 6)),
        max_per_cell=8, max_contacts=32)
    return model, state, coll, chassis, wheel_ids
