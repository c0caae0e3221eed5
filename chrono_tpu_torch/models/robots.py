"""Small robot models: a quadcopter and a differential-drive robot.

Counterpart of ``chrono_tpu/models/robots.py`` (the reference's n-prop
copter with per-prop thrust and torque coefficients, and its two-wheel
Turtlebot with passive casters), assembled on the multibody core.

The step functions read nothing on the host and build no tensor from host
data: the rotor arms, the caster offsets and the body indices are made
once with the robot, and the forces are summed with ``index_add``, so a
step can be captured in a CUDA graph.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import Tensor

from chrono_tpu_torch.core import quaternion as Q
from chrono_tpu_torch.core.functions import FConst
from chrono_tpu_torch.physics.builder import SystemBuilder
from chrono_tpu_torch.physics.system import (
    Model, SolverSettings, step_euler_implicit_linearized,
)
from chrono_tpu_torch.utils.tree import static_field, tensor_dataclass
from chrono_tpu_torch.vehicle.wheeled import body_index

#: rotor positions in the body frame (X configuration), unit arm
_ROTORS = np.asarray([[1, 1, 0], [1, -1, 0], [-1, -1, 0], [-1, 1, 0]],
                     float) / np.sqrt(2.0)
#: casters fore and aft of the chassis centre, in the chassis frame
_CASTERS = np.asarray([[0.10, 0.0, -0.055], [-0.10, 0.0, -0.055]])


def _made_once(obj, name, value):
    object.__setattr__(obj, name, value)


def _device_field():
    return dataclasses.field(init=False, repr=False, compare=False)


# ---------------------------------------------------------------------------
# quadcopter
# ---------------------------------------------------------------------------


@tensor_dataclass
class Copter:
    model: Model
    arm: Tensor                 # rotor arm length
    c_thrust: Tensor            # thrust per ω² [N s²]
    c_torque: Tensor            # yaw drag torque per ω² [N m s²]
    spin_dirs: Tensor           # (4,) ±1 rotor handedness
    body: int = static_field(default=0)
    rotors: Tensor = _device_field()       # (4, 3) unit-arm rotor offsets
    body_index: Tensor = _device_field()   # (1,) the body, for index_add

    def __post_init__(self):
        like = self.spin_dirs
        _made_once(self, "rotors", torch.tensor(
            _ROTORS, dtype=like.dtype, device=like.device))
        _made_once(self, "body_index", body_index((self.body,), self.model))


def create_copter(mass=1.2, arm=0.18, inertia=(0.012, 0.012, 0.022),
                  c_thrust=1.2e-5, c_torque=2.5e-7, pos=(0, 0, 1.0),
                  dtype=torch.float32, device=None):
    """Quad-X copter (reference Copter<4> role): one 6-DOF body; the four
    rotors are force generators, not articulated bodies (their gyroscopics
    are negligible at model scale).  On the card unless ``device`` names
    another."""
    b = SystemBuilder(dtype=dtype, device=device)
    b.set_gravity((0, 0, -9.81))
    body = b.add_body(mass=mass, inertia=inertia, pos=pos, name="copter")
    model, state = b.finalize()

    def t(v):
        return torch.as_tensor(np.asarray(v, np.float32), device=b.device)

    return Copter(model=model, arm=t(arm), c_thrust=t(c_thrust),
                  c_torque=t(c_torque), spin_dirs=t([1.0, -1.0, 1.0, -1.0]),
                  body=body), state


def copter_forces(copter: Copter, state, rotor_omega: Tensor):
    """World force and body-local torque from the rotor speeds (4,)
    [rad/s]."""
    q = state.q[copter.body_index][0]
    thrust = copter.c_thrust * rotor_omega ** 2            # (4,)
    up_body = torch.eye(3, dtype=thrust.dtype, device=thrust.device)[2]
    f_world = Q.qrotate(q, up_body * torch.sum(thrust))
    r = copter.rotors * copter.arm                         # (4, 3)
    tau = torch.sum(torch.linalg.cross(
        r, up_body[None, :] * thrust[:, None], dim=-1), dim=0)
    tau = tau + up_body * torch.sum(
        copter.spin_dirs * copter.c_torque * rotor_omega ** 2)
    return f_world, tau


def copter_step(copter: Copter, state, rotor_omega, t, h,
                settings=SolverSettings(solver="direct")):
    f_w, tau_b = copter_forces(copter, state, torch.as_tensor(
        rotor_omega, dtype=state.x.dtype, device=state.x.device))
    n = copter.model.n_bodies
    f_ext = state.x.new_zeros((n, 3)).index_add(0, copter.body_index,
                                                f_w[None])
    tau_ext = state.x.new_zeros((n, 3)).index_add(0, copter.body_index,
                                                  tau_b[None])
    return step_euler_implicit_linearized(copter.model, state, t, h,
                                          settings, f_ext=f_ext,
                                          tau_ext=tau_ext)


def copter_hover_omega(copter: Copter, mass=None):
    """Rotor speed that exactly balances gravity (all four equal)."""
    m = (1.0 / copter.model.props.inv_mass[copter.body] if mass is None
         else mass)
    return torch.sqrt(m * 9.81 / (4.0 * copter.c_thrust))


# ---------------------------------------------------------------------------
# turtlebot (differential drive)
# ---------------------------------------------------------------------------


@tensor_dataclass
class Turtlebot:
    model: Model
    wheel_radius: Tensor
    track: Tensor
    chassis: int = static_field(default=0)
    wheels: tuple = static_field(default=())
    wheel_index: Tensor = _device_field()     # (2,) the wheels
    chassis_index: Tensor = _device_field()   # (1,) the chassis
    casters: Tensor = _device_field()         # (2, 3) chassis-frame offsets

    def __post_init__(self):
        like = self.wheel_radius
        _made_once(self, "wheel_index", body_index(self.wheels, self.model))
        _made_once(self, "chassis_index",
                   body_index((self.chassis,), self.model))
        _made_once(self, "casters", torch.tensor(
            _CASTERS, dtype=like.dtype, device=like.device))


def create_turtlebot(mass=2.8, wheel_radius=0.035, track=0.23,
                     clearance=0.02, dtype=torch.float32, device=None):
    """Two driven wheels + front/rear caster contacts (reference Turtlebot
    role).  The casters are vertical support forces in the step function
    (passive ball rollers).  On the card unless ``device`` names
    another."""
    b = SystemBuilder(dtype=dtype, device=device)
    b.set_gravity((0, 0, -9.81))
    z0 = wheel_radius
    chassis = b.add_body(mass=mass, inertia=(0.02, 0.02, 0.03),
                         pos=(0, 0, z0 + clearance), name="chassis")
    wheels = []
    for side, sy in (("L", track / 2), ("R", -track / 2)):
        w = b.add_body(mass=0.15, inertia=(1e-4, 2e-4, 1e-4),
                       pos=(0.0, sy, z0), name=f"wheel_{side}")
        b.add_motor_rotation_speed(chassis, w, world_pos=(0.0, sy, z0),
                                   world_axis=(0, 1, 0),
                                   profile=FConst(c=torch.tensor(0.0)))
        wheels.append(w)
    model, state = b.finalize()

    def t(v):
        return torch.as_tensor(np.float32(v), device=b.device)

    return Turtlebot(model=model, wheel_radius=t(wheel_radius),
                     track=t(track), chassis=chassis,
                     wheels=tuple(wheels)), state


def set_turtlebot_speeds(bot: Turtlebot, left, right) -> Turtlebot:
    """The robot with its left and right wheel speeds [rad/s]."""
    md = bot.model.motors["rot_speed"]
    c = torch.tensor([left, right], dtype=md.fa_pos.dtype,
                     device=md.fa_pos.device)
    motors = dict(bot.model.motors)
    motors["rot_speed"] = md.replace(profile=md.profile.replace(c=c))
    return bot.replace(model=bot.model.replace(motors=motors))


def turtlebot_step(bot: Turtlebot, state, t, h, mu=0.7,
                   settings=SolverSettings(solver="direct")):
    """Flat-ground step: wheel contact = vertical spring-damper support +
    regularised-Coulomb longitudinal traction at each wheel; casters =
    frictionless supports fore and aft of the chassis."""
    n = bot.model.n_bodies
    r = bot.wheel_radius
    k, c = 8000.0, 120.0
    e = torch.eye(3, dtype=state.x.dtype, device=state.x.device)
    w_idx = bot.wheel_index
    xw, vw = state.x[w_idx], state.v[w_idx]
    pen = r - xw[:, 2]
    fn = torch.clamp_min(k * pen - c * vw[:, 2], 0.0)            # (2,)
    # contact-point slip: v + ω×(−r ẑ) (ω body-local ≈ world here)
    w_world = Q.qrotate(state.q[w_idx], state.w[w_idx])
    vslip = vw[:, :2] + torch.linalg.cross(
        w_world, (-r * e[2]).expand_as(w_world), dim=-1)[:, :2]
    ft = (-mu * fn[:, None] * vslip
          / (torch.linalg.norm(vslip, dim=-1, keepdim=True) + 0.05))
    f_ext = state.x.new_zeros((n, 3)).index_add(
        0, w_idx, torch.cat([ft, fn[:, None]], dim=-1))
    # traction reaction torque about the wheel axle (body-local y)
    tau_ext = state.x.new_zeros((n, 3)).index_add(
        0, w_idx, (-ft[:, 0] * r)[:, None] * e[1])
    # casters fore/aft (frictionless vertical support at chassis height)
    c_idx = bot.chassis_index
    p = state.x[c_idx] + Q.qrotate(state.q[c_idx], bot.casters)   # (2, 3)
    fn_c = torch.clamp_min(k * -p[:, 2], 0.0)
    f_ext = f_ext.index_add(0, c_idx, ((fn_c[0] + fn_c[1]) * e[2])[None])
    return step_euler_implicit_linearized(bot.model, state, t, h, settings,
                                          f_ext=f_ext, tau_ext=tau_ext)
