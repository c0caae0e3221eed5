"""Wheeled-vehicle assembly and its fused step.

Counterpart of ``chrono_tpu/vehicle/wheeled.py`` (the reference's
ChWheeledVehicle with its subsystem templates): the vehicle is an ordinary
multibody ``Model`` built from suspension corners, and ``vehicle_step``
runs tires → driveline and brakes → steering → the multibody solve.  The
step reads nothing on the host (the wheel indices live on the vehicle's
device, the gear is a device tensor), so a CUDA graph can capture it; the
steering writes the motor profile's constant functionally (``_set_steering``
and ``_set_rack`` replace it with a tensor the step computes), which a
capture records like any other kernel.

Suspension template (per corner, "reduced"): chassis →[prismatic z +
TSDA]→ upright →[steer revolute z + angle motor (front only)]→ knuckle
→[revolute y]→ wheel.  "wishbone" builds geometric double-wishbone corners
(``vehicle.suspension``) steered through a rack body and tie rods.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
from torch import Tensor

from chrono_tpu_torch.core import quaternion as Q
from chrono_tpu_torch.core.functions import FConst
from chrono_tpu_torch.physics.builder import SystemBuilder
from chrono_tpu_torch.physics.system import (
    Model, SolverSettings, step_euler_implicit_linearized,
)
from chrono_tpu_torch.utils.tree import (
    fields_as_tensors, static_field, tensor_dataclass,
)
from chrono_tpu_torch.vehicle.driver import DriverInputs
from chrono_tpu_torch.vehicle.powertrain import (
    PowertrainParams, brake_torques, default_engine_map, driveline_torques,
)
from chrono_tpu_torch.vehicle.tire import TMeasyParams, tmeasy_forces

DRIVEN = {"AWD": [1.0, 1.0, 1.0, 1.0], "RWD": [0.0, 0.0, 1.0, 1.0],
          "FWD": [1.0, 1.0, 0.0, 0.0]}


def body_index(bodies: tuple, model: Model) -> Tensor:
    """The body indices as an int64 tensor on the model's device (made once
    at build: a step that made it would copy from the host)."""
    return torch.tensor(bodies, dtype=torch.long,
                        device=model.props.inv_mass.device)


@tensor_dataclass
class WheeledVehicle:
    """The assembled vehicle: multibody model + vehicle-level parameters."""

    model: Model
    tire: TMeasyParams
    powertrain: PowertrainParams
    max_steer_angle: Tensor            # rad at full steering input
    max_brake_torque: Tensor
    ackermann: Tensor                  # 0 = parallel, 1 = full Ackermann
    wheelbase: Tensor
    track: Tensor
    aero_cda: Tensor                   # ½ρ·Cd·A lumped coefficient
    steer_rack_gain: Tensor = 0.0      # rack travel per steer rad (wishbone)
    chassis: int = static_field(default=0)
    wheels: tuple = static_field(default=())      # body indices FL, FR, RL, RR
    knuckles: tuple = static_field(default=())    # steered bodies (front)
    wheel_index: Tensor = dataclasses.field(init=False, repr=False,
                                            compare=False)

    def __post_init__(self):
        object.__setattr__(self, "wheel_index",
                           body_index(self.wheels, self.model))


class VehicleStepOut(NamedTuple):
    state: object
    tire_fz: Tensor
    engine_speed: Tensor
    gear: Tensor


def _default_powertrain(driven, like):
    speeds, torques, losses = default_engine_map(dtype=like.dtype,
                                                 device=like.device)
    return PowertrainParams(
        map_speed=speeds, map_torque=torques, map_losses=losses,
        max_speed=650.0,
        gear_ratios=torch.tensor([3.5, 2.2, 1.5, 1.0, 0.75], dtype=like.dtype,
                                 device=like.device),
        shift_speeds=torch.tensor([5.0, 10.0, 16.0, 23.0], dtype=like.dtype,
                                  device=like.device),
        final_drive=3.7,
        driven_wheels=torch.tensor(DRIVEN[driven], dtype=like.dtype,
                                   device=like.device))


def _finish(model, chassis, wheels, knuckles, wheel_radius, wheel_width,
            chassis_mass, tire, powertrain, driven, max_steer_angle,
            max_brake_torque, ackermann, wheelbase, track, rack_gain=0.0):
    """The ``WheeledVehicle`` on the model's device, every parameter a
    tensor there (the step then copies nothing from the host)."""
    like = model.props.inv_mass
    if tire is None:
        tire = TMeasyParams(radius=wheel_radius, width=wheel_width,
                            Fz0=chassis_mass * 9.81 / 4)
    if powertrain is None:
        powertrain = _default_powertrain(driven, like)
    return fields_as_tensors(WheeledVehicle(
        model=model, tire=fields_as_tensors(tire, like),
        powertrain=fields_as_tensors(powertrain, like),
        max_steer_angle=max_steer_angle, max_brake_torque=max_brake_torque,
        ackermann=ackermann, wheelbase=wheelbase, track=track, aero_cda=1.2,
        steer_rack_gain=rack_gain, chassis=chassis, wheels=tuple(wheels),
        knuckles=tuple(knuckles)), like)


def build_wheeled_vehicle(
    chassis_mass=2000.0,
    chassis_inertia=(900.0, 3000.0, 3200.0),
    wheelbase=3.0,
    track=1.8,
    cg_height=0.9,
    wheel_mass=40.0,
    wheel_radius=0.35,
    wheel_width=0.25,
    wheel_inertia_spin=2.0,
    suspension_k=90000.0,
    suspension_c=9000.0,
    suspension_travel_preload=None,
    tire: TMeasyParams | None = None,
    powertrain: PowertrainParams | None = None,
    max_steer_angle=0.45,
    max_brake_torque=3000.0,
    driven="AWD",
    suspension="reduced",
    dtype=torch.float32,
    device=None,
):
    """Assemble a 4-wheel vehicle at the origin, +x forward; returns
    ``(WheeledVehicle, BodyState)`` on the card unless ``device`` names
    another.

    ``suspension``: "reduced" (prismatic-travel corner) or "wishbone"
    (geometric double-wishbone corners of ``vehicle.suspension``, steered
    through a rack body and tie rods: camber, caster and Ackermann come
    from the linkage geometry).
    """
    if suspension == "wishbone":
        return _build_wishbone_vehicle(
            chassis_mass, chassis_inertia, wheelbase, track, cg_height,
            wheel_mass, wheel_radius, wheel_width, wheel_inertia_spin,
            tire, powertrain, max_steer_angle, max_brake_torque, driven,
            dtype, device)
    b = SystemBuilder(dtype=dtype, device=device)
    chassis = b.add_body(mass=chassis_mass, inertia=chassis_inertia,
                         pos=(0, 0, cg_height), name="chassis")
    a, s = wheelbase / 2, track / 2
    corners = [(+a, +s, "FL", True), (+a, -s, "FR", True),
               (-a, +s, "RL", False), (-a, -s, "RR", False)]
    wheels, knuckles = [], []
    z_w = wheel_radius
    m_up = 30.0
    for (cx, cy, name, steered) in corners:
        upright = b.add_body(mass=m_up, inertia=(1.0, 1.0, 1.0),
                             pos=(cx, cy, z_w), name=f"upright_{name}")
        # suspension travel along chassis z + spring-damper
        b.add_joint("prismatic", chassis, upright, world_pos=(cx, cy, z_w),
                    world_axis=(0, 0, 1))
        # spring preloaded to carry the static corner load
        corner_load = (chassis_mass / 4 + m_up +
                       (20.0 if steered else 0.0)) * 9.81
        b.add_tsda(chassis, upright, pa_world=(cx, cy, cg_height),
                   pb_world=(cx, cy, z_w), k=suspension_k, c=suspension_c,
                   rest_length=(cg_height - z_w) + corner_load / suspension_k)
        if steered:
            knuckle = b.add_body(mass=20.0, inertia=(0.5, 0.5, 0.5),
                                 pos=(cx, cy, z_w), name=f"knuckle_{name}")
            b.add_motor_rotation_angle(
                upright, knuckle, world_pos=(cx, cy, z_w),
                world_axis=(0, 0, 1), profile=FConst(c=torch.tensor(0.0)))
            hub = knuckle
            knuckles.append(knuckle)
        else:
            hub = upright
        wheel = b.add_body(mass=wheel_mass,
                           inertia=(wheel_inertia_spin * 0.55,
                                    wheel_inertia_spin,
                                    wheel_inertia_spin * 0.55),
                           pos=(cx, cy, z_w), name=f"wheel_{name}")
        b.add_joint("revolute", hub, wheel, world_pos=(cx, cy, z_w),
                    world_axis=(0, 1, 0))
        wheels.append(wheel)

    model, state = b.finalize()
    vehicle = _finish(model, chassis, wheels, knuckles, wheel_radius,
                      wheel_width, chassis_mass, tire, powertrain, driven,
                      max_steer_angle, max_brake_torque, 1.0, wheelbase,
                      track)
    return vehicle, state


def _build_wishbone_vehicle(chassis_mass, chassis_inertia, wheelbase, track,
                            cg_height, wheel_mass, wheel_radius, wheel_width,
                            wheel_inertia_spin, tire, powertrain,
                            max_steer_angle, max_brake_torque, driven, dtype,
                            device):
    from chrono_tpu_torch.vehicle.suspension import (
        WishboneHardpoints, add_double_wishbone_corner,
    )

    b = SystemBuilder(dtype=dtype, device=device)
    chassis = b.add_body(mass=chassis_mass, inertia=chassis_inertia,
                         pos=(0, 0, cg_height), name="chassis")
    a, s = wheelbase / 2, track / 2
    z_w = wheel_radius
    r = wheel_radius
    hp = WishboneHardpoints(
        spindle=(0.0, 0.0, 0.0),
        uca_front=(0.30 * r / 0.35, -0.9 * s, 0.55 * r),
        uca_rear=(-0.30 * r / 0.35, -0.9 * s, 0.55 * r),
        uca_ball=(0.0, -0.25 * r, 0.62 * r),
        lca_front=(0.35 * r / 0.35, -0.95 * s, -0.45 * r),
        lca_rear=(-0.35 * r / 0.35, -0.95 * s, -0.45 * r),
        lca_ball=(0.0, -0.18 * r, -0.5 * r),
        spring_chassis=(0.0, -0.6 * s, 1.3 * r),
        spring_lca=(0.0, -0.5 * s, -0.4 * r),
        tierod_chassis=(0.5 * r, -0.85 * s, 0.0),
        tierod_upright=(0.45 * r, -0.25 * r, 0.0),
        masses=dict(uca=6.0, lca=8.0, upright=25.0, wheel=wheel_mass),
        inertias=dict(uca=(0.03, 0.03, 0.05), lca=(0.05, 0.05, 0.08),
                      upright=(0.4, 0.4, 0.4),
                      wheel=(wheel_inertia_spin * 0.55, wheel_inertia_spin,
                             wheel_inertia_spin * 0.55)),
        spring_k=chassis_mass * 50.0,    # ~5 Hz corner with lever ratio
        spring_c=chassis_mass * 4.0)

    # front steering rack: one body sliding laterally on the chassis with a
    # position motor; the tie rods do the rest (Ackermann from geometry)
    rack_x = a + 0.5 * r
    rack = b.add_body(mass=5.0, inertia=(0.05, 0.05, 0.05),
                      pos=(rack_x, 0, z_w), name="rack")
    b.add_motor_linear_position(chassis, rack, world_pos=(rack_x, 0, z_w),
                                world_axis=(0, 1, 0),
                                profile=FConst(c=torch.tensor(0.0)),
                                add_joint=True)

    wheels, uprights = [], []
    for (cx, side, name, steered) in ((+a, +1, "FL", True),
                                      (+a, -1, "FR", True),
                                      (-a, +1, "RL", False),
                                      (-a, -1, "RR", False)):
        corner = add_double_wishbone_corner(
            b, chassis, (cx, side * s, z_w), hp, side=side,
            steered_rack_body=rack if steered else None)
        wheels.append(corner.wheel)
        if steered:
            uprights.append(corner.upright)

    model, state = b.finalize()

    # steer-arm radius: the distance of the tie-rod anchor from the kingpin
    # axis (UCA ball ↔ LCA ball line) sets the rack travel per steer angle
    kp_top = np.asarray(hp.uca_ball)
    kp_bot = np.asarray(hp.lca_ball)
    axis = kp_top - kp_bot
    axis = axis / np.linalg.norm(axis)
    tr = np.asarray(hp.tierod_upright) - kp_bot
    arm = np.linalg.norm(tr - np.dot(tr, axis) * axis)

    vehicle = _finish(model, chassis, wheels, uprights, wheel_radius,
                      wheel_width, chassis_mass, tire, powertrain, driven,
                      max_steer_angle, max_brake_torque, 0.0, wheelbase,
                      track, rack_gain=float(arm))
    return vehicle, state


def _set_motor_constant(model: Model, kind: str, c) -> Model:
    md = model.motors[kind]
    motors = dict(model.motors)
    motors[kind] = md.replace(profile=md.profile.replace(c=c))
    return model.replace(motors=motors)


def _set_rack(model: Model, disp) -> Model:
    """Write the steering-rack displacement into the lin_pos motor
    profile."""
    shape = model.motors["lin_pos"].profile.c.shape
    return _set_motor_constant(model, "lin_pos", disp.expand(shape))


def _set_steering(model: Model, angles: Tensor) -> Model:
    """Write per-knuckle steer angles into the rot_angle motor profiles."""
    return _set_motor_constant(model, "rot_angle", angles)


def ackermann_angles(steer_input, max_angle, wheelbase, track, ackermann):
    """Left/right steer angles with the Ackermann correction."""
    delta = steer_input * max_angle
    # ideal Ackermann: cot(δo) − cot(δi) = track/wheelbase
    tan_d = torch.tan(torch.abs(delta) + 1e-9)
    inner = torch.atan(wheelbase * tan_d / (wheelbase - 0.5 * track * tan_d))
    outer = torch.atan(wheelbase * tan_d / (wheelbase + 0.5 * track * tan_d))
    inner = torch.abs(delta) + (inner - torch.abs(delta)) * ackermann
    outer = torch.abs(delta) + (outer - torch.abs(delta)) * ackermann
    # steering left (+): the left wheel is the inner one
    left = torch.where(delta >= 0, inner, outer) * torch.sign(delta)
    right = torch.where(delta >= 0, outer, inner) * torch.sign(delta)
    return torch.stack([left, right])


def vehicle_step(vehicle: WheeledVehicle, state, inputs: DriverInputs,
                 terrain_height_fn, t, h,
                 settings: SolverSettings = SolverSettings(solver="direct")):
    """One fused vehicle step: tires → driveline/brakes → steering → MBS.

    The loads are added with ``index_add`` at the wheel indices, which are
    distinct, so each entry gets one addend and the sum is the same on
    every run.
    """
    w_idx = vehicle.wheel_index
    ch = vehicle.chassis
    wx, wq, wv, ww = (state.x[w_idx], state.q[w_idx], state.v[w_idx],
                      state.w[w_idx])

    # tires
    f_tire, t_spin, fz = tmeasy_forces(vehicle.tire, wx, wq, wv, ww,
                                       terrain_height_fn)

    # driveline + brakes
    speed = torch.linalg.norm(state.v[ch, :2])
    omegas = ww[:, 1]
    t_drive, engine_speed, gear = driveline_torques(
        vehicle.powertrain, omegas, speed, inputs.throttle)
    t_brake = brake_torques(inputs.braking, vehicle.max_brake_torque, omegas)

    # steering: wishbone build → rack displacement; reduced → knuckle motors
    if "lin_pos" in vehicle.model.motors:
        disp = (inputs.steering * vehicle.max_steer_angle
                * vehicle.steer_rack_gain)
        model = _set_rack(vehicle.model, disp)
    else:
        angles = ackermann_angles(inputs.steering, vehicle.max_steer_angle,
                                  vehicle.wheelbase, vehicle.track,
                                  vehicle.ackermann)
        model = _set_steering(vehicle.model, angles)

    # external loads
    n = model.n_bodies
    e_y = torch.eye(3, dtype=state.x.dtype, device=state.x.device)[1]
    f_ext = state.x.new_zeros((n, 3)).index_add(0, w_idx, f_tire)
    spin_t = t_spin + t_drive + t_brake
    tau_ext = state.x.new_zeros((n, 3)).index_add(0, w_idx,
                                                  spin_t[:, None] * e_y)
    # aero drag on the chassis
    v_ch = state.v[ch]
    f_ext[ch] += -vehicle.aero_cda * torch.linalg.norm(v_ch) * v_ch
    # driveline reaction torque on the chassis (about the wheel spin axes)
    tau_ext[ch] += Q.qrotate_inv(
        state.q[ch],
        torch.sum(-(t_drive + t_brake)[:, None] * Q.qrotate(wq, e_y), dim=0))

    new_state, _ = step_euler_implicit_linearized(
        model, state, t, h, settings, f_ext=f_ext, tau_ext=tau_ext)
    return VehicleStepOut(state=new_state, tire_fz=fz,
                          engine_speed=engine_speed, gear=gear)
