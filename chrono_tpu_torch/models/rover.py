"""Planetary rovers: a Viper-scale 4-wheel rover and a Curiosity-class
6-wheel rocker-bogie, driven on SCM soil.

Counterpart of ``chrono_tpu/models/rover.py`` (the reference's viper and
curiosity robots): per-wheel speed motors on the multibody core;
Curiosity's rocker differential is the reference's shafts idiom (one shaft
per rocker and one on the chassis, bound by ChShaftsBody rows and tied by
a ChShaftsPlanetary row).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import Tensor

from chrono_tpu_torch.core.functions import FConst
from chrono_tpu_torch.physics.builder import SystemBuilder
from chrono_tpu_torch.physics.system import (
    Model, SolverSettings, step_euler_implicit_linearized,
)
from chrono_tpu_torch.utils.tree import static_field, tensor_dataclass
from chrono_tpu_torch.vehicle.terrain import scm_wheel_forces
from chrono_tpu_torch.vehicle.wheeled import body_index


@tensor_dataclass
class Rover:
    model: Model
    wheel_radius: Tensor
    wheel_width: Tensor
    chassis: int = static_field(default=0)
    wheels: tuple = static_field(default=())
    wheel_index: Tensor = dataclasses.field(init=False, repr=False,
                                            compare=False)

    def __post_init__(self):
        object.__setattr__(self, "wheel_index",
                           body_index(self.wheels, self.model))


def _rover(model, wheel_radius, wheel_width, chassis, wheels):
    like = model.props.inv_mass
    return Rover(model=model,
                 wheel_radius=torch.tensor(wheel_radius, dtype=like.dtype,
                                           device=like.device),
                 wheel_width=torch.tensor(wheel_width, dtype=like.dtype,
                                          device=like.device),
                 chassis=chassis, wheels=tuple(wheels))


def create_rover(body_mass=440.0, wheel_mass=12.0, wheel_radius=0.25,
                 wheel_width=0.2, wheelbase=1.6, track=1.2,
                 clearance=0.35, gravity=(0, 0, -9.81), dtype=torch.float32,
                 device=None):
    """A Viper-scale 4-wheel rover; each wheel gets a speed motor.  On the
    card unless ``device`` names another."""
    b = SystemBuilder(dtype=dtype, device=device)
    b.set_gravity(gravity)
    chassis = b.add_body(
        mass=body_mass, inertia=(60.0, 100.0, 120.0),
        pos=(0, 0, clearance + wheel_radius), name="chassis")
    a, s = wheelbase / 2, track / 2
    wheels = []
    for (cx, cy, name) in [(a, s, "FL"), (a, -s, "FR"),
                           (-a, s, "RL"), (-a, -s, "RR")]:
        # suspension upright with travel + spring
        up = b.add_body(mass=6.0, inertia=(0.3, 0.3, 0.3),
                        pos=(cx, cy, wheel_radius), name=f"up_{name}")
        b.add_joint("prismatic", chassis, up, world_pos=(cx, cy, wheel_radius),
                    world_axis=(0, 0, 1))
        load = (body_mass / 4 + 6 + wheel_mass) * abs(gravity[2])
        b.add_tsda(chassis, up,
                   pa_world=(cx, cy, clearance + wheel_radius),
                   pb_world=(cx, cy, wheel_radius),
                   k=25000.0, c=2500.0,
                   rest_length=clearance + load / 25000.0)
        w = b.add_body(mass=wheel_mass, inertia=(0.3, 0.5, 0.3),
                       pos=(cx, cy, wheel_radius), name=f"wheel_{name}")
        b.add_motor_rotation_speed(up, w, world_pos=(cx, cy, wheel_radius),
                                   world_axis=(0, 1, 0),
                                   profile=FConst(c=torch.tensor(0.0)))
        wheels.append(w)
    model, state = b.finalize()
    return _rover(model, wheel_radius, wheel_width, chassis, wheels), state


def set_wheel_speeds(rover: Rover, speeds) -> Rover:
    """Command per-wheel angular speeds (skid steering: differential
    left/right speeds)."""
    md = rover.model.motors["rot_speed"]
    c = torch.as_tensor(speeds, dtype=md.fa_pos.dtype,
                        device=md.fa_pos.device)
    motors = dict(rover.model.motors)
    motors["rot_speed"] = md.replace(profile=md.profile.replace(c=c))
    return rover.replace(model=rover.model.replace(motors=motors))


def rover_step_scm(rover: Rover, state, scm_params, scm_state, t, h,
                   settings=SolverSettings(solver="direct")):
    """One rover step on SCM soil → ``(state, scm_state, info)``.  The wheel
    indices are distinct, so the ``index_add`` of the loads gives each
    entry one addend."""
    w_idx = rover.wheel_index
    out = scm_wheel_forces(
        scm_params, scm_state,
        state.x[w_idx], state.q[w_idx], state.v[w_idx], state.w[w_idx],
        wheel_radius=rover.wheel_radius, wheel_width=rover.wheel_width)
    n = rover.model.n_bodies
    e_y = torch.eye(3, dtype=state.x.dtype, device=state.x.device)[1]
    f_ext = state.x.new_zeros((n, 3)).index_add(0, w_idx, out.force)
    tau_ext = state.x.new_zeros((n, 3)).index_add(
        0, w_idx, out.torque_spin[:, None] * e_y)
    new_state, info = step_euler_implicit_linearized(
        rover.model, state, t, h, settings, f_ext=f_ext, tau_ext=tau_ext)
    return new_state, out.new_state, info


def create_curiosity(body_mass=500.0, wheel_mass=10.0, wheel_radius=0.25,
                     wheel_width=0.25, track=2.2, clearance=0.6,
                     gravity=(0, 0, -9.81), dtype=torch.float32, device=None):
    """Curiosity-class 6-wheel rocker-bogie rover, on the card unless
    ``device`` names another.

    Per side a ROCKER pivots on the chassis (revolute about y) and carries
    the front wheel and a BOGIE (revolute about y) that carries the middle
    and rear wheels.  The rockers are tied through the body-mounted
    differential: one shaft per rocker about the pivot axis and the chassis
    shaft as carrier, Willis ratio ψ = 1, so 2·ω_chassis = ω_L + ω_R and
    the body pitch averages the terrain."""
    b = SystemBuilder(dtype=dtype, device=device)
    b.set_gravity(gravity)
    r = wheel_radius
    s = track / 2
    zc = clearance + r                   # chassis centre height
    chassis = b.add_body(mass=body_mass, inertia=(250.0, 350.0, 400.0),
                         pos=(0, 0, zc), name="chassis")
    # wheel x stations (front, middle, rear) and the pivot points
    xf, xm, xr = 1.1, 0.0, -1.1
    x_rocker_piv, z_piv = 0.45, zc - 0.15      # rocker ↔ chassis
    x_bogie_piv, z_bpiv = -0.5, r + 0.5 * (z_piv - r)   # bogie ↔ rocker

    wheels, rockers = [], []
    for side, sy in (("L", s), ("R", -s)):
        rocker = b.add_body(mass=25.0, inertia=(2.0, 8.0, 8.0),
                            pos=(x_rocker_piv, sy, z_piv),
                            name=f"rocker_{side}")
        b.add_joint("revolute", chassis, rocker,
                    world_pos=(x_rocker_piv, sy, z_piv), world_axis=(0, 1, 0))
        bogie = b.add_body(mass=15.0, inertia=(1.0, 4.0, 4.0),
                           pos=(x_bogie_piv, sy, z_bpiv),
                           name=f"bogie_{side}")
        b.add_joint("revolute", rocker, bogie,
                    world_pos=(x_bogie_piv, sy, z_bpiv), world_axis=(0, 1, 0))
        for (carrier, wx, name) in ((rocker, xf, f"F{side}"),
                                    (bogie, xm, f"M{side}"),
                                    (bogie, xr, f"R{side}")):
            w = b.add_body(mass=wheel_mass, inertia=(0.3, 0.5, 0.3),
                           pos=(wx, sy, r), name=f"wheel_{name}")
            b.add_motor_rotation_speed(carrier, w, world_pos=(wx, sy, r),
                                       world_axis=(0, 1, 0),
                                       profile=FConst(c=torch.tensor(0.0)))
            wheels.append(w)
        rockers.append(rocker)

    # differential: shafts bound to the chassis and rockers about local y
    sh_c = b.add_shaft(inertia=0.5)
    sh_l = b.add_shaft(inertia=0.5)
    sh_r = b.add_shaft(inertia=0.5)
    b.add_shaft_body(sh_c, chassis, axis_local=(0, 1, 0))
    b.add_shaft_body(sh_l, rockers[0], axis_local=(0, 1, 0))
    b.add_shaft_body(sh_r, rockers[1], axis_local=(0, 1, 0))
    b.add_shaft_planetary(sh_c, sh_l, sh_r, ratio=1.0)

    model, state = b.finalize()
    return _rover(model, wheel_radius, wheel_width, chassis, wheels), state
