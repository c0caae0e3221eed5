"""Tracked vehicles: the continuous-band track model.

Counterpart of ``chrono_tpu/vehicle/tracked.py``:

  * each track side is a sprocket shaft (``physics.shafts``) whose spin
    sets the band surface speed v_band = ω R;
  * the track–ground interface is a row of contact patches along the
    footprint; each patch carries a penetration-spring normal load and
    saturated-friction longitudinal and lateral forces from the slip
    between the band surface and the patch's ground velocity (yaw makes
    the patch speeds differ along the footprint: skid-steer resistance);
  * the patch reactions act on the chassis, and their longitudinal sum
    back-torques the sprocket shaft (τ = −R ΣF_x), with rolling
    resistance.

``tracked_step`` evaluates both sides batched over patches and takes one
multibody step with the direct solver.  It reads nothing on the host and
builds no tensor from host data, so a CUDA graph can capture it
(``m113_acceleration_run`` replays one).
"""

from __future__ import annotations

from typing import NamedTuple, Union

import torch
from torch import Tensor

from chrono_tpu_torch.core import quaternion as Q
from chrono_tpu_torch.physics.builder import SystemBuilder
from chrono_tpu_torch.physics.system import (
    Model, SolverSettings, step_euler_implicit_linearized,
)
from chrono_tpu_torch.utils.tree import static_field, tensor_dataclass

Num = Union[float, Tensor]


@tensor_dataclass
class TrackParams:
    """Per-side band-track parameters (M113-class defaults)."""

    sprocket_radius: Num = 0.24
    track_length: Num = 2.6       # footprint length on the ground
    track_width: Num = 0.36
    n_patches: int = static_field(default=7)
    kz: Num = 4.0e5               # patch normal stiffness [N/m]
    cz: Num = 3.0e4               # patch normal damping
    mu_lon: Num = 0.9             # longitudinal friction (grouser grip)
    mu_lat: Num = 0.7             # lateral (skid) friction
    slip_v0: Num = 0.15           # slip-velocity scale for saturation [m/s]
    rolling_resistance: Num = 0.02


@tensor_dataclass
class TrackedVehicle:
    model: Model
    track: TrackParams
    chassis: int = static_field(default=0)
    sprockets: tuple = static_field(default=())   # (left, right) shaft idx
    half_track: Num = 0.95                        # lateral offset of bands
    ride_height: Num = 0.3                        # chassis COM above ground


def build_tracked_vehicle(chassis_mass=9000.0,
                          chassis_inertia=(8000.0, 25000.0, 28000.0),
                          sprocket_inertia=15.0, half_track=0.95,
                          ride_height=0.45, track=TrackParams(),
                          pos=(0.0, 0.0, None), dtype=torch.float32,
                          device=None):
    """Assemble chassis + two sprocket shafts (M113-class scale); returns
    ``(TrackedVehicle, BodyState)`` on the card unless ``device`` names
    another."""
    bld = SystemBuilder(dtype=dtype, device=device)
    bld.set_gravity((0, 0, -9.81))
    z0 = ride_height if pos[2] is None else pos[2]
    chassis = bld.add_body(mass=chassis_mass, inertia=chassis_inertia,
                           pos=(pos[0], pos[1], z0))
    left = bld.add_shaft(inertia=sprocket_inertia)
    right = bld.add_shaft(inertia=sprocket_inertia)
    model, state = bld.finalize()

    def t(v):
        return torch.as_tensor(v, dtype=dtype, device=bld.device)

    veh = TrackedVehicle(model=model, track=track, chassis=chassis,
                         sprockets=(left, right), half_track=t(half_track),
                         ride_height=t(ride_height))
    return veh, state


def _track_forces(veh: TrackedVehicle, state, terrain_height_fn):
    """Patch forces for both sides.

    Returns (f_chassis_world (3,), tau_chassis_local (3,),
             tau_sprocket (2,), fz_total (2,))."""
    tp = veh.track
    ch = veh.chassis
    x_c = state.x[ch]
    q_c = state.q[ch]
    v_c = state.v[ch]
    w_l = state.w[ch]                       # body-local
    R = Q.q_to_matrix(q_c)
    # flatten to the ground plane (tracks work in the yaw frame)
    e_lon = torch.stack([R[0, 0], R[1, 0], torch.zeros_like(R[2, 0])])
    e_lon = e_lon / torch.clamp_min(torch.linalg.norm(e_lon), 1e-9)
    e_lat = torch.stack([-e_lon[1], e_lon[0], torch.zeros_like(e_lon[0])])
    ez = torch.eye(3, dtype=x_c.dtype, device=x_c.device)[2]

    n_p = tp.n_patches
    s = (torch.arange(n_p, dtype=x_c.dtype, device=x_c.device) / (n_p - 1)
         - 0.5) * tp.track_length                    # along the track
    w_world = Q.qrotate(q_c, w_l)

    def side_patches(side, w_shaft):
        py = side * veh.half_track
        p_local = s[:, None] * e_lon[None, :] + py * e_lat[None, :]
        p_world = x_c[None, :] + p_local
        z_ground = terrain_height_fn(p_world[:, :2])
        pen = z_ground + veh.ride_height - p_world[:, 2]
        # patch velocity (chassis heave + pitch + roll)
        v_pt = v_c[None, :] + torch.linalg.cross(
            w_world[None, :].expand_as(p_local), p_local, dim=-1)
        # each patch carries its share of the track stiffness
        fz = torch.clamp_min((tp.kz * pen - tp.cz * v_pt[:, 2]) / n_p, 0.0)
        in_contact = pen > 0

        v_band = w_shaft * tp.sprocket_radius
        v_lon = torch.sum(v_pt * e_lon[None, :], dim=1)
        v_lat = torch.sum(v_pt * e_lat[None, :], dim=1)
        slip_lon = v_band - v_lon
        fx = tp.mu_lon * fz * torch.tanh(slip_lon / tp.slip_v0)
        fy = -tp.mu_lat * fz * torch.tanh(v_lat / tp.slip_v0)
        zero = torch.zeros_like(fz)
        fx = torch.where(in_contact, fx, zero)
        fy = torch.where(in_contact, fy, zero)
        fzc = torch.where(in_contact, fz, zero)
        f_w = (fx[:, None] * e_lon[None, :] + fy[:, None] * e_lat[None, :]
               + fzc[:, None] * ez[None, :])
        # torque about the chassis COM (world)
        tau_w = torch.sum(torch.linalg.cross(p_local, f_w, dim=-1), dim=0)
        # sprocket back-torque + rolling resistance
        tau_s = (-tp.sprocket_radius * torch.sum(fx)
                 - tp.rolling_resistance * tp.sprocket_radius
                 * torch.sum(fzc) * torch.tanh(w_shaft / 0.5))
        return torch.sum(f_w, dim=0), tau_w, tau_s, torch.sum(fzc)

    w_left = state.w[veh.sprockets[0], 2]
    w_right = state.w[veh.sprockets[1], 2]
    fL, tL, tsL, fzL = side_patches(1.0, w_left)
    fR, tR, tsR, fzR = side_patches(-1.0, w_right)

    f_tot = fL + fR
    tau_local = Q.qrotate_inv(q_c, tL + tR)
    return f_tot, tau_local, torch.stack([tsL, tsR]), torch.stack([fzL, fzR])


class TrackedStepOut(NamedTuple):
    state: object
    fz: Tensor           # (2,) per-side normal load
    sprocket_w: Tensor   # (2,)


def tracked_step(veh: TrackedVehicle, state, torques, terrain_height_fn,
                 h, settings=SolverSettings(solver="direct")):
    """One step: track patch forces → chassis + sprocket loads → MBS.

    ``torques``: (2,) drive torque on the (left, right) sprockets —
    differential torques skid-steer the vehicle.
    """
    f_tr, tau_tr, tau_spr, fz = _track_forces(veh, state, terrain_height_fn)
    n = veh.model.n_bodies
    f_ext = state.x.new_zeros((n, 3))
    f_ext[veh.chassis] = f_tr
    tau_ext = state.x.new_zeros((n, 3))
    tau_ext[veh.chassis] = tau_tr
    for k, spr in enumerate(veh.sprockets):
        tau_ext[spr, 2] += torques[k] + tau_spr[k]
    new_state, _ = step_euler_implicit_linearized(
        veh.model, state, state.x.new_zeros(()), h, settings,
        f_ext=f_ext, tau_ext=tau_ext)
    return TrackedStepOut(
        state=new_state, fz=fz,
        sprocket_w=torch.stack([new_state.w[veh.sprockets[0], 2],
                                new_state.w[veh.sprockets[1], 2]]))
