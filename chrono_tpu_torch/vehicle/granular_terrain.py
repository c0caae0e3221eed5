"""Granular (DEM) terrain patch coupled to a multibody vehicle.

Counterpart of ``chrono_tpu/vehicle/granular_terrain.py``
(``make_granular_terrain_state``, ``GranularFSIState``, ``granular_step``,
``make_granular_advance_fn``): the bed is the neighbour-list DEM system of
``dem.system`` (Hertz–Mindlin, history friction, rolling resistance); the
wheels enter as moving solid cylinders (``dem.bc.WheelBCs``, the last B
wall slots) whose poses and velocities are set from the bodies every outer
step, and their reactions come back to the multibody step.

One outer step = wheel kinematics from the body states → neighbour rebuild
→ ``n_substeps`` DEM substeps, the wheel reactions summed over them (a
``dem.system.SubstepBlock``: on the card one CUDA-graph replay, the wheel
poses copied into its static wall tensors) → mean wheel loads moved to
the wheel centres → one implicit-linearised multibody step over the outer
interval (an ``MBSStep``: a CUDA-graph replay on the card with the direct
solver).  The wheel loads reach their bodies through a one-hot row sum,
in a fixed order, with no scatter.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass

import numpy as np
import torch

from chrono_tpu_torch.collision.cell_list import GridSpec
from chrono_tpu_torch.core import quaternion as Q
from chrono_tpu_torch.dem.bc import (
    DEMBoundaries, PlaneBCs, WheelBCs, box_boundaries,
)
from chrono_tpu_torch.dem.params import DEMParams
from chrono_tpu_torch.dem.system import (
    DEMState, SubstepBlock, make_dem_state, rebuild_neighbors,
)
from chrono_tpu_torch.fsi.crm_terrain import MBSStep, _drive_loads
from chrono_tpu_torch.physics.body import BodyState
from chrono_tpu_torch.physics.system import (
    Model, SolverSettings, step_euler_implicit_linearized,
)
from chrono_tpu_torch.utils.device import resolve_device
from chrono_tpu_torch.utils.samplers import hcp_sample_box


def make_granular_terrain_state(params: DEMParams, size, depth,
                                wheel_radius, wheel_width, n_wheels,
                                carve_fn=None, dtype=torch.float32, *,
                                device=None):
    """An open-topped box bed of HCP spheres with ``n_wheels`` wheel slots.

    ``size``: (Lx, Ly); ``depth``: the bed's depth (z from 0);
    ``carve_fn(pts) → keep`` removes particles (pre-sunk wheels).  Returns
    ``(DEMState, GridSpec, DEMBoundaries)`` on ``device`` (the card unless
    told otherwise); the wheels are parked far away until the first step
    sets their poses, so the wall history is sized once."""
    device = resolve_device(device, "make_granular_terrain_state")
    r = float(params.radius)
    Lx, Ly = float(size[0]), float(size[1])
    H = float(depth)
    pts = hcp_sample_box((0.0, 0.0, 0.0), (Lx, Ly, H), r * 1.005)
    if carve_fn is not None:
        pts = pts[np.asarray(carve_fn(pts), bool)]

    box = box_boundaries((0.0, 0.0, 0.0), (Lx, Ly, H + 40 * r), dtype)
    # drop the top plane: box_boundaries gives the three lo planes, then
    # the three hi planes, the top last
    walls = PlaneBCs(**{f.name: getattr(box, f.name)[:5]
                        for f in dataclasses.fields(PlaneBCs)})
    B = int(n_wheels)

    def full(shape, value):
        return torch.full(shape, float(value), dtype=dtype)

    axis = torch.zeros((B, 3), dtype=dtype)
    axis[:, 1] = 1.0
    wheels = WheelBCs(center=full((B, 3), 1e6), axis=axis,
                      radius=full((B,), wheel_radius),
                      half_width=full((B,), float(wheel_width) / 2),
                      vel=full((B, 3), 0.0), omega=full((B, 3), 0.0))
    bcs = DEMBoundaries(planes=walls, wheels=wheels).to(device)
    state = make_dem_state(params, bcs, pts, dtype=dtype, device=device)

    cutoff = 2 * r * (1.0 + params.skin)
    margin = 4 * r
    zmax = H + wheel_radius * 2 + 20 * r
    dims = (int(np.ceil((Lx + 2 * margin) / cutoff)),
            int(np.ceil((Ly + 2 * margin) / cutoff)),
            int(np.ceil((zmax + 2 * margin) / cutoff)))
    grid = GridSpec(origin=(-margin, -margin, -margin), cell_size=cutoff,
                    dims=dims, periodic=(False, False, False))
    return state, grid, bcs


@dataclass(frozen=True)
class GranularFSIState:
    """The vehicle's bodies, the bed and the time (a () tensor)."""

    bodies: BodyState
    terrain: DEMState
    time: torch.Tensor

    def replace(self, **changes) -> "GranularFSIState":
        return dataclasses.replace(self, **changes)

    def to(self, device) -> "GranularFSIState":
        return GranularFSIState(
            bodies=BodyState(*(getattr(self.bodies, f).to(device)
                               for f in "xqvw")),
            terrain=self.terrain.to(device), time=self.time.to(device))


@functools.lru_cache(maxsize=8)
def _unit_y(dtype, device) -> torch.Tensor:
    """The wheels' local spin axis, made once per device."""
    return torch.tensor([0.0, 1.0, 0.0], dtype=dtype, device=device)


def _wheel_index(wheel_bodies, device) -> torch.Tensor:
    wb = torch.as_tensor(wheel_bodies, dtype=torch.long, device=device)
    return wb.reshape(-1)


def granular_step(model: Model, params: DEMParams, bcs: DEMBoundaries,
                  grid: GridSpec, state: GranularFSIState, n_substeps: int,
                  wheel_bodies,
                  mbs_settings: SolverSettings = SolverSettings(
                      solver="direct"),
                  f_ext_fn=None, mbs_step=None, substeps=None):
    """One coupled outer step.  ``wheel_bodies``: the (B,) distinct body
    indices (a list or an int64 tensor on the state's device) whose poses
    drive the wheel walls, in the order of the ``WheelBCs`` rows (the last
    B wall slots).  ``f_ext_fn(t, bodies) → (f_world, tau_local)`` adds
    the caller's loads; ``mbs_step`` (an ``MBSStep``) replaces the eager
    multibody step, and ``info`` is then None; ``substeps`` (a
    ``SubstepBlock`` of ``n_substeps``) runs the DEM substeps, eagerly by
    default.  Returns (state, overflow, info); on the card with a
    ``substeps`` block the terrain holds its buffers until its next
    call."""
    bodies, terrain = state.bodies, state.terrain
    dev, dt = bodies.x.device, bodies.x.dtype
    wb = _wheel_index(wheel_bodies, dev)
    q_w = bodies.q[wb]
    wheels = dataclasses.replace(
        bcs.wheels, center=bodies.x[wb],
        axis=Q.qrotate(q_w, _unit_y(dt, dev)), vel=bodies.v[wb],
        omega=Q.qrotate(q_w, bodies.w[wb]))
    bcs_t = dataclasses.replace(bcs, wheels=wheels)
    B = wb.shape[0]

    terrain = rebuild_neighbors(params, grid, terrain)
    if substeps is None:
        substeps = SubstepBlock(params, n_substeps)
    terrain, (sum_f, sum_t0) = substeps(terrain, bcs_t)
    f_wheel = sum_f[-B:] / n_substeps
    # torque about each wheel centre: τ_c = τ_0 − c × F
    tau_wheel = sum_t0[-B:] / n_substeps - torch.linalg.cross(
        wheels.center, f_wheel, dim=-1)

    # (n_bodies, B) one-hot: each wheel's load onto its body
    onehot = (torch.arange(model.n_bodies, device=dev)[:, None]
              == wb[None, :]).to(dt)[..., None]
    f_b = torch.sum(onehot * f_wheel.to(dt)[None], dim=1)
    tau_b = torch.sum(onehot * Q.qrotate_inv(q_w, tau_wheel.to(dt))[None],
                      dim=1)

    h_outer = params.dt * n_substeps
    f_tot, tau_tot = _drive_loads(f_ext_fn, state.time, bodies, f_b, tau_b)
    if mbs_step is None:
        bodies, info = step_euler_implicit_linearized(
            model, bodies, state.time, h_outer, mbs_settings,
            f_ext=f_tot, tau_ext=tau_tot)
    else:
        bodies, info = mbs_step(bodies, state.time, f_tot, tau_tot), None
    return (GranularFSIState(bodies=bodies, terrain=terrain,
                             time=state.time + h_outer),
            terrain.nbr.overflow, info)


def make_granular_advance_fn(model: Model, params: DEMParams,
                             bcs: DEMBoundaries, grid: GridSpec,
                             n_substeps: int, wheel_bodies,
                             mbs_settings: SolverSettings = SolverSettings(
                                 solver="direct"),
                             f_ext_fn=None, *, device=None):
    """``advance(state, n_outer) → (state, overflow)``: ``n_outer`` calls
    of :func:`granular_step` on ``device`` (the card unless told
    otherwise), the DEM substeps a ``SubstepBlock`` and the multibody step
    an ``MBSStep`` (each one graph replay on the card); ``overflow`` ()
    int32 is the largest list overflow of the call."""
    device = resolve_device(device, "make_granular_advance_fn")
    bcs = bcs.to(device)
    wb = _wheel_index(wheel_bodies, device)
    if len(set(wb.tolist())) != wb.shape[0]:
        raise ValueError("each wheel wall needs a body of its own")
    mbs_step = MBSStep(model, params.dt * n_substeps, mbs_settings)
    substeps = SubstepBlock(params, n_substeps)

    def advance(state: GranularFSIState, n_outer: int):
        state = state.to(device)
        ovf = torch.zeros((), dtype=torch.int32, device=device)
        for _ in range(n_outer):
            state, o, _ = granular_step(model, params, bcs, grid, state,
                                        n_substeps, wb, mbs_settings,
                                        f_ext_fn, mbs_step=mbs_step,
                                        substeps=substeps)
            ovf = torch.maximum(ovf, o)
        return state.replace(terrain=state.terrain.clone()), ovf

    return advance
