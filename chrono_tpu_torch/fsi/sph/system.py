"""SPH fluid system: neighbour management, explicit time integration,
state assembly and time-step bounds.

Counterpart of ``chrono_tpu/fsi/sph/system.py``: ``rebuild_sph_neighbors``
(the neighbour list of ``dem.neighbors`` at the kernel's support),
``sph_substep`` (the Euler, symplectic and RK2 schemes with XSPH, PPST or
no shifting, the periodic wrap and the ρ clip to [0.7, 1.5] ρ0),
``make_sph_advance_fn`` (the gather backend's advance, what
demos/demo_sph_dam_break.py runs), ``make_sph_state`` (fluid,
fixed-boundary and rigid-body BCE markers), ``suggest_sph_dt`` and
``runtime_dt``.  The cell-sorted CUDA sweeps run the dam break through
``fsi.sph.pencil.make_sph_advance_pencil``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from chrono_tpu_torch.collision.cell_list import GridSpec, wrap_positions
from chrono_tpu_torch.dem.neighbors import NeighborList, build_neighbor_list
from chrono_tpu_torch.fsi.sph import wcsph
from chrono_tpu_torch.fsi.sph.kernels import KERNELS
from chrono_tpu_torch.fsi.sph.state import (
    BOUNDARY, FLUID, RIGID_BCE, SPHParams, SPHState,
)
from chrono_tpu_torch.utils.device import resolve_device


def rebuild_sph_neighbors(params: SPHParams, grid: GridSpec,
                          state: SPHState) -> SPHState:
    """The state with its neighbour list rebuilt at the kernel's support
    (``max_per_cell``, ``max_neighbors``)."""
    cutoff = KERNELS[params.kernel][2] * params.h
    return state.replace(nbr=build_neighbor_list(
        grid, state.pos, cutoff, params.max_per_cell, params.max_neighbors))


def sph_substep(params: SPHParams, grid: GridSpec, state: SPHState,
                body_acc=None) -> SPHState:
    """One explicit step of ``params.integrator`` on the state's
    neighbour list; solid markers are not integrated."""
    h = params.dt
    is_fluid = (state.kind == FLUID)[:, None]
    kind, idx, valid = state.kind, state.nbr.idx, state.nbr.valid
    # the pair geometry at state.pos, shared by every pass evaluated there
    geo0 = wcsph.pair_geometry(params, grid, state.pos, idx)

    def rhs(pos, vel, rho, geo=None):
        return wcsph.wcsph_rhs(params, grid, pos, vel, rho, kind, idx, valid,
                               body_acc, geo)

    def transport_velocity(vel, rho):
        """The shifted transport velocity at ``state.pos``."""
        if params.shifting == "xsph":
            return wcsph.xsph_velocity(params, grid, state.pos, vel, rho,
                                       kind, idx, valid, geo0)
        if params.shifting == "ppst":
            return vel + wcsph.ppst_shift(params, grid, state.pos, vel, rho,
                                          kind, idx, valid, geo0) / h
        return vel

    if params.integrator == "euler":
        drho, dv = rhs(state.pos, state.vel, state.rho, geo0)
        vel = torch.where(is_fluid, state.vel + h * dv, state.vel)
        vt = transport_velocity(vel, state.rho)
        pos = torch.where(is_fluid, state.pos + h * vt, state.pos)
        rho = state.rho + h * drho
    elif params.integrator == "symplectic":
        # kick from p(ρⁿ), continuity at the new v, transport with the
        # XSPH weight at ρⁿ
        _, dv = rhs(state.pos, state.vel, state.rho, geo0)
        vel = torch.where(is_fluid, state.vel + h * dv, state.vel)
        drho = wcsph.continuity_rhs(params, grid, state.pos, vel, state.rho,
                                    kind, idx, valid, geo0)
        rho = state.rho + h * drho
        vt = transport_velocity(vel, state.rho)
        pos = torch.where(is_fluid, state.pos + h * vt, state.pos)
    elif params.integrator == "rk2":
        drho1, dv1 = rhs(state.pos, state.vel, state.rho, geo0)
        pos_m = torch.where(is_fluid, state.pos + 0.5 * h * state.vel,
                            state.pos)
        vel_m = torch.where(is_fluid, state.vel + 0.5 * h * dv1, state.vel)
        rho_m = state.rho + 0.5 * h * drho1
        drho2, dv2 = rhs(pos_m, vel_m, rho_m)
        vel = torch.where(is_fluid, state.vel + h * dv2, state.vel)
        rho = state.rho + h * drho2
        vt = transport_velocity(vel, rho)
        pos = torch.where(is_fluid, state.pos + h * vt, state.pos)
    else:
        raise ValueError(f"unknown integrator {params.integrator!r}")

    pos = wrap_positions(grid, pos)
    rho = torch.clamp(rho, 0.7 * params.rho0, 1.5 * params.rho0)
    return state.replace(pos=pos, vel=vel, rho=rho, time=state.time + h)


def make_sph_advance_fn(params: SPHParams, grid: GridSpec,
                        adaptive_dt: bool = False, *, device=None):
    """``advance(state, n_cycles) → (state, overflow)`` on ``device`` (the
    card unless told otherwise); one cycle is a list rebuild and
    ``params.rebuild_every`` substeps, and ``overflow`` () int32 is the
    largest list overflow of the call.

    ``adaptive_dt``: each cycle's step is min(params.dt, ``runtime_dt``)
    at the cycle's start, as a tensor (no host sync)."""
    device = resolve_device(device, "make_sph_advance_fn")

    def advance(state: SPHState, n_cycles: int):
        state = state.to(device)
        ovf = torch.zeros((), dtype=torch.int32, device=device)
        for _ in range(n_cycles):
            state = rebuild_sph_neighbors(params, grid, state)
            p = params
            if adaptive_dt:
                p = params.replace(dt=torch.clamp(runtime_dt(params, state),
                                                  max=params.dt))
            for _ in range(params.rebuild_every):
                state = sph_substep(p, grid, state)
            ovf = torch.maximum(ovf, state.nbr.overflow)
        return state, ovf

    return advance


def runtime_dt(params: SPHParams, state: SPHState,
               safety=0.25) -> torch.Tensor:
    """Per-cycle adaptive step from the current velocity field (Courant
    advective, acoustic and viscous bounds), as a tensor: no host sync."""
    is_fluid = state.kind == FLUID
    speed = torch.sqrt(torch.sum(state.vel**2, dim=-1))
    vmax = torch.max(torch.where(is_fluid, speed, torch.zeros_like(speed)))
    dt_acoustic = params.h / (params.c_s + vmax)
    dt_adv = params.h / torch.clamp(vmax, min=1e-9)
    dt_visc = 0.125 * params.h**2 * params.rho0 / max(params.mu, 1e-12)
    return safety * torch.clamp(torch.minimum(dt_acoustic, dt_adv),
                                max=dt_visc)


def make_sph_state(params: SPHParams, fluid_pts, boundary_pts=None,
                   rigid_pts=None, rigid_body_ids=None, rigid_local=None,
                   fluid_vel=None, flex_pts=None, dtype=torch.float32, *,
                   device) -> SPHState:
    """Assemble the marker population in the JAX package's order: fluid,
    fixed walls, then rigid-body BCE markers (``rigid_pts`` in the world,
    with their body index ``rigid_body_ids`` and body-local offset
    ``rigid_local``), with an empty neighbour list of ``max_neighbors``
    slots.  Flexible BCE markers wait for FEA (ROADMAP Queue 1 item 8) and
    raise."""
    if flex_pts is not None and len(flex_pts):
        raise NotImplementedError(
            "flexible BCE markers are not ported: they wait for FEA "
            "(ROADMAP Queue 1 item 8)")
    fluid_pts = np.asarray(fluid_pts, float)
    chunks, kinds = [fluid_pts], [np.full(len(fluid_pts), FLUID)]
    bodies = [np.full(len(fluid_pts), -1)]
    locals_ = [np.zeros((len(fluid_pts), 3))]
    if boundary_pts is not None and len(boundary_pts):
        boundary_pts = np.asarray(boundary_pts, float)
        chunks.append(boundary_pts)
        kinds.append(np.full(len(boundary_pts), BOUNDARY))
        bodies.append(np.full(len(boundary_pts), -1))
        locals_.append(np.zeros((len(boundary_pts), 3)))
    if rigid_pts is not None and len(rigid_pts):
        rigid_pts = np.asarray(rigid_pts, float)
        chunks.append(rigid_pts)
        kinds.append(np.full(len(rigid_pts), RIGID_BCE))
        bodies.append(np.asarray(rigid_body_ids, int))
        locals_.append(np.asarray(rigid_local, float))
    pos = np.concatenate(chunks)
    n = len(pos)
    vel = np.zeros((n, 3))
    if fluid_vel is not None:
        vel[: len(fluid_pts)] = fluid_vel

    def t(a, dt=dtype):
        return torch.as_tensor(a, dtype=dt, device=device)

    return SPHState(
        pos=t(pos), vel=t(vel),
        rho=torch.full((n,), float(params.rho0), dtype=dtype, device=device),
        kind=t(np.concatenate(kinds), torch.int32),
        body_id=t(np.concatenate(bodies), torch.int32),
        bce_local=t(np.concatenate(locals_)),
        time=torch.zeros((), dtype=dtype, device=device),
        nbr=NeighborList.empty(n, params.max_neighbors, device))


def suggest_sph_dt(params: SPHParams, safety=0.25) -> float:
    """CFL, viscous and body-force bounds (reference computeTimeStep)."""
    h = float(params.h)
    dt_cfl = h / float(params.c_s)
    dt_visc = 0.125 * h * h * float(params.rho0) / max(float(params.mu),
                                                       1e-12)
    g = math.sqrt(sum(float(x) ** 2 for x in params.gravity))
    dt_g = math.sqrt(h / max(g, 1e-12))
    return safety * min(dt_cfl, dt_visc, dt_g)
