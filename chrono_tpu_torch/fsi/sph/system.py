"""SPH fluid system: state assembly and time-step bounds.

Counterpart of part of ``chrono_tpu/fsi/sph/system.py``: ``make_sph_state``
(fluid, fixed-boundary and rigid-body BCE markers), ``suggest_sph_dt`` and
``runtime_dt``.
The gather backend's advance (``make_sph_advance_fn``) is not ported; the
dam break runs on ``fsi.sph.pencil.make_sph_advance_pencil``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from chrono_tpu_torch.fsi.sph.state import (
    BOUNDARY, FLUID, RIGID_BCE, SPHParams, SPHState,
)


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
    ``rigid_local``).  Flexible BCE markers wait for FEA (ROADMAP Queue 1
    item 8) and raise."""
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
        time=torch.zeros((), dtype=dtype, device=device))


def suggest_sph_dt(params: SPHParams, safety=0.25) -> float:
    """CFL, viscous and body-force bounds (reference computeTimeStep)."""
    h = float(params.h)
    dt_cfl = h / float(params.c_s)
    dt_visc = 0.125 * h * h * float(params.rho0) / max(float(params.mu),
                                                       1e-12)
    g = math.sqrt(sum(float(x) ** 2 for x in params.gravity))
    dt_g = math.sqrt(h / max(g, 1e-12))
    return safety * min(dt_cfl, dt_visc, dt_g)
