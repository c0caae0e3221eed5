"""Coupled fluid–solid interaction: rigid bodies in WCSPH or ISPH.

Counterpart of ``chrono_tpu/fsi/system.py``.  One outer step
(:func:`fsi_step`) runs, in the JAX package's order:

1. the rigid BCE markers moved to their bodies (``bce.update_rigid_markers``);
2. the neighbour list rebuilt (every outer step; ``rebuild_every`` is not
   read here, as in the JAX package);
3. ``n_fluid_substeps`` fluid substeps (``fsi.sph.system.sph_substep``, or
   ``fsi.sph.isph.isph_substep``), the markers held kinematically;
4. the fluid's reaction on the solid markers from one ``wcsph_rhs`` at the
   final state (or ``isph_solid_reaction`` from the last pressure);
5. its reduction to per-body forces and torques (``bce.rigid_body_forces``:
   a segment sum by offsets, no atomics), the torque turned into the body
   frame;
6. one ``step_euler_implicit_linearized`` of the outer interval with those
   loads.

:func:`make_fsi_advance_fn` drives it on a device; with the direct solver
on the card the multibody step is a graph replay
(``fsi.crm_terrain.MBSStep``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from chrono_tpu_torch.collision.cell_list import GridSpec
from chrono_tpu_torch.core import quaternion as Q
from chrono_tpu_torch.fsi import bce
from chrono_tpu_torch.fsi.sph import isph as isph_mod
from chrono_tpu_torch.fsi.sph import wcsph
from chrono_tpu_torch.fsi.sph.state import SPHParams, SPHState
from chrono_tpu_torch.fsi.sph.system import (
    rebuild_sph_neighbors, sph_substep,
)
from chrono_tpu_torch.physics.body import BodyState
from chrono_tpu_torch.physics.system import (
    Model, SolverSettings, step_euler_implicit_linearized,
)
from chrono_tpu_torch.utils.device import resolve_device


@dataclass(frozen=True)
class FSIState:
    """The rigid bodies, the markers and the time (a () tensor)."""

    bodies: BodyState
    fluid: SPHState
    time: torch.Tensor

    def replace(self, **changes) -> "FSIState":
        return dataclasses.replace(self, **changes)

    def to(self, device) -> "FSIState":
        return FSIState(
            bodies=BodyState(*(getattr(self.bodies, f).to(device)
                               for f in "xqvw")),
            fluid=self.fluid.to(device), time=self.time.to(device))


def fsi_step(model: Model, params: SPHParams, grid: GridSpec,
             state: FSIState, h_fluid, n_fluid_substeps: int,
             mbs_settings: SolverSettings = SolverSettings(solver="direct"),
             scheme: str = "wcsph", mbs_step=None):
    """One coupled outer step of ``n_fluid_substeps`` fluid steps and one
    multibody step of ``h_fluid · n_fluid_substeps``.  ``scheme``:
    "wcsph" or "isph".  ``mbs_step`` (an ``MBSStep`` of that interval)
    replaces the eager multibody step; ``info`` is then None.  Returns
    ``(state, info)``."""
    bodies, fluid = state.bodies, state.fluid
    pos, vel = bce.update_rigid_markers(
        fluid.pos, fluid.vel, fluid.kind, fluid.body_id, fluid.bce_local,
        bodies.x, bodies.q, bodies.v, bodies.w)
    fluid = rebuild_sph_neighbors(params, grid,
                                  fluid.replace(pos=pos, vel=vel))
    if scheme == "isph":
        p_last = torch.zeros((fluid.n,), dtype=fluid.pos.dtype,
                             device=fluid.pos.device)
        for _ in range(n_fluid_substeps):
            fluid, p_last, _ = isph_mod.isph_substep(params, grid, fluid)
        dv_dt = isph_mod.isph_solid_reaction(params, grid, fluid, p_last)
    elif scheme == "wcsph":
        for _ in range(n_fluid_substeps):
            fluid = sph_substep(params, grid, fluid)
        # the fluid's reaction: one right-hand side at the final state
        _, dv_dt = wcsph.wcsph_rhs(params, grid, fluid.pos, fluid.vel,
                                   fluid.rho, fluid.kind, fluid.nbr.idx,
                                   fluid.nbr.valid)
    else:
        raise ValueError(f"unknown FSI scheme {scheme!r}")
    f_bodies, tau_world = bce.rigid_body_forces(
        params, dv_dt, fluid.kind, fluid.body_id, fluid.pos, bodies.x,
        model.n_bodies)
    tau_local = Q.qrotate_inv(bodies.q, tau_world)
    h_outer = h_fluid * n_fluid_substeps
    if mbs_step is None:
        bodies, info = step_euler_implicit_linearized(
            model, bodies, state.time, h_outer, mbs_settings,
            f_ext=f_bodies, tau_ext=tau_local)
    else:
        bodies, info = mbs_step(bodies, state.time, f_bodies,
                                tau_local), None
    return FSIState(bodies=bodies, fluid=fluid,
                    time=state.time + h_outer), info


def make_fsi_advance_fn(model: Model, params: SPHParams, grid: GridSpec,
                        n_fluid_substeps: int = 1,
                        mbs_settings: SolverSettings = SolverSettings(
                            solver="direct"),
                        scheme: str = "wcsph", *, device=None):
    """``advance(state, n_outer) → (state, overflow)`` on ``device`` (the
    card unless told otherwise): ``n_outer`` calls of :func:`fsi_step`
    with ``h_fluid = params.dt``, the multibody step an ``MBSStep`` (a
    graph replay on the card with the direct solver).  ``overflow`` () int32
    is the largest neighbour-list overflow of the call's rebuilds (no host
    sync); the JAX advance returns the state alone, as the port's other
    advances it returns the overflow beside it."""
    from chrono_tpu_torch.fsi.crm_terrain import MBSStep

    device = resolve_device(device, "make_fsi_advance_fn")
    if scheme not in ("wcsph", "isph"):
        raise ValueError(f"unknown FSI scheme {scheme!r}")
    mbs_step = MBSStep(model, params.dt * n_fluid_substeps, mbs_settings)

    def advance(state: FSIState, n_outer: int):
        state = state.to(device)
        ovf = torch.zeros((), dtype=torch.int32, device=device)
        for _ in range(n_outer):
            state, _ = fsi_step(model, params, grid, state, params.dt,
                                n_fluid_substeps, mbs_settings, scheme,
                                mbs_step=mbs_step)
            ovf = torch.maximum(ovf, state.fluid.nbr.overflow)
        return state, ovf

    return advance
