"""ISPH: implicit (incompressible) SPH by pressure projection.

Counterpart of ``chrono_tpu/fsi/sph/isph.py`` on the neighbour list of
``dem.neighbors``:

1. predictor: v* = v + dt (Morris viscosity with Adami ghosts + gravity)
   (:func:`viscous_predictor`);
2. the pressure Poisson equation −∇²p = −(ρ0/dt) ∇·v* − β (ρ0 − ρ_sum)/dt²,
   matrix-free (a masked (N, K) gather and row reduction a product), with
   free-surface markers pinned at p = 0 and a pure-Neumann fallback for a
   confined fluid, solved with Jacobi-preconditioned CG or BiCGStab from
   ``solver.krylov`` (their loop tests are read on the host once an
   iteration);
3. correction: v⁺ = v* − (dt/ρ0) ∇p, then x += dt v⁺ with XSPH.

:func:`isph_solid_reaction` is the fluid reaction on the solid markers
that the BCE reduction takes; :func:`suggest_isph_dt` has no acoustic
bound.
"""

from __future__ import annotations

import math

import torch

from chrono_tpu_torch.collision.cell_list import GridSpec, wrap_positions
from chrono_tpu_torch.fsi.sph import wcsph
from chrono_tpu_torch.fsi.sph.wcsph import rowsum
from chrono_tpu_torch.fsi.sph.kernels import KERNELS, grad_w
from chrono_tpu_torch.fsi.sph.state import FLUID, SPHParams, SPHState
from chrono_tpu_torch.solver.krylov import solve_bicgstab, solve_cg
from chrono_tpu_torch.utils.device import resolve_device


def _pair_geometry(params: SPHParams, grid: GridSpec, pos, nbr_idx,
                   geo=None):
    _, dw_fn, _ = KERNELS[params.kernel]
    j, d, r2, r = wcsph.pair_geometry(params, grid, pos, nbr_idx, geo)
    return j, d, r2, grad_w(dw_fn, d, r, params.h)


def _morris(params, d, gw, r2, rho_i, rho_j, v_ij, valid):
    """Σ_j m 2μ/(ρ_i ρ_j) (d·∇W)/(r² + 0.01 h²) v_ij over valid slots."""
    m = wcsph.particle_mass(params)
    coef = m * 2.0 * params.mu / (rho_i * rho_j) * torch.sum(
        d * gw, dim=-1) / (r2 + 0.01 * params.h ** 2)
    return rowsum(valid, coef[..., None] * v_ij)


def _pressure_gradient(params, p, j, gw, valid):
    """−Σ_j m (p_i + p_j)/ρ0² ∇W over valid slots."""
    m = wcsph.particle_mass(params)
    pterm = (p[:, None] + p[j]) / (params.rho0 * params.rho0)
    return -rowsum(valid, (m * pterm)[..., None] * gw)


def viscous_predictor(params: SPHParams, grid: GridSpec, pos, vel, rho,
                      kind, nbr_idx, nbr_valid, body_acc=None, geo=None):
    """The v* rate: Morris laminar viscosity (Adami no-slip ghosts) and
    gravity on fluid markers; zero on solid markers.  ``geo``: the pair
    geometry at ``pos`` (``wcsph.pair_geometry``), if already built."""
    is_fluid = kind == FLUID
    geo = wcsph.pair_geometry(params, grid, pos, nbr_idx, geo)
    _, _, v_bc = wcsph.adami_bc(params, grid, pos, vel, rho, kind, nbr_idx,
                                nbr_valid, body_acc, geo)
    j, d, r2, gw = _pair_geometry(params, grid, pos, nbr_idx, geo)
    v_ij = vel[:, None, :] - torch.where(is_fluid[j][..., None], vel[j],
                                         v_bc[j])
    dv = _morris(params, d, gw, r2, rho[:, None], rho[j], v_ij, nbr_valid)
    dv = dv + wcsph.gravity(params, pos)[None, :]
    return torch.where(is_fluid[:, None], dv, 0.0)


def isph_substep(params: SPHParams, grid: GridSpec, state: SPHState,
                 body_acc=None, beta_density: float = 0.5,
                 cg_iters: int = 200, cg_tol: float = 1e-5,
                 clamp_tensile: bool = True, linear_solver: str = "cg"):
    """One projection step on the state's neighbour list.  Returns
    ``(state⁺, pressure, iterations)``."""
    h_dt = params.dt
    m = wcsph.particle_mass(params)
    is_fluid = state.kind == FLUID
    pos, vel, rho, kind = state.pos, state.vel, state.rho, state.kind
    nbr_idx, nbr_valid = state.nbr.idx, state.nbr.valid
    geo = wcsph.pair_geometry(params, grid, pos, nbr_idx)

    dv_visc = viscous_predictor(params, grid, pos, vel, rho, kind, nbr_idx,
                                nbr_valid, body_acc, geo)
    v_star = torch.where(is_fluid[:, None], vel + h_dt * dv_visc, vel)

    j, d, r2, gw = _pair_geometry(params, grid, pos, nbr_idx, geo)
    rho0 = params.rho0
    div = -(m / rho0) * rowsum(nbr_valid, torch.sum(
        (v_star[:, None, :] - v_star[j]) * gw, dim=-1))
    # only compression is a source, capped at 5 %
    rho_sum = wcsph.summation_density(params, grid, pos, kind, nbr_idx,
                                      nbr_valid, geo)
    compression = torch.clamp(rho_sum - rho0, 0.0, 0.05 * rho0)
    src_rho = torch.where(is_fluid, beta_density * compression
                          / (h_dt * h_dt), 0.0)
    b = -(rho0 / h_dt) * div + src_rho

    # free surface = Dirichlet p = 0; a fully confined fluid falls back to
    # the pure-Neumann operator with a range-projected right-hand side
    has_nbr = torch.any(nbr_valid, dim=1)
    n_act = torch.clamp(torch.sum(has_nbr), min=1)
    surface = is_fluid & (rho_sum < 0.88 * rho0)
    confined = (torch.sum(surface) == 0).to(b.dtype)
    interior = has_nbr & ~surface
    b = torch.where(interior, b, 0.0)
    b = b - confined * torch.sum(b) / n_act

    coeffs = -(2.0 * m / rho0) * torch.sum(d * gw, dim=-1) / (
        r2 + 0.01 * params.h ** 2)
    row_sum = rowsum(nbr_valid, coeffs)
    alpha = 1e-8 * torch.sum(row_sum) / n_act + 1e-20
    int_j = interior[j]
    scale = torch.sum(row_sum) / n_act + alpha

    def A(pv):
        diff = pv[:, None] - torch.where(int_j, pv[j], torch.zeros_like(
            coeffs))
        lap = rowsum(nbr_valid, coeffs * diff) + alpha * pv
        return torch.where(interior, lap, scale * pv)

    diag = torch.where(interior, row_sum + alpha, scale)
    dinv = 1.0 / torch.clamp(diag, min=1e-30)
    solve = {"cg": solve_cg, "bicgstab": solve_bicgstab}[linear_solver]
    sol = solve(A, b, Minv=lambda r_: dinv * r_, max_iter=cg_iters,
                tol=cg_tol)
    p = sol.x
    p_min = torch.min(torch.where(has_nbr, p, math.inf))
    p = torch.where(has_nbr, p - confined * p_min, 0.0)
    if clamp_tensile:
        p = torch.clamp(p, min=0.0)

    dv_p = _pressure_gradient(params, p, j, gw, nbr_valid)
    v_new = torch.where(is_fluid[:, None], v_star + h_dt * dv_p, vel)
    vt = wcsph.xsph_velocity(params, grid, pos, v_new, rho, kind, nbr_idx,
                             nbr_valid, geo)
    pos_new = torch.where(is_fluid[:, None], pos + h_dt * vt, pos)
    pos_new = wrap_positions(grid, pos_new)
    # incompressible: ρ stays (ρ_sum feeds only the source term)
    return (state.replace(pos=pos_new, vel=v_new, time=state.time + h_dt),
            p, sol.iterations)


def make_isph_advance_fn(params: SPHParams, grid: GridSpec,
                         beta_density: float = 0.5, cg_iters: int = 200,
                         cg_tol: float = 1e-5, clamp_tensile: bool = True,
                         linear_solver: str = "cg", *, device=None):
    """``advance(state, n_cycles) → (state, overflow, iterations)`` on
    ``device`` (the card unless told otherwise): a list rebuild and
    ``params.rebuild_every`` projection steps a cycle; the largest list
    overflow and Krylov iteration count of the call."""
    from chrono_tpu_torch.fsi.sph.system import rebuild_sph_neighbors

    device = resolve_device(device, "make_isph_advance_fn")

    def advance(state: SPHState, n_cycles: int):
        state = state.to(device)
        ovf = torch.zeros((), dtype=torch.int32, device=device)
        iters = torch.zeros((), dtype=torch.int32, device=device)
        for _ in range(n_cycles):
            state = rebuild_sph_neighbors(params, grid, state)
            for _ in range(params.rebuild_every):
                state, _, it = isph_substep(params, grid, state, None,
                                            beta_density, cg_iters, cg_tol,
                                            clamp_tensile, linear_solver)
                iters = torch.maximum(iters, it)
            ovf = torch.maximum(ovf, state.nbr.overflow)
        return state, ovf, iters

    return advance


def suggest_isph_dt(params: SPHParams, v_max: float = 1.0,
                    safety: float = 0.25) -> float:
    """Advective, viscous and body-force bounds: no acoustic term."""
    h = float(params.h)
    dt_adv = h / max(v_max, 1e-9)
    dt_visc = 0.125 * h * h * float(params.rho0) / max(float(params.mu),
                                                       1e-12)
    g = math.sqrt(sum(float(x) ** 2 for x in params.gravity))
    dt_g = math.sqrt(h / max(g, 1e-12))
    return safety * min(dt_adv, dt_visc, dt_g)


def isph_solid_reaction(params: SPHParams, grid: GridSpec, state: SPHState,
                        p: torch.Tensor) -> torch.Tensor:
    """The fluid reaction acceleration at every marker from the PPE
    pressure: the symmetric pressure gradient and the Morris viscous term
    (with ρ0 for both densities), the solid markers' used by the BCE
    reduction."""
    is_fluid = state.kind == FLUID
    pos, vel, rho = state.pos, state.vel, state.rho
    nbr_idx, nbr_valid = state.nbr.idx, state.nbr.valid
    geo = wcsph.pair_geometry(params, grid, pos, nbr_idx)
    _, _, v_bc = wcsph.adami_bc(params, grid, pos, vel, rho, state.kind,
                                nbr_idx, nbr_valid, None, geo)
    j, d, r2, gw = _pair_geometry(params, grid, pos, nbr_idx, geo)
    dv = _pressure_gradient(params, p, j, gw, nbr_valid)
    v_ij = vel[:, None, :] - torch.where(is_fluid[j][..., None], vel[j],
                                         v_bc[j])
    return dv + _morris(params, d, gw, r2, params.rho0, params.rho0, v_ij,
                        nbr_valid)
