"""WCSPH right-hand side on the neighbour list: continuity and momentum
with Adami (or Holmes) walls.

Counterpart of ``chrono_tpu/fsi/sph/wcsph.py``, the gather backend's
passes: ``adami_bc`` (pressure, density and no-slip velocity extrapolated
onto solid markers from their fluid neighbours), ``continuity_rhs``,
``wcsph_rhs`` (continuity with δ-SPH diffusion, the symmetric pressure
gradient and laminar or artificial viscosity; on solid markers the fluid
reaction that ``fsi.bce.rigid_body_forces`` reduces), ``xsph_velocity``,
``ppst_shift`` and ``summation_density``.  Each is a masked (N, K) gather
and row reduction over the list of ``dem.neighbors``, in the JAX package's
pair order; all markers share the passes with masks, and the passes at
one state may share its pair geometry (``geo``).  ``particle_mass`` is
the marker mass the BCE reduction reads.  The cell-sorted sweeps of
``ops.cuda.sph_substep`` run the same physics for the dam break's
symplectic, XSPH, cubic, Adami case.
"""

from __future__ import annotations

import torch

from chrono_tpu_torch.collision.cell_list import GridSpec, min_image
from chrono_tpu_torch.fsi.sph.kernels import KERNELS, grad_w
from chrono_tpu_torch.fsi.sph.state import (
    FLUID, SPHParams, tait_density, tait_pressure,
)


def particle_mass(params) -> float:
    """ρ0 · d0³, the mass of one marker."""
    return params.rho0 * params.d0 ** 3


def gravity(params, like: torch.Tensor) -> torch.Tensor:
    """``params.gravity`` as a (3,) tensor of ``like``'s dtype and
    device."""
    return torch.tensor(params.gravity, dtype=like.dtype, device=like.device)


def pair_geometry(params: SPHParams, grid: GridSpec, pos, nbr_idx,
                  geo=None):
    """``(j, d, r2, r)``: each slot's partner (−1 read as 0), the
    separation x_i − x_j (minimum image), its square length and
    √(r² + 1e-12).  ``geo``, the same tuple already computed for these
    positions and list, is returned as it is: the passes of one substep
    at one state share it."""
    if geo is not None:
        return geo
    j = torch.clamp(nbr_idx, min=0)
    d = min_image(grid, pos[:, None, :] - pos[j])
    r2 = torch.sum(d * d, dim=-1)
    return j, d, r2, torch.sqrt(r2 + 1e-12)


def rowsum(mask, x):
    """Σ over a row's slots of ``x`` where ``mask``; ``x`` (N, K) or
    (N, K, 3)."""
    if x.dim() == 3:
        mask = mask[..., None]
    return torch.sum(torch.where(mask, x, 0.0), dim=1)


def adami_bc(params: SPHParams, grid: GridSpec, pos, vel, rho, kind,
             nbr_idx, nbr_valid, body_acc=None, geo=None):
    """Extrapolate pressure, density and velocity onto solid markers.

    Returns ``(p_all, rho_all, v_bc_all)``: fluid markers keep their own
    EOS pressure and velocity; solid markers get the Adami ghost values
    (v_bc = 2 v_wall − ⟨v_fluid⟩ for the viscous term; the hydrostatic
    term with the wall's acceleration ``body_acc`` (N, 3), or none with
    ``boundary_model="holmes"``)."""
    w_fn, _, _ = KERNELS[params.kernel]
    is_fluid = kind == FLUID
    p_own = tait_pressure(params, rho)
    j, d, _, r = pair_geometry(params, grid, pos, nbr_idx, geo)
    Wf = torch.where(nbr_valid & is_fluid[j], w_fn(r, params.h), 0.0)
    denom = torch.sum(Wf, dim=1)
    has_fluid = denom > 1e-12
    denom = torch.clamp(denom, min=1e-12)

    g = gravity(params, pos)
    acc_w = -g[None, :] if body_acc is None else body_acc - g[None, :]
    if params.boundary_model == "holmes":
        hydro = torch.zeros_like(r)
    else:
        hydro = torch.sum((-acc_w[:, None, :]) * d, dim=-1) * rho[j]
    p_solid = torch.sum(Wf * (p_own[j] + hydro), dim=1) / denom
    p_solid = torch.where(has_fluid, p_solid, 0.0)

    v_avg = torch.sum(Wf[..., None] * vel[j], dim=1) / denom[:, None]
    v_bc_solid = torch.where(has_fluid[:, None], 2.0 * vel - v_avg, vel)

    p_all = torch.where(is_fluid, p_own, p_solid)
    rho_all = torch.where(is_fluid, rho, tait_density(params, p_all))
    v_bc_all = torch.where(is_fluid[:, None], vel, v_bc_solid)
    return p_all, rho_all, v_bc_all


def _density_diffusion(params, d, gw, r2, rho_i, rho_j, ok):
    """δ-SPH (Molteni–Colagrossi) term of dρ/dt over the pairs ``ok``."""
    m = particle_mass(params)
    psi = 2.0 * (rho_j - rho_i) * torch.sum(-d * gw, dim=-1) / (r2 + 1e-12)
    return params.delta_sph * params.h * params.c_s * rowsum(
        ok, m / rho_j * psi)


def continuity_rhs(params: SPHParams, grid: GridSpec, pos, vel, rho, kind,
                   nbr_idx, nbr_valid, geo=None):
    """dρ/dt alone (continuity + δ-SPH) at the given velocities: the
    symplectic scheme evaluates it at the kicked velocities."""
    _, dw_fn, _ = KERNELS[params.kernel]
    m = particle_mass(params)
    is_fluid = kind == FLUID
    j, d, r2, r = pair_geometry(params, grid, pos, nbr_idx, geo)
    gw = grad_w(dw_fn, d, r, params.h)
    v_ij = vel[:, None, :] - vel[j]
    drho = rowsum(nbr_valid, m * torch.sum(v_ij * gw, dim=-1))
    diff_ok = nbr_valid & is_fluid[j] & is_fluid[:, None]
    drho = drho + _density_diffusion(params, d, gw, r2, rho[:, None],
                                     rho[j], diff_ok)
    return torch.where(is_fluid, drho, 0.0)


def wcsph_rhs(params: SPHParams, grid: GridSpec, pos, vel, rho, kind,
              nbr_idx, nbr_valid, body_acc=None, geo=None):
    """``(dρ/dt, dv/dt)`` of every marker.  Fluid: continuity and
    momentum with gravity.  Solid: dρ/dt = 0 and dv/dt the fluid reaction
    (pressure and viscous, no gravity: the body's weight lives in the
    multibody system), not integrated."""
    _, dw_fn, _ = KERNELS[params.kernel]
    m = particle_mass(params)
    is_fluid = kind == FLUID
    geo = pair_geometry(params, grid, pos, nbr_idx, geo)
    p_all, rho_all, v_bc = adami_bc(params, grid, pos, vel, rho, kind,
                                    nbr_idx, nbr_valid, body_acc, geo)
    j, d, r2, r = geo
    gw = grad_w(dw_fn, d, r, params.h)
    act = nbr_valid
    rho_i, rho_j = rho_all[:, None], rho_all[j]
    p_i, p_j = p_all[:, None], p_all[j]
    fluid_j = is_fluid[j]
    # continuity takes the prescribed solid velocity, the viscous term the
    # no-slip ghost velocity
    v_i = vel[:, None, :]
    v_ij_cont = v_i - vel[j]
    v_ij = v_i - torch.where(fluid_j[..., None], vel[j], v_bc[j])

    drho = rowsum(act, m * torch.sum(v_ij_cont * gw, dim=-1))
    drho = drho + _density_diffusion(params, d, gw, r2, rho_i, rho_j,
                                     act & fluid_j & is_fluid[:, None])

    pterm = p_i / (rho_i ** 2) + p_j / (rho_j ** 2)
    dv = -rowsum(act, (m * pterm)[..., None] * gw)
    if params.viscosity_model == "laminar":
        coef = m * (2.0 * params.mu) / (rho_i * rho_j) * torch.sum(
            d * gw, dim=-1) / (r2 + 0.01 * params.h ** 2)
        dv = dv + rowsum(act, coef[..., None] * v_ij)
    else:
        v_dot_r = torch.sum(v_ij * d, dim=-1)
        mu_ij = params.h * v_dot_r / (r2 + 0.01 * params.h ** 2)
        Pi = torch.where(v_dot_r < 0,
                         -params.alpha_visc * params.c_s * mu_ij
                         / (0.5 * (rho_i + rho_j)), 0.0)
        dv = dv - rowsum(act, (m * Pi)[..., None] * gw)

    dv = torch.where(is_fluid[:, None], dv + gravity(params, pos)[None, :],
                     dv)
    drho = torch.where(is_fluid, drho, 0.0)
    return drho, dv


def xsph_velocity(params: SPHParams, grid: GridSpec, pos, vel, rho, kind,
                  nbr_idx, nbr_valid, geo=None):
    """XSPH-corrected transport velocity (fluid markers only)."""
    w_fn, _, _ = KERNELS[params.kernel]
    m = particle_mass(params)
    is_fluid = kind == FLUID
    j, _, _, r = pair_geometry(params, grid, pos, nbr_idx, geo)
    Wij = w_fn(r, params.h)
    ok = nbr_valid & is_fluid[j] & is_fluid[:, None]
    rho_avg = 0.5 * (rho[:, None] + rho[j])
    corr = rowsum(ok, (m / rho_avg * Wij)[..., None]
                   * (vel[j] - vel[:, None, :]))
    return torch.where(is_fluid[:, None], vel + params.xsph_eps * corr, vel)


def ppst_shift(params: SPHParams, grid: GridSpec, pos, vel, rho, kind,
               nbr_idx, nbr_valid, geo=None):
    """PPST shift δr = −D ∇C with C = Σ (m/ρ) W and D = 2 h |v| dt, capped
    at 0.1 d0 and suppressed for surface-deficient markers (C at most 0.9
    of the fluid's largest)."""
    w_fn, dw_fn, _ = KERNELS[params.kernel]
    m = particle_mass(params)
    is_fluid = kind == FLUID
    j, d, _, r = pair_geometry(params, grid, pos, nbr_idx, geo)
    gw = grad_w(dw_fn, d, r, params.h)
    vol = m / torch.clamp(rho[j], min=1e-9)
    gradC = rowsum(nbr_valid, vol[..., None] * gw)
    C = rowsum(nbr_valid, vol * w_fn(r, params.h)) \
        + m / torch.clamp(rho, min=1e-9) * w_fn(torch.zeros_like(rho),
                                                params.h)
    interior = C > 0.9 * torch.max(torch.where(is_fluid, C,
                                               torch.zeros_like(C)))
    speed = torch.sqrt(torch.sum(vel * vel, dim=-1))
    D = 2.0 * params.h * speed * params.dt
    shift = -D[:, None] * gradC
    mag = torch.sqrt(torch.sum(shift * shift, dim=-1, keepdim=True) + 1e-20)
    shift = shift * torch.clamp(0.1 * params.d0 / mag, max=1.0)
    return torch.where((is_fluid & interior)[:, None], shift,
                       torch.zeros_like(shift))


def summation_density(params: SPHParams, grid: GridSpec, pos, kind,
                      nbr_idx, nbr_valid, geo=None):
    """ρ_i = Σ m W_ij, the marker's own term included."""
    w_fn, _, _ = KERNELS[params.kernel]
    m = particle_mass(params)
    _, _, _, r = pair_geometry(params, grid, pos, nbr_idx, geo)
    W_self = w_fn(torch.zeros_like(r[:, 0]), params.h)
    return m * (W_self + rowsum(nbr_valid, w_fn(r, params.h)))
