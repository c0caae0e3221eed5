"""CRM: continuum granular material as elastoplastic SPH.

Counterpart of ``chrono_tpu/fsi/sph/crm.py``: each granular marker carries
a full Cauchy stress, evolved with a Jaumann (co-rotational) elastic rate
and projected onto the Drucker–Prager cone by a radial return.  The stress
rides as two (N, 3) arrays, ``tau_d`` (σxx σyy σzz) and ``tau_o``
(σxy σxz σyz).

Ported here: ``CRMParams``, ``CRMState``, ``make_crm_state``,
``lithostatic_init`` and ``drucker_prager_return``, plus the channel-wise
forms of the stress update (``strain_and_spin``, ``jaumann_update``,
``drucker_prager_channels``) that the plain twins of the CRM sweeps
(``ops.cuda.crm_substep``) share, term for term with the TPU kernel's
``postG`` (``chrono_tpu/ops/pallas/crm_sym_kernel.py:168-229``).  The
gather backend on the neighbour list of ``dem.neighbors``:
``velocity_gradient``, ``crm_forces``, ``crm_step`` and
``make_crm_advance_fn``, masked (N, K) gathers and row reductions in the
JAX package's pair order; the cell-sorted engine is
``fsi.sph.crm_pencil.make_crm_advance_pencil``.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import torch

from chrono_tpu_torch.collision.cell_list import GridSpec
from chrono_tpu_torch.dem.neighbors import build_neighbor_list
from chrono_tpu_torch.fsi.sph.kernels import KERNELS, grad_w
from chrono_tpu_torch.fsi.sph.state import FLUID, FROZEN
from chrono_tpu_torch.fsi.sph.wcsph import (
    gravity, pair_geometry, particle_mass, rowsum,
)
from chrono_tpu_torch.utils.device import resolve_device


@dataclass(frozen=True)
class CRMParams:
    """Granular material constants (SI), as Python floats.
    ``dilatancy`` is carried as the JAX package declares it and, as
    there, read by nothing (the return is non-associated)."""

    youngs: float = 1e6          # elastic modulus E [Pa]
    poisson: float = 0.3
    friction_angle: float = 0.6  # internal friction tan(φ)
    cohesion: float = 0.0        # [Pa]
    dilatancy: float = 0.0       # tan(ψ); read by nothing, as in JAX

    @property
    def shear_G(self) -> float:
        return self.youngs / (2.0 * (1.0 + self.poisson))

    @property
    def bulk_K(self) -> float:
        return self.youngs / (3.0 * (1.0 - 2.0 * self.poisson))

    def replace(self, **changes) -> "CRMParams":
        return dataclasses.replace(self, **changes)


@dataclass(frozen=True)
class CRMState:
    """Granular SPH state: kinematics, per-marker stress and, on the
    gather backend, its neighbour list ``nbr`` (None until a gather step
    builds one; the cell-sorted engines leave it as it is)."""

    pos: torch.Tensor        # (N, 3) float32
    vel: torch.Tensor        # (N, 3) float32
    rho: torch.Tensor        # (N,) float32
    kind: torch.Tensor       # (N,) int32: FLUID = granular, BOUNDARY = walls
    body_id: torch.Tensor    # (N,) int32
    bce_local: torch.Tensor  # (N, 3)
    tau_d: torch.Tensor      # (N, 3) σxx σyy σzz
    tau_o: torch.Tensor      # (N, 3) σxy σxz σyz
    time: torch.Tensor       # () float32
    nbr: object = None       # NeighborList or None

    @property
    def n(self) -> int:
        return self.pos.shape[0]

    def replace(self, **changes) -> "CRMState":
        return dataclasses.replace(self, **changes)

    def to(self, device) -> "CRMState":
        """Every field on ``device``."""
        return CRMState(**{f.name: None if getattr(self, f.name) is None
                           else getattr(self, f.name).to(device)
                           for f in dataclasses.fields(self)})


def make_crm_state(sph_state, dtype=torch.float32) -> CRMState:
    """A ``CRMState`` of the markers of an ``SPHState``, stress-free."""
    n, dev = sph_state.n, sph_state.pos.device
    return CRMState(
        pos=sph_state.pos, vel=sph_state.vel, rho=sph_state.rho,
        kind=sph_state.kind, body_id=sph_state.body_id,
        bce_local=sph_state.bce_local,
        tau_d=torch.zeros((n, 3), dtype=dtype, device=dev),
        tau_o=torch.zeros((n, 3), dtype=dtype, device=dev),
        time=sph_state.time, nbr=sph_state.nbr)


def drucker_prager_channels(s: torch.Tensor, friction_angle: float,
                            cohesion: float) -> torch.Tensor:
    """Radial return of stresses in channel form, (…, 6) as (xx, yy, zz,
    xy, xz, yz), onto the Drucker–Prager cone.

    Yield: √J₂ ≤ α·p + k with p = −tr(σ)/3 (compression positive),
    α = tan φ / √(9 + 3 tan² φ) and k = 3c / √(9 + 3 tan² φ).  Tension
    cut-off: p below the apex −k/α moves to the apex."""
    den = math.sqrt(9.0 + 3.0 * friction_angle ** 2)
    alpha = friction_angle / den
    k_c = 3.0 * cohesion / den
    p_mean = -(s[..., 0] + s[..., 1] + s[..., 2]) / 3.0
    dev_d = s[..., 0:3] + p_mean[..., None]
    J2 = 0.5 * (dev_d * dev_d).sum(-1) + (s[..., 3:6] * s[..., 3:6]).sum(-1)
    sqrt_J2 = torch.sqrt(J2 + 1e-20)
    p_new = torch.clamp(p_mean, min=-k_c / max(alpha, 1e-9))
    scale = torch.clamp((alpha * p_new + k_c) / sqrt_J2, max=1.0)
    return torch.cat([dev_d * scale[..., None] - p_new[..., None],
                      s[..., 3:6] * scale[..., None]], dim=-1)


def _to_channels(s: torch.Tensor) -> torch.Tensor:
    return torch.stack([s[:, 0, 0], s[:, 1, 1], s[:, 2, 2], s[:, 0, 1],
                        s[:, 0, 2], s[:, 1, 2]], dim=-1)


def _from_channels(c: torch.Tensor) -> torch.Tensor:
    xx, yy, zz, xy, xz, yz = c.unbind(-1)
    return torch.stack([torch.stack([xx, xy, xz], -1),
                        torch.stack([xy, yy, yz], -1),
                        torch.stack([xz, yz, zz], -1)], dim=-2)


def drucker_prager_return(s: torch.Tensor, p: CRMParams) -> torch.Tensor:
    """Radial return of (N, 3, 3) symmetric stresses onto the
    Drucker–Prager cone (see :func:`drucker_prager_channels`)."""
    return _from_channels(drucker_prager_channels(
        _to_channels(s), p.friction_angle, p.cohesion))


def strain_and_spin(g: torch.Tensor):
    """(…, 9) velocity gradient, g[3a + b] = ∂v_a/∂x_b → the strain rate
    D (…, 6) as (xx, yy, zz, xy, xz, yz) and the spin W (…, 3) as
    (W_xy, W_xz, W_yz)."""
    gxx, gxy, gxz, gyx, gyy, gyz, gzx, gzy, gzz = g.unbind(-1)
    d = torch.stack([gxx, gyy, gzz, 0.5 * (gxy + gyx), 0.5 * (gxz + gzx),
                     0.5 * (gyz + gzy)], dim=-1)
    w = torch.stack([0.5 * (gxy - gyx), 0.5 * (gxz - gzx),
                     0.5 * (gyz - gzy)], dim=-1)
    return d, w


def jaumann_update(s: torch.Tensor, d: torch.Tensor, w: torch.Tensor,
                   dt: float, shear_G: float, bulk_K: float) -> torch.Tensor:
    """σ + dt·(2G dev D + K tr D I + Wσ − σW), channel-wise (…, 6)."""
    sxx, syy, szz, sxy, sxz, syz = s.unbind(-1)
    dxx, dyy, dzz, dxy, dxz, dyz = d.unbind(-1)
    w1, w2, w3 = w.unbind(-1)
    tr = dxx + dyy + dzz
    third = tr / 3.0
    G2 = 2.0 * shear_G
    return torch.stack([
        sxx + dt * (G2 * (dxx - third) + bulk_K * tr
                    + 2.0 * (w1 * sxy + w2 * sxz)),
        syy + dt * (G2 * (dyy - third) + bulk_K * tr
                    + 2.0 * (-w1 * sxy + w3 * syz)),
        szz + dt * (G2 * (dzz - third) + bulk_K * tr
                    + 2.0 * (-w2 * sxz - w3 * syz)),
        sxy + dt * (G2 * dxy + w1 * (syy - sxx) + w2 * syz + w3 * sxz),
        sxz + dt * (G2 * dxz + w1 * syz + w2 * (szz - sxx) - w3 * sxy),
        syz + dt * (G2 * dyz - w1 * sxz - w2 * sxy + w3 * (szz - syy)),
    ], dim=-1)


def lithostatic_init(state: CRMState, params, crm: CRMParams,
                     surface_z) -> CRMState:
    """The at-rest stress profile on granular markers: σzz = −ρ0 g (H − z),
    lateral K₀ σzz with K₀ = ν/(1 − ν).  ``surface_z`` is a float or an
    (N,) tensor of per-marker surface heights."""
    g = abs(float(params.gravity[2]))
    depth = torch.clamp(surface_z - state.pos[:, 2], min=0.0)
    szz = -float(params.rho0) * g * depth
    K0 = crm.poisson / (1.0 - crm.poisson)
    tau_d = torch.stack([K0 * szz, K0 * szz, szz], dim=-1)
    gran = (state.kind == FLUID)[:, None]
    return state.replace(tau_d=torch.where(gran, tau_d.to(state.tau_d.dtype),
                                           state.tau_d))


# ------------------------------------------------ the gather backend


def velocity_gradient(params, grid: GridSpec, pos, vel, rho, nbr_idx,
                      nbr_valid, geo=None) -> torch.Tensor:
    """SPH velocity gradient ∇v_i = Σ_j (m/ρ_j)(v_j − v_i) ⊗ ∇_i W_ij,
    (N, 3, 3); ``geo``: the pair geometry at ``pos``, if already built."""
    _, dw_fn, _ = KERNELS[params.kernel]
    m = particle_mass(params)
    j, d, _, r = pair_geometry(params, grid, pos, nbr_idx, geo)
    gw = grad_w(dw_fn, d, r, params.h)
    dv = vel[j] - vel[:, None, :]
    w = torch.where(nbr_valid, m / rho[j], 0.0)
    return torch.einsum("nk,nka,nkb->nab", w, dv, gw)


def crm_forces(params, crm: CRMParams, grid: GridSpec,
               state: CRMState, geo=None) -> torch.Tensor:
    """Acceleration of every marker without gravity: on granular markers
    (FLUID or FROZEN) the divergence of stress, artificial viscosity and
    the wall penalty; on solid markers the granular reaction that the BCE
    reduction takes.  Wall markers mirror the granular marker's own
    stress; the penalty acts on mixed pairs closer than d0, with damping
    (full on approach, 30 % on separation)."""
    _, dw_fn, _ = KERNELS[params.kernel]
    m = particle_mass(params)
    is_gran = (state.kind == FLUID) | (state.kind == FROZEN)
    valid = state.nbr.valid
    j, d, r2, r = pair_geometry(params, grid, state.pos, state.nbr.idx, geo)
    gw = grad_w(dw_fn, d, r, params.h)
    sig = _from_channels(torch.cat([state.tau_d, state.tau_o], dim=1))

    is_gran_j = is_gran[j]
    sig_jj = sig[j]
    sig_j = torch.where(is_gran_j[..., None, None], sig_jj,
                        sig[:, None].expand_as(sig_jj))
    rho_i = state.rho[:, None]
    rho_j = state.rho[j]
    sig_term = (sig[:, None] / (rho_i ** 2)[..., None, None]
                + sig_j / (rho_j ** 2)[..., None, None])
    sig_term = torch.where(valid[..., None, None], sig_term,
                           torch.zeros_like(sig_term))
    dv = torch.einsum("nkab,nkb->na", sig_term, m * gw)

    v_ij = state.vel[:, None, :] - state.vel[j]
    v_dot_r = torch.sum(v_ij * d, dim=-1)
    mu_ij = params.h * v_dot_r / (r2 + 0.01 * params.h ** 2)
    Pi = torch.where(v_dot_r < 0,
                     -params.alpha_visc * params.c_s * mu_ij
                     / (0.5 * (rho_i + rho_j)), 0.0)
    dv = dv - rowsum(valid, (m * Pi)[..., None] * gw)

    r0 = params.d0
    mixed = is_gran[:, None] != is_gran_j
    close = valid & mixed & (r < r0)
    overlap = torch.where(close, (r0 - r) / r0, 0.0)
    k_bc = params.c_s ** 2 / r0
    nhat = d / r[..., None]
    vn_rel = torch.sum(v_ij * nhat, dim=-1)
    c_bc = 3.0 * math.sqrt(k_bc / r0)
    damp = torch.where(close, -c_bc * vn_rel * torch.where(vn_rel < 0, 1.0,
                                                            0.3), 0.0)
    return dv + torch.sum((k_bc * overlap + damp)[..., None] * nhat, dim=1)


def crm_step(params, crm: CRMParams, grid: GridSpec,
             state: CRMState) -> CRMState:
    """One explicit elastoplastic step on the state's neighbour list:
    kick, then the Jaumann stress update at the new velocities with the
    Drucker–Prager return, continuity (ρ clipped to [0.5, 2] ρ0) and the
    drift.  Only FLUID markers are integrated: FROZEN ones are neighbours
    that keep their state."""
    _, dw_fn, _ = KERNELS[params.kernel]
    m = particle_mass(params)
    h = params.dt
    integrate = state.kind == FLUID
    valid = state.nbr.valid
    geo = pair_geometry(params, grid, state.pos, state.nbr.idx)
    j, d, r2, r = geo
    gw = grad_w(dw_fn, d, r, params.h)
    sig = _from_channels(torch.cat([state.tau_d, state.tau_o], dim=1))

    dv = crm_forces(params, crm, grid, state, geo) + gravity(
        params, state.pos)[None, :]
    vel = torch.where(integrate[:, None], state.vel + h * dv, state.vel)

    gradv = velocity_gradient(params, grid, state.pos, vel, state.rho,
                              state.nbr.idx, valid, geo)
    gT = gradv.transpose(-1, -2)
    D = 0.5 * (gradv + gT)
    Wspin = 0.5 * (gradv - gT)
    eye = torch.eye(3, dtype=state.pos.dtype, device=state.pos.device)
    trD = torch.diagonal(D, dim1=-2, dim2=-1).sum(-1)
    devD = D - (trD / 3.0)[:, None, None] * eye
    sig_dot = (2.0 * crm.shear_G * devD
               + crm.bulk_K * trD[:, None, None] * eye
               + torch.einsum("nab,nbc->nac", Wspin, sig)
               - torch.einsum("nab,nbc->nac", sig, Wspin))
    sig_new = drucker_prager_return(sig + h * sig_dot, crm)
    sig_new = torch.where(integrate[:, None, None], sig_new, sig)

    v_ij_new = vel[:, None, :] - vel[j]
    drho = rowsum(valid, m * torch.sum(v_ij_new * gw, dim=-1))
    rho = torch.where(integrate, state.rho + h * drho, state.rho)
    rho = torch.clamp(rho, 0.5 * params.rho0, 2.0 * params.rho0)
    pos = torch.where(integrate[:, None], state.pos + h * vel, state.pos)
    ch = _to_channels(sig_new)
    return state.replace(pos=pos, vel=vel, rho=rho,
                         tau_d=ch[:, :3].contiguous(),
                         tau_o=ch[:, 3:].contiguous(), time=state.time + h)


def rebuild_crm_neighbors(params, grid: GridSpec,
                          state: CRMState) -> CRMState:
    """The state with its neighbour list rebuilt at the kernel's
    support."""
    cutoff = KERNELS[params.kernel][2] * params.h
    return state.replace(nbr=build_neighbor_list(
        grid, state.pos, cutoff, params.max_per_cell, params.max_neighbors))


def make_crm_advance_fn(params, crm: CRMParams, grid: GridSpec, *,
                        device=None):
    """``advance(state, n_cycles) → (state, overflow)`` on ``device`` (the
    card unless told otherwise): a list rebuild and
    ``params.rebuild_every`` :func:`crm_step` a cycle; the largest list
    overflow of the call."""
    device = resolve_device(device, "make_crm_advance_fn")

    def advance(state: CRMState, n_cycles: int):
        state = state.to(device)
        ovf = torch.zeros((), dtype=torch.int32, device=device)
        for _ in range(n_cycles):
            state = rebuild_crm_neighbors(params, grid, state)
            for _ in range(params.rebuild_every):
                state = crm_step(params, crm, grid, state)
            ovf = torch.maximum(ovf, state.nbr.overflow)
        return state, ovf

    return advance
