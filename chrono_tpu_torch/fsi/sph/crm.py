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
gather backend (``crm_forces``, ``crm_step``, ``make_crm_advance_fn``) is
not ported: terrain runs on ``fsi.sph.crm_pencil.make_crm_advance_pencil``.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import torch

from chrono_tpu_torch.fsi.sph.state import FLUID


@dataclass(frozen=True)
class CRMParams:
    """Granular material constants (SI), as Python floats."""

    youngs: float = 1e6          # elastic modulus E [Pa]
    poisson: float = 0.3
    friction_angle: float = 0.6  # internal friction tan(φ)
    cohesion: float = 0.0        # [Pa]

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
    """Granular SPH state: kinematics and per-marker stress.  The JAX
    ``CRMState`` also carries the gather backend's neighbour list; the
    cell-sorted path does not use one."""

    pos: torch.Tensor        # (N, 3) float32
    vel: torch.Tensor        # (N, 3) float32
    rho: torch.Tensor        # (N,) float32
    kind: torch.Tensor       # (N,) int32: FLUID = granular, BOUNDARY = walls
    body_id: torch.Tensor    # (N,) int32
    bce_local: torch.Tensor  # (N, 3)
    tau_d: torch.Tensor      # (N, 3) σxx σyy σzz
    tau_o: torch.Tensor      # (N, 3) σxy σxz σyz
    time: torch.Tensor       # () float32

    @property
    def n(self) -> int:
        return self.pos.shape[0]

    def replace(self, **changes) -> "CRMState":
        return dataclasses.replace(self, **changes)

    def to(self, device) -> "CRMState":
        """Every field on ``device``."""
        return CRMState(**{f.name: getattr(self, f.name).to(device)
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
        time=sph_state.time)


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
