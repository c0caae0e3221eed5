"""DEM parameter set, Hertz–Mindlin and user-stiffness coefficients.

Counterpart of ``chrono_tpu/dem/params.py`` (``DEMMaterial``,
``DEMParams``, ``hertz_coefficients``, ``user_coefficients``,
``suggest_step_size``).  The parameters are host-side Python floats: the
kernels take them by value and the tensor code multiplies by them.  The
cell-slot paths (``dem.cell_dense``) read the material-based Hertz
coefficients and frictionless or single-step friction; the neighbour-list
system (``dem.system``) reads every field.  ``mu_sp`` and ``adhesion`` are
carried as the JAX package carries them: declared, and read by no force.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field


@dataclass(frozen=True)
class DEMMaterial:
    """Monomaterial granular material, SI units."""

    youngs: float = 1e7         # Young's modulus E [Pa]
    poisson: float = 0.3        # ν
    restitution: float = 0.5    # coefficient of restitution e
    mu_s: float = 0.5           # sliding friction
    mu_r: float = 0.0           # rolling resistance coefficient
    mu_sp: float = 0.0          # spinning resistance coefficient (unread)
    adhesion: float = 0.0       # constant adhesion force ratio (unread)
    # raw user stiffness and damping, read when force_model == "user"
    kn: float = 0.0             # [N/m]
    gn: float = 0.0             # [1/s] (× m_eff)
    kt: float = 0.0             # [N/m]
    gt: float = 0.0             # [1/s] (× m_eff)


@dataclass(frozen=True)
class DEMParams:
    """Everything the substep reads (monodisperse spheres)."""

    radius: float               # particle radius [m]
    mass: float                 # particle mass [kg]
    material: DEMMaterial = field(default_factory=DEMMaterial)
    wall_material: DEMMaterial = field(default_factory=DEMMaterial)
    gravity: tuple = (0.0, 0.0, -9.81)
    dt: float = 1e-5            # step size [s]
    max_neighbors: int = 16     # neighbour-list slots a particle
    max_per_cell: int = 8       # cell capacity of the list build
    rebuild_every: int = 8      # substeps per rebuild cycle
    skin: float = 0.2           # neighbour skin, a fraction of the diameter
    integrator: str = "centered_difference"
    friction_mode: str = "multi_step"  # frictionless|single_step|multi_step
    rolling_mode: str = "none"         # none|schwartz|elastic_plastic
    force_model: str = "mat_based"     # mat_based|user

    @property
    def inertia(self) -> float:
        return 0.4 * self.mass * self.radius ** 2


def hertz_coefficients(mat: DEMMaterial, m_eff: float, r_eff: float):
    """Effective Hertzian stiffness and damping prefactors (kn, gn, kt, gt).

    E* = E / (2(1−ν²)), G* = E / (4(2−ν)(1+ν)), β = ln e / √(ln²e + π²);
    k_n = 4/3 E* √R* (× √δ at run time), k_t = 8 G* √R*,
    γ = −2√(5/6) β √(S m*) with S = {2E*, 8G*} √R* (× δ^¼ at run time).
    """
    E, nu = mat.youngs, mat.poisson
    e = min(max(mat.restitution, 1e-3), 1.0 - 1e-6)
    E_star = E / (2.0 * (1.0 - nu * nu))
    G_star = E / (4.0 * (2.0 - nu) * (1.0 + nu))
    ln_e = math.log(e)
    beta = ln_e / math.sqrt(ln_e * ln_e + math.pi * math.pi)
    sqrt_R = math.sqrt(r_eff)
    kn_pref = (4.0 / 3.0) * E_star * sqrt_R
    kt_pref = 8.0 * G_star * sqrt_R
    gn_pref = -2.0 * math.sqrt(5.0 / 6.0) * beta * math.sqrt(
        2.0 * E_star * sqrt_R * m_eff)
    gt_pref = -2.0 * math.sqrt(5.0 / 6.0) * beta * math.sqrt(
        8.0 * G_star * sqrt_R * m_eff)
    return kn_pref, gn_pref, kt_pref, gt_pref


def user_coefficients(mat: DEMMaterial, m_eff: float, radius: float):
    """Prefactors of the user-stiffness model: F_n = K_n·δ·√(δ/R) −
    Γ_n·m*·√(δ/R)·v_n, the tangential pair alike.  In the kernels'
    convention (k = pref·√δ, γ = pref·√δ in this model):
    kn_pref = K_n/√R, gn_pref = Γ_n·m*/√R."""
    inv_sqrt_r = 1.0 / math.sqrt(radius)
    return (mat.kn * inv_sqrt_r, mat.gn * m_eff * inv_sqrt_r,
            mat.kt * inv_sqrt_r, mat.gt * m_eff * inv_sqrt_r)


def contact_coefficients(params: DEMParams, mat: DEMMaterial, m_eff: float,
                         r_eff: float):
    """The coefficients of ``params.force_model``: the user model's (which
    takes the particle radius) or the Hertz ones at (m*, r*)."""
    if params.force_model == "user":
        return user_coefficients(mat, m_eff, params.radius)
    return hertz_coefficients(mat, m_eff, r_eff)


def suggest_step_size(params: DEMParams, safety: float = 0.2) -> float:
    """Rayleigh-wave stable step estimate (the usual DEM heuristic)."""
    E = float(params.material.youngs)
    nu = float(params.material.poisson)
    rho = float(params.mass) / (4.0 / 3.0 * math.pi
                                * float(params.radius) ** 3)
    G = E / (2 * (1 + nu))
    t_r = (math.pi * float(params.radius) / (0.1631 * nu + 0.8766)
           ) * math.sqrt(rho / G)
    return safety * t_r
