"""DEM parameter set and Hertz–Mindlin coefficients.

Counterpart of ``chrono_tpu/dem/params.py`` (``DEMMaterial``, ``DEMParams``,
``hertz_coefficients``), cut to what the cell-slot settling path reads:
material-based Hertz–Mindlin contact, frictionless or single-step friction.
The parameters are host-side Python floats: the kernels take them by value.
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


@dataclass(frozen=True)
class DEMParams:
    """Everything the substep reads (monodisperse spheres)."""

    radius: float               # particle radius [m]
    mass: float                 # particle mass [kg]
    material: DEMMaterial = field(default_factory=DEMMaterial)
    wall_material: DEMMaterial = field(default_factory=DEMMaterial)
    gravity: tuple = (0.0, 0.0, -9.81)
    dt: float = 1e-5            # step size [s]
    rebuild_every: int = 8      # substeps per rebin cycle
    friction_mode: str = "multi_step"  # frictionless|single_step|multi_step

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
