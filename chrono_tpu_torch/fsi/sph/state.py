"""SPH marker state and parameters.

Counterpart of ``chrono_tpu/fsi/sph/state.py``: one flat marker population
with a type code and a body attachment, so fluid, fixed-boundary and
rigid-body BCE markers flow through the same passes with masks.  The
gather backend (``fsi.sph.system``, ``fsi.sph.isph``, ``fsi.sph.crm``)
keeps its neighbour list on the state as ``nbr``; the cell-sorted engines
(``fsi.sph.pencil``, ``fsi.sph.crm_pencil``) bin the markers themselves
and leave ``nbr`` as it is (None unless a gather step set it).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

# marker type codes
FLUID = 0
BOUNDARY = 1     # fixed BCE (walls)
RIGID_BCE = 2    # markers attached to rigid bodies
FLEX_BCE = 3     # markers attached to FEA nodes
FROZEN = 4       # outside the active domain: a neighbour, not integrated


@dataclass(frozen=True)
class SPHParams:
    """Fluid and discretisation parameters, as Python floats and static
    fields (the JAX ``SPHParams`` holds the floats as traced leaves).
    ``max_neighbors`` and ``max_per_cell`` are the gather backend's
    neighbour-list capacities.  ``density_reinit_every`` is carried as the
    JAX package declares it and, as there, read by nothing."""

    d0: float               # initial particle spacing [m]
    h: float                # smoothing length = h_mult · d0
    rho0: float             # rest density
    mu: float               # dynamic viscosity
    c_s: float              # artificial sound speed (≥ 10·v_max)
    gravity: tuple          # (3,)
    dt: float               # step size
    eos_gamma: float = 7.0  # Tait exponent
    alpha_visc: float = 0.02     # artificial viscosity α
    delta_sph: float = 0.1       # δ-SPH density-diffusion coefficient
    xsph_eps: float = 0.5        # XSPH shifting strength
    kernel: str = "cubic"
    viscosity_model: str = "laminar"   # laminar | artificial
    boundary_model: str = "adami"      # adami | holmes
    shifting: str = "xsph"             # xsph | ppst | none
    max_neighbors: int = 64
    max_per_cell: int = 32
    rebuild_every: int = 4
    integrator: str = "symplectic"     # symplectic | rk2 | euler
    density_reinit_every: int = 0      # read by nothing, as in JAX

    def replace(self, **changes) -> "SPHParams":
        return dataclasses.replace(self, **changes)


@dataclass(frozen=True)
class SPHState:
    """All markers of an SPH problem (fluid, boundary and rigid BCE), and
    the gather backend's neighbour list (``dem.neighbors.NeighborList``)
    when it has built one."""

    pos: torch.Tensor        # (N, 3) float32
    vel: torch.Tensor        # (N, 3) float32
    rho: torch.Tensor        # (N,) float32
    kind: torch.Tensor       # (N,) int32 marker type code
    body_id: torch.Tensor    # (N,) int32 rigid body index, else -1
    bce_local: torch.Tensor  # (N, 3) body-local marker offset
    time: torch.Tensor       # () float32
    nbr: object = None       # NeighborList or None

    @property
    def n(self) -> int:
        return self.pos.shape[0]

    def replace(self, **changes) -> "SPHState":
        return dataclasses.replace(self, **changes)

    def to(self, device) -> "SPHState":
        """Every field on ``device``."""
        return SPHState(**{f.name: None if getattr(self, f.name) is None
                           else getattr(self, f.name).to(device)
                           for f in dataclasses.fields(self)})


def tait_pressure(params, rho: torch.Tensor) -> torch.Tensor:
    """Tait EOS: p = c²ρ0/γ [(ρ/ρ0)^γ − 1] (weakly compressible).

    ``params`` is anything with ``rho0``, ``c_s`` and ``eos_gamma``: an
    ``SPHParams`` or the substep's ``SPHConsts``."""
    g = params.eos_gamma
    B = params.c_s**2 * params.rho0 / g
    return B * ((rho / params.rho0) ** g - 1.0)


def tait_density(params, p: torch.Tensor, floor: float = 1e-3
                 ) -> torch.Tensor:
    """Inverse Tait EOS, with ``1 + p/B`` clamped at ``floor``: 1e-3 as the
    JAX gather backend clamps it (the substep clamps at 0.1, as the TPU
    kernels do: ``ops.cuda.sph_substep``)."""
    g = params.eos_gamma
    B = params.c_s**2 * params.rho0 / g
    return params.rho0 * torch.clamp(p / B + 1.0, min=floor) ** (1.0 / g)
