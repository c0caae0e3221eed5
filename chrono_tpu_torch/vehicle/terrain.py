"""Terrain models: flat, heightmap, and SCM deformable soil (Bekker–Wong).

Counterpart of ``chrono_tpu/vehicle/terrain.py`` (the reference's
RigidTerrain and SCMTerrain: Bekker pressure–sinkage with Janosi–Hanamoto
shear): the SCM grid is a dense (nx, ny) tensor; every wheel is tested
against every node at once (the reference's per-node ray cast), and
erosion is a one-pass relaxation.  ``scm_wheel_forces`` returns the new
state, with ``sinkage_max`` a device tensor, so a CUDA graph can capture a
step that copies the new sinkage into a static buffer.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor

from chrono_tpu_torch.core import quaternion as Q
from chrono_tpu_torch.utils.device import resolve_device
from chrono_tpu_torch.utils.tree import fields_as_tensors, tensor_dataclass


# ---------------- rigid terrain ----------------

def flat_terrain(height: float = 0.0) -> Callable:
    """(N, 2) xy → (N,) height."""
    def h(xy):
        return torch.full(xy.shape[:-1], height, dtype=xy.dtype,
                          device=xy.device)
    return h


@tensor_dataclass
class Heightmap:
    """Bilinearly interpolated height field (the reference's height-map
    patch)."""

    z: Tensor                 # (nx, ny)
    origin: Tensor            # (2,)
    spacing: Tensor           # ()

    def height(self, xy: Tensor) -> Tensor:
        u = (xy[..., 0] - self.origin[0]) / self.spacing
        v = (xy[..., 1] - self.origin[1]) / self.spacing
        nx, ny = self.z.shape
        i0 = torch.clamp(torch.floor(u).to(torch.int32), 0, nx - 2).long()
        j0 = torch.clamp(torch.floor(v).to(torch.int32), 0, ny - 2).long()
        fu = torch.clamp(u - i0, 0.0, 1.0)
        fv = torch.clamp(v - j0, 0.0, 1.0)
        z00 = self.z[i0, j0]
        z10 = self.z[i0 + 1, j0]
        z01 = self.z[i0, j0 + 1]
        z11 = self.z[i0 + 1, j0 + 1]
        return ((1 - fu) * (1 - fv) * z00 + fu * (1 - fv) * z10
                + (1 - fu) * fv * z01 + fu * fv * z11)


# ---------------- SCM deformable terrain ----------------

@tensor_dataclass
class SCMParams:
    """Bekker–Wong soil parameters (reference
    SCMTerrain::SetSoilParameters)."""

    Kphi: Tensor = 2e6        # frictional modulus [N/m^(n+2)]
    Kc: Tensor = 0.0          # cohesive modulus [N/m^(n+1)]
    n_exp: Tensor = 1.1       # sinkage exponent
    cohesion: Tensor = 0.0    # Mohr cohesion [Pa]
    friction_angle: Tensor = 0.6  # tan(phi) internal friction
    janosi_k: Tensor = 0.01   # Janosi shear modulus [m]
    elastic_K: Tensor = 4e7   # unloading stiffness [Pa/m]
    damping_R: Tensor = 3e4   # vertical damping [Pa s/m]


@tensor_dataclass
class SCMState:
    """Deformable grid state (persistent plastic sinkage)."""

    z0: Tensor        # (nx, ny) undeformed height
    sinkage: Tensor   # (nx, ny) plastic sinkage (≥ 0, accumulated)
    origin: Tensor    # (2,)
    spacing: Tensor   # ()

    @property
    def height(self) -> Tensor:
        return self.z0 - self.sinkage

    def height_fn(self):
        return Heightmap(z=self.height, origin=self.origin,
                         spacing=self.spacing).height


def make_scm_state(lo, hi, spacing, z0_fn=None, dtype=torch.float32,
                   device=None) -> SCMState:
    """A fresh grid over [lo, hi] (numpy, as the JAX package builds it), on
    the card unless ``device`` names another."""
    device = resolve_device(device, "make_scm_state")
    nx = int(np.ceil((hi[0] - lo[0]) / spacing)) + 1
    ny = int(np.ceil((hi[1] - lo[1]) / spacing)) + 1
    xs = lo[0] + spacing * np.arange(nx)
    ys = lo[1] + spacing * np.arange(ny)
    if z0_fn is None:
        z0 = np.zeros((nx, ny))
    else:
        g = np.stack(np.meshgrid(xs, ys, indexing="ij"), -1)
        z0 = z0_fn(g[..., 0], g[..., 1])

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return SCMState(z0=t(z0), sinkage=t(np.zeros((nx, ny))),
                    origin=t(np.asarray(lo[:2])), spacing=t(spacing))


class SCMWheelOut(NamedTuple):
    force: Tensor        # (W, 3) world force on each wheel
    torque_spin: Tensor  # (W,) resistance torque about the spin axis
    new_state: SCMState
    sinkage_max: Tensor  # () the largest sinkage added this call


def _minimum(a, b):
    if isinstance(a, Tensor) or isinstance(b, Tensor):
        return torch.minimum(torch.as_tensor(a), torch.as_tensor(b))
    return min(a, b)


def scm_wheel_forces(params: SCMParams, state: SCMState,
                     wheel_x, wheel_q, wheel_v, wheel_w_local,
                     wheel_radius, wheel_width) -> SCMWheelOut:
    """SCM contact for W cylindrical wheels, dense over the grid.

    For every node, test the footprint of every wheel (the cylinder's
    lower surface), take the node pressure from the Bekker sinkage with
    elastic unloading, the Janosi shear traction from the slip, then sum
    the per-wheel forces and update the plastic sinkage (the reference's
    SCMTerrain ComputeInternalForces as dense tensor ops).
    """
    params = fields_as_tensors(params, wheel_x)
    nx, ny = state.z0.shape
    dev, dt = wheel_x.device, wheel_x.dtype
    gx = (state.origin[0] + state.spacing
          * torch.arange(nx, device=dev, dtype=dt))[:, None]      # (nx, 1)
    gy = (state.origin[1] + state.spacing
          * torch.arange(ny, device=dev, dtype=dt))[None, :]      # (1, ny)
    cell_area = state.spacing ** 2

    e_spin = Q.q_to_matrix(wheel_q)[:, :, 1]                       # (W, 3)
    up = torch.eye(3, dtype=dt, device=dev)[2]
    e_lon = torch.linalg.cross(e_spin, up.expand_as(e_spin), dim=-1)
    e_lon = e_lon / torch.clamp_min(
        torch.linalg.norm(e_lon, dim=-1, keepdim=True), 1e-9)
    e_lat = torch.linalg.cross(up.expand_as(e_lon), e_lon, dim=-1)

    # node position relative to each wheel centre, in footprint coordinates
    dx = gx[None] - wheel_x[:, None, None, 0]                      # (W,nx,ny)
    dy = gy[None] - wheel_x[:, None, None, 1]
    u_lon = dx * e_lon[:, None, None, 0] + dy * e_lon[:, None, None, 1]
    u_lat = dx * e_lat[:, None, None, 0] + dy * e_lat[:, None, None, 1]

    r = wheel_radius
    inside = (torch.abs(u_lat) <= 0.5 * wheel_width) & (torch.abs(u_lon) < r)
    # height of the cylinder's lower surface above the node
    arm = torch.sqrt(torch.clamp_min(r * r - u_lon ** 2, 1e-12))
    surf_z = wheel_x[:, None, None, 2] - arm
    # total sinkage below the undeformed surface, elastic-plastic: virgin
    # loading on the Bekker curve σ_B(z) = (Kc/b + Kφ) zⁿ, unloading and
    # reloading elastic with slope elastic_K against the stored plastic
    # sinkage (the return-mapping form σ = clip(min(elastic_K (z − p),
    # σ_B(z)), 0))
    z_tot = torch.clamp_min(
        torch.where(inside, state.z0[None] - surf_z, torch.zeros_like(surf_z)),
        0.0)
    b = _minimum(wheel_width, r)
    sigma_B = (params.Kc / b + params.Kphi) * z_tot ** params.n_exp
    sigma_e = params.elastic_K * (z_tot - state.sinkage[None])
    sigma_st = torch.clamp_min(torch.minimum(sigma_e, sigma_B), 0.0)
    contact = sigma_st > 0
    # vertical damping from the approach rate of the wheel surface
    vz_node = (wheel_v[:, None, None, 2]
               - wheel_w_local[:, None, None, 1] * 0.0)
    sigma = sigma_st + params.damping_R * torch.clamp_min(-vz_node, 0.0) \
        * contact

    # slip velocity at the node: the wheel surface against the ground
    v_lon_w = torch.sum(wheel_v * e_lon, dim=-1)                   # (W,)
    omega = wheel_w_local[:, 1]
    v_slip_lon = v_lon_w[:, None, None] - omega[:, None, None] * arm
    v_slip_lat = torch.sum(wheel_v * e_lat, dim=-1)[:, None, None] \
        + 0.0 * u_lat
    v_slip = torch.sqrt(v_slip_lon ** 2 + v_slip_lat ** 2) + 1e-9

    # Janosi–Hanamoto shear: τ = τ_max (1 − e^(−j/k)), j ≈ slip · dwell
    tau_max = params.cohesion + sigma * params.friction_angle
    j_shear = v_slip * 0.1                               # dwell surrogate
    tau = tau_max * (1.0 - torch.exp(-j_shear / params.janosi_k))
    tau_lon = -tau * v_slip_lon / v_slip
    tau_lat = -tau * v_slip_lat / v_slip

    # per-wheel sums over the nodes
    fz_w = torch.sum(sigma, dim=(1, 2)) * cell_area               # (W,)
    f_lon_w = torch.sum(tau_lon * contact, dim=(1, 2)) * cell_area
    f_lat_w = torch.sum(tau_lat * contact, dim=(1, 2)) * cell_area
    force = (f_lon_w[:, None] * e_lon + f_lat_w[:, None] * e_lat
             + fz_w[:, None] * up)
    # resistance torque: shear acting at the radius about the spin axis
    t_spin = torch.sum(tau_lon * contact * arm, dim=(1, 2)) * cell_area

    # plastic sinkage: on virgin (Bekker-branch) loading the plastic set
    # point moves to z − σ/elastic_K; elastic reloading leaves it (the max
    # keeps the deepest imprint over wheels and history)
    p_new = torch.amax(torch.where(contact,
                                   z_tot - sigma_st / params.elastic_K,
                                   torch.zeros_like(z_tot)), dim=0)
    new_sink = torch.maximum(state.sinkage, p_new)
    return SCMWheelOut(force=force, torque_spin=t_spin,
                       new_state=state.replace(sinkage=new_sink),
                       sinkage_max=(new_sink - state.sinkage).max())


def scm_erosion_step(state: SCMState, max_slope: float = 0.6) -> SCMState:
    """Bulldozing-style erosion: relax sinkage slopes steeper than the angle
    of repose by moving material to the neighbours (the reference's erosion
    iterations), one Jacobi pass."""
    z = state.height
    dz_lim = max_slope * state.spacing

    def flow(a, b):
        # material moving from the higher to the lower column
        return torch.clamp_min((a - b - dz_lim) * 0.25, 0.0)

    zp = F.pad(z[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    out = (flow(z, zp[2:, 1:-1]) + flow(z, zp[:-2, 1:-1])
           + flow(z, zp[1:-1, 2:]) + flow(z, zp[1:-1, :-2]))
    inc = (flow(zp[2:, 1:-1], z) + flow(zp[:-2, 1:-1], z)
           + flow(zp[1:-1, 2:], z) + flow(zp[1:-1, :-2], z))
    return state.replace(sinkage=state.z0 - (z - out + inc))


def scm_relocate(state: SCMState, center_xy, z0_fn=None) -> SCMState:
    """Moving-patch relocation: shift the grid window by WHOLE cells so that
    its centre tracks ``center_xy``, carrying the plastic sinkage with the
    roll and exposing fresh undeformed soil at the leading edges.  The
    shift stays a device tensor (the roll is a gather), so no host read.
    ``z0_fn(x, y)`` gives the undeformed height on newly exposed strips
    (default 0: flat virgin soil)."""
    nx, ny = state.sinkage.shape
    dev, dt = state.z0.device, state.z0.dtype
    center = torch.as_tensor(center_xy, dtype=dt, device=dev)
    half = torch.stack([torch.full_like(state.spacing, (nx - 1) / 2.0),
                        torch.full_like(state.spacing, (ny - 1) / 2.0)]) \
        * state.spacing
    shift = torch.round((center - half - state.origin)
                        / state.spacing).to(torch.int32)
    new_origin = state.origin + shift.to(dt) * state.spacing
    ii = torch.arange(nx, device=dev)
    jj = torch.arange(ny, device=dev)
    # jnp.roll(a, -shift): out[i, j] = a[(i + s0) % nx, (j + s1) % ny]
    src_i = torch.remainder(ii + shift[0], nx)
    src_j = torch.remainder(jj + shift[1], ny)
    # the indices wrapped around by the roll hold stale data: reset them
    stale_i = torch.where(shift[0] >= 0, ii >= nx - shift[0], ii < -shift[0])
    stale_j = torch.where(shift[1] >= 0, jj >= ny - shift[1], jj < -shift[1])
    stale = stale_i[:, None] | stale_j[None, :]

    def roll_and_clear(a, fresh):
        a = a.index_select(0, src_i).index_select(1, src_j)
        return torch.where(stale, fresh, a)

    xs = new_origin[0] + state.spacing * ii.to(dt)[:, None]
    ys = new_origin[1] + state.spacing * jj.to(dt)[None, :]
    z0_fresh = (torch.zeros((nx, ny), dtype=dt, device=dev) if z0_fn is None
                else z0_fn(xs + 0 * ys, ys + 0 * xs))
    return state.replace(
        z0=roll_and_clear(state.z0, z0_fresh),
        sinkage=roll_and_clear(state.sinkage, torch.zeros((), dtype=dt,
                                                          device=dev)),
        origin=new_origin)
