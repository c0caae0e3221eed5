"""Analytic DEM walls: planes, z-cylinders, spheres, z-cones and wheels.

Counterpart of ``chrono_tpu/dem/bc.py``.  Each boundary kind is a batch of
B walls held as tensors; every particle is tested against every wall (a
dense (N, B) pass).  Each contact function returns a :class:`BCContact`: the
signed gap (< 0 penetrating) between the particle's surface and the wall,
the unit normal pointing into the domain (the push-out direction) and the
wall's surface velocity at the contact, with the JAX package's ``1e-12`` /
``1e-18`` guards under every square root.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import NamedTuple, Optional

import torch


class _Walls:
    """``to(device)`` for a frozen dataclass of tensors."""

    def to(self, device):
        return type(self)(**{f.name: getattr(self, f.name).to(device)
                             for f in fields(self)})


@dataclass(frozen=True)
class PlaneBCs(_Walls):
    """B half-space walls: particles kept on the +normal side."""

    point: torch.Tensor    # (B, 3)
    normal: torch.Tensor   # (B, 3) unit, into the domain
    vel: torch.Tensor      # (B, 3) wall velocity (conveyor / piston)


@dataclass(frozen=True)
class CylinderBCs(_Walls):
    """B infinite cylinders along z, particles kept inside (ρ < R)."""

    center: torch.Tensor   # (B, 2) xy
    radius: torch.Tensor   # (B,)
    vel: torch.Tensor      # (B, 3)


@dataclass(frozen=True)
class SphereBCs(_Walls):
    """B spherical obstacles, particles kept outside."""

    center: torch.Tensor   # (B, 3)
    radius: torch.Tensor   # (B,)
    vel: torch.Tensor      # (B, 3)


@dataclass(frozen=True)
class ConeBCs(_Walls):
    """B z-axis cones, particles kept inside: ρ < slope·(z − apex_z) on the
    open side; ``slope`` = tan(half-angle), > 0 opens toward +z."""

    apex: torch.Tensor     # (B, 3)
    slope: torch.Tensor    # (B,)
    vel: torch.Tensor      # (B, 3)


@dataclass(frozen=True)
class WheelBCs(_Walls):
    """B finite oriented solid cylinders (wheels, rollers), particles kept
    outside; the surface velocity includes the body's spin."""

    center: torch.Tensor      # (B, 3)
    axis: torch.Tensor        # (B, 3) unit
    radius: torch.Tensor      # (B,)
    half_width: torch.Tensor  # (B,)
    vel: torch.Tensor         # (B, 3) translational velocity
    omega: torch.Tensor       # (B, 3) angular velocity (world frame)


KINDS = ("planes", "cylinders", "spheres", "cones", "wheels")


@dataclass(frozen=True)
class DEMBoundaries:
    planes: Optional[PlaneBCs] = None
    cylinders: Optional[CylinderBCs] = None
    spheres: Optional[SphereBCs] = None
    cones: Optional[ConeBCs] = None
    wheels: Optional[WheelBCs] = None

    def to(self, device) -> "DEMBoundaries":
        return DEMBoundaries(**{k: None if getattr(self, k) is None
                                else getattr(self, k).to(device)
                                for k in KINDS})

    def kinds(self):
        """The names of the kinds that hold walls, in the wall order."""
        return [k for k in KINDS if getattr(self, k) is not None]


def n_walls(bcs: DEMBoundaries) -> int:
    """Total wall count B over every kind (``system.py`` ``_n_walls``)."""
    return sum(getattr(bcs, k).vel.shape[0] for k in bcs.kinds())


class BCContact(NamedTuple):
    gap: torch.Tensor      # (N, B) signed, particle surface vs wall
    normal: torch.Tensor   # (N, B, 3) into the domain
    vel: torch.Tensor      # (N, B, 3) wall surface velocity


def _wall_vel(vel, normal):
    return vel[None].expand_as(normal)


def plane_contacts(bc: PlaneBCs, pos: torch.Tensor, radius) -> BCContact:
    d = pos @ bc.normal.T - (bc.point * bc.normal).sum(-1)[None, :]
    n = bc.normal[None].expand(pos.shape[0], -1, -1)
    return BCContact(d - radius, n, _wall_vel(bc.vel, n))


def cylinder_contacts(bc: CylinderBCs, pos: torch.Tensor,
                      radius) -> BCContact:
    d = pos[:, None, :2] - bc.center[None]                # (N, B, 2)
    r = torch.sqrt((d * d).sum(-1) + 1e-12)
    gap = (bc.radius[None] - r) - radius                  # inside: r < R
    n_xy = -d / r[..., None]                              # toward the axis
    n = torch.cat([n_xy, torch.zeros_like(n_xy[..., :1])], dim=-1)
    return BCContact(gap, n, _wall_vel(bc.vel, n))


def sphere_bc_contacts(bc: SphereBCs, pos: torch.Tensor,
                       radius) -> BCContact:
    d = pos[:, None, :] - bc.center[None]
    r = torch.sqrt((d * d).sum(-1) + 1e-12)
    gap = (r - bc.radius[None]) - radius                  # outside: r > R
    n = d / r[..., None]
    return BCContact(gap, n, _wall_vel(bc.vel, n))


def cone_contacts(bc: ConeBCs, pos: torch.Tensor, radius) -> BCContact:
    """Signed distance (m·h − ρ)/√(1+m²) to the cone surface, inside
    positive, with h the height along the opening direction; the inward
    normal tilts from radial toward the opening by the half-angle.  (The
    JAX function gives this for one particle at a time: for N > 1 its
    concatenation of an (N, B, 2) and a (1, B, 1) array raises.)"""
    d = pos[:, None, :] - bc.apex[None]                   # (N, B, 3)
    sign = torch.sign(bc.slope)[None]
    h = d[..., 2] * sign
    m = bc.slope.abs()[None]
    rho = torch.sqrt(d[..., 0] ** 2 + d[..., 1] ** 2 + 1e-12)
    denom = torch.sqrt(1.0 + m * m)
    gap = (m * h - rho) / denom - radius
    n_r = -d[..., :2] / rho[..., None]
    n_z = (m / denom * sign).expand_as(gap)
    n = torch.cat([n_r / denom[..., None], n_z[..., None]], dim=-1)
    return BCContact(gap, n, _wall_vel(bc.vel, n))


def wheel_contacts(bc: WheelBCs, pos: torch.Tensor, radius) -> BCContact:
    """Particle vs finite solid cylinder (kept outside), branch-free.

    2-D signed distance in (radial, axial) coordinates: dr = ρ − R,
    da = |ax| − hw; outside hypot(max(dr, 0), max(da, 0)), inside
    max(dr, da).  The normal is its gradient (radial on the tread, axial on
    the caps, blended on the rim), and the surface velocity at the nearest
    surface point p_c is v + ω × (p_c − c).
    """
    d = pos[:, None, :] - bc.center[None]                 # (N, B, 3)
    a = bc.axis[None]
    ax = (d * a).sum(-1)                                  # (N, B)
    rad = d - ax[..., None] * a
    rho = torch.sqrt((rad * rad).sum(-1) + 1e-12)
    r_hat = rad / rho[..., None]
    dr = rho - bc.radius[None]
    da = ax.abs() - bc.half_width[None]
    drp = torch.clamp(dr, min=0.0)
    dap = torch.clamp(da, min=0.0)
    out = torch.sqrt(drp * drp + dap * dap + 1e-18)
    outside = (dr > 0) | (da > 0)
    sd = torch.where(outside, out, torch.maximum(dr, da))
    ax_hat = torch.sign(ax)[..., None] * a
    n = torch.where(outside[..., None],
                    (drp[..., None] * r_hat + dap[..., None] * ax_hat)
                    / out[..., None],
                    torch.where((dr >= da)[..., None], r_hat, ax_hat))
    p_c = pos[:, None, :] - sd[..., None] * n             # surface point
    w = bc.omega[None].expand_as(p_c)
    v = bc.vel[None] + torch.linalg.cross(w, p_c - bc.center[None], dim=-1)
    return BCContact(sd - radius, n, v)


CONTACTS = {"planes": plane_contacts, "cylinders": cylinder_contacts,
            "spheres": sphere_bc_contacts, "cones": cone_contacts,
            "wheels": wheel_contacts}


def box_boundaries(lo, hi, dtype=torch.float32) -> PlaneBCs:
    """The 6 inward-facing planes of an axis-aligned box."""
    lo = torch.as_tensor(lo, dtype=dtype)
    hi = torch.as_tensor(hi, dtype=dtype)
    eye = torch.eye(3, dtype=dtype)
    points = torch.cat([lo.expand(3, 3), hi.expand(3, 3)])
    normals = torch.cat([eye, -eye])
    return PlaneBCs(point=points, normal=normals,
                    vel=torch.zeros((6, 3), dtype=dtype))


def conveyor_plane(point, normal, surface_vel,
                   dtype=torch.float32) -> PlaneBCs:
    """One plane whose surface moves tangentially (a conveyor belt):
    friction against the moving surface drags particles along."""
    def row(x):
        return torch.as_tensor([x], dtype=dtype)

    return PlaneBCs(point=row(point), normal=row(normal),
                    vel=row(surface_vel))
