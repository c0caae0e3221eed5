"""Analytic DEM walls: static half-space planes.

Counterpart of ``chrono_tpu/dem/bc.py`` (``PlaneBCs``, ``DEMBoundaries``,
``plane_contacts``, ``box_boundaries``).  Only planes are ported: the
cell-slot settling path supports no other wall type in the JAX package
either, so ``DEMBoundaries`` holds planes alone.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass(frozen=True)
class PlaneBCs:
    """B half-space walls: particles kept on the +normal side."""

    point: torch.Tensor    # (B, 3)
    normal: torch.Tensor   # (B, 3) unit, into the domain
    vel: torch.Tensor      # (B, 3) wall velocity

    def to(self, device) -> "PlaneBCs":
        return PlaneBCs(self.point.to(device), self.normal.to(device),
                        self.vel.to(device))


@dataclass(frozen=True)
class DEMBoundaries:
    planes: Optional[PlaneBCs] = None


def plane_contacts(bc: PlaneBCs, pos: torch.Tensor, radius: float):
    """Signed gap (N, B) (< 0 penetrating), into-domain normal and wall
    velocity, each (N, B, 3)."""
    d = pos @ bc.normal.T - (bc.point * bc.normal).sum(-1)[None, :]
    gap = d - radius
    n = bc.normal[None].expand(pos.shape[0], -1, -1)
    v = bc.vel[None].expand_as(n)
    return gap, n, v


def box_boundaries(lo, hi, dtype=torch.float32) -> PlaneBCs:
    """The 6 inward-facing planes of an axis-aligned box."""
    lo = torch.as_tensor(lo, dtype=dtype)
    hi = torch.as_tensor(hi, dtype=dtype)
    eye = torch.eye(3, dtype=dtype)
    points = torch.cat([lo.expand(3, 3), hi.expand(3, 3)])
    normals = torch.cat([eye, -eye])
    return PlaneBCs(point=points, normal=normals,
                    vel=torch.zeros((6, 3), dtype=dtype))
