"""Uniform grid: cell coordinates of particle positions.

Counterpart of ``chrono_tpu/collision/cell_list.py`` (``GridSpec``,
``cell_ijk``, ``cell_index``).  Non-periodic grids only: the DEM cell-slot
path this package ports rejects periodic axes in the JAX package too.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class GridSpec:
    """Static description of the uniform grid."""

    origin: tuple = (0.0, 0.0, 0.0)
    cell_size: float = 1.0
    dims: tuple = (8, 8, 8)  # (nx, ny, nz)
    periodic: tuple = (False, False, False)

    def __post_init__(self):
        if any(self.periodic):
            raise NotImplementedError("periodic grids are not ported")

    @property
    def n_cells(self) -> int:
        nx, ny, nz = self.dims
        return nx * ny * nz


def cell_ijk(grid: GridSpec, pos: torch.Tensor) -> torch.Tensor:
    """(…, 3) positions → (…, 3) int32 cell coordinates, clamped to the grid.

    ``floor((p − origin) / cell_size)`` with a true division (a division by
    a scalar may become a multiplication by its reciprocal on the GPU, which
    can move a particle on a cell face by one cell); the migrate kernel and
    its twin use the same expression.
    """
    origin = torch.tensor(grid.origin, dtype=pos.dtype, device=pos.device)
    size = torch.full((3,), grid.cell_size, dtype=pos.dtype, device=pos.device)
    ijk = torch.floor((pos - origin) / size).to(torch.int32)
    hi = torch.tensor([d - 1 for d in grid.dims], dtype=torch.int32,
                      device=pos.device)
    return torch.minimum(torch.clamp(ijk, min=0), hi)


def cell_index(grid: GridSpec, pos: torch.Tensor) -> torch.Tensor:
    """Linear cell id ``(i·ny + j)·nz + k`` per position (clamped), int64."""
    ijk = cell_ijk(grid, pos).long()
    _, ny, nz = grid.dims
    return (ijk[..., 0] * ny + ijk[..., 1]) * nz + ijk[..., 2]
