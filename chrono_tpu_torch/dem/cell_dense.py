"""Cell-slot DEM advance: the granular settling box's main path.

Counterpart of ``chrono_tpu/dem/cell_dense.py`` (``to_cells``,
``from_cells``, ``wall_static_coefs``, ``pallas_static_coefs``,
``make_cell_dense_advance``).  Particles live in a slot-major structure of
arrays: a (10, n_cells, C) float32 tensor of planes (pos xyz, vel xyz,
omega xyz, mask) and a (n_cells, C) int32 tensor of particle ids (-1 for an
empty slot), with cell id ``(i·ny + j)·nz + k``.  A cycle is
``rebuild_every`` fused substeps (kernel K1, ``ops.cuda.dem_substep``)
followed by a rebin: either a full sort (``migrate=False``) or the
one-cell-per-axis migration (kernel K2, ``ops.cuda.migrate``).  Binning,
unbinning and the cycle loop are plain PyTorch on every device.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from chrono_tpu_torch.collision.cell_list import GridSpec, cell_index
from chrono_tpu_torch.dem.bc import DEMBoundaries
from chrono_tpu_torch.dem.params import DEMParams, hertz_coefficients
from chrono_tpu_torch.ops.cuda.dem_substep import (
    MAX_WALLS, SubstepCoefs, dem_substep,
)
from chrono_tpu_torch.ops.cuda.migrate import dem_migrate

_MASK = 9


@dataclass(frozen=True)
class CellField:
    """Particles binned into cell slots."""

    feat: torch.Tensor      # (10, n_cells, C) float32 planes
    ids: torch.Tensor       # (n_cells, C) int32 particle id, -1 when empty
    perm: torch.Tensor      # (N,) int64 particle → flat slot cell·C + slot
    overflow: torch.Tensor  # () int32, max occupancy − C (0 when it fits)


def to_cells(grid: GridSpec, capacity: int, pos, vel, omega) -> CellField:
    """Bin particles into cell slots (stable sort + rank in cell).

    Particles keep their input order inside a cell.  A cell holding more
    than ``capacity`` particles keeps the first ``capacity`` and reports the
    excess in ``overflow``.
    """
    n = pos.shape[0]
    n_cells = grid.n_cells
    ids = cell_index(grid, pos)
    order = torch.argsort(ids, stable=True)
    ids_sorted = ids[order]
    # rank within the cell = position − first occurrence
    first = torch.searchsorted(ids_sorted, ids_sorted)
    rank = torch.arange(n, device=pos.device) - first
    overflow = torch.clamp(rank.max() + 1 - capacity, min=0).to(torch.int32)
    flat = ids_sorted * capacity + torch.clamp(rank, max=capacity - 1)
    perm = torch.empty_like(flat).scatter_(0, order, flat)
    keep = rank < capacity
    rows = torch.cat([pos, vel, omega, torch.ones_like(pos[:, :1])], dim=1)
    feat = pos.new_zeros((10, n_cells * capacity))
    feat[:, flat[keep]] = rows[order[keep]].T
    slot_ids = torch.full((n_cells * capacity,), -1, dtype=torch.int32,
                          device=pos.device)
    slot_ids[flat[keep]] = order[keep].to(torch.int32)
    return CellField(feat=feat.reshape(10, n_cells, capacity),
                     ids=slot_ids.reshape(n_cells, capacity), perm=perm,
                     overflow=overflow)


def from_cells(field: CellField, *arrays):
    """(k, n_cells, C) slot planes → (N, k) per-particle rows."""
    return [a.reshape(a.shape[0], -1)[:, field.perm].T for a in arrays]


def wall_static_coefs(params: DEMParams) -> dict:
    """Wall-contact Hertz coefficients (m* = m, r* = r)."""
    kn, gn, kt, gt = hertz_coefficients(params.wall_material, params.mass,
                                        params.radius)
    return dict(knw=kn, gnw=gn, ktw=kt, gtw=gt,
                muw=params.wall_material.mu_s)


def pallas_static_coefs(params: DEMParams) -> dict:
    """Pair-contact constants of the substep (m* = m/2, r* = r/2); the name
    is the JAX package's, whose TPU kernel takes the same constants."""
    kn, gn, kt, gt = hertz_coefficients(params.material, 0.5 * params.mass,
                                        0.5 * params.radius)
    return dict(radius=params.radius, kn=kn, gn=gn, kt=kt, gt=gt,
                mu=params.material.mu_s, dt=params.dt,
                friction=params.friction_mode != "frictionless")


def substep_coefs(params: DEMParams, bcs: DEMBoundaries, grid: GridSpec,
                  capacity: int) -> SubstepCoefs:
    """Everything kernel K1 and its twin take, from the user's objects."""
    planes = bcs.planes
    if planes is not None:
        if planes.normal.shape[0] > MAX_WALLS:
            raise ValueError(f"at most {MAX_WALLS} plane walls")
        planes = planes.to("cpu")
    return SubstepCoefs(dims=tuple(grid.dims), capacity=capacity,
                        planes=planes,
                        gravity=tuple(float(g) for g in params.gravity),
                        inv_m=1.0 / params.mass,
                        inv_I=1.0 / params.inertia,
                        **pallas_static_coefs(params),
                        **wall_static_coefs(params))


def make_cell_dense_advance(params: DEMParams, bcs: DEMBoundaries,
                            grid: GridSpec, capacity: int = 8,
                            migrate: bool = True, *, device):
    """``advance(pos, vel, omega, n_cycles) → (pos, vel, omega, ovf)``.

    One cycle = ``params.rebuild_every`` substeps, then a rebin.  With
    ``migrate=True`` the particles are binned once, each cycle ends with the
    one-cell migration, and a carried id plane unbins them at the end; with
    ``migrate=False`` every cycle bins by a full sort and unbins.  ``ovf`` is
    the largest capacity overflow seen, and with migration also the number
    of particles lost to a jump of more than one cell (0 when all is well).
    Inputs are (N, 3) arrays; outputs are (N, 3) float32 tensors on
    ``device``.
    """
    if params.friction_mode == "multi_step":
        params = replace(params, friction_mode="single_step")
    coefs = substep_coefs(params, bcs, grid, capacity)
    steps = params.rebuild_every

    def as_tensor(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    def substeps(feat, spare):
        for _ in range(steps):
            dem_substep(feat, spare, coefs)
            feat, spare = spare, feat
        return feat, spare

    def advance_sort(pos, vel, omega, n_cycles: int):
        pos, vel, omega = as_tensor(pos), as_tensor(vel), as_tensor(omega)
        ovf = torch.zeros((), dtype=torch.int32, device=device)
        for _ in range(n_cycles):
            field = to_cells(grid, capacity, pos, vel, omega)
            feat, _ = substeps(field.feat, torch.empty_like(field.feat))
            pos, vel, omega = from_cells(field, feat[0:3], feat[3:6],
                                         feat[6:9])
            ovf = torch.maximum(ovf, field.overflow)
        return pos, vel, omega, ovf

    def advance_migrate(pos, vel, omega, n_cycles: int):
        pos, vel, omega = as_tensor(pos), as_tensor(vel), as_tensor(omega)
        n = pos.shape[0]
        field = to_cells(grid, capacity, pos, vel, omega)
        feat, ids, ovf = field.feat, field.ids, field.overflow
        feat_b, ids_b = torch.empty_like(feat), torch.empty_like(ids)
        count = torch.empty(grid.n_cells, dtype=torch.int32, device=device)
        for _ in range(n_cycles):
            feat, feat_b = substeps(feat, feat_b)
            n_before = (feat[_MASK] > 0.5).sum()
            dem_migrate(feat, ids, feat_b, ids_b, count, grid)
            feat, feat_b, ids, ids_b = feat_b, feat, ids_b, ids
            lost = (n_before - (feat[_MASK] > 0.5).sum()).abs()
            ovf = torch.maximum(ovf, torch.maximum(count.max() - capacity,
                                                   lost).to(torch.int32))
        # unbin through the carried ids (empty slots go to the spare row n)
        valid = feat[_MASK].reshape(-1) > 0.5
        row = torch.where(valid, ids.reshape(-1).long(), n)
        out = []
        for f0 in (0, 3, 6):
            buf = feat.new_zeros((n + 1, 3))
            buf[row] = feat[f0:f0 + 3].reshape(3, -1).T
            out.append(buf[:n])
        return (*out, ovf)

    return advance_migrate if migrate else advance_sort
