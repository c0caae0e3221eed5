"""Cell-slot DEM advance: the granular settling box's main path and the
JAX package's other cell-dense backends.

Counterpart of ``chrono_tpu/dem/cell_dense.py`` (``to_cells``,
``from_cells``, ``wall_static_coefs``, ``pallas_static_coefs``,
``cell_dense_forces`` with its TPU-kernel drop-ins ``pallas_cell_forces``
and ``pallas_pencil_forces``, ``make_cell_dense_advance``).  Particles live
in a slot-major structure of arrays: a (10, n_cells, C) float32 tensor of
planes (pos xyz, vel xyz, omega xyz, mask) and a (n_cells, C) int32 tensor
of particle ids (-1 for an empty slot), with cell id ``(i·ny + j)·nz + k``.
Two kinds of substep:

* fused (backends ``"flat"``, ``"sym"``, ``"pencil"``): kernel K1
  (``ops.cuda.dem_substep``) computes pairs, plane walls and the Euler step
  in one launch;
* forces path (backends ``"pallas"``, ``"xla"``): kernel ``dem_forces``
  (``ops.cuda.dem_forces``) gives the pair forces and torques alone, then
  the general wall pass (``dem.forces.wall_forces``, any boundary kind) and
  the masked semi-implicit Euler step run as tensor code.

A cycle is ``rebuild_every`` substeps followed by a rebin: a full sort, or
for ``"flat"`` with ``migrate=True`` the one-cell-per-axis migration (kernel
K2, ``ops.cuda.migrate``).  Binning, unbinning and the cycle loop are plain
PyTorch on every device.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from chrono_tpu_torch.collision.cell_list import GridSpec, cell_index
from chrono_tpu_torch.dem.bc import DEMBoundaries
from chrono_tpu_torch.dem.forces import wall_forces
from chrono_tpu_torch.dem.params import DEMParams, hertz_coefficients
from chrono_tpu_torch.ops.cuda.dem_forces import PairCoefs, dem_forces
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


def pair_coefs(params: DEMParams, grid: GridSpec,
               capacity: int) -> PairCoefs:
    """Everything kernel ``dem_forces`` and its twin take."""
    return PairCoefs(dims=tuple(grid.dims), capacity=capacity,
                     **pallas_static_coefs(params))


def cell_dense_forces(params: DEMParams, grid: GridSpec, feat: torch.Tensor):
    """Pair force and torque (each (3, n_cells, C)) of (10, n_cells, C)
    slot planes: kernel ``dem_forces`` on a CUDA tensor, its twin on a CPU
    tensor.  The port's counterpart of the JAX ``cell_dense_forces`` and of
    its two TPU-kernel drop-ins, ``pallas_cell_forces`` and
    ``pallas_pencil_forces``: all three take the same planes here."""
    out = feat.new_empty((6,) + tuple(feat.shape[1:]))
    dem_forces(feat, out, pair_coefs(params, grid, feat.shape[2]))
    return out[0:3], out[3:6]


def substep_coefs(params: DEMParams, bcs: DEMBoundaries, grid: GridSpec,
                  capacity: int) -> SubstepCoefs:
    """Everything kernel K1 and its twin take, from the user's objects."""
    others = [k for k in bcs.kinds() if k != "planes"]
    if others:
        raise ValueError(f"the fused substep takes plane walls only, not "
                         f"{', '.join(others)}")
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


def valid_slots(feat: torch.Tensor) -> torch.Tensor:
    """Flat indices cell·C + slot of the occupied slots, int64."""
    return torch.nonzero(feat[_MASK].reshape(-1) > 0.5).squeeze(1)


def slot_wall_forces(params: DEMParams, bcs: DEMBoundaries,
                     x: torch.Tensor) -> torch.Tensor:
    """The general wall pass on gathered slots: x (10, M) → force xyz and
    torque xyz (6, M)."""
    f, t, _ = wall_forces(params, bcs, x[0:3].T, x[3:6].T, x[6:9].T)
    return torch.cat([f.T, t.T])


def integrate_slots(params: DEMParams, x: torch.Tensor,
                    f: torch.Tensor) -> torch.Tensor:
    """Semi-implicit Euler of gathered slots: x (10, M) and total force and
    torque f (6, M) → new pos, vel, omega (9, M)."""
    g = torch.tensor(params.gravity, dtype=x.dtype,
                     device=x.device)[:, None]
    vel = x[3:6] + params.dt * (f[0:3] / params.mass + g)
    omega = x[6:9] + params.dt * (f[3:6] / params.inertia)
    return torch.cat([x[0:3] + params.dt * vel, vel, omega])


def forces_substep(params: DEMParams, bcs: DEMBoundaries, pair: PairCoefs,
                   feat: torch.Tensor, sel: torch.Tensor,
                   out: torch.Tensor) -> None:
    """One substep of the forces path, in place on ``feat``: the pair pass
    into ``out`` (6, n_cells, C), then on the occupied slots ``sel`` the
    wall pass, acc = (F + F_w)/m + g, α = (T + T_w)/I and the Euler step.
    Empty slots keep their values, as the JAX backends' mask keeps them."""
    dem_forces(feat, out, pair)
    flat = feat.view(10, -1)
    x = flat[:, sel]
    f = out.view(6, -1)[:, sel]
    if bcs.kinds():
        f = f + slot_wall_forces(params, bcs, x)
    flat[0:9, sel] = integrate_slots(params, x, f)


BACKENDS = ("flat", "sym", "pencil", "pallas", "xla")


def make_cell_dense_advance(params: DEMParams, bcs: DEMBoundaries,
                            grid: GridSpec, capacity: int = 8,
                            backend: str = "flat", migrate: bool = True, *,
                            device):
    """``advance(pos, vel, omega, n_cycles) → (pos, vel, omega, ovf)``.

    One cycle = ``params.rebuild_every`` substeps, then a rebin.  The
    backend names are the JAX package's; the port runs:

    * ``"flat"``: the fused substep K1.  With ``migrate=True`` the
      particles are binned once, each cycle ends with the one-cell
      migration K2, and a carried id plane unbins them at the end; with
      ``migrate=False`` every cycle bins by a full sort and unbins.
    * ``"sym"``, ``"pencil"``: K1 with a sort rebin every cycle, the JAX
      backends' non-migrating cycle (their TPU kernels compute K1's substep
      in other layouts).  ``migrate`` is ignored, as in JAX.
    * ``"pallas"``, ``"xla"``: the forces path (``forces_substep``) with a
      sort rebin every cycle; ``migrate`` is ignored.  Both names run kernel
      ``dem_forces`` on the card and its twin on the CPU.

    The fused backends take plane walls only and raise on any other kind;
    the forces path takes every kind of ``DEMBoundaries``.  The defaults
    (``"flat"`` with migration) are the port's main path; the JAX defaults
    are ``"xla"`` without migration.  ``multi_step`` friction runs as
    ``single_step`` (no history), as in JAX.  ``ovf`` is the largest
    capacity overflow seen, and with migration also the number of particles
    lost to a jump of more than one cell (0 when all is well).  Inputs are
    (N, 3) arrays; outputs are (N, 3) float32 tensors on ``device``.
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown cell-dense backend {backend!r}")
    if params.friction_mode == "multi_step":
        params = replace(params, friction_mode="single_step")
    steps = params.rebuild_every

    def as_tensor(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    if backend in ("pallas", "xla"):
        pair = pair_coefs(params, grid, capacity)
        bcs_dev = bcs.to(device)

        def cycle_substeps(feat):
            sel = valid_slots(feat)
            out = feat.new_empty((6,) + tuple(feat.shape[1:]))
            for _ in range(steps):
                forces_substep(params, bcs_dev, pair, feat, sel, out)
            return feat
    else:
        coefs = substep_coefs(params, bcs, grid, capacity)

        def substeps(feat, spare):
            for _ in range(steps):
                dem_substep(feat, spare, coefs)
                feat, spare = spare, feat
            return feat, spare

        def cycle_substeps(feat):
            return substeps(feat, torch.empty_like(feat))[0]

    def advance_sort(pos, vel, omega, n_cycles: int):
        pos, vel, omega = as_tensor(pos), as_tensor(vel), as_tensor(omega)
        ovf = torch.zeros((), dtype=torch.int32, device=device)
        for _ in range(n_cycles):
            field = to_cells(grid, capacity, pos, vel, omega)
            feat = cycle_substeps(field.feat)
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

    return (advance_migrate if backend == "flat" and migrate
            else advance_sort)
