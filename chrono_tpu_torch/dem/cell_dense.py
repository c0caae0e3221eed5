"""Cell-slot DEM advance: the granular settling box's main path and the
JAX package's other cell-dense backends.

Counterpart of ``chrono_tpu/dem/cell_dense.py`` (``to_cells``,
``from_cells``, ``wall_static_coefs``, ``pallas_static_coefs``,
``cell_dense_forces`` with its TPU-kernel drop-ins ``pallas_cell_forces``
and ``pallas_pencil_forces``, ``make_cell_dense_advance``).  Particles live
in a slot-major structure of arrays: a (10, n_cells, C) float32 tensor of
planes (pos xyz, vel xyz, omega xyz, mask) and a (n_cells, C) int32 tensor
of particle ids (-1 for an empty slot), with cell id ``(i·ny + j)·nz + k``.
A cycle's substeps run on cell-sorted rows (``dem/rows.py``): the
occupied particles in slot order with a per-cell (start, count) table, laid
out once per rebin.  Two kinds of substep:

* fused (backends ``"flat"``, ``"sym"``, ``"pencil"``): kernel K1
  (``ops.cuda.dem_substep``) computes pairs, plane walls and the Euler step
  in one launch, between two row buffers;
* forces path (backends ``"pallas"``, ``"xla"``): kernel ``dem_forces``
  (``ops.cuda.dem_forces``) gives the pair forces and torques alone, then
  the general wall pass (``dem.forces.wall_forces``, any boundary kind) and
  the semi-implicit Euler step run as tensor code on the rows, in place.

A cycle is ``rebuild_every`` substeps followed by a rebin: a full sort
(:func:`to_rows` straight to rows, unbinned through each particle's row),
or for ``"flat"`` with ``migrate=True`` the one-cell-per-axis migration
(kernel K2, ``ops.cuda.migrate`` ``dem_migrate_rows``) from the cycle's rows
to the next cycle's, carrying each row's particle id.  Binning, unbinning
and the cycle loop are plain PyTorch on every device.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from chrono_tpu_torch.collision.cell_list import (
    GridSpec, cell_index, refuse_periodic,
)
from chrono_tpu_torch.dem.bc import DEMBoundaries
from chrono_tpu_torch.dem.forces import wall_forces
from chrono_tpu_torch.dem.params import DEMParams, hertz_coefficients
from chrono_tpu_torch.dem.rows import (
    CellRows, pack_rows, rows_from_prefix_slots, rows_of_cells,
)
from chrono_tpu_torch.ops.cuda.dem_forces import (
    PairCoefs, dem_forces, dem_forces_rows,
)
from chrono_tpu_torch.ops.cuda.dem_substep import (
    MAX_WALLS, SubstepCoefs, dem_substep_rows,
)
from chrono_tpu_torch.ops.cuda.migrate import dem_migrate_rows

_MASK = 9


@dataclass(frozen=True)
class CellField:
    """Particles binned into cell slots."""

    feat: torch.Tensor      # (10, n_cells, C) float32 planes
    ids: torch.Tensor       # (n_cells, C) int32 particle id, -1 when empty
    perm: torch.Tensor      # (N,) int64 particle → flat slot cell·C + slot
    overflow: torch.Tensor  # () int32, max occupancy − C (0 when it fits)


def _sort_bin(grid: GridSpec, capacity: int, pos):
    """The stable sort of particles by cell: ``(order, cell of each sorted
    particle, its rank in the cell, overflow)``, int64 but the overflow
    (() int32, max occupancy − C, 0 when it fits)."""
    refuse_periodic(grid, "the DEM cell-slot and row paths")
    n = pos.shape[0]
    ids = cell_index(grid, pos)
    order = torch.argsort(ids, stable=True)
    ids_sorted = ids[order]
    # rank within the cell = position − first occurrence
    first = torch.searchsorted(ids_sorted, ids_sorted)
    rank = torch.arange(n, device=pos.device) - first
    overflow = torch.clamp(rank.max() + 1 - capacity, min=0).to(torch.int32)
    return order, ids_sorted, rank, overflow


def to_cells(grid: GridSpec, capacity: int, pos, vel, omega) -> CellField:
    """Bin particles into cell slots (stable sort + rank in cell).

    Particles keep their input order inside a cell.  A cell holding more
    than ``capacity`` particles keeps the first ``capacity`` and reports the
    excess in ``overflow``.
    """
    n_cells = grid.n_cells
    order, ids_sorted, rank, overflow = _sort_bin(grid, capacity, pos)
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


def to_rows(grid: GridSpec, capacity: int, pos, vel, omega):
    """Bin particles straight into cell-sorted rows, holding the particles
    ``to_cells`` puts in slots, in its slot order, with no host sync:
    ``(CellRows, prow, overflow)``.  ``prow`` (N,) int64 is each particle's
    row; a particle past a full cell's capacity gets the row of the cell's
    last slot, as ``from_cells`` gives it that slot.  R = N + 1 rows."""
    n = pos.shape[0]
    order, ids_sorted, rank, overflow = _sort_bin(grid, capacity, pos)
    cells = torch.arange(grid.n_cells + 1, device=pos.device)
    first = torch.searchsorted(ids_sorted, cells)         # sorted index
    count = torch.clamp(first[1:] - first[:-1], max=capacity)
    cell, row_rank, start, table = rows_of_cells(count, n + 1)
    live = cell >= 0
    cell_c = torch.clamp(cell, min=0)
    src = order[torch.where(live, first[cell_c] + row_rank, 0)]
    rows = pack_rows(pos[src], vel[src], omega[src], cell, table, live)
    row_sorted = start[ids_sorted] + torch.clamp(rank, max=capacity - 1)
    prow = torch.empty_like(row_sorted).scatter_(0, order, row_sorted)
    return rows, prow, overflow


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


def wall_rows(params: DEMParams, bcs: DEMBoundaries,
              state: torch.Tensor):
    """The general wall pass on (3, R, 4) rows: force and torque, each
    (R, 3), with zero wall history (the JAX forces path passes zeros)."""
    return wall_forces(params, bcs, state[0, :, :3], state[1, :, :3],
                       state[2, :, :3])[:2]


def integrate_rows(params: DEMParams, state: torch.Tensor,
                   force: torch.Tensor, torque: torch.Tensor) -> None:
    """Semi-implicit Euler of (3, R, 4) rows in place, from the total force
    and torque (each (R, 3)): v += dt (F/m + g), x += dt v, ω += dt T/I."""
    g = torch.tensor(params.gravity, dtype=state.dtype, device=state.device)
    state[1, :, :3] += params.dt * (force / params.mass + g)
    state[0, :, :3] += params.dt * state[1, :, :3]
    state[2, :, :3] += params.dt * (torque / params.inertia)


def forces_substep(params: DEMParams, bcs: DEMBoundaries, pair: PairCoefs,
                   rows: CellRows, out: torch.Tensor) -> None:
    """One substep of the forces path on the rows, in place: the pair pass
    into ``out`` (2, R, 4), then the wall pass, acc = (F + F_w)/m + g,
    α = (T + T_w)/I and the Euler step.  Dead rows are stepped too and
    never read."""
    dem_forces_rows(rows, out, pair)
    force, torque = out[0, :, :3], out[1, :, :3]
    if bcs.kinds():
        fw, tw = wall_rows(params, bcs, rows.state)
        force, torque = force + fw, torque + tw
    integrate_rows(params, rows.state, force, torque)


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
    ``single_step`` (no history), as in JAX; rolling resistance and the
    user force model change the forces path's wall pass alone (the pair
    kernels and K1 take the Hertz coefficients), as in JAX.  ``ovf`` is
    the largest capacity overflow seen, and with migration also the number
    of particles lost to a jump of more than one cell (0 when all is
    well).  Inputs are (N, 3) arrays; outputs are (N, 3) float32 tensors
    on ``device``.
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown cell-dense backend {backend!r}")
    refuse_periodic(grid, "the DEM cell-slot and row paths")
    if params.friction_mode == "multi_step":
        params = replace(params, friction_mode="single_step")
    steps = params.rebuild_every

    def as_tensor(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    if backend in ("pallas", "xla"):
        pair = pair_coefs(params, grid, capacity)
        bcs_dev = bcs.to(device)

        def substeps(rows: CellRows):
            out = rows.state.new_empty((2, rows.n_rows, 4))
            for _ in range(steps):
                forces_substep(params, bcs_dev, pair, rows, out)
            return rows.state
    else:
        coefs = substep_coefs(params, bcs, grid, capacity)

        def substeps(rows: CellRows):
            # the spare's dead rows stay zero: K1 writes live rows only
            state, spare = rows.state, torch.zeros_like(rows.state)
            for _ in range(steps):
                dem_substep_rows(replace(rows, state=state), spare, coefs)
                state, spare = spare, state
            return state

    def advance_sort(pos, vel, omega, n_cycles: int):
        pos, vel, omega = as_tensor(pos), as_tensor(vel), as_tensor(omega)
        ovf = torch.zeros((), dtype=torch.int32, device=device)
        for _ in range(n_cycles):
            rows, prow, overflow = to_rows(grid, capacity, pos, vel, omega)
            state = substeps(rows)
            pos, vel, omega = (state[k, prow, :3] for k in range(3))
            ovf = torch.maximum(ovf, overflow)
        return pos, vel, omega, ovf

    def advance_migrate(pos, vel, omega, n_cycles: int):
        pos, vel, omega = as_tensor(pos), as_tensor(vel), as_tensor(omega)
        n = pos.shape[0]
        field = to_cells(grid, capacity, pos, vel, omega)
        ovf = field.overflow
        # n + 1 rows: the last is dead and zero, and empty slots gather it
        rows, row_of_slot = rows_from_prefix_slots(
            field.feat, (field.feat[_MASK] > 0.5).sum(1), n + 1)
        ids = torch.full((n + 1,), -1, dtype=torch.int32, device=device)
        ids[row_of_slot] = field.ids.reshape(-1)   # empty slots: −1, row n
        del field, row_of_slot
        nxt = CellRows(state=torch.empty_like(rows.state),
                       cell=torch.empty_like(rows.cell),
                       table=torch.empty_like(rows.table))
        ids_b = torch.empty_like(ids)
        landed = torch.empty(grid.n_cells, dtype=torch.int32, device=device)
        for _ in range(n_cycles):
            state = substeps(rows)
            n_before = rows.table[:, 1].sum()
            dem_migrate_rows(replace(rows, state=state), ids, nxt, ids_b,
                             landed, grid, capacity)
            rows, nxt = nxt, replace(rows, state=state)
            ids, ids_b = ids_b, ids
            lost = (n_before - rows.table[:, 1].sum()).abs()
            ovf = torch.maximum(ovf, torch.maximum(landed.max() - capacity,
                                                   lost).to(torch.int32))
        # unbin through the carried ids (dead rows go to the spare row n)
        row = torch.where(ids >= 0, ids.long(), n)
        out = []
        for k in range(3):
            buf = pos.new_zeros((n + 1, 3))
            buf[row] = rows.state[k, :, :3]
            out.append(buf[:n])
        return (*out, ovf)

    return (advance_migrate if backend == "flat" and migrate
            else advance_sort)
