"""Cell-sorted particle rows: the layout kernels K1 and ``dem_forces`` walk.

A cycle's cell membership is fixed for its ``rebuild_every`` substeps, so at
each rebin the occupied particles are laid out once, in the order the slot
planes give them (cell id ``(i·ny + j)·nz + k``, then slot):

* ``state`` (3, R, 4) float32: position, velocity and spin rows as float4
  (fourth lane 0), one row per particle, rows ``[0, M)`` live;
* ``cell`` (R,) int32: each row's cell, −1 on a dead row (rows ``[M, R)``);
* ``table`` (n_cells, 2) int32: each cell's first row and row count.

R exceeds the largest possible M by at least one, so the last row is always
dead; it stays zero where a writer keeps it so (K1 writes live rows only),
and gathers of empty slots read it.  For fixed (dx, dy) the cells k−1, k,
k+1 of a neighbour column are consecutive ids, so their particles are one
contiguous run of rows (:func:`neighbour_runs`): a particle's 27 neighbour
cells are nine runs.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class CellRows:
    """Occupied particles in cell order, with their per-cell table."""

    state: torch.Tensor   # (3, R, 4) float32 pos, vel, omega (lane 3 = 0)
    cell: torch.Tensor    # (R,) int32 cell of each row, −1 when dead
    table: torch.Tensor   # (n_cells, 2) int32 (start, count)

    @property
    def n_rows(self) -> int:
        return self.state.shape[1]


def rows_of_cells(count: torch.Tensor, n_rows: int):
    """For per-cell row counts, each row's cell (n_cells past the last live
    row), its rank in the cell, and the cells' first rows, int64; with the
    (n_cells, 2) int32 table."""
    count = count.long()
    end = torch.cumsum(count, 0)
    start = end - count
    row = torch.arange(n_rows, device=count.device)
    cell = torch.searchsorted(end, row, right=True)
    live = cell < count.numel()
    cell_c = torch.clamp(cell, max=count.numel() - 1)
    rank = torch.where(live, row - start[cell_c], 0)
    table = torch.stack([start, count], dim=1).to(torch.int32)
    return torch.where(live, cell, -1), rank, start, table


def pack_rows(pos, vel, omega, cell, table, live) -> CellRows:
    """Rows from (R, 3) values, zeros on the dead rows."""
    state = pos.new_zeros((3, cell.numel(), 4))
    for k, a in enumerate((pos, vel, omega)):
        state[k, :, :3] = torch.where(live[:, None], a, 0.0)
    return CellRows(state=state, cell=cell.to(torch.int32), table=table)


def rows_from_prefix_slots(feat: torch.Tensor, count: torch.Tensor,
                           n_rows: int):
    """Rows of (10, n_cells, C) slot planes whose cells fill their first
    ``count`` slots (as ``to_cells`` and K2 leave them), with no host sync:
    ``(CellRows, row_of_slot)``, where ``row_of_slot`` (n_cells·C,) int64
    maps each slot to its row and an empty slot to the dead last row.
    ``n_rows`` must exceed ``count.sum()``."""
    _, n_cells, C = feat.shape
    count = torch.clamp(count.long(), max=C)
    cell, rank, start, table = rows_of_cells(count, n_rows)
    live = cell >= 0
    slot = torch.where(live, cell * C + rank, 0)
    planes = feat.reshape(10, n_cells * C)[0:9, slot]             # (9, R)
    rows = pack_rows(*(planes[k:k + 3].T for k in (0, 3, 6)), cell, table,
                     live)
    s = torch.arange(C, device=feat.device)
    row_of_slot = torch.where(s < count[:, None], start[:, None] + s,
                              n_rows - 1).reshape(-1)
    return rows, row_of_slot


def rows_from_slots(feat: torch.Tensor):
    """Rows of (10, n_cells, C) slot planes with any mask, in slot order:
    ``(CellRows, sel)`` with ``sel`` the flat indices cell·C + slot of the
    occupied slots, row by row.  Takes one host sync (the count)."""
    _, n_cells, C = feat.shape
    valid = feat[9] > 0.5
    sel = torch.nonzero(valid.reshape(-1)).squeeze(1)
    n_rows = sel.numel() + 1
    cell, _, _, table = rows_of_cells(valid.sum(1), n_rows)
    planes = feat.reshape(10, n_cells * C)[0:9]
    live = cell >= 0
    pad = torch.cat([sel, sel.new_zeros(1)])
    rows = pack_rows(*(planes[k:k + 3, pad].T for k in (0, 3, 6)), cell,
                     table, live)
    return rows, sel


def rows_to_planes(state: torch.Tensor, index=None) -> torch.Tensor:
    """(k, R, 4) rows, gathered at ``index`` if given → (3k, n) planes."""
    g = state[:, :, :3] if index is None else state[:, index, :3]
    return g.permute(0, 2, 1).reshape(3 * state.shape[0], g.shape[1])


def neighbour_runs(cell: torch.Tensor, table: torch.Tensor, dims):
    """The nine runs of each row's 27 neighbour cells, in (dx, dy) order:
    a list of ``(lo, hi)`` int64 pairs, each (R,), where rows ``[lo, hi)``
    hold cells ``(i+dx, j+dy, max(k−1, 0) … min(k+1, nz−1))``; an empty
    run (lo = hi) where i+dx or j+dy leaves the grid or the row is dead.
    The vectorised form of the kernels' arithmetic (``csrc/dem_pairs.cuh``
    ``neighbour_run``)."""
    nx, ny, nz = dims
    live = cell >= 0
    c = torch.clamp(cell.long(), min=0)
    k = c % nz
    j = (c // nz) % ny
    i = c // (nz * ny)
    k0 = torch.clamp(k - 1, min=0)
    k1 = torch.clamp(k + 1, max=nz - 1)
    start = table[:, 0].long()
    end = start + table[:, 1].long()
    runs = []
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            ii, jj = i + dx, j + dy
            ok = live & (ii >= 0) & (ii < nx) & (jj >= 0) & (jj < ny)
            base = (torch.clamp(ii, 0, nx - 1) * ny
                    + torch.clamp(jj, 0, ny - 1)) * nz
            lo = start[base + k0]
            hi = torch.where(ok, end[base + k1], lo)
            runs.append((lo, hi))
    return runs
