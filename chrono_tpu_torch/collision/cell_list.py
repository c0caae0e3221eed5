"""Uniform grid: cell coordinates, periodic wrapping, the sorted cell list
and its 27-cell candidates, the cell-slot feature table and compaction.

Counterpart of ``chrono_tpu/collision/cell_list.py`` (``GridSpec``,
``wrap_positions``, ``min_image``, ``cell_ijk``, ``cell_index``,
``CellList``, ``build_cell_list``, ``neighbor_candidates``,
``build_feature_table``, ``neighbor_feature_rows``, ``topk_select``,
``cell_occupancy_max``, ``compact_rows``).  A grid may be periodic on any
axis: the neighbour lists of ``dem.neighbors`` wrap the cell neighbourhood
and take minimum-image displacements there.  The paths that run
non-periodic boxes only (the SPH and CRM cell-sorted engines, as in the
JAX package; the DEM cell-slot and row paths, the NSC pencil and the
contact pipeline) refuse a periodic grid at their entry points
(:func:`refuse_periodic`).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from chrono_tpu_torch.utils.segment import rank_in_run
from chrono_tpu_torch.utils.tree import tensor_dataclass


@dataclass(frozen=True)
class GridSpec:
    """Static description of the uniform grid."""

    origin: tuple = (0.0, 0.0, 0.0)
    cell_size: float = 1.0
    dims: tuple = (8, 8, 8)  # (nx, ny, nz)
    periodic: tuple = (False, False, False)

    @property
    def n_cells(self) -> int:
        nx, ny, nz = self.dims
        return nx * ny * nz

    @property
    def lengths(self) -> tuple:
        return tuple(d * self.cell_size for d in self.dims)


def refuse_periodic(grid: GridSpec, what: str) -> None:
    """Raise for a periodic ``grid`` at an entry point that runs
    non-periodic boxes only."""
    if any(grid.periodic):
        raise NotImplementedError(
            f"periodic grids are not ported to {what}: it runs "
            "non-periodic boxes only")


def _axis_mask(grid: GridSpec, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(grid.periodic, dtype=torch.bool, device=like.device)


def wrap_positions(grid: GridSpec, pos: torch.Tensor) -> torch.Tensor:
    """Wrap positions into the domain along periodic axes."""
    if not any(grid.periodic):
        return pos
    origin = torch.tensor(grid.origin, dtype=pos.dtype, device=pos.device)
    L = torch.tensor(grid.lengths, dtype=pos.dtype, device=pos.device)
    wrapped = origin + torch.remainder(pos - origin, L)
    return torch.where(_axis_mask(grid, pos), wrapped, pos)


def min_image(grid: GridSpec, d: torch.Tensor) -> torch.Tensor:
    """Minimum-image displacement for periodic axes (``round`` half to
    even, as ``jnp.round``): d − L·round(d / L) on each periodic axis, the
    other axes as they are (a new tensor; ``d`` is not changed)."""
    if not any(grid.periodic):
        return d
    d = d.clone()
    for ax, (per, L) in enumerate(zip(grid.periodic, grid.lengths)):
        if per:
            c = d[..., ax]
            c.sub_(L * torch.round(c / L))
    return d


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


def build_feature_table(grid: GridSpec, pos: torch.Tensor,
                        feat: torch.Tensor, max_per_cell: int):
    """Write per-particle feature rows into the cell-slot table.

    ``feat``: (N, ch).  Returns ``(table (n_cells, K·ch), overflow ()
    int32)``: each table row packs K slots × ch channels, a cell's
    particles in index order (a stable sort by cell); empty slots are
    zero, so callers carry an explicit validity channel in ``feat``.

    Scatters with duplicate indices: the JAX package writes every particle
    past a cell's K-th into slot K−1 as well, so which one lands there is
    undefined (and ``detect_contacts`` drops the overflow flag).  This port
    writes only the particles under the cap, so its table is deterministic
    and equals the JAX package's wherever no cell holds more than K.
    """
    n, ch = feat.shape
    K = max_per_cell
    ids = cell_index(grid, pos)
    ids_sorted, order = torch.sort(ids, stable=True)
    rank = rank_in_run(ids_sorted)
    most = torch.max(rank) + 1 if n else torch.zeros((), dtype=torch.int64,
                                                       device=pos.device)
    overflow = torch.clamp_min(most - K, 0).to(torch.int32)
    dump = grid.n_cells * K
    flat = torch.where(rank < K, ids_sorted * K + rank,
                       torch.full_like(rank, dump))
    table = feat.new_zeros((dump + 1, ch))
    table[flat] = feat[order]
    return table[:dump].reshape(grid.n_cells, K * ch), overflow


_OFFSETS_27 = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
               for dz in (-1, 0, 1)]


@tensor_dataclass
class CellList:
    """Markers sorted by cell: ``order`` (N,) int32 the stable sort (a
    cell's markers in index order), ``start`` and ``count`` (n_cells,)
    int64 each cell's run in it."""

    order: torch.Tensor
    start: torch.Tensor
    count: torch.Tensor


def build_cell_list(grid: GridSpec, pos: torch.Tensor) -> CellList:
    """The sorted cell list; integer counts by ``bincount``, no host
    sync."""
    ids = cell_index(grid, pos)
    order = torch.sort(ids, stable=True).indices.to(torch.int32)
    count = torch.bincount(ids, minlength=grid.n_cells)
    return CellList(order=order, start=torch.cumsum(count, 0) - count,
                    count=count)


def neighbour_cells(grid: GridSpec, query_ijk: torch.Tensor):
    """The 27 neighbour cells of each query cell (the offsets dx-major,
    then dy, then dz): ``(cells (Q, 27) int64, in_range (Q, 27) bool)``;
    an out-of-range neighbour is wrapped into the grid, and flagged out of
    range unless its axis is periodic."""
    _, ny, nz = grid.dims
    dev = query_ijk.device
    dims = torch.tensor(grid.dims, dtype=torch.int64, device=dev)
    offs = torch.tensor(_OFFSETS_27, dtype=torch.int64, device=dev)
    nb = query_ijk.long()[:, None, :] + offs[None, :, :]       # (Q, 27, 3)
    in_range = torch.all((nb >= 0) & (nb < dims)
                         | _axis_mask(grid, nb)[None, None, :], dim=-1)
    nb = torch.remainder(nb, dims)
    return (nb[..., 0] * ny + nb[..., 1]) * nz + nb[..., 2], in_range


def neighbor_candidates(grid: GridSpec, cl: CellList,
                        query_ijk: torch.Tensor, max_per_cell: int):
    """For each query cell (Q, 3 ijk), the markers of its 3×3×3
    neighbourhood: ``(cand (Q, 27·max_per_cell) int32, valid (Q, 27·C)
    bool)``, each neighbour cell's first ``max_per_cell`` markers in
    sorted order; slots past a cell's count are invalid.  A periodic axis
    needs at least 3 cells: with fewer, the neighbourhood wraps onto the
    same cell more than once."""
    for ax in range(3):
        if grid.periodic[ax] and grid.dims[ax] < 3:
            raise ValueError(
                f"periodic axis {ax} needs >=3 cells (got {grid.dims[ax]}): "
                "with fewer, the 3x3x3 neighborhood wraps onto the same cell "
                "more than once and pairs get double-counted")
    cells, in_range = neighbour_cells(grid, query_ijk)
    slots = torch.arange(max_per_cell, device=query_ijk.device)
    idx_sorted = cl.start[cells][..., None] + slots             # (Q, 27, C)
    valid = (slots < cl.count[cells][..., None]) & in_range[..., None]
    cand = cl.order[torch.clamp(idx_sorted, max=cl.order.shape[0] - 1)]
    Q = query_ijk.shape[0]
    return cand.reshape(Q, -1), valid.reshape(Q, -1)


def neighbor_feature_rows(grid: GridSpec, table: torch.Tensor,
                          query_ijk: torch.Tensor, max_per_cell: int,
                          ch: int):
    """Fetch the 3×3×3 neighbourhood's packed feature rows per query (the
    offsets dx-major, then dy, then dz).

    Returns ``(feat (Q, 27, K, ch), in_range (Q, 27) bool)``; an
    out-of-range neighbour cell is wrapped into the grid, as the JAX
    package wraps it, and flagged out of range on a non-periodic axis.
    """
    cells, in_range = neighbour_cells(grid, query_ijk)
    rows = table[cells]                                       # (Q, 27, K·ch)
    return rows.reshape(query_ijk.shape[0], 27, max_per_cell, ch), in_range


def topk_select(ok: torch.Tensor, capacity: int):
    """Indices of the first ``capacity`` True entries of ``ok``, in order.

    Contact order: a stable sort on the 0/1 key keeps the valid entries in
    their order in ``ok`` (the detection segments in turn: sphere–sphere,
    sphere–box, sphere–triangle), which fixes the contact rows' order, the
    projector's triples and the solver's sums; entries past ``capacity``
    are dropped.  Returns ``(sel (capacity,) int64, active (capacity,)
    bool, count () int32)``, ``count`` the true number of valid entries
    (it may exceed capacity); inactive slots point at entry n−1.
    """
    n = ok.shape[0]
    order = torch.sort((~ok).to(torch.uint8), stable=True).indices
    if capacity > n:
        order = torch.cat([order, order.new_full((capacity - n,), n - 1)])
    sel = order[:capacity]
    k = min(capacity, n)
    active = torch.zeros((capacity,), dtype=torch.bool, device=ok.device)
    active[:k] = ok[sel[:k]]
    return (torch.where(active, sel, torch.full_like(sel, n - 1)), active,
            torch.sum(ok).to(torch.int32))


def cell_occupancy_max(grid: GridSpec, pos: torch.Tensor) -> torch.Tensor:
    """Most particles in any cell (for capacity checks); integer counts, so
    the order of the adds does not matter."""
    ids = cell_index(grid, pos)
    counts = torch.zeros((grid.n_cells,), dtype=torch.int64,
                         device=pos.device)
    counts.scatter_add_(0, ids, torch.ones_like(ids))
    return counts.max().to(torch.int32)


def compact_rows(cand: torch.Tensor, valid: torch.Tensor, k_out: int,
                 fill: int = -1):
    """Left-pack each row's valid entries into ``k_out`` slots, in their
    order in the row: (Q, C) candidates and mask → ``(idx (Q, k_out),
    valid (Q, k_out))``.  Entries past ``k_out`` in a row are dropped
    (count the overflow upstream).  Each kept entry has a slot of its own;
    the dropped ones all go to a dump column that is cut off, so the result
    does not depend on the order of the writes."""
    Q = cand.shape[0]
    place = torch.cumsum(valid, dim=1) - 1
    place = torch.where(valid, place, k_out).clamp_(max=k_out)
    out = cand.new_full((Q, k_out + 1), fill)
    out.scatter_(1, place, cand)
    out = out[:, :k_out]
    return out, out != fill
