"""Uniform grid: cell coordinates, the cell-slot feature table and
compaction.

Counterpart of ``chrono_tpu/collision/cell_list.py`` (``GridSpec``,
``cell_ijk``, ``cell_index``, ``build_feature_table``,
``neighbor_feature_rows``, ``topk_select``, ``cell_occupancy_max``).
Non-periodic grids only: the DEM cell-slot path this package ports rejects
periodic axes in the JAX package too.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from chrono_tpu_torch.utils.segment import rank_in_run


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


def neighbor_feature_rows(grid: GridSpec, table: torch.Tensor,
                          query_ijk: torch.Tensor, max_per_cell: int,
                          ch: int):
    """Fetch the 3×3×3 neighbourhood's packed feature rows per query (the
    offsets dx-major, then dy, then dz).

    Returns ``(feat (Q, 27, K, ch), in_range (Q, 27) bool)``; an
    out-of-range neighbour cell is wrapped into the grid, as the JAX
    package wraps it, and flagged out of range.
    """
    _, ny, nz = grid.dims
    dev = query_ijk.device
    dims = torch.tensor(grid.dims, dtype=torch.int64, device=dev)
    offs = torch.tensor(_OFFSETS_27, dtype=torch.int64, device=dev)
    nb = query_ijk.long()[:, None, :] + offs[None, :, :]       # (Q, 27, 3)
    in_range = torch.all((nb >= 0) & (nb < dims), dim=-1)
    nb = torch.remainder(nb, dims)
    cells = (nb[..., 0] * ny + nb[..., 1]) * nz + nb[..., 2]
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
