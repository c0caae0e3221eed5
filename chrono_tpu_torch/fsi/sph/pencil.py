"""WCSPH advance on cell-sorted markers: the dam break's main path.

Counterpart of ``chrono_tpu/fsi/sph/pencil.py`` (``bin_to_pencils``,
``pencils_to_state``, ``make_sph_advance_pencil``).  The name is kept so
that a reader finds the counterpart, but the layout is not pencils: the
markers are sorted by cell id into a (10, N) structure of arrays with a
per-cell ``(start, count)`` table, once per cycle, with sweep A's thread
order (the live solid markers first), and each substep is the three sweeps
of ``ops.cuda.sph_substep``.  The JAX advance's row-activity
masks have no counterpart: a GPU thread of a solid or empty region simply
skips its pair loop.
"""

from __future__ import annotations

import torch

from chrono_tpu_torch.collision.cell_list import (
    GridSpec, cell_index, refuse_periodic,
)
from chrono_tpu_torch.fsi.sph.state import FLUID, SPHParams, SPHState
from chrono_tpu_torch.ops.cuda.sph_substep import (
    N_ADAMI, PX, PZ, RHO, VX, VZ, SortedCells, adami_walk_order,
    sph_static_params, sph_substep, state_planes,
)


def bin_to_cells(grid: GridSpec, capacity: int, pos: torch.Tensor):
    """Sort markers by cell: ``(order, cells, overflow)`` with ``order``
    (N,) int64 the sorted position → input index (a stable sort, so markers
    keep their input order inside a cell), ``cells`` the cell table, and
    ``overflow`` () int32 = max occupancy − capacity, clamped at 0."""
    ids = cell_index(grid, pos)
    order = torch.argsort(ids, stable=True)
    ids_sorted = ids[order]
    cid = torch.arange(grid.n_cells, device=pos.device)
    start = torch.searchsorted(ids_sorted, cid)
    count = torch.searchsorted(ids_sorted, cid, right=True) - start
    overflow = torch.clamp(count.max() - capacity, min=0).to(torch.int32)
    cells = SortedCells(cell=ids_sorted.to(torch.int32),
                        start=start.to(torch.int32),
                        count=count.to(torch.int32),
                        dims=tuple(grid.dims), capacity=capacity)
    return order, cells, overflow


def state_to_cells(grid: GridSpec, capacity: int, state: SPHState, consts):
    """``(feat, order, cells, overflow)``: the (10, N) sorted state planes
    and the binning of :func:`bin_to_cells`."""
    order, cells, overflow = bin_to_cells(grid, capacity, state.pos)
    feat = state_planes(state.pos[order], state.vel[order],
                        state.rho[order], state.kind[order] == FLUID, consts)
    return feat, order, cells, overflow


def cells_to_state(feat: torch.Tensor, order: torch.Tensor,
                   state: SPHState) -> SPHState:
    """Scatter the sorted planes back into the input marker order."""
    out = torch.empty((RHO + 1, feat.shape[1]), dtype=feat.dtype,
                      device=feat.device)
    out[:, order] = feat[:RHO + 1]
    return state.replace(pos=out[PX:PZ + 1].T.contiguous(),
                         vel=out[VX:VZ + 1].T.contiguous(), rho=out[RHO])


def make_sph_advance_pencil(params: SPHParams, grid: GridSpec,
                            capacity: int = 32, *, device):
    """``advance(state, n_cycles) → (state, overflow)``.

    One cycle bins the markers, runs ``params.rebuild_every`` symplectic
    substeps (three sweeps each) and unbins them.  ``overflow`` is the
    largest capacity excess seen over the call (0 when every cell fits).
    Cells must be at least the kernel support 2h, so that one ring of 27
    cells covers it; the grid is not periodic.  The state is moved to
    ``device``.
    """
    refuse_periodic(grid, "the SPH cell-sorted engine")
    consts = sph_static_params(params)
    support = 2.0 * float(params.h)
    if float(grid.cell_size) < support - 1e-9:
        raise ValueError(f"cell {grid.cell_size} < kernel support {support}: "
                         "one ring of 27 cells does not cover it")
    if capacity < 1:
        raise ValueError("capacity must be at least 1")
    steps = params.rebuild_every
    cycle_time = params.dt * steps

    def advance(state: SPHState, n_cycles: int):
        state = state.to(device)
        ovf = torch.zeros((), dtype=torch.int32, device=device)
        for _ in range(n_cycles):
            feat, order, cells, overflow = state_to_cells(
                grid, capacity, state, consts)
            n = feat.shape[1]
            spare = torch.empty_like(feat)
            adami = feat.new_empty((N_ADAMI, n))
            vel = feat.new_empty((3, n))
            walk_order = adami_walk_order(feat, cells)
            for _ in range(steps):
                sph_substep(feat, cells, consts, adami, vel, spare,
                            walk_order)
                feat, spare = spare, feat
            state = cells_to_state(feat, order, state)
            state = state.replace(time=state.time + cycle_time)
            ovf = torch.maximum(ovf, overflow)
        return state, ovf

    return advance

