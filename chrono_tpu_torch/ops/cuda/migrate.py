"""K2: rebin particles by at most one cell per axis.

Replaces the TPU kernel ``chrono_tpu/ops/pallas/migrate_kernel.py``
``migrate_flat_pallas`` (and the kernel half of ``chrono_tpu/dem/
cell_dense.py`` ``migrate_flat``).  Two forms, both in ``csrc/migrate.cu``:

* :func:`dem_migrate_rows`, the main path's: from one cycle's cell-sorted
  rows (``dem/rows.py``) and their particle ids to the next cycle's rows,
  with each cell's landing count.  A key pass writes every row's new
  cell; then a warp per 32 cells of a column sweeps the rows of the nine
  neighbour columns, counting, then copying, so that a cell's landers
  come in ascending row order: the slot walk's order (dx, dy, dz, slot).
  Its twin :func:`dem_migrate_rows_plain` sorts the rows by new cell
  instead (a stable sort keeps that order) and agrees bit for bit.
* :func:`dem_migrate`, on (10, n_cells, C) slot planes: one thread per
  destination cell gathers from the 27 source cells in the same order.
  Its twin, :func:`dem_migrate_plain`, makes the same 27-source gather with
  a cumulative-sum rank and a scatter: the two agree bit for bit.

Rows of the slot form's output (``rows_from_prefix_slots``) equal the row
form's output.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from chrono_tpu_torch.collision.cell_list import GridSpec, cell_ijk
from chrono_tpu_torch.dem.rows import CellRows, rows_of_cells
from chrono_tpu_torch.ops.cuda import _build
from chrono_tpu_torch.ops.cuda.dem_substep import check_rows
from chrono_tpu_torch.ops.cuda.sph_substep import overlaps

N_FEAT = 10


def dem_migrate_plain(feat: torch.Tensor, ids: torch.Tensor, grid: GridSpec):
    """Plain PyTorch twin: returns (feat', ids', count) with count (n_cells,)
    int32 the number of particles whose new cell is each cell."""
    F, n_cells, C = feat.shape
    nx, ny, nz = grid.dims

    def candidates(a, fill):  # (…, n_cells, C) → (…, nx, ny, nz, 27·C)
        lead = a.shape[:-2]
        out = a.new_full(lead + (nx + 2, ny + 2, nz + 2, C), fill)
        out[..., 1:-1, 1:-1, 1:-1, :] = a.reshape(lead + (nx, ny, nz, C))
        return torch.cat([out[..., 1 + dx:1 + dx + nx, 1 + dy:1 + dy + ny,
                              1 + dz:1 + dz + nz, :]
                          for dx in (-1, 0, 1) for dy in (-1, 0, 1)
                          for dz in (-1, 0, 1)], dim=-1)

    cand = candidates(feat, 0.0)
    cand_ids = candidates(ids, -1)
    dest = cell_ijk(grid, cand[0:3].movedim(0, -1))    # (nx,ny,nz,27C,3)
    here = torch.stack(torch.meshgrid(
        *(torch.arange(d, dtype=torch.int32, device=feat.device)
          for d in grid.dims), indexing="ij"), dim=-1)[..., None, :]
    match = (cand[9] > 0.5) & (dest == here).all(-1)
    rank = torch.cumsum(match, dim=-1) - 1
    keep = match & (rank < C)
    cell = torch.arange(n_cells, device=feat.device).reshape(nx, ny, nz, 1)
    slot = (cell * C + rank)[keep]
    feat_out = feat.new_zeros((F, n_cells * C))
    feat_out[:, slot] = cand[:, keep]
    ids_out = ids.new_full((n_cells * C,), -1)
    ids_out[slot] = cand_ids[keep]
    count = match.sum(-1).reshape(n_cells).to(torch.int32)
    return feat_out.reshape(F, n_cells, C), ids_out.reshape(n_cells, C), count


class _MigrateParams(ctypes.Structure):
    _fields_ = ([(k, ctypes.c_int) for k in ("nx", "ny", "nz", "C")]
                + [("origin", ctypes.c_float * 3),
                   ("cell_size", ctypes.c_float)])


def _params(grid: GridSpec, capacity: int) -> _MigrateParams:
    return _MigrateParams(*grid.dims, capacity,
                          (ctypes.c_float * 3)(*grid.origin),
                          grid.cell_size)


def _launcher(name: str = "dem_migrate"):
    return _bind(name, _build.DEFINES)


@functools.cache
def _bind(name: str, defines: tuple):
    """The launcher of the build that ``_build.load`` returns under
    ``defines`` (the cache key: each build binds its own)."""
    fn = getattr(_build.load("migrate"), f"{name}_launch")
    n_ptr, n_int = {"dem_migrate": (5, 1), "dem_migrate_rows": (11, 3)}[name]
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                   + [ctypes.POINTER(_MigrateParams), ctypes.c_void_p,
                      ctypes.c_int])
    fn.restype = ctypes.c_int
    return fn


def _launch(feat_in, ids_in, feat_out, ids_out, count, grid: GridSpec):
    n_cells = grid.n_cells
    C = feat_in.shape[-1]
    expect = {"feat_in": (feat_in, torch.float32, (N_FEAT, n_cells, C)),
              "feat_out": (feat_out, torch.float32, (N_FEAT, n_cells, C)),
              "ids_in": (ids_in, torch.int32, (n_cells, C)),
              "ids_out": (ids_out, torch.int32, (n_cells, C)),
              "count": (count, torch.int32, (n_cells,))}
    for name, (t, dtype, shape) in expect.items():
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous() or t.device != feat_in.device:
            raise ValueError(f"{name} must be contiguous on {feat_in.device}")
    if {feat_out.data_ptr(), ids_out.data_ptr()} & {feat_in.data_ptr(),
                                                    ids_in.data_ptr()}:
        raise ValueError("the migration runs out of place")
    if n_cells == 0 or N_FEAT * n_cells * C >= 2 ** 31:
        raise ValueError(f"{n_cells} cells is outside the kernel's range")
    params = _params(grid, C)
    err = _launcher()(feat_in.data_ptr(), ids_in.data_ptr(),
                      feat_out.data_ptr(), ids_out.data_ptr(),
                      count.data_ptr(), n_cells, ctypes.byref(params),
                      torch.cuda.current_stream(feat_in.device).cuda_stream,
                      feat_in.device.index)
    if err != 0:
        raise RuntimeError(f"dem_migrate launch failed: cudaError {err}")


def dem_migrate(feat_in: torch.Tensor, ids_in: torch.Tensor,
                feat_out: torch.Tensor, ids_out: torch.Tensor,
                count: torch.Tensor, grid: GridSpec) -> None:
    """Rebin feat_in / ids_in into feat_out / ids_out and write the per-cell
    landing count.  A CUDA tensor launches the kernel; a CPU tensor runs the
    twin."""
    if feat_in.device.type == "cuda":
        _launch(feat_in, ids_in, feat_out, ids_out, count, grid)
        dem_migrate.launches += 1
    elif feat_in.device.type == "cpu":
        f, i, n = dem_migrate_plain(feat_in, ids_in, grid)
        feat_out.copy_(f)
        ids_out.copy_(i)
        count.copy_(n)
    else:
        raise ValueError(f"no dem_migrate for device {feat_in.device}")


dem_migrate.launches = 0


# ------------------------------------------------------------- row form


def dem_migrate_rows_plain(rows: CellRows, ids: torch.Tensor,
                           grid: GridSpec, capacity: int):
    """Plain PyTorch twin of :func:`dem_migrate_rows`: ``(rows', ids',
    landed)``.  Each live row's new cell; a row whose new cell is more than
    one cell from its old one on an axis is dropped, since no cell's walk
    finds it; a stable sort of the rest by new cell, which keeps the walk's
    order (its runs visit rows in ascending order); the first ``capacity``
    of each cell kept.  No host sync."""
    n_cells = grid.n_cells
    n_rows = rows.n_rows
    dev = rows.state.device
    live = rows.cell >= 0
    new = cell_ijk(grid, rows.state[0, :, :3]).long()
    _, ny, nz = grid.dims
    c = torch.clamp(rows.cell.long(), min=0)
    old = torch.stack([c // (ny * nz), (c // nz) % ny, c % nz], dim=1)
    found = live & ((new - old).abs() <= 1).all(1)
    key = torch.where(found, (new[:, 0] * ny + new[:, 1]) * nz + new[:, 2],
                      n_cells)
    order = torch.argsort(key, stable=True)
    landed = torch.bincount(key, minlength=n_cells + 1)[:n_cells]
    cells = torch.arange(n_cells, device=dev)
    first = torch.searchsorted(key[order], cells)
    cell, rank, _, table = rows_of_cells(torch.clamp(landed, max=capacity),
                                         n_rows)
    alive = cell >= 0
    src = order[torch.where(alive, first[torch.clamp(cell, min=0)] + rank,
                            0)]
    state = torch.where(alive[None, :, None], rows.state[:, src],
                        rows.state.new_zeros(()))
    ids_out = torch.where(alive, ids[src], -1).to(torch.int32)
    out = CellRows(state=state, cell=cell.to(torch.int32), table=table)
    return out, ids_out, landed.to(torch.int32)


def row_blocks(grid: GridSpec) -> int:
    """Blocks of the row kernel's count and copy launches: a warp for each
    segment of 32 cells of a column, 8 warps a block."""
    nx, ny, nz = grid.dims
    return -(-nx * ny * -(-nz // 32) // 8)


def _check_migrate_rows(rows, ids, out, ids_out, landed, grid, capacity):
    check_rows(rows, grid.dims, out.state, 3)
    if capacity < 1:
        raise ValueError(f"capacity {capacity} < 1")
    n_rows = rows.n_rows
    for name, t, shape in (("out.cell", out.cell, (n_rows,)),
                           ("out.table", out.table, (grid.n_cells, 2)),
                           ("ids", ids, (n_rows,)),
                           ("ids_out", ids_out, (n_rows,)),
                           ("landed", landed, (grid.n_cells,))):
        if (t.dtype != torch.int32 or tuple(t.shape) != shape
                or not t.is_contiguous() or t.device != rows.state.device):
            raise ValueError(f"{name} must be contiguous int32 {shape} on "
                             f"{rows.state.device}")
    ins = (rows.state, rows.cell, rows.table, ids)
    outs = (out.state, out.cell, out.table, ids_out, landed)
    if any(overlaps(a, b) for a in ins for b in outs) or any(
            overlaps(a, b) for i, a in enumerate(outs) for b in outs[i + 1:]):
        raise ValueError("the migration runs out of place, into separate "
                         "outputs")


def dem_migrate_rows(rows: CellRows, ids: torch.Tensor, out: CellRows,
                     ids_out: torch.Tensor, landed: torch.Tensor,
                     grid: GridSpec, capacity: int) -> None:
    """Migrate ``rows`` (with their particle ids, (R,) int32) into ``out``
    and ``ids_out``, at most ``capacity`` rows a cell, and write each cell's
    landing count into ``landed`` (n_cells,) int32: ``max(landed) − C`` is
    the overflow; a row that moved two or more cells on an axis lands
    nowhere.  A CUDA tensor launches the kernel; a CPU tensor runs the
    twin."""
    dev = rows.state.device
    if dev.type == "cuda":
        _check_migrate_rows(rows, ids, out, ids_out, landed, grid, capacity)
        n_rows, n_cells = rows.n_rows, grid.n_cells
        key = torch.empty(n_rows, dtype=torch.int32, device=dev)
        n_blocks = row_blocks(grid)
        block_total = torch.empty(n_blocks, dtype=torch.int32, device=dev)
        params = _params(grid, capacity)
        err = _launcher("dem_migrate_rows")(
            *(t.data_ptr() for t in (
                rows.state, rows.cell, rows.table, ids, out.state, out.cell,
                out.table, ids_out, landed, key, block_total)),
            n_rows, n_cells, n_blocks, ctypes.byref(params),
            torch.cuda.current_stream(dev).cuda_stream, dev.index)
        if err != 0:
            raise RuntimeError(f"dem_migrate_rows launch failed: cudaError "
                               f"{err}")
        dem_migrate_rows.launches += 1
    elif dev.type == "cpu":
        r, i, n = dem_migrate_rows_plain(rows, ids, grid, capacity)
        for a, b in ((out.state, r.state), (out.cell, r.cell),
                     (out.table, r.table), (ids_out, i), (landed, n)):
            a.copy_(b)
    else:
        raise ValueError(f"no dem_migrate_rows for device {dev}")


dem_migrate_rows.launches = 0
