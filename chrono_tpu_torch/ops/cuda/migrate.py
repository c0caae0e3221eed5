"""K2: rebin (10, n_cells, C) cell-slot planes by at most one cell per axis.

Replaces the TPU kernel ``chrono_tpu/ops/pallas/migrate_kernel.py``
``migrate_flat_pallas`` (and the kernel half of ``chrono_tpu/dem/
cell_dense.py`` ``migrate_flat``).  The CUDA kernel (``csrc/migrate.cu``)
runs one thread per destination cell and gathers from the 27 source cells in
the order (dx, dy, dz, slot).  Its plain twin, :func:`dem_migrate_plain`,
makes the same 27-source gather with a cumulative-sum rank and a scatter, so
it places the same particles in the same slots: the two agree bit for bit.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from chrono_tpu_torch.collision.cell_list import GridSpec, cell_ijk
from chrono_tpu_torch.ops.cuda import _build

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


@functools.cache
def _launcher():
    fn = _build.load("migrate").dem_migrate_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.POINTER(_MigrateParams), ctypes.c_void_p,
                   ctypes.c_int]
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
    params = _MigrateParams(*grid.dims, C,
                            (ctypes.c_float * 3)(*grid.origin),
                            grid.cell_size)
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
