"""DEM pair forces and torques alone on cell-sorted rows.

Replaces the TPU kernels ``chrono_tpu/ops/pallas/dem_pencil_kernel.py``
``dem_pencil_forces_pallas`` and ``chrono_tpu/ops/pallas/dem_cell_kernel.py``
``dem_cell_forces_pallas``.  The CUDA kernel (``csrc/dem_forces.cu``) runs one
thread per occupied particle of the rows of ``dem/rows.py`` over its nine
neighbour runs, with the pair loop it shares with K1 (``csrc/dem_pairs.cuh``),
and writes (2, R, 4) rows: force and torque, zeros on dead rows.
:func:`dem_forces_rows` launches it (its plain twin:
:func:`dem_forces_rows_plain`); :func:`dem_forces` keeps the JAX API's
(10, n_cells, C) slot planes → (6, n_cells, C) force xyz and torque xyz
planes, zeros on empty slots, by compacting and scattering back, and
:func:`dem_forces_plain` is the slot planes' own twin, the vectorised
27-neighbour form of the JAX ``cell_dense_forces``.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from chrono_tpu_torch.dem.forces import cell_pair_forces, row_pair_forces
from chrono_tpu_torch.dem.rows import CellRows, rows_from_slots, rows_to_planes
from chrono_tpu_torch.ops.cuda import _build
from chrono_tpu_torch.ops.cuda.dem_substep import check_rows
from chrono_tpu_torch.ops.cuda.sph_substep import overlaps

N_FEAT = 10
N_OUT = 6


@dataclass(frozen=True)
class PairCoefs:
    """Host-side constants of the pair pass (m* = m/2, r* = r/2)."""

    dims: tuple
    capacity: int
    radius: float
    kn: float
    gn: float
    kt: float
    gt: float
    mu: float
    dt: float
    friction: bool

    @functools.cached_property
    def kernel_params(self) -> "_ForcesParams":
        """The kernel's argument struct, packed once."""
        return _ForcesParams(*self.dims, self.radius, self.kn, self.gn,
                             self.kt, self.gt, self.mu, self.dt,
                             int(self.friction))


def dem_forces_plain(feat: torch.Tensor, c: PairCoefs) -> torch.Tensor:
    """Plain PyTorch twin on slot planes: (10, n_cells, C) → (6, n_cells, C)
    by the 27-cell slot walk."""
    grid = feat.reshape((N_FEAT,) + tuple(c.dims) + (feat.shape[2],))
    force, torque = cell_pair_forces(grid[0:3], grid[3:6], grid[6:9],
                                     grid[9] > 0.5, c.radius, c.kn, c.gn,
                                     c.kt, c.gt, c.mu, c.dt, c.friction)
    return torch.cat([force, torque]).reshape((N_OUT,) + feat.shape[1:])


def dem_forces_rows_plain(rows: CellRows, c: PairCoefs) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: (3, R, 4) rows → (2, R, 4) force
    and torque rows by the nine-run walk, zeros on dead rows."""
    force, torque = row_pair_forces(rows.state, rows.cell, rows.table, c.dims,
                                    c.radius, c.kn, c.gn, c.kt, c.gt, c.mu,
                                    c.dt, c.friction)
    out = rows.state.new_zeros((2, rows.n_rows, 4))
    out[0, :, :3] = force.T
    out[1, :, :3] = torque.T
    return out


class _ForcesParams(ctypes.Structure):
    _fields_ = ([(k, ctypes.c_int) for k in ("nx", "ny", "nz")]
                + [(k, ctypes.c_float) for k in
                   ("radius", "kn", "gn", "kt", "gt", "mu", "dt")]
                + [("friction", ctypes.c_int)])


@functools.cache
def _launcher():
    fn = _build.load("dem_forces").dem_forces_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int,
                   ctypes.POINTER(_ForcesParams), ctypes.c_void_p,
                   ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn


def dem_forces_rows(rows: CellRows, out: torch.Tensor,
                    c: PairCoefs) -> None:
    """out (2, R, 4) ← the pair force and torque of each row, zeros on dead
    rows.  A CUDA tensor launches the kernel; a CPU tensor runs the twin."""
    dev = rows.state.device
    if dev.type == "cuda":
        check_rows(rows, c.dims, out, 2)
        err = _launcher()(rows.state.data_ptr(), out.data_ptr(),
                          rows.cell.data_ptr(), rows.table.data_ptr(),
                          rows.n_rows, ctypes.byref(c.kernel_params),
                          torch.cuda.current_stream(dev).cuda_stream,
                          dev.index)
        if err != 0:
            raise RuntimeError(f"dem_forces launch failed: cudaError {err}")
        dem_forces_rows.launches += 1
    elif dev.type == "cpu":
        out.copy_(dem_forces_rows_plain(rows, c))
    else:
        raise ValueError(f"no dem_forces for device {dev}")


dem_forces_rows.launches = 0


def dem_forces(feat: torch.Tensor, out: torch.Tensor, c: PairCoefs) -> None:
    """out ← the pair force and torque planes of feat: (10, n_cells, C) →
    (6, n_cells, C) float32, zeros on empty slots: the occupied slots
    compacted to rows, :func:`dem_forces_rows`, and scattered back."""
    n_cells = c.dims[0] * c.dims[1] * c.dims[2]
    for name, t, f in (("feat", feat, N_FEAT), ("out", out, N_OUT)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32")
        if tuple(t.shape) != (f, n_cells, c.capacity):
            raise ValueError(f"{name} must be ({f}, {n_cells}, "
                             f"{c.capacity}), got {tuple(t.shape)}")
        if t.device.type not in ("cuda", "cpu"):
            raise ValueError(f"no dem_forces for device {t.device}")
    if out.device != feat.device:
        raise ValueError("out must be on feat's device")
    if overlaps(feat, out):
        raise ValueError("the force pass runs out of place")
    rows, sel = rows_from_slots(feat)
    f = rows.state.new_empty((2, rows.n_rows, 4))
    dem_forces_rows(rows, f, c)
    out.zero_()
    out.view(N_OUT, -1)[:, sel] = rows_to_planes(f[:, :sel.numel()])
