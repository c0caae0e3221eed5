"""K1: one fused DEM substep on cell-sorted rows.

Replaces the TPU kernel ``chrono_tpu/ops/pallas/dem_flat_kernel.py``
``dem_flat_substep_pallas`` and the ``flatlane_kernel.py`` ``sym_sweep_flat``
sweep it runs on, and computes the substep of ``dem_sym_kernel.py``
``dem_sym_substep_pallas`` and ``dem_pencil_kernel.py``
``dem_pencil_substep_pallas`` (the same substep in other TPU layouts).  The
CUDA kernel (``csrc/dem_substep.cu``) runs one thread per occupied particle
of the rows of ``dem/rows.py`` and walks its nine neighbour runs (the pair
loop of ``csrc/dem_pairs.cuh``), each pair from both sides, so it needs no
atomics.  :func:`dem_substep_rows` launches it (its plain twin:
:func:`dem_substep_rows_plain`, the same walk vectorised);
:func:`dem_substep` keeps the JAX API's (10, n_cells, C) slot planes (pos
xyz, vel xyz, omega xyz, mask) by compacting, stepping and scattering back,
and :func:`dem_substep_plain` is the slot planes' own twin, the vectorised
27-neighbour form of the JAX ``cell_dense_forces`` plus the wall and Euler
tail.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional

import torch

from chrono_tpu_torch.dem.bc import PlaneBCs
from chrono_tpu_torch.dem.forces import (
    cell_pair_forces, plane_wall_forces, row_pair_forces,
)
from chrono_tpu_torch.dem.rows import (
    CellRows, rows_from_slots, rows_to_planes,
)
from chrono_tpu_torch.ops.cuda import _build
from chrono_tpu_torch.ops.cuda.sph_substep import overlaps

N_FEAT = 10
MAX_WALLS = 6


@dataclass(frozen=True)
class SubstepCoefs:
    """Host-side constants of one substep (pair: m* = m/2, r* = r/2;
    wall: m* = m, r* = r)."""

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
    planes: Optional[PlaneBCs]   # float32, on the CPU
    knw: float
    gnw: float
    ktw: float
    gtw: float
    muw: float
    gravity: tuple
    inv_m: float
    inv_I: float

    @functools.cached_property
    def kernel_params(self) -> "_SubstepParams":
        """The kernel's argument struct, packed once."""
        return _kernel_params(self)


def _tail(c: SubstepCoefs, pos, vel, omega, force, torque, live):
    """Plane walls, gravity and semi-implicit Euler on (3, M) planes; rows
    where ``live`` is false keep their values."""
    if c.planes is not None:
        fw, tw = plane_wall_forces(c.planes.to(pos.device), pos, vel, omega,
                                   c.radius, c.knw, c.gnw, c.ktw, c.gtw,
                                   c.muw, c.dt, c.friction)
        force = force + fw
        torque = torque + tw
    g = torch.tensor(c.gravity, dtype=pos.dtype,
                     device=pos.device).reshape(3, 1)
    vel2 = vel + c.dt * (force * c.inv_m + g) * live
    pos2 = pos + c.dt * vel2 * live
    omega2 = omega + c.dt * torque * c.inv_I * live
    return pos2, vel2, omega2


def dem_substep_plain(feat: torch.Tensor, c: SubstepCoefs) -> torch.Tensor:
    """Plain PyTorch twin on slot planes: returns the next (10, n_cells, C)
    of (10, n_cells, C) by the 27-cell slot walk."""
    grid = feat.reshape((N_FEAT,) + tuple(c.dims) + (feat.shape[2],))
    force, torque = cell_pair_forces(grid[0:3], grid[3:6], grid[6:9],
                                     grid[9] > 0.5, c.radius, c.kn, c.gn,
                                     c.kt, c.gt, c.mu, c.dt, c.friction)
    flat = feat.reshape(N_FEAT, -1)
    nxt = _tail(c, flat[0:3], flat[3:6], flat[6:9], force.reshape(3, -1),
                torque.reshape(3, -1), flat[9])
    return torch.cat([*nxt, flat[9:]]).reshape(feat.shape)


def dem_substep_rows_plain(rows: CellRows, c: SubstepCoefs) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: the next (3, R, 4) rows by the
    nine-run walk; dead rows keep their values."""
    s = rows.state
    force, torque = row_pair_forces(s, rows.cell, rows.table, c.dims,
                                    c.radius, c.kn, c.gn, c.kt, c.gt, c.mu,
                                    c.dt, c.friction)
    live = (rows.cell >= 0).to(s.dtype)
    nxt = _tail(c, *(s[k, :, :3].T for k in range(3)), force, torque, live)
    out = s.clone()
    for k, a in enumerate(nxt):
        out[k, :, :3] = a.T
    return out


class _Wall(ctypes.Structure):
    _fields_ = [("n", ctypes.c_float * 3), ("off", ctypes.c_float),
                ("v", ctypes.c_float * 3)]


class _SubstepParams(ctypes.Structure):
    _fields_ = ([(k, ctypes.c_int) for k in ("nx", "ny", "nz")]
                + [(k, ctypes.c_float) for k in
                   ("radius", "kn", "gn", "kt", "gt", "mu", "dt")]
                + [("friction", ctypes.c_int), ("n_walls", ctypes.c_int),
                   ("walls", _Wall * MAX_WALLS)]
                + [(k, ctypes.c_float) for k in
                   ("knw", "gnw", "ktw", "gtw", "muw")]
                + [("gravity", ctypes.c_float * 3), ("inv_m", ctypes.c_float),
                   ("inv_I", ctypes.c_float)])


def _kernel_params(c: SubstepCoefs) -> _SubstepParams:
    p = _SubstepParams(*c.dims, c.radius, c.kn, c.gn, c.kt, c.gt, c.mu, c.dt,
                       int(c.friction), 0)
    if c.planes is not None:
        normal = c.planes.normal.double()
        offset = (normal * c.planes.point.double()).sum(-1)
        p.n_walls = normal.shape[0]
        for b in range(p.n_walls):
            p.walls[b] = _Wall((ctypes.c_float * 3)(*normal[b].tolist()),
                               float(offset[b]),
                               (ctypes.c_float * 3)(*c.planes.vel[b].tolist()))
    p.knw, p.gnw, p.ktw, p.gtw, p.muw = c.knw, c.gnw, c.ktw, c.gtw, c.muw
    p.gravity = (ctypes.c_float * 3)(*c.gravity)
    p.inv_m, p.inv_I = c.inv_m, c.inv_I
    return p


@functools.cache
def _launcher():
    fn = _build.load("dem_substep").dem_substep_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int,
                   ctypes.POINTER(_SubstepParams), ctypes.c_void_p,
                   ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn


def check_rows(rows: CellRows, dims, out: torch.Tensor, n_out: int):
    """Raise unless ``rows`` and ``out`` are what the row kernels take:
    contiguous (3, R, 4) and (n_out, R, 4) float32, an int32 cell per row
    and an int32 (n_cells, 2) table, all on one device, out apart from the
    input, and R inside the kernels' index range."""
    n_rows = rows.n_rows
    n_cells = dims[0] * dims[1] * dims[2]
    dev = rows.state.device
    for name, t, dtype, shape in (
            ("state", rows.state, torch.float32, (3, n_rows, 4)),
            ("out", out, torch.float32, (n_out, n_rows, 4)),
            ("cell", rows.cell, torch.int32, (n_rows,)),
            ("table", rows.table, torch.int32, (n_cells, 2))):
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous() or t.device != dev:
            raise ValueError(f"{name} must be contiguous on {dev}")
    if overlaps(rows.state, out):
        raise ValueError("the row kernels run out of place")
    if n_rows == 0 or 4 * 3 * n_rows >= 2 ** 31:
        raise ValueError(f"{n_rows} rows is outside the kernel's range")


def dem_substep_rows(rows: CellRows, out: torch.Tensor,
                     c: SubstepCoefs) -> None:
    """out (3, R, 4) ← one substep of the rows' live particles; dead rows
    of ``out`` are left as they are.  A CUDA tensor launches the kernel; a
    CPU tensor runs the twin."""
    dev = rows.state.device
    if dev.type == "cuda":
        check_rows(rows, c.dims, out, 3)
        err = _launcher()(rows.state.data_ptr(), out.data_ptr(),
                          rows.cell.data_ptr(), rows.table.data_ptr(),
                          rows.n_rows, ctypes.byref(c.kernel_params),
                          torch.cuda.current_stream(dev).cuda_stream,
                          dev.index)
        if err != 0:
            raise RuntimeError(f"dem_substep launch failed: cudaError {err}")
        dem_substep_rows.launches += 1
    elif dev.type == "cpu":
        live = (rows.cell >= 0)[None, :, None]
        out.copy_(torch.where(live, dem_substep_rows_plain(rows, c), out))
    else:
        raise ValueError(f"no dem_substep for device {dev}")


dem_substep_rows.launches = 0


def dem_substep(feat_in: torch.Tensor, feat_out: torch.Tensor,
                c: SubstepCoefs) -> None:
    """feat_out ← one substep of feat_in, both (10, n_cells, C) float32:
    the occupied slots compacted to rows, :func:`dem_substep_rows`, and
    scattered back; empty slots are copied through."""
    n_cells = c.dims[0] * c.dims[1] * c.dims[2]
    for name, t in (("feat_in", feat_in), ("feat_out", feat_out)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32")
        if tuple(t.shape) != (N_FEAT, n_cells, c.capacity):
            raise ValueError(f"{name} must be (10, {n_cells}, "
                             f"{c.capacity}), got {tuple(t.shape)}")
        if t.device.type not in ("cuda", "cpu"):
            raise ValueError(f"no dem_substep for device {t.device}")
    if feat_out.device != feat_in.device:
        raise ValueError("feat_out must be on feat_in's device")
    if overlaps(feat_in, feat_out):
        raise ValueError("the substep runs out of place")
    rows, sel = rows_from_slots(feat_in)
    out = torch.empty_like(rows.state)
    dem_substep_rows(rows, out, c)
    feat_out.copy_(feat_in)
    m = sel.numel()
    feat_out.view(N_FEAT, -1)[0:9, sel] = rows_to_planes(out[:, :m])
