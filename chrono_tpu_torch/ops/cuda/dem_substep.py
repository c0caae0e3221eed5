"""K1: one fused DEM substep on (10, n_cells, C) cell-slot planes.

Replaces the TPU kernel ``chrono_tpu/ops/pallas/dem_flat_kernel.py``
``dem_flat_substep_pallas`` and the ``flatlane_kernel.py`` ``sym_sweep_flat``
sweep it runs on, and computes the substep of ``dem_sym_kernel.py``
``dem_sym_substep_pallas`` and ``dem_pencil_kernel.py``
``dem_pencil_substep_pallas`` (the same substep in other TPU layouts).  The
CUDA kernel (``csrc/dem_substep.cu``) runs one thread per slot over the 27
neighbour cells (the pair loop of ``csrc/dem_pairs.cuh``) and sums each pair
from both sides, so it needs no atomics.  Its plain twin,
:func:`dem_substep_plain`, is the vectorised 27-neighbour form of the JAX
``cell_dense_forces`` plus the wall and Euler tail.  Planes: pos xyz, vel xyz, omega xyz, mask.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional

import torch

from chrono_tpu_torch.dem.bc import PlaneBCs
from chrono_tpu_torch.dem.forces import cell_pair_forces, plane_wall_forces
from chrono_tpu_torch.ops.cuda import _build

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


def dem_substep_plain(feat: torch.Tensor, c: SubstepCoefs) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: returns the next (10, n_cells, C)."""
    grid = feat.reshape((N_FEAT,) + tuple(c.dims) + (feat.shape[2],))
    pos, vel, omega = grid[0:3], grid[3:6], grid[6:9]
    force, torque = cell_pair_forces(pos, vel, omega, grid[9] > 0.5,
                                     c.radius, c.kn, c.gn, c.kt, c.gt, c.mu,
                                     c.dt, c.friction)
    if c.planes is not None:
        fw, tw = plane_wall_forces(c.planes.to(feat.device),
                                   pos.reshape(3, -1), vel.reshape(3, -1),
                                   omega.reshape(3, -1), c.radius, c.knw,
                                   c.gnw, c.ktw, c.gtw, c.muw, c.dt,
                                   c.friction)
        force = force + fw.reshape(force.shape)
        torque = torque + tw.reshape(torque.shape)
    m = grid[9]
    g = torch.tensor(c.gravity, dtype=feat.dtype,
                     device=feat.device).reshape(3, 1, 1, 1, 1)
    vel2 = vel + c.dt * (force * c.inv_m + g) * m
    pos2 = pos + c.dt * vel2 * m
    omega2 = omega + c.dt * torque * c.inv_I * m
    return torch.cat([pos2, vel2, omega2, grid[9:]]).reshape(feat.shape)


class _Wall(ctypes.Structure):
    _fields_ = [("n", ctypes.c_float * 3), ("off", ctypes.c_float),
                ("v", ctypes.c_float * 3)]


class _SubstepParams(ctypes.Structure):
    _fields_ = ([(k, ctypes.c_int) for k in ("nx", "ny", "nz", "C")]
                + [(k, ctypes.c_float) for k in
                   ("radius", "kn", "gn", "kt", "gt", "mu", "dt")]
                + [("friction", ctypes.c_int), ("n_walls", ctypes.c_int),
                   ("walls", _Wall * MAX_WALLS)]
                + [(k, ctypes.c_float) for k in
                   ("knw", "gnw", "ktw", "gtw", "muw")]
                + [("gravity", ctypes.c_float * 3), ("inv_m", ctypes.c_float),
                   ("inv_I", ctypes.c_float)])


def _kernel_params(c: SubstepCoefs) -> _SubstepParams:
    p = _SubstepParams(*c.dims, c.capacity, c.radius, c.kn, c.gn, c.kt,
                       c.gt, c.mu, c.dt, int(c.friction), 0)
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
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.POINTER(_SubstepParams), ctypes.c_void_p,
                   ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn


def _launch(feat_in: torch.Tensor, feat_out: torch.Tensor, c: SubstepCoefs):
    n_cells = c.dims[0] * c.dims[1] * c.dims[2]
    for name, t in (("feat_in", feat_in), ("feat_out", feat_out)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32")
        if tuple(t.shape) != (N_FEAT, n_cells, c.capacity):
            raise ValueError(f"{name} must be (10, {n_cells}, "
                             f"{c.capacity}), got {tuple(t.shape)}")
    if feat_out.device != feat_in.device:
        raise ValueError("feat_out must be on feat_in's device")
    if feat_in.data_ptr() == feat_out.data_ptr():
        raise ValueError("the substep runs out of place")
    n_slots = n_cells * c.capacity
    if n_slots == 0 or N_FEAT * n_slots >= 2 ** 31:
        raise ValueError(f"{n_slots} slots is outside the kernel's range")
    err = _launcher()(feat_in.data_ptr(), feat_out.data_ptr(), n_slots,
                      ctypes.byref(c.kernel_params),
                      torch.cuda.current_stream(feat_in.device).cuda_stream,
                      feat_in.device.index)
    if err != 0:
        raise RuntimeError(f"dem_substep launch failed: cudaError {err}")


def dem_substep(feat_in: torch.Tensor, feat_out: torch.Tensor,
                c: SubstepCoefs) -> None:
    """feat_out ← one substep of feat_in, both (10, n_cells, C) float32.

    A CUDA tensor launches the kernel; a CPU tensor runs the twin.
    """
    if feat_in.device.type == "cuda":
        _launch(feat_in, feat_out, c)
        dem_substep.launches += 1
    elif feat_in.device.type == "cpu":
        feat_out.copy_(dem_substep_plain(feat_in, c))
    else:
        raise ValueError(f"no dem_substep for device {feat_in.device}")


dem_substep.launches = 0
