"""DEM pair forces and torques alone on (10, n_cells, C) cell-slot planes.

Replaces the TPU kernels ``chrono_tpu/ops/pallas/dem_pencil_kernel.py``
``dem_pencil_forces_pallas`` and ``chrono_tpu/ops/pallas/dem_cell_kernel.py``
``dem_cell_forces_pallas``.  The CUDA kernel (``csrc/dem_forces.cu``) runs one
thread per slot over the 27 neighbour cells with the pair loop it shares with
K1 (``csrc/dem_pairs.cuh``) and writes (6, n_cells, C) planes: force xyz and
torque xyz, zeros on empty slots.  Its plain twin, :func:`dem_forces_plain`,
is the vectorised 27-neighbour form of the JAX ``cell_dense_forces``.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from chrono_tpu_torch.dem.forces import cell_pair_forces
from chrono_tpu_torch.ops.cuda import _build
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
        return _ForcesParams(*self.dims, self.capacity, self.radius, self.kn,
                             self.gn, self.kt, self.gt, self.mu, self.dt,
                             int(self.friction))


def dem_forces_plain(feat: torch.Tensor, c: PairCoefs) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: (10, n_cells, C) → (6, n_cells, C)."""
    grid = feat.reshape((N_FEAT,) + tuple(c.dims) + (feat.shape[2],))
    force, torque = cell_pair_forces(grid[0:3], grid[3:6], grid[6:9],
                                     grid[9] > 0.5, c.radius, c.kn, c.gn,
                                     c.kt, c.gt, c.mu, c.dt, c.friction)
    return torch.cat([force, torque]).reshape((N_OUT,) + feat.shape[1:])


class _ForcesParams(ctypes.Structure):
    _fields_ = ([(k, ctypes.c_int) for k in ("nx", "ny", "nz", "C")]
                + [(k, ctypes.c_float) for k in
                   ("radius", "kn", "gn", "kt", "gt", "mu", "dt")]
                + [("friction", ctypes.c_int)])


@functools.cache
def _launcher():
    fn = _build.load("dem_forces").dem_forces_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.POINTER(_ForcesParams), ctypes.c_void_p,
                   ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn


def _launch(feat: torch.Tensor, out: torch.Tensor, c: PairCoefs):
    n_cells = c.dims[0] * c.dims[1] * c.dims[2]
    for name, t, f in (("feat", feat, N_FEAT), ("out", out, N_OUT)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32")
        if tuple(t.shape) != (f, n_cells, c.capacity):
            raise ValueError(f"{name} must be ({f}, {n_cells}, "
                             f"{c.capacity}), got {tuple(t.shape)}")
    if out.device != feat.device:
        raise ValueError("out must be on feat's device")
    if overlaps(feat, out):
        raise ValueError("the force pass runs out of place")
    n_slots = n_cells * c.capacity
    if n_slots == 0 or N_FEAT * n_slots >= 2 ** 31:
        raise ValueError(f"{n_slots} slots is outside the kernel's range")
    err = _launcher()(feat.data_ptr(), out.data_ptr(), n_slots,
                      ctypes.byref(c.kernel_params),
                      torch.cuda.current_stream(feat.device).cuda_stream,
                      feat.device.index)
    if err != 0:
        raise RuntimeError(f"dem_forces launch failed: cudaError {err}")


def dem_forces(feat: torch.Tensor, out: torch.Tensor, c: PairCoefs) -> None:
    """out ← the pair force and torque planes of feat: (10, n_cells, C) →
    (6, n_cells, C) float32.

    A CUDA tensor launches the kernel; a CPU tensor runs the twin.
    """
    if feat.device.type == "cuda":
        _launch(feat, out, c)
        dem_forces.launches += 1
    elif feat.device.type == "cpu":
        out.copy_(dem_forces_plain(feat, c))
    else:
        raise ValueError(f"no dem_forces for device {feat.device}")


dem_forces.launches = 0
