"""NSC contact detection on cell-sorted bodies, once per DVI step.

Counterpart of ``chrono_tpu/ops/pallas/nsc_half_kernel.py`` ``detect_half``
(an XLA function that lies on the JAX mixer's path once per step): each
sphere pair within the detection envelope is owned by one side, the one
from which the other lies in the forward half stencil, and an owner keeps up
to P partners.  Bodies are sorted by cell id ``(i·ny + j)·nz + k`` with a
stable sort, so a cell's bodies keep their input order, which is the JAX
package's slot order.  An owner walks the 14 forward classes in
``_class_offset`` order: the 12 cells (dx, dy) ∈ {(0, 1), (1, −1), (1, 0),
(1, 1)} × dz ∈ {−1, 0, 1}, then (0, 0, +1), then its own cell with the
partner after it in sorted order.  Partners are ranked in that order (and
by sorted index within a cell), as ``detect_half`` ranks its codes, so
the P-th partner and the overflow are the JAX path's.

``nsc_detect`` (``csrc/nsc_detect.cu``: a group of lanes a body, as many
as :func:`lanes_for` gives, walks six contiguous runs of sorted bodies,
the four forward columns, the cell above and the own cell, its hits
ranked in walk order by a ballot) and its twin ``nsc_detect_plain`` agree
bit for bit: the distance is computed in the same operations and
roundings (``|d|² = (dx² + dy²) + dz²``, no fused multiply-add).  Unlike
the JAX binning, a cell holding more than C bodies drops none of them;
the caller reports the excess as overflow.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from chrono_tpu_torch.ops.cuda import _build
from chrono_tpu_torch.ops.cuda.sph_substep import (
    SortedCells, check_cells, check_planes,
)

FWD_XY = ((0, 1), (1, -1), (1, 0), (1, 1))
# the most lanes of a warp that walk one body's runs together (the kernel
# takes 1, 2, 4 or 8)
MAX_LANES = 8
N_CLASS = 14
# candidate pairs per chunk of the plain twin
_TWIN_PAIRS = 1 << 22


def class_offset(k: int):
    """(dx, dy, dz) of forward class k (13: the owner's own cell)."""
    if k < 12:
        dx, dy = FWD_XY[k // 3]
        return dx, dy, (k % 3) - 1
    return (0, 0, 1) if k == 12 else (0, 0, 0)


@dataclass(frozen=True)
class DetectConsts:
    """float32 2r and envelope (the detection test is gap < envelope)."""

    two_r: float
    envelope: float

    @staticmethod
    def of(radius: float, envelope: float) -> "DetectConsts":
        return DetectConsts(float(np.float32(2.0 * radius)),
                            float(np.float32(envelope)))


@dataclass(frozen=True)
class ReverseTable:
    """For each body, the owned contacts that name it as partner: entries
    ``entry[start[j]:start[j] + count[j]]`` are flat indices ``i·P + p``
    of the partner table, ascending (owner, then slot)."""

    start: torch.Tensor     # (N,) int32
    count: torch.Tensor     # (N,) int32
    entry: torch.Tensor     # (N·P,) int32


def _cell_ijk(cells: SortedCells, i: torch.Tensor):
    _, ny, nz = cells.dims
    cid = cells.cell[i].long()
    return cid // (ny * nz), (cid // nz) % ny, cid % nz


def nsc_detect_plain(pos: torch.Tensor, cells: SortedCells, P: int,
                     c: DetectConsts):
    """Twin of ``nsc_detect``: ``(partners, count)`` with partners (N, P)
    int32 sorted indices (−1 = empty) and count (N,) int32 the number of
    contacts each body owns (more than P is an overflow)."""
    dev = pos.device
    n = pos.shape[1]
    nx, ny, nz = cells.dims
    partners = torch.full((n, P), -1, dtype=torch.int32, device=dev)
    total = torch.empty((n,), dtype=torch.int32, device=dev)
    width = int(cells.count.max())
    offs = torch.tensor([class_offset(k) for k in range(N_CLASS)],
                        device=dev)
    hi = torch.tensor([nx, ny, nz], device=dev)
    t = torch.arange(width, device=dev)
    step = max(1, _TWIN_PAIRS // (N_CLASS * max(width, 1)))
    for lo in range(0, n, step):
        i = torch.arange(lo, min(n, lo + step), device=dev)
        ijk = torch.stack(_cell_ijk(cells, i), 1)
        nb = ijk[:, None, :] + offs                      # (b, 14, 3)
        inside = ((nb >= 0) & (nb < hi)).all(-1)
        nbc = torch.where(inside, (nb[..., 0] * ny + nb[..., 1]) * nz
                          + nb[..., 2], 0)
        cnt = torch.where(inside, cells.count.long()[nbc], 0)
        j = cells.start.long()[nbc][..., None] + t       # (b, 14, width)
        ok = t < cnt[..., None]
        ok[:, N_CLASS - 1] &= j[:, N_CLASS - 1] > i[:, None]
        j = torch.where(ok, j, i[:, None, None]).reshape(len(i), -1)
        ok = ok.reshape(len(i), -1)
        d = [pos[a][j] - pos[a][i][:, None] for a in range(3)]
        dist = torch.sqrt((d[0] * d[0] + d[1] * d[1]) + d[2] * d[2] + 1e-18)
        ok &= dist - c.two_r < c.envelope
        rank = torch.cumsum(ok.to(torch.int32), 1) - 1
        keep = ok & (rank < P)
        rows = i[:, None].expand_as(j)
        partners[rows[keep], rank[keep].long()] = j[keep].to(torch.int32)
        total[i] = ok.sum(1).to(torch.int32)
    return partners, total


def reverse_table(partners: torch.Tensor) -> ReverseTable:
    """The reverse of the partner table, built by a stable sort (so its
    order is fixed) and two binary searches: no host sync."""
    n = partners.shape[0]
    flat = partners.reshape(-1).long()
    key = torch.where(flat >= 0, flat, n)
    order = torch.argsort(key, stable=True)
    key = key[order]
    body = torch.arange(n, device=partners.device)
    start = torch.searchsorted(key, body)
    count = torch.searchsorted(key, body, right=True) - start
    return ReverseTable(start=start.to(torch.int32),
                        count=count.to(torch.int32),
                        entry=order.to(torch.int32))


def _launcher(name: str = "nsc_detect"):
    return _bind(name, _build.DEFINES)


@functools.cache
def _bind(name: str, defines: tuple):
    """The launcher of the build that ``_build.load`` returns under
    ``defines`` (the cache key: each build binds its own)."""
    fn = getattr(_build.load("nsc_detect"), f"{name}_launch")
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                   + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p,
                                             ctypes.c_int])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _resident_threads(index: int) -> int:
    props = torch.cuda.get_device_properties(index)
    return props.multi_processor_count * getattr(
        props, "max_threads_per_multi_processor", 2048)


def lanes_for(n: int, device: torch.device) -> int:
    """Lanes a body: the fewest of 1, 2, 4 and 8 that put at least half as
    many threads in flight as the card holds at once (SMs × resident
    threads), else 8.  Lanes buy parallelism at the price of a vote a step:
    on an NVIDIA H100 80GB HBM3 at 700 W (``kernel_turns.py``) one lane a
    body was fastest at 400,000 bodies (0.0511 ms a launch, two lanes
    0.0729) and four at 40,000 (0.0119 ms; eight 0.0140, one 0.0167)."""
    lanes = 1
    while (lanes < MAX_LANES
           and 2 * n * lanes < _resident_threads(device.index)):
        lanes *= 2
    return lanes


def _launch(pos, cells, P, c, partners, count, lanes=None):
    n = pos.shape[1]
    dev = pos.device
    check_planes("pos", pos, 3, n, dev)
    check_cells(cells, dev, 3)
    lanes = lanes_for(n, dev) if lanes is None else lanes
    if P < 1 or n * max(P, lanes) >= 2 ** 31:
        raise ValueError(f"P = {P} with {n} bodies is outside the kernel's "
                         "range")
    for label, t, shape in (("partners", partners, (n, P)),
                            ("count", count, (n,))):
        if (t.dtype != torch.int32 or not t.is_contiguous()
                or tuple(t.shape) != shape or t.device != dev):
            raise ValueError(f"{label} must be contiguous int32 {shape} on "
                             f"{dev}")
    err = _launcher()(pos.data_ptr(), cells.cell.data_ptr(),
                      cells.start.data_ptr(), cells.count.data_ptr(),
                      partners.data_ptr(), count.data_ptr(), n,
                      *cells.dims, P, c.two_r, c.envelope, lanes,
                      torch.cuda.current_stream(dev).cuda_stream, dev.index)
    if err != 0:
        raise RuntimeError(f"nsc_detect launch failed: cudaError {err}")


def nsc_detect(pos: torch.Tensor, cells: SortedCells, P: int,
               c: DetectConsts):
    """``(partners, count)`` of the (3, N) sorted positions: see
    :func:`nsc_detect_plain`.  A CUDA tensor launches the kernel; a CPU
    tensor runs the twin."""
    if pos.device.type == "cuda":
        n = pos.shape[1]
        partners = torch.empty((n, P), dtype=torch.int32, device=pos.device)
        count = torch.empty((n,), dtype=torch.int32, device=pos.device)
        _launch(pos, cells, P, c, partners, count)
        nsc_detect.launches += 1
        return partners, count
    if pos.device.type == "cpu":
        return nsc_detect_plain(pos, cells, P, c)
    raise ValueError(f"no nsc_detect for device {pos.device}")


nsc_detect.launches = 0
