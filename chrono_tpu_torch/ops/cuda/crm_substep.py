"""One CRM (elastoplastic granular SPH) substep as two neighbour sweeps on
cell-sorted markers, and a whole outer step of n substeps in one launch.

Replaces the TPU kernels ``chrono_tpu/ops/pallas/crm_sym_kernel.py``
``crm_substep_sym`` / ``crm_substep_sym_dual`` (sweeps M and G, with their
``forces_only`` and ``with_acc`` modes) and
``chrono_tpu/ops/pallas/crm_outer_kernel.py`` ``crm_outer_substeps``: the
same physics, which ``chrono_tpu/fsi/sph/crm.py`` ``crm_step`` and
``crm_forces`` define term by term, without the TPU's pencils, lane rolls,
slot tiers and row trim.

Markers are sorted by cell id and held as a structure of arrays with the
per-cell ``(start, count)`` table of the SPH sweeps (:class:`SortedCells`).
The kernels (``csrc/crm_substep.cu`` and ``csrc/crm_outer.cu``, with the
physics in ``csrc/crm_sweeps.cuh``) run one thread per marker over the 27
neighbour cells and sum each pair from their own side: no atomics in a sum,
a fixed order.  Both scan the candidates first and run the pair body
over the hits only (``csrc/cell_pairs.cuh``); M lists each integrated
marker's in-support neighbours (a :class:`NeighbourList`) for G to replay.
Ahead of each sweep a pack pass writes the terms its pair body reads of a
neighbour as one record a marker (scratch that the wrapper allocates).

  M ``crm_momentum``: stress divergence with wall mirroring, artificial
    viscosity and the mixed-pair penalty → the kick of integrated markers,
    and optionally the raw acceleration of every valid marker
                   state (17, N) → mv (4, N) and/or acc (3, N), the list
  G ``crm_gradv_stress``: ∇v and continuity at the kicked velocities →
    Jaumann rate, Drucker–Prager return, ρ update and clip, drift
                             state, mv, M's list → next state (17, N)
  ``crm_outer_substeps``: n × (M, G) in one cooperative launch, with the
    last M sweep's acceleration      state → state after n, acc (3, N),
    and the neighbour list's overflow (a list of K slots a marker, (K, N))

State planes: the TPU kernel's 16 (pos xyz, vel xyz, ρ, σ xx yy zz xy xz
yz, granular flag, integrate flag, valid) and a derived 1/max(ρ², 1e-9)
that M reads and G computes for the next substep.  "Valid" marks the
first ``capacity`` markers of a cell: the rest are carried through
unchanged, and the caller reports the excess as overflow.  mv planes: the
kicked velocity and 1/max(ρ, 1e-9).  Every function here runs on the
tensors' device; the ``*_plain`` twins are plain PyTorch, chunked over the
markers whose pair loop is needed, and walk every candidate.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

from chrono_tpu_torch.fsi.sph.crm import (
    drucker_prager_channels, jaumann_update, strain_and_spin,
)
from chrono_tpu_torch.fsi.sph.kernels import cubic_spline_dwdr
from chrono_tpu_torch.ops.cuda import _build
from chrono_tpu_torch.ops.cuda.sph_substep import (
    SortedCells, candidates_of, check_cells, check_planes, overlaps,
)

N_STATE = 17
N_MV = 4
# floats a marker of the packed records that M's and G's pair bodies read
# (csrc/crm_sweeps.cuh RecordNbr, RecordMv)
N_RECORD = 12
N_GRADV_RECORD = 8
(PX, PY, PZ, VX, VY, VZ, RHO, SXX, SYY, SZZ, SXY, SXZ, SYZ, GRN, INT, VAL,
 DER) = range(N_STATE)
# candidate pairs per chunk of the plain twins
_TWIN_PAIRS = 1 << 24
# neighbour-list slots a marker (a uniform bed has ~58 neighbours inside
# 2h = 2.4 d0)
LIST_SLOTS = 128


@dataclass(frozen=True)
class NeighbourList:
    """Sweep M's list of each kicked marker's in-support neighbours, in
    walk order, that sweep G replays: the first K in ``nbrs`` (K, N) int32
    (slot-major: entry t of marker i at ``nbrs[t, i]``), their number,
    which may pass K, in ``n_listed`` (N,) int32."""

    nbrs: torch.Tensor
    n_listed: torch.Tensor

    @staticmethod
    def empty(n: int, device, slots: int = LIST_SLOTS) -> "NeighbourList":
        return NeighbourList(
            torch.empty((slots, n), dtype=torch.int32, device=device),
            torch.empty((n,), dtype=torch.int32, device=device))


@dataclass(frozen=True)
class CRMConsts:
    """Host-side constants of the substep (Python floats)."""

    h: float
    m: float
    d0: float
    c_s: float
    alpha_visc: float
    dt: float
    rho0: float
    gravity: tuple
    shear_G: float
    bulk_K: float
    friction_angle: float
    cohesion: float
    k_bc: float             # penalty stiffness c_s²/d0 [m/s²]
    c_bc: float             # penalty damping rate 3 √(k_bc/d0) [1/s]

    def replace(self, **changes) -> "CRMConsts":
        return dataclasses.replace(self, **changes)

    @functools.cached_property
    def kernel_params(self) -> "_Consts":
        """The kernels' argument struct, packed once."""
        den = math.sqrt(9.0 + 3.0 * self.friction_angle ** 2)
        alpha = self.friction_angle / den
        k_c = 3.0 * self.cohesion / den
        return _Consts(
            self.h, 1.0 / (math.pi * self.h ** 3), self.m, self.d0, self.c_s,
            self.alpha_visc, self.dt, self.rho0,
            (ctypes.c_float * 3)(*self.gravity), 2.0 * self.shear_G,
            self.bulk_K, alpha, k_c, -k_c / max(alpha, 1e-9), self.k_bc,
            self.c_bc)


def crm_static_params(params, crm) -> CRMConsts:
    """The substep's constants from an ``SPHParams`` and a ``CRMParams``;
    the kernels implement the cubic spline only."""
    if params.kernel != "cubic":
        raise ValueError("the CRM substep implements the cubic kernel")
    d0, c_s = float(params.d0), float(params.c_s)
    k_bc = c_s * c_s / d0
    return CRMConsts(
        h=float(params.h), m=float(params.rho0) * d0 ** 3, d0=d0, c_s=c_s,
        alpha_visc=float(params.alpha_visc), dt=float(params.dt),
        rho0=float(params.rho0),
        gravity=tuple(float(g) for g in params.gravity),
        shear_G=float(crm.shear_G), bulk_K=float(crm.bulk_K),
        friction_angle=float(crm.friction_angle),
        cohesion=float(crm.cohesion), k_bc=k_bc,
        c_bc=3.0 * math.sqrt(k_bc / d0))


# ------------------------------------------------------------ plain twins


def _rows(cells: SortedCells, need: torch.Tensor):
    """Chunks of the sorted markers where ``need`` holds, with the cell
    table's capacity cut to the fullest cell (the candidates beyond it are
    empty slots)."""
    cells = dataclasses.replace(cells, capacity=max(1, min(
        cells.capacity, int(cells.count.max()))))
    idx = torch.nonzero(need).flatten()
    step = max(1, _TWIN_PAIRS // (27 * cells.capacity))
    for lo in range(0, idx.shape[0], step):
        yield cells, idx[lo:lo + step]


def _pairs(pos, i, cells, h):
    """(j, ok, d, r2, r, ∇W) of the candidates of sorted markers i."""
    j, ok, _ = candidates_of(cells, i)
    d = pos[i][:, None, :] - pos[j]
    r2 = (d * d).sum(-1)
    r = torch.sqrt(r2 + 1e-12)
    gw = (cubic_spline_dwdr(r, h) / torch.clamp(r, min=1e-12))[..., None] * d
    return j, ok, d, r2, r, gw


def _sym_dot(T, g):
    """(T·g) for a symmetric 3×3 in channel form (…, 6) and a (…, 3)."""
    return torch.stack([
        T[..., 0] * g[..., 0] + T[..., 3] * g[..., 1] + T[..., 4] * g[..., 2],
        T[..., 3] * g[..., 0] + T[..., 1] * g[..., 1] + T[..., 5] * g[..., 2],
        T[..., 4] * g[..., 0] + T[..., 5] * g[..., 1] + T[..., 2] * g[..., 2],
    ], dim=-1)


def crm_momentum_plain(state: torch.Tensor, cells: SortedCells,
                       c: CRMConsts, with_acc: bool = False):
    """Twin of sweep M: ``(mv (4, N), acc (3, N) or None)``.  The pair
    sums run for integrated valid markers, or for every valid marker with
    ``with_acc`` (whose acc is returned)."""
    n = state.shape[1]
    valid = state[VAL] > 0.5
    kick = valid & (state[INT] > 0.5)
    pos, vel = state[PX:PZ + 1].T, state[VX:VZ + 1].T
    sig = state[SXX:SYZ + 1].T
    rho, ir2 = state[RHO], state[DER]
    gran = state[GRN] > 0.5
    acc = torch.zeros((n, 3), dtype=state.dtype, device=state.device)
    eps_h2 = 0.01 * c.h * c.h
    for cells_c, i in _rows(cells, valid if with_acc else kick):
        j, ok, d, r2, r, gw = _pairs(pos, i, cells_c, c.h)
        gw = c.m * gw
        s_i = sig[i][:, None, :]
        s_j = torch.where(gran[j][..., None], sig[j], s_i)
        a = _sym_dot(s_i * ir2[i][:, None, None] + s_j * ir2[j][..., None],
                     gw)
        v_ij = vel[i][:, None, :] - vel[j]
        vr = (v_ij * d).sum(-1)
        mu_ij = c.h * vr / (r2 + eps_h2)
        pi = torch.where(vr < 0, -c.alpha_visc * c.c_s * mu_ij
                         / (0.5 * (rho[i][:, None] + rho[j])),
                         torch.zeros_like(vr))
        a = a - pi[..., None] * gw
        close = (gran[i][:, None] != gran[j]) & (r < c.d0)
        nh = d / r[..., None]
        vn = (v_ij * nh).sum(-1)
        pen = (c.k_bc * ((c.d0 - r) / c.d0)
               - c.c_bc * vn * torch.where(vn < 0, 1.0, 0.3))
        a = a + torch.where(close, pen, torch.zeros_like(pen))[..., None] * nh
        acc[i] = torch.where(ok[..., None], a, torch.zeros_like(a)).sum(1)
    g = torch.tensor(c.gravity, dtype=state.dtype, device=state.device)
    mv = torch.empty((N_MV, n), dtype=state.dtype, device=state.device)
    mv[0:3] = torch.where(kick[:, None], vel + c.dt * (acc + g), vel).T
    mv[3] = 1.0 / torch.clamp(rho, min=1e-9)
    return mv, (acc.T.contiguous() if with_acc else None)


def crm_gradv_stress_plain(state: torch.Tensor, mv: torch.Tensor,
                           cells: SortedCells,
                           c: CRMConsts) -> torch.Tensor:
    """Twin of sweep G: the next (17, N) state from M's (4, N) planes."""
    n = state.shape[1]
    valid = state[VAL] > 0.5
    move = valid & (state[INT] > 0.5)
    pos, v1, irho = state[PX:PZ + 1].T, mv[0:3].T, mv[3]
    grad = torch.zeros((n, 9), dtype=state.dtype, device=state.device)
    drho = torch.zeros((n,), dtype=state.dtype, device=state.device)
    for cells_c, i in _rows(cells, move):
        j, ok, _, _, _, gw = _pairs(pos, i, cells_c, c.h)
        u = v1[j] - v1[i][:, None, :]
        w = torch.where(ok, c.m * irho[j], torch.zeros_like(irho[j]))
        grad[i] = ((w[..., None, None] * u[..., :, None] * gw[..., None, :])
                   .sum(1).reshape(-1, 9))
        drho[i] = torch.where(ok, -c.m * (u * gw).sum(-1),
                              torch.zeros_like(w)).sum(1)
    sig = state[SXX:SYZ + 1].T
    d, w = strain_and_spin(grad)
    trial = jaumann_update(sig, d, w, c.dt, c.shear_G, c.bulk_K)
    sig = torch.where(move[:, None], drucker_prager_channels(
        trial, c.friction_angle, c.cohesion), sig)
    rho = torch.where(move, state[RHO] + c.dt * drho, state[RHO])
    rho = torch.where(valid, torch.clamp(rho, 0.5 * c.rho0, 2.0 * c.rho0),
                      rho)
    out = torch.empty_like(state)
    out[PX:PZ + 1] = torch.where(move[:, None], pos + c.dt * v1, pos).T
    out[VX:VZ + 1] = mv[0:3]
    out[RHO] = rho
    out[SXX:SYZ + 1] = sig.T
    out[GRN:VAL + 1] = state[GRN:VAL + 1]
    out[DER] = 1.0 / torch.clamp(rho * rho, min=1e-9)
    return out


def crm_substep_plain(state: torch.Tensor, cells: SortedCells,
                      c: CRMConsts, with_acc: bool = False):
    """Twin of the whole substep: ``(next state, acc or None)``."""
    mv, acc = crm_momentum_plain(state, cells, c, with_acc)
    return crm_gradv_stress_plain(state, mv, cells, c), acc


def _fma32(a, b, c):
    """float32 fma(a, b, c) with one rounding, as the card's: the float64
    product of two float32 is exact; the float64 sum is made exact to
    round-to-odd (its error by TwoSum), whose one rounding to float32 is
    then the correctly rounded sum (53 ≥ 24 + 2 bits)."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    t = s - p
    err = (p - (s - t)) + (c - t)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, math.inf, -math.inf)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def _in_support(pos, i, j, ok, h):
    """Whether candidates j (b, K) of sorted markers i (b,) lie inside the
    support by the kernels' scan test, to the bit: r² = fma(dz, dz, fma(dx,
    dx, dy dy)), r² ≤ 4.0004 h² and √(r² + 1e-12)/h < 2, all in float32
    with true divisions (a division by a Python number may become a product
    with its reciprocal on the GPU)."""
    d = pos[i][:, None, :] - pos[j]
    dx, dy, dz = d.unbind(-1)
    r2 = _fma32(dz, dz, _fma32(dx, dx, dy * dy))
    h32 = np.float32(h)
    cut = float((np.float32(4.0004) * h32) * h32)
    h_t = torch.tensor([h32], device=pos.device)
    return ok & (r2 <= cut) & (torch.sqrt(r2 + 1e-12) / h_t < 2.0)


def crm_neighbour_list_plain(state: torch.Tensor, cells: SortedCells,
                             c: CRMConsts, slots: int = LIST_SLOTS):
    """Twin of sweep M's neighbour list: ``(nbrs (slots, N), n_listed
    (N,))``, int32, for each integrated valid marker its neighbours inside
    the support (:func:`_in_support`) in the kernels' walk order (the 27
    cells in (dx, dy, dz) order, each cell's markers in sorted order), the
    first ``slots`` of them, and their number; −1 and 0 elsewhere."""
    move = (state[VAL] > 0.5) & (state[INT] > 0.5)
    pos = state[PX:PZ + 1].T
    n = state.shape[1]
    nbrs = torch.full((slots, n), -1, dtype=torch.int32, device=state.device)
    counts = torch.zeros(n, dtype=torch.int32, device=state.device)
    for cells_c, i in _rows(cells, move):
        j, ok, _ = candidates_of(cells_c, i)
        inside = _in_support(pos, i, j, ok, c.h)
        counts[i] = inside.sum(1).to(torch.int32)
        width = j.shape[1]
        at = torch.where(inside, torch.arange(width, device=j.device), width)
        at = at.sort(dim=1).values[:, :slots]
        got = torch.gather(j, 1, at.clamp(max=width - 1))
        got = torch.where(at < width, got, -1).to(torch.int32)
        nbrs[:got.shape[1], i] = got.T
    return nbrs, counts


def crm_neighbour_counts_plain(state: torch.Tensor, cells: SortedCells,
                               c: CRMConsts) -> torch.Tensor:
    """Twin of the kernels' list lengths: (N,) int32, the neighbours inside
    the support (the kernels' test, :func:`_in_support`) of each integrated
    valid marker, 0 elsewhere."""
    return crm_neighbour_list_plain(state, cells, c, 1)[1]


def crm_outer_substeps_plain(state: torch.Tensor, cells: SortedCells,
                             c: CRMConsts, n_substeps: int,
                             most: torch.Tensor | None = None):
    """Twin of the whole outer step: the per-sweep twins ``n_substeps``
    times, the last with its acceleration: ``(state, acc (3, N))``.  With
    ``most`` (a () int32 tensor), also raises it in place to the kernel's
    largest list length over the substeps
    (:func:`crm_neighbour_counts_plain` before each)."""
    for s in range(n_substeps):
        if most is not None:
            torch.maximum(most, crm_neighbour_counts_plain(state, cells,
                                                           c).max(),
                          out=most)
        state, acc = crm_substep_plain(state, cells, c,
                                       with_acc=s == n_substeps - 1)
    return state, acc


# ---------------------------------------------------------------- kernels


class _Consts(ctypes.Structure):
    _fields_ = ([(k, ctypes.c_float) for k in
                 ("h", "sigma", "m", "d0", "c_s", "alpha_visc", "dt",
                  "rho0")]
                + [("g", ctypes.c_float * 3)]
                + [(k, ctypes.c_float) for k in
                   ("G2", "K", "alpha_dp", "k_c", "p_apex", "k_bc", "c_bc")])


_P, _I = ctypes.c_void_p, ctypes.c_int
# each launcher's library, its pointer arguments (the state, the cell
# table, the other buffers) and its ints after (n, nx, ny, nz, cap)
_LAUNCHERS = {
    # + the records' scratch, mv, acc, the list, its lengths; K
    "crm_momentum": ("crm_substep", [_P] * 9, [_I]),
    # + the records' scratch, mv, out, the list, its lengths; K
    "crm_gradv_stress": ("crm_substep", [_P] * 9, [_I]),
    # + out, spare, mv, acc, the records' scratch, order, the list, its
    # lengths, most; n_sub, K
    "crm_outer": ("crm_outer", [_P] * 13, [_I] * 2),
}


def _launcher(name: str):
    return _bind(name, _build.DEFINES)


@functools.cache
def _bind(name: str, defines: tuple):
    """The launcher of the build that ``_build.load`` returns under
    ``defines`` (the cache key: a counter build binds its own)."""
    lib, ptrs, extra = _LAUNCHERS[name]
    fn = getattr(_build.load(lib), f"{name}_launch")
    fn.argtypes = (ptrs + [_I] * 5 + extra
                   + [ctypes.POINTER(_Consts), _P, _I])
    fn.restype = ctypes.c_int
    return fn


def _run(name, buffers, cells: SortedCells, c: CRMConsts, extra=(),
         ints=()):
    """Check the (label, tensor or None, rows) float buffers and the
    (label, tensor or None) int32 ones (already checked by the caller), none
    sharing memory with another, and the cell table; launch."""
    n = cells.cell.shape[0]
    dev = buffers[0][1].device
    given = [(label, t) for label, t, _ in buffers if t is not None]
    given += [(label, t) for label, t in ints if t is not None]
    for label, t, rows in buffers:
        if t is not None:
            check_planes(label, t, rows, n, dev)
    for k, (label, t) in enumerate(given):
        for other, u in given[k + 1:]:
            if overlaps(t, u):
                raise ValueError(f"the CRM kernels run out of place: "
                                 f"{label} and {other} overlap")
    check_cells(cells, dev, N_STATE)
    ptrs = [None if t is None else t.data_ptr() for _, t, _ in buffers]
    ptrs += [None if t is None else t.data_ptr() for _, t in ints]
    err = _launcher(name)(
        ptrs[0], cells.cell.data_ptr(), cells.start.data_ptr(),
        cells.count.data_ptr(), *ptrs[1:], n, *cells.dims, cells.capacity,
        *extra, ctypes.byref(c.kernel_params),
        torch.cuda.current_stream(dev).cuda_stream, dev.index)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def check_list(nbrs: torch.Tensor, state: torch.Tensor) -> None:
    """Raise unless ``nbrs`` is a contiguous int32 (K, N) neighbour list,
    K ≥ 1, on the state's device, that the kernel can index."""
    n = state.shape[1]
    if nbrs.dtype != torch.int32 or not nbrs.is_contiguous():
        raise ValueError("nbrs must be contiguous int32")
    if nbrs.dim() != 2 or nbrs.shape[0] < 1 or nbrs.shape[1] != n:
        raise ValueError(f"nbrs must be (K, {n}) with K >= 1, got "
                         f"{tuple(nbrs.shape)}")
    if nbrs.device != state.device:
        raise ValueError(f"nbrs must be on {state.device}")
    if nbrs.numel() >= 2 ** 31:
        raise ValueError("nbrs is outside the kernel's range")


def _list_args(lists: NeighbourList | None, state: torch.Tensor):
    """The launchers' (label, tensor) int32 list buffers and K, checked."""
    if lists is None:
        return [("nbrs", None), ("n_listed", None)], 0
    check_list(lists.nbrs, state)
    t = lists.n_listed
    if (t.dtype != torch.int32 or not t.is_contiguous()
            or tuple(t.shape) != (state.shape[1],)
            or t.device != state.device):
        raise ValueError(f"n_listed must be contiguous int32 of "
                         f"({state.shape[1]},) on {state.device}")
    return [("nbrs", lists.nbrs), ("n_listed", t)], lists.nbrs.shape[0]


def crm_momentum(state: torch.Tensor, cells: SortedCells, c: CRMConsts,
                 mv: torch.Tensor | None = None,
                 acc: torch.Tensor | None = None,
                 lists: NeighbourList | None = None) -> None:
    """Sweep M on the (17, N) state.  ``mv`` (4, N) ← the kicked
    velocities and 1/ρ; ``acc`` (3, N) ← the raw acceleration of every
    valid marker.  Either may be None, not both: ``mv`` alone is the
    substep, both its ``with_acc`` mode, ``acc`` alone ``forces_only``.
    With ``lists`` (and ``mv``), each kicked marker's in-support neighbours
    go to it for sweep G.

    A CUDA tensor launches the kernels: one packs each marker's terms that
    the pair body reads into a record, the other walks the cells.  A CPU
    tensor runs the twin and leaves ``lists`` as it is: G's twin walks
    (:func:`crm_neighbour_list_plain` is the list's twin)."""
    if mv is None and acc is None:
        raise ValueError("crm_momentum needs mv or acc")
    if lists is not None and mv is None:
        raise ValueError("crm_momentum lists only the kicked markers: "
                         "lists needs mv")
    if state.device.type == "cuda":
        ints, K = _list_args(lists, state)
        # scratch for the neighbours' packed records, marker-major
        rec = state.new_empty((N_RECORD, state.shape[1]))
        _run("crm_momentum", [("state", state, N_STATE),
                              ("rec", rec, N_RECORD), ("mv", mv, N_MV),
                              ("acc", acc, 3)], cells, c, (K,), ints)
        crm_momentum.launches += 1
    elif state.device.type == "cpu":
        got_mv, got_acc = crm_momentum_plain(state, cells, c,
                                             with_acc=acc is not None)
        if mv is not None:
            mv.copy_(got_mv)
        if acc is not None:
            acc.copy_(got_acc)
    else:
        raise ValueError(f"no crm_momentum for device {state.device}")


def crm_gradv_stress(state: torch.Tensor, mv: torch.Tensor,
                     cells: SortedCells, c: CRMConsts,
                     out: torch.Tensor,
                     lists: NeighbourList | None = None) -> None:
    """Sweep G: out (17, N) ← the next state, from the (4, N) planes of
    sweep M and, on the card, the neighbour list that sweep M wrote from
    the same state (``lists``; a marker past its K slots walks again)."""
    if state.device.type == "cuda":
        if lists is None:
            raise ValueError("crm_gradv_stress replays sweep M's list: "
                             "lists is needed on the card")
        ints, K = _list_args(lists, state)
        rec = state.new_empty((N_GRADV_RECORD, state.shape[1]))
        _run("crm_gradv_stress", [("state", state, N_STATE),
                                  ("rec", rec, N_GRADV_RECORD),
                                  ("mv", mv, N_MV),
                                  ("out", out, N_STATE)], cells, c, (K,),
             ints)
        crm_gradv_stress.launches += 1
    elif state.device.type == "cpu":
        out.copy_(crm_gradv_stress_plain(state, mv, cells, c))
    else:
        raise ValueError(f"no crm_gradv_stress for device {state.device}")


def crm_outer_substeps(state: torch.Tensor, cells: SortedCells,
                       c: CRMConsts, n_substeps: int, out: torch.Tensor,
                       acc: torch.Tensor,
                       nbrs: torch.Tensor | None = None) -> torch.Tensor:
    """out (17, N) ← ``n_substeps`` substeps of ``state`` in one launch;
    acc (3, N) ← the last M sweep's raw acceleration of every valid marker,
    at its pre-substep state.  ``nbrs`` (K, N) int32 is scratch for each
    substep's neighbour list (:data:`LIST_SLOTS` slots when None).

    Returns the list overflow, () int32 on the state's device with no host
    sync: the most in-support neighbours of an integrated marker over the
    substeps, less K, clamped at 0.  A marker past K walks its neighbours
    again in sweep G, so the state is the same either way; the overflow
    says that K is short."""
    if n_substeps < 1:
        raise ValueError("crm_outer_substeps needs at least one substep")
    if nbrs is None:
        nbrs = torch.empty((LIST_SLOTS, state.shape[1]), dtype=torch.int32,
                           device=state.device)
    check_list(nbrs, state)
    if state.device.type == "cuda":
        n = state.shape[1]
        spare = torch.empty_like(state)
        mv = state.new_empty((N_MV, n))
        # the markers to stride over: integrated first, then the other
        # valid ones (walls), then the rest, each in sorted order
        valid = state[VAL] > 0.5
        kick = valid & (state[INT] > 0.5)
        order = torch.argsort(2 - valid.to(torch.int8) - kick.to(torch.int8),
                              stable=True).to(torch.int32)
        n_listed = torch.empty((n,), dtype=torch.int32, device=state.device)
        most = torch.zeros((n,), dtype=torch.int32, device=state.device)
        rec = state.new_empty((N_RECORD, n))    # the records, M's then G's
        _run("crm_outer", [("state", state, N_STATE), ("out", out, N_STATE),
                           ("spare", spare, N_STATE), ("mv", mv, N_MV),
                           ("acc", acc, 3), ("rec", rec, N_RECORD)], cells, c,
             (n_substeps, nbrs.shape[0]),
             [("order", order), ("nbrs", nbrs), ("n_listed", n_listed),
              ("most", most)])
        crm_outer_substeps.launches += 1
        most = most.max()
    elif state.device.type == "cpu":
        most = torch.zeros((), dtype=torch.int32)
        got, got_acc = crm_outer_substeps_plain(state, cells, c, n_substeps,
                                                most)
        out.copy_(got)
        acc.copy_(got_acc)
    else:
        raise ValueError(f"no crm_outer_substeps for device {state.device}")
    return torch.clamp(most - nbrs.shape[0], min=0).to(torch.int32)


crm_momentum.launches = 0
crm_gradv_stress.launches = 0
crm_outer_substeps.launches = 0


def crm_substep(state: torch.Tensor, cells: SortedCells, c: CRMConsts,
                mv: torch.Tensor, out: torch.Tensor,
                acc: torch.Tensor | None = None,
                lists: NeighbourList | None = None) -> None:
    """out ← one substep of ``state`` through the two sweeps; ``mv``
    (4, N) and ``lists`` (M's neighbour list; allocated here when None) are
    scratch; ``acc`` (3, N), if given, ← sweep M's acceleration at the
    pre-substep state."""
    if lists is None:
        lists = NeighbourList.empty(state.shape[1], state.device)
    crm_momentum(state, cells, c, mv, acc, lists)
    crm_gradv_stress(state, mv, cells, c, out, lists)
