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
per-cell ``(start, count)`` table of :class:`SortedCells`, as the SPH
sweeps hold them (``ops.cuda.sph_substep``).  The kernels
(``csrc/crm_substep.cu`` and ``csrc/crm_outer.cu``, with the physics in
``csrc/crm_sweeps.cuh``) run one thread per marker over the 27 neighbour
cells and sum each pair from their own side: no atomics, a fixed order.
``crm_outer`` walks in M only, with the pair body over the compacted hits
(``for_pairs_compact``, ``csrc/cell_pairs.cuh``), and lists each integrated
marker's in-support neighbours for G to replay.

  M ``crm_momentum``: stress divergence with wall mirroring, artificial
    viscosity and the mixed-pair penalty → the kick of integrated markers,
    and optionally the raw acceleration of every valid marker
                             state (17, N) → mv (4, N) and/or acc (3, N)
  G ``crm_gradv_stress``: ∇v and continuity at the kicked velocities →
    Jaumann rate, Drucker–Prager return, ρ update and clip, drift
                             state, mv → next state (17, N)
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
markers whose pair loop is needed.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from dataclasses import dataclass

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
(PX, PY, PZ, VX, VY, VZ, RHO, SXX, SYY, SZZ, SXY, SXZ, SYZ, GRN, INT, VAL,
 DER) = range(N_STATE)
# candidate pairs per chunk of the plain twins
_TWIN_PAIRS = 1 << 24
# neighbour-list slots a marker in crm_outer (a uniform bed has ~58
# neighbours inside 2h = 2.4 d0)
LIST_SLOTS = 128


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


def crm_neighbour_counts_plain(state: torch.Tensor, cells: SortedCells,
                               c: CRMConsts) -> torch.Tensor:
    """Twin of the whole-outer kernel's list lengths: (N,) int32, the
    neighbours inside the support (the kernels' test: r² ≤ 4.0004 h² and
    √(r² + 1e-12)/h < 2) of each integrated valid marker, 0 elsewhere."""
    move = (state[VAL] > 0.5) & (state[INT] > 0.5)
    pos = state[PX:PZ + 1].T
    counts = torch.zeros(state.shape[1], dtype=torch.int32,
                         device=state.device)
    for cells_c, i in _rows(cells, move):
        j, ok, _ = candidates_of(cells_c, i)
        d = pos[i][:, None, :] - pos[j]
        r2 = (d * d).sum(-1)
        inside = (ok & (r2 <= 4.0004 * c.h * c.h)
                  & (torch.sqrt(r2 + 1e-12) / c.h < 2.0))
        counts[i] = inside.sum(1).to(torch.int32)
    return counts


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
    "crm_momentum": ("crm_substep", [_P] * 6, []),
    "crm_gradv_stress": ("crm_substep", [_P] * 6, []),
    # + order, the list, its lengths, most; n_sub, K
    "crm_outer": ("crm_outer", [_P] * 12, [_I] * 2),
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
    (label, tensor) int32 ones (already checked by the caller), none
    sharing memory with another, and the cell table; launch."""
    n = cells.cell.shape[0]
    dev = buffers[0][1].device
    given = [(label, t) for label, t, _ in buffers if t is not None]
    given += list(ints)
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
    ptrs += [t.data_ptr() for _, t in ints]
    err = _launcher(name)(
        ptrs[0], cells.cell.data_ptr(), cells.start.data_ptr(),
        cells.count.data_ptr(), *ptrs[1:], n, *cells.dims, cells.capacity,
        *extra, ctypes.byref(c.kernel_params),
        torch.cuda.current_stream(dev).cuda_stream, dev.index)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def crm_momentum(state: torch.Tensor, cells: SortedCells, c: CRMConsts,
                 mv: torch.Tensor | None = None,
                 acc: torch.Tensor | None = None) -> None:
    """Sweep M on the (17, N) state.  ``mv`` (4, N) ← the kicked
    velocities and 1/ρ; ``acc`` (3, N) ← the raw acceleration of every
    valid marker.  Either may be None, not both: ``mv`` alone is the
    substep, both its ``with_acc`` mode, ``acc`` alone ``forces_only``.

    A CUDA tensor launches the kernel; a CPU tensor runs the twin."""
    if mv is None and acc is None:
        raise ValueError("crm_momentum needs mv or acc")
    if state.device.type == "cuda":
        _run("crm_momentum", [("state", state, N_STATE), ("mv", mv, N_MV),
                              ("acc", acc, 3)], cells, c)
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
                     out: torch.Tensor) -> None:
    """Sweep G: out (17, N) ← the next state, from the (4, N) planes of
    sweep M."""
    if state.device.type == "cuda":
        _run("crm_gradv_stress", [("state", state, N_STATE),
                                  ("mv", mv, N_MV),
                                  ("out", out, N_STATE)], cells, c)
        crm_gradv_stress.launches += 1
    elif state.device.type == "cpu":
        out.copy_(crm_gradv_stress_plain(state, mv, cells, c))
    else:
        raise ValueError(f"no crm_gradv_stress for device {state.device}")


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
        _run("crm_outer", [("state", state, N_STATE), ("out", out, N_STATE),
                           ("spare", spare, N_STATE), ("mv", mv, N_MV),
                           ("acc", acc, 3)], cells, c,
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
                acc: torch.Tensor | None = None) -> None:
    """out ← one substep of ``state`` through the two sweeps; ``mv``
    (4, N) is scratch; ``acc`` (3, N), if given, ← sweep M's acceleration
    at the pre-substep state."""
    crm_momentum(state, cells, c, mv, acc)
    crm_gradv_stress(state, mv, cells, c, out)
