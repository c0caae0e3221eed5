"""One symplectic WCSPH substep as three neighbour sweeps on cell-sorted
markers.

Replaces the TPU kernels ``chrono_tpu/ops/pallas/sph_sym_kernel.py``
``sph_substep_sym`` (on ``_sym_sweep``) and ``sph_pencil_kernel.py``
``sph_substep_pencil`` (on ``_pencil_sweep``): the same physics, which
``chrono_tpu/fsi/sph/wcsph.py`` defines term by term, without the TPU's
pencils, lane rolls and reaction window.

Markers are sorted by cell id ``(i·ny + j)·nz + k`` and held as a
structure of arrays, with a per-cell ``(start, count)`` table
(:class:`SortedCells`).  Each sweep is one CUDA kernel
(``csrc/sph_substep.cu``) that runs one thread per marker over the 27
neighbour cells and sums each pair from its own side, so it needs no
atomics and its sum order is fixed.  Each scans the candidates first and
runs its pair body over the hits only (``for_pairs_compact`` in
``csrc/cell_pairs.cuh``).  A walks only from solid markers: its threads
take the markers in :func:`adami_walk_order`, the live solids first.  Each
sweep needs the previous one's result on every neighbour, so each writes a
fresh buffer:

  A  ``sph_adami``: Adami wall BC on solid markers, from their fluid
     neighbours               state (10, N) → adami (7, N)
  B  ``sph_momentum``: pressure gradient + viscosity, velocity kick
                              state, adami → vel (3, N)
  CD ``sph_continuity_drift``: continuity + δ-SPH at the kicked
     velocities, XSPH drift at ρⁿ (the TPU sym kernel's fused CD)
                              state, vel → next state (10, N)

State planes: pos xyz, vel xyz, ρ, is_fluid, p = Tait(ρ), 1/max(ρ, 1e-9).
The last two are per-marker terms that the sweeps read on every neighbour;
CD computes them once per marker for the next substep.  Adami planes: p,
v_bc xyz (the no-slip ghost velocity; v itself for fluid), ρ (Tait inverse
for solid), p/ρ², 1/ρ.

In a cell that holds more than ``capacity`` markers only the first
``capacity`` (in sorted order) take part; the rest are carried through
unchanged, and the caller reports the excess as overflow.  Every function
here runs on the tensors' device; the ``*_plain`` twins are plain PyTorch,
chunked over runs of sorted markers so that they fit in memory at full
size.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from chrono_tpu_torch.fsi.sph.kernels import cubic_spline_dwdr, cubic_spline_w
from chrono_tpu_torch.fsi.sph.state import tait_density, tait_pressure
from chrono_tpu_torch.ops.cuda import _build

N_STATE = 10
N_ADAMI = 7
PX, PY, PZ, VX, VY, VZ, RHO, FLU, PRS, IRHO = range(N_STATE)
A_P, A_VBX, A_VBY, A_VBZ, A_RHO, A_PR2, A_IRHO = range(N_ADAMI)
# the Tait inverse clamps 1 + p/B at 0.1, as the TPU kernels do
# (sph_pencil_kernel._tait_rho; the JAX gather backend clamps at 1e-3,
# which differs only where p/B < −0.9)
TAIT_FLOOR = 0.1
# candidate pairs per chunk of the plain twins
_TWIN_PAIRS = 1 << 24


@dataclass(frozen=True)
class SPHConsts:
    """Host-side constants of the substep (Python floats)."""

    h: float
    m: float
    rho0: float
    c_s: float
    eos_gamma: float
    delta_sph: float
    alpha_visc: float
    mu: float
    xsph_eps: float
    dt: float
    gravity: tuple
    viscosity: str          # "artificial" | "laminar"

    @functools.cached_property
    def kernel_params(self) -> "_Consts":
        """The kernels' argument struct, packed once."""
        return _Consts(
            self.h, 1.0 / (torch.pi * self.h**3), self.m, self.rho0,
            self.c_s, self.eos_gamma,
            self.c_s**2 * self.rho0 / self.eos_gamma,
            self.delta_sph * self.h * self.c_s, self.alpha_visc, self.mu,
            self.xsph_eps, self.dt, (ctypes.c_float * 3)(*self.gravity),
            int(self.viscosity == "laminar"))


def sph_static_params(params) -> SPHConsts:
    """The substep's constants from an ``SPHParams``; the kernels implement
    the cubic spline, XSPH shifting, the symplectic scheme and the Adami
    wall model only."""
    if params.kernel != "cubic":
        raise ValueError("the SPH substep implements the cubic kernel")
    if params.shifting != "xsph":
        raise ValueError("the SPH substep implements XSPH shifting")
    if params.integrator != "symplectic":
        raise ValueError("the SPH substep implements the symplectic scheme")
    if params.boundary_model != "adami":
        raise ValueError("the SPH substep implements the Adami wall model")
    if params.viscosity_model not in ("artificial", "laminar"):
        raise ValueError(f"unknown viscosity {params.viscosity_model!r}")
    return SPHConsts(
        h=float(params.h), m=float(params.rho0) * float(params.d0) ** 3,
        rho0=float(params.rho0), c_s=float(params.c_s),
        eos_gamma=float(params.eos_gamma), delta_sph=float(params.delta_sph),
        alpha_visc=float(params.alpha_visc), mu=float(params.mu),
        xsph_eps=float(params.xsph_eps), dt=float(params.dt),
        gravity=tuple(float(g) for g in params.gravity),
        viscosity=params.viscosity_model)


@dataclass(frozen=True)
class SortedCells:
    """The per-cell table of cell-sorted markers."""

    cell: torch.Tensor      # (N,) int32 cell id of each sorted marker
    start: torch.Tensor     # (n_cells,) int32 first sorted index in the cell
    count: torch.Tensor     # (n_cells,) int32 markers in the cell
    dims: tuple             # (nx, ny, nz)
    capacity: int           # markers per cell that take part


def state_planes(pos, vel, rho, is_fluid, c: SPHConsts) -> torch.Tensor:
    """(10, N) state planes from (N, 3) pos / vel and (N,) ρ / is_fluid."""
    rho = rho.to(torch.float32)
    return torch.cat([pos.T, vel.T, rho[None], is_fluid.to(rho.dtype)[None],
                      tait_pressure(c, rho)[None],
                      (1.0 / torch.clamp(rho, min=1e-9))[None]])


# ------------------------------------------------------------ plain twins


_OFFSETS = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
            for dz in (-1, 0, 1)]


def neighbour_candidates(cells: SortedCells, lo: int, hi: int):
    """The candidate neighbours of sorted markers lo..hi−1, in the kernels'
    order (27 cells, dx-major, then the cell's markers): ``(j, ok, live)``
    with j (b, 27·C) int64 (the marker itself where not ok), ok (b, 27·C)
    bool, and live (b,) bool, false for a marker past its cell's
    capacity."""
    return candidates_of(cells, torch.arange(lo, hi,
                                             device=cells.cell.device))


def candidates_of(cells: SortedCells, i: torch.Tensor):
    """:func:`neighbour_candidates` of the sorted markers ``i`` (b,)
    int64."""
    dev = cells.cell.device
    nx, ny, nz = cells.dims
    C = cells.capacity
    b = i.shape[0]
    cid = cells.cell[i].long()
    ijk = torch.stack([cid // (ny * nz), (cid // nz) % ny, cid % nz], 1)
    nb = ijk[:, None, :] + torch.tensor(_OFFSETS, device=dev)   # (b, 27, 3)
    hi_ijk = torch.tensor([nx, ny, nz], device=dev)
    inside = ((nb >= 0) & (nb < hi_ijk)).all(-1)
    nbc = torch.where(inside, (nb[..., 0] * ny + nb[..., 1]) * nz
                      + nb[..., 2], 0)
    st = cells.start.long()[nbc]
    cnt = torch.where(inside, torch.clamp(cells.count.long()[nbc], max=C), 0)
    k = torch.arange(C, device=dev)
    j = st[..., None] + k                                       # (b, 27, C)
    ok = (k < cnt[..., None]) & (j != i[:, None, None])
    j = torch.where(ok, j, i[:, None, None]).reshape(b, -1)
    live = (i - cells.start.long()[cid]) < C
    return j, ok.reshape(b, -1), live


def _chunks(cells: SortedCells):
    n = cells.cell.shape[0]
    step = max(1, _TWIN_PAIRS // (27 * cells.capacity))
    for lo in range(0, n, step):
        yield lo, min(n, lo + step)


def _pair_geom(xi, xj, h):
    """d = x_i − x_j (b, K, 3), r² and r = sqrt(r² + 1e-12)."""
    d = xi[:, None, :] - xj
    r2 = (d * d).sum(-1)
    return d, r2, torch.sqrt(r2 + 1e-12)


def _grad(d, r, h):
    return (cubic_spline_dwdr(r, h) / torch.clamp(r, min=1e-12))[..., None] * d


def sph_adami_plain(state: torch.Tensor, cells: SortedCells,
                    c: SPHConsts) -> torch.Tensor:
    """Twin of sweep A: (10, N) state → (7, N) Adami planes."""
    out = torch.empty((N_ADAMI, state.shape[1]), dtype=state.dtype,
                      device=state.device)
    g = torch.tensor(c.gravity, dtype=state.dtype, device=state.device)
    pos, vel = state[PX:PZ + 1].T, state[VX:VZ + 1].T
    for lo, hi in _chunks(cells):
        j, ok, live = neighbour_candidates(cells, lo, hi)
        d, _, r = _pair_geom(pos[lo:hi], pos[j], c.h)
        wf = torch.where(ok & (state[FLU][j] > 0.5),
                         cubic_spline_w(r, c.h), torch.zeros_like(r))
        hydro = (d * g).sum(-1) * state[RHO][j]
        swp = (wf * (state[PRS][j] + hydro)).sum(1)
        swv = (wf[..., None] * vel[j]).sum(1)
        sw = wf.sum(1)
        has = sw > 1e-12
        den = torch.clamp(sw, min=1e-12)
        v = vel[lo:hi]
        p_solid = torch.where(has, swp / den, torch.zeros_like(swp))
        v_ghost = torch.where(has[:, None], 2.0 * v - swv / den[:, None], v)
        solid = (state[FLU, lo:hi] < 0.5) & live
        p_all = torch.where(solid, p_solid, state[PRS, lo:hi])
        v_bc = torch.where(solid[:, None], v_ghost, v)
        rho_all = torch.where(state[FLU, lo:hi] > 0.5, state[RHO, lo:hi],
                              tait_density(c, p_all, TAIT_FLOOR))
        out[A_P, lo:hi] = p_all
        out[A_VBX:A_VBZ + 1, lo:hi] = v_bc.T
        out[A_RHO, lo:hi] = rho_all
        out[A_PR2, lo:hi] = p_all / (rho_all * rho_all)
        out[A_IRHO, lo:hi] = 1.0 / rho_all
    return out


def sph_momentum_plain(state: torch.Tensor, adami: torch.Tensor,
                       cells: SortedCells, c: SPHConsts) -> torch.Tensor:
    """Twin of sweep B: the kicked velocities, (3, N)."""
    out = torch.empty((3, state.shape[1]), dtype=state.dtype,
                      device=state.device)
    g = torch.tensor(c.gravity, dtype=state.dtype, device=state.device)
    pos, vel = state[PX:PZ + 1].T, state[VX:VZ + 1].T
    v_bc = adami[A_VBX:A_VBZ + 1].T
    eps_h2 = 0.01 * c.h * c.h
    for lo, hi in _chunks(cells):
        j, ok, live = neighbour_candidates(cells, lo, hi)
        d, r2, r = _pair_geom(pos[lo:hi], pos[j], c.h)
        gw = _grad(d, r, c.h)
        v_ij = vel[lo:hi, None, :] - v_bc[j]
        pterm = adami[A_PR2, lo:hi, None] + adami[A_PR2][j]
        acc = -(c.m * pterm)[..., None] * gw
        if c.viscosity == "laminar":
            coef = (c.m * 2.0 * c.mu * adami[A_IRHO, lo:hi, None]
                    * adami[A_IRHO][j] * (d * gw).sum(-1) / (r2 + eps_h2))
            acc = acc + coef[..., None] * v_ij
        else:
            v_dot_r = (v_ij * d).sum(-1)
            mu_ij = c.h * v_dot_r / (r2 + eps_h2)
            pi = torch.where(v_dot_r < 0, -c.alpha_visc * c.c_s * mu_ij
                             / (0.5 * (adami[A_RHO, lo:hi, None]
                                       + adami[A_RHO][j])),
                             torch.zeros_like(mu_ij))
            acc = acc - (c.m * pi)[..., None] * gw
        acc = torch.where(ok[..., None], acc, torch.zeros_like(acc)).sum(1)
        kick = (state[FLU, lo:hi] > 0.5) & live
        v = vel[lo:hi]
        out[:, lo:hi] = torch.where(kick[:, None], v + c.dt * (acc + g), v).T
    return out


def sph_continuity_drift_plain(state: torch.Tensor, vel: torch.Tensor,
                               cells: SortedCells,
                               c: SPHConsts) -> torch.Tensor:
    """Twin of sweep CD: the next (10, N) state from the kicked (3, N)
    velocities."""
    out = torch.empty_like(state)
    pos, v1 = state[PX:PZ + 1].T, vel.T
    for lo, hi in _chunks(cells):
        j, ok, live = neighbour_candidates(cells, lo, hi)
        d, r2, r = _pair_geom(pos[lo:hi], pos[j], c.h)
        gw = _grad(d, r, c.h)
        zero = torch.zeros_like(r)
        drho = torch.where(ok, c.m * ((v1[lo:hi, None, :] - v1[j]) * gw)
                           .sum(-1), zero).sum(1)
        rho_i, rho_j = state[RHO, lo:hi, None], state[RHO][j]
        ff = ok & (state[FLU][j] > 0.5)
        psi = 2.0 * (rho_j - rho_i) * (-d * gw).sum(-1) / (r2 + 1e-12)
        diff = torch.where(ff, c.m * state[IRHO][j] * psi, zero).sum(1)
        drho = drho + c.delta_sph * c.h * c.c_s * diff
        rho_avg = torch.clamp(0.5 * (rho_i + rho_j), min=1e-9)
        wx = torch.where(ff, c.m / rho_avg * cubic_spline_w(r, c.h), zero)
        corr = (wx[..., None] * (v1[j] - v1[lo:hi, None, :])).sum(1)
        move = (state[FLU, lo:hi] > 0.5) & live
        rho = state[RHO, lo:hi]
        rho = torch.clamp(torch.where(move, rho + c.dt * drho, rho),
                          0.7 * c.rho0, 1.5 * c.rho0)
        x = pos[lo:hi]
        x = torch.where(move[:, None],
                        x + c.dt * (v1[lo:hi] + c.xsph_eps * corr), x)
        out[PX:PZ + 1, lo:hi] = x.T
        out[VX:VZ + 1, lo:hi] = vel[:, lo:hi]
        out[RHO, lo:hi] = rho
        out[FLU, lo:hi] = state[FLU, lo:hi]
        out[PRS, lo:hi] = tait_pressure(c, rho)
        out[IRHO, lo:hi] = 1.0 / torch.clamp(rho, min=1e-9)
    return out


def sph_substep_plain(state: torch.Tensor, cells: SortedCells,
                      c: SPHConsts) -> torch.Tensor:
    """Twin of the whole substep: the next (10, N) state."""
    adami = sph_adami_plain(state, cells, c)
    vel = sph_momentum_plain(state, adami, cells, c)
    return sph_continuity_drift_plain(state, vel, cells, c)


# ---------------------------------------------------------------- kernels


class _Consts(ctypes.Structure):
    _fields_ = ([(k, ctypes.c_float) for k in
                 ("h", "sigma", "m", "rho0", "c_s", "gamma", "B", "dhc",
                  "alpha_visc", "mu", "xsph_eps", "dt")]
                + [("g", ctypes.c_float * 3), ("laminar", ctypes.c_int)])


def _launcher(name: str):
    return _bind(name, _build.DEFINES)


@functools.cache
def _bind(name: str, defines: tuple):
    """The launcher of the build that ``_build.load`` returns under
    ``defines`` (the cache key: a counter build binds its own)."""
    fn = getattr(_build.load("sph_substep"), f"{name}_launch")
    # A's inputs: the state and its thread order
    n_in = {"sph_adami": 2, "sph_momentum": 2, "sph_continuity_drift": 2}
    fn.argtypes = ([ctypes.c_void_p] * n_in[name]          # inputs
                   + [ctypes.c_void_p] * 3                 # cell table
                   + [ctypes.c_void_p]                     # output
                   + [ctypes.c_int] * 5                    # n, dims, C
                   + [ctypes.POINTER(_Consts), ctypes.c_void_p,
                      ctypes.c_int])
    fn.restype = ctypes.c_int
    return fn


def check_planes(name, t, rows, n, device):
    """Raise unless ``t`` is a contiguous float32 (rows, n) on device."""
    if t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous float32")
    if tuple(t.shape) != (rows, n):
        raise ValueError(f"{name} must be ({rows}, {n}), got "
                         f"{tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} must be on {device}")


def overlaps(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether the bytes of two contiguous tensors overlap."""
    a0, b0 = a.data_ptr(), b.data_ptr()
    return (a0 < b0 + b.numel() * b.element_size()
            and b0 < a0 + a.numel() * a.element_size())


def check_cells(cells: SortedCells, device, n_state: int):
    """Raise unless the cell table is contiguous int32 of the right sizes
    on ``device`` and the kernels can index ``n_state`` planes of it."""
    n = cells.cell.shape[0]
    n_cells = cells.dims[0] * cells.dims[1] * cells.dims[2]
    for label, t, size in (("cell", cells.cell, n),
                           ("start", cells.start, n_cells),
                           ("count", cells.count, n_cells)):
        if (t.dtype != torch.int32 or not t.is_contiguous()
                or t.numel() != size or t.device != device):
            raise ValueError(f"cells.{label} must be contiguous int32 of "
                             f"{size} on {device}")
    if n == 0 or n_state * n >= 2 ** 31 or cells.capacity < 1:
        raise ValueError(f"{n} markers is outside the kernels' range")


def _launch(name, inputs, cells: SortedCells, out, out_rows,
            c: SPHConsts, order=None):
    """Check ``inputs`` (label, tensor, rows), ``out`` and A's thread
    ``order`` and launch."""
    n = cells.cell.shape[0]
    dev = inputs[0][1].device
    for label, t, rows in inputs:
        check_planes(label, t, rows, n, dev)
    check_planes("out", out, out_rows, n, dev)
    for label, t, _ in inputs:
        if overlaps(t, out):
            raise ValueError(f"{name} runs out of place ({label} is out)")
    check_cells(cells, dev, N_STATE)
    extra = ()
    if order is not None:
        check_walk_order(order, n, dev)
        if overlaps(order, out):
            raise ValueError(f"{name} runs out of place (order is out)")
        extra = (order.data_ptr(),)
    err = _launcher(name)(
        *(t.data_ptr() for _, t, _ in inputs), *extra, cells.cell.data_ptr(),
        cells.start.data_ptr(), cells.count.data_ptr(), out.data_ptr(), n,
        *cells.dims, cells.capacity, ctypes.byref(c.kernel_params),
        torch.cuda.current_stream(dev).cuda_stream, dev.index)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def check_walk_order(order: torch.Tensor, n: int, device) -> None:
    """Raise unless ``order`` is a contiguous int32 (n,) tensor on
    ``device`` holding each of 0 … n − 1 once: a thread order that leaves
    no column of sweep A's output unwritten.  The permutation test sorts
    and reads the result on the host, once per tensor and in-place change
    (the result is kept on the tensor, keyed by its version counter): a
    walk order is made once a binning and handed to every substep."""
    if (order.dtype != torch.int32 or not order.is_contiguous()
            or tuple(order.shape) != (n,) or order.device != device):
        raise ValueError(f"order must be contiguous int32 ({n},) on "
                         f"{device}")
    if getattr(order, "_permutation_of", None) == (n, order._version):
        return
    if not torch.equal(torch.sort(order).values,
                       torch.arange(n, dtype=torch.int32, device=device)):
        raise ValueError(f"order must hold each of the {n} binned markers "
                         "once (a permutation, as adami_walk_order makes)")
    order._permutation_of = (n, order._version)


def adami_walk_order(state: torch.Tensor,
                     cells: SortedCells) -> torch.Tensor:
    """A's thread order, (N,) int32: the sorted indices of the live solid
    markers (those whose pair loop runs) in sorted order, then the others in
    sorted order.  A stable sort of a 0/1 key on the state's device, with no
    host sync; markers never change kind, so it holds for a binning."""
    n = state.shape[1]
    start = cells.start.long()[cells.cell.long()]
    live = torch.arange(n, device=state.device) - start < cells.capacity
    rest = ~((state[FLU] < 0.5) & live)
    return torch.argsort(rest.to(torch.int32), stable=True).to(torch.int32)


def sph_adami(state: torch.Tensor, cells: SortedCells, c: SPHConsts,
              out: torch.Tensor, order: torch.Tensor | None = None) -> None:
    """Sweep A: out (7, N) ← the Adami planes of the (10, N) state.

    ``order`` should be :func:`adami_walk_order` of this binning (any
    state of it: markers never change kind), which puts the walking
    threads first; it must be a permutation of the binned markers
    (:func:`check_walk_order`, on every device), so that no column of
    ``out`` is left unwritten.  Without ``order`` (a convenience for a
    single call, as in the tests) it is made here, a sort on every call.
    A CUDA tensor launches the kernel; a CPU tensor runs the twin."""
    if order is not None:
        check_walk_order(order, state.shape[1], state.device)
    if state.device.type == "cuda":
        if order is None:
            order = adami_walk_order(state, cells)
        _launch("sph_adami", [("state", state, N_STATE)], cells, out,
                N_ADAMI, c, order)
        sph_adami.launches += 1
    elif state.device.type == "cpu":
        out.copy_(sph_adami_plain(state, cells, c))
    else:
        raise ValueError(f"no sph_adami for device {state.device}")


def sph_momentum(state: torch.Tensor, adami: torch.Tensor,
                 cells: SortedCells, c: SPHConsts,
                 out: torch.Tensor) -> None:
    """Sweep B: out (3, N) ← the kicked velocities."""
    if state.device.type == "cuda":
        _launch("sph_momentum", [("state", state, N_STATE),
                                 ("adami", adami, N_ADAMI)], cells, out, 3, c)
        sph_momentum.launches += 1
    elif state.device.type == "cpu":
        out.copy_(sph_momentum_plain(state, adami, cells, c))
    else:
        raise ValueError(f"no sph_momentum for device {state.device}")


def sph_continuity_drift(state: torch.Tensor, vel: torch.Tensor,
                         cells: SortedCells, c: SPHConsts,
                         out: torch.Tensor) -> None:
    """Sweep CD: out (10, N) ← the next state, from the kicked (3, N)
    velocities."""
    if state.device.type == "cuda":
        _launch("sph_continuity_drift", [("state", state, N_STATE),
                                         ("vel", vel, 3)], cells, out,
                N_STATE, c)
        sph_continuity_drift.launches += 1
    elif state.device.type == "cpu":
        out.copy_(sph_continuity_drift_plain(state, vel, cells, c))
    else:
        raise ValueError(f"no sph_continuity_drift for device "
                         f"{state.device}")


sph_adami.launches = 0
sph_momentum.launches = 0
sph_continuity_drift.launches = 0


def sph_substep(state: torch.Tensor, cells: SortedCells, c: SPHConsts,
                adami: torch.Tensor, vel: torch.Tensor, out: torch.Tensor,
                order: torch.Tensor | None = None) -> None:
    """out ← one substep of ``state`` through the three sweeps; ``adami``
    (7, N) and ``vel`` (3, N) are scratch, ``order`` A's thread order."""
    sph_adami(state, cells, c, adami, order)
    sph_momentum(state, adami, cells, c, vel)
    sph_continuity_drift(state, vel, cells, c, out)
