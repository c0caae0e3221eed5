"""CRM terrain on cell-sorted markers: the terrain-alone main path.

Counterpart of ``chrono_tpu/fsi/sph/crm_pencil.py`` (the engine of
``make_crm_pencil_engine`` / ``make_crm_dual_engine``,
``make_crm_substeps_pencil``, ``make_crm_advance_pencil``).  The name is
kept so that a reader finds the counterpart, but the layout is not pencils:
the markers, with their stress and flags, are sorted by cell id into a
(17, N) structure of arrays with a per-cell ``(start, count)`` table, as
the SPH path bins them (``fsi.sph.pencil.bin_to_cells``), and each substep
is the two sweeps of ``ops.cuda.crm_substep``.  The JAX engines' layout
choices (pencil, flat, dual A/B tiers, the axis permutation, ``clip_z``)
have no counterpart: a GPU thread of an empty region simply does nothing.
"""

from __future__ import annotations

import torch

from chrono_tpu_torch.collision.cell_list import GridSpec, refuse_periodic
from chrono_tpu_torch.fsi.sph.crm import CRMParams, CRMState
from chrono_tpu_torch.fsi.sph.kernels import KERNELS
from chrono_tpu_torch.fsi.sph.pencil import bin_to_cells
from chrono_tpu_torch.fsi.sph.state import FLUID, FROZEN
from chrono_tpu_torch.ops.cuda.crm_substep import (
    N_MV, PX, PZ, RHO, SXX, SYZ, VX, VZ, NeighbourList, crm_momentum,
    crm_outer_substeps, crm_static_params, crm_substep,
)


def crm_state_to_cells(grid: GridSpec, capacity: int, st: CRMState):
    """``(feat, order, cells, overflow)``: the (17, N) sorted state planes
    and the binning of :func:`fsi.sph.pencil.bin_to_cells` (``order`` maps
    a sorted position to its input index).  The valid plane marks the first
    ``capacity`` markers of each cell."""
    order, cells, overflow = bin_to_cells(grid, capacity, st.pos)
    kind = st.kind[order]
    rho = st.rho[order].to(torch.float32)
    n = order.shape[0]
    start = cells.start.long()[cells.cell.long()]
    valid = torch.arange(n, device=order.device) - start < capacity
    flags = torch.stack([(kind == FLUID) | (kind == FROZEN), kind == FLUID,
                         valid]).to(rho.dtype)
    feat = torch.cat([st.pos[order].T, st.vel[order].T, rho[None],
                      st.tau_d[order].T, st.tau_o[order].T, flags,
                      (1.0 / torch.clamp(rho * rho, min=1e-9))[None]])
    return feat.contiguous(), order, cells, overflow


def cells_to_crm_state(feat: torch.Tensor, order: torch.Tensor,
                       st: CRMState) -> CRMState:
    """Scatter the sorted planes back into the input marker order."""
    out = torch.empty((SYZ + 1, feat.shape[1]), dtype=feat.dtype,
                      device=feat.device)
    out[:, order] = feat[:SYZ + 1]
    return st.replace(pos=out[PX:PZ + 1].T.contiguous(),
                      vel=out[VX:VZ + 1].T.contiguous(), rho=out[RHO],
                      tau_d=out[SXX:SXX + 3].T.contiguous(),
                      tau_o=out[SXX + 3:SYZ + 1].T.contiguous())


def cells_to_markers(planes: torch.Tensor, order: torch.Tensor):
    """(k, N) sorted planes → (N, k) rows in the input marker order."""
    out = torch.empty((planes.shape[1], planes.shape[0]),
                      dtype=planes.dtype, device=planes.device)
    out[order] = planes.T
    return out


def make_crm_engine(params, crm: CRMParams, grid: GridSpec,
                    capacity: int = 16, *, device):
    """The CRM engine on ``device``: a dict with

      bin(st) → (feat (17, N), order, cells, overflow); bin(st, extras)
          with extras (E, N) per-marker aux rows also returns them sorted
          through the same ``order``, (E, N), last
      substep(feat, cells, lists=None) → feat   one substep, sweeps M and G
      substep_acc(feat, cells, lists=None) → (feat, acc)  acc (3, N): sweep
          M's acceleration of every valid marker at the pre-substep state
      forces(feat, cells) → acc              sweep M alone (forces_only)
      outer(feat, cells, n) → (feat, acc, overflow)   n substeps in one
          launch, with the last M sweep's acceleration; overflow () int32
          is the excess of the most in-support neighbours of a marker over
          the kernel's list (``ops.cuda.crm_substep.LIST_SLOTS``; 0 when
          they fit, and the state is the same either way), to be taken
          into the binning's overflow
      consts                                 the kernels' constants

    ``lists`` is scratch for sweep M's neighbour list (a
    ``NeighbourList``), allocated once by the caller and handed to every
    substep; without it each substep allocates its own.

    The JAX engine's contract, with the cell table passed beside the planes
    (a pencil layout carries it in its shape).  Cells must be at least the
    kernel support 2h, so that one ring of 27 cells covers it."""
    refuse_periodic(grid, "the CRM cell-sorted engine")
    consts = crm_static_params(params, crm)
    support = KERNELS[params.kernel][2] * float(params.h)
    if float(grid.cell_size) < support - 1e-9:
        raise ValueError(f"cell {grid.cell_size} < kernel support {support}: "
                         "one ring of 27 cells does not cover it")
    if capacity < 1:
        raise ValueError("capacity must be at least 1")

    def bin_all(st: CRMState, extras: torch.Tensor | None = None):
        binned = crm_state_to_cells(grid, capacity, st.to(device))
        if extras is None:
            return binned
        # the aux rows ride the same sort as the planes
        return binned + (extras.to(device)[:, binned[1]].contiguous(),)

    def substep(feat, cells, acc=None, lists=None):
        out, mv = torch.empty_like(feat), feat.new_empty((N_MV,
                                                          feat.shape[1]))
        crm_substep(feat, cells, consts, mv, out, acc, lists)
        return out

    def substep_acc(feat, cells, lists=None):
        acc = feat.new_empty((3, feat.shape[1]))
        return substep(feat, cells, acc, lists), acc

    def forces(feat, cells):
        acc = feat.new_empty((3, feat.shape[1]))
        crm_momentum(feat, cells, consts, acc=acc)
        return acc

    def outer(feat, cells, n_substeps: int):
        out, acc = torch.empty_like(feat), feat.new_empty((3, feat.shape[1]))
        ovf = crm_outer_substeps(feat, cells, consts, n_substeps, out, acc)
        return out, acc, ovf

    return dict(bin=bin_all, substep=substep, substep_acc=substep_acc,
                forces=forces, outer=outer, consts=consts)


def make_crm_substeps_pencil(params, crm: CRMParams, grid: GridSpec,
                             capacity: int = 16, *, device):
    """``substeps(st, n) → (st2, dv (N, 3), overflow)``: bin, n substeps,
    the forces-only M sweep at the stepped state (the granular reaction
    used for the BCE force reduction), unbin."""
    eng = make_crm_engine(params, crm, grid, capacity, device=device)

    def substeps(st: CRMState, n_substeps: int):
        st = st.to(device)
        feat, order, cells, ovf = eng["bin"](st)
        lists = NeighbourList.empty(feat.shape[1], device)
        for _ in range(n_substeps):
            feat = eng["substep"](feat, cells, lists=lists)
        dv = cells_to_markers(eng["forces"](feat, cells), order)
        return cells_to_crm_state(feat, order, st), dv, ovf

    return substeps


def make_crm_advance_pencil(params, crm: CRMParams, grid: GridSpec,
                            capacity: int = 16, *, device):
    """``advance(state, n_cycles) → (state, overflow)``: terrain-only
    stepping on ``device``.

    One cycle bins the markers, runs ``params.rebuild_every`` substeps (two
    sweeps each) and unbins them.  ``overflow`` is the largest capacity
    excess seen over the call (0 when every cell fits).  The JAX advance
    discards the reaction ``dv`` of its substeps, so the forces-only sweep
    is not run here.  Sweep M's neighbour list is allocated once a call."""
    eng = make_crm_engine(params, crm, grid, capacity, device=device)
    steps = params.rebuild_every
    cycle_time = params.dt * steps

    def advance(state: CRMState, n_cycles: int):
        state = state.to(device)
        ovf = torch.zeros((), dtype=torch.int32, device=device)
        lists = NeighbourList.empty(state.n, device)
        for _ in range(n_cycles):
            feat, order, cells, overflow = eng["bin"](state)
            for _ in range(steps):
                feat = eng["substep"](feat, cells, lists=lists)
            state = cells_to_crm_state(feat, order, state)
            state = state.replace(time=state.time + cycle_time)
            ovf = torch.maximum(ovf, overflow)
        return state, ovf

    return advance
