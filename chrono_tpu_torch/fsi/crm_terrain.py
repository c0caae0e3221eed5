"""CRM deformable terrain coupled to a multibody vehicle.

Counterpart of ``chrono_tpu/fsi/crm_terrain.py``: the box terrain patch
(``make_crm_terrain_state``, with rigid-body BCE markers such as wheels),
``wheel_bce_markers``, ``CRMFSIState``, the coupled outer step
``crm_fsi_step`` (BCE kinematics from the body states, the CRM substeps,
the reduction of the granular reaction on the BCE markers to per-body
forces and torques, then one multibody step with those loads) and its two
drivers: ``make_crm_fsi_advance_fn`` (every outer step on its own,
optionally over the active domains of ``fsi.active``) and
``make_crm_fsi_advance_persistent`` (the terrain kept binned for
``rebuild_outer`` outer steps, the BCE update and the reduction done on
the sorted planes).  The substeps run on one of two engines: the gather
backend (``fsi.sph.crm``'s ``crm_step`` on a neighbour list rebuilt every
outer step, :func:`gather_substeps`), the JAX package's default, or the
CRM kernels of ``ops.cuda.crm_substep`` through the engine of
``fsi.sph.crm_pencil``.  Every reduction sums in a fixed order with no
atomics.

On the card with the direct solver the multibody step is captured once in
a ``torch.cuda.CUDAGraph`` and replayed every outer step (the step builds
no tensor from host data; ``physics.system.simulate`` replays it the same
way); elsewhere it runs eagerly.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from chrono_tpu_torch.collision.cell_list import GridSpec
from chrono_tpu_torch.core import quaternion as Q
from chrono_tpu_torch.fsi import bce
from chrono_tpu_torch.fsi.active import (
    ActiveDomainSpec, activity_masks, compact_indices, gather_state,
    scatter_state,
)
from chrono_tpu_torch.fsi.sph.crm import (
    CRMParams, CRMState, crm_forces, crm_step, lithostatic_init,
    make_crm_state, rebuild_crm_neighbors,
)
from chrono_tpu_torch.fsi.sph.crm_pencil import (
    cells_to_crm_state, make_crm_engine, make_crm_substeps_pencil,
)
from chrono_tpu_torch.fsi.sph.kernels import KERNELS
from chrono_tpu_torch.fsi.sph.state import RIGID_BCE
from chrono_tpu_torch.fsi.sph.system import make_sph_state
from chrono_tpu_torch.fsi.sph.wcsph import particle_mass
from chrono_tpu_torch.ops.cuda.crm_substep import (
    PX, PZ, VX, VZ, NeighbourList,
)
from chrono_tpu_torch.physics.body import BodyState
from chrono_tpu_torch.physics.system import (
    Model, SolverSettings, step_euler_implicit_linearized,
)
from chrono_tpu_torch.utils.samplers import grid_sample_box
from chrono_tpu_torch.utils.segment import segment_reduce_sum

def make_crm_terrain_state(params, crm: CRMParams, size, depth,
                           spacing=None, rigid_pts=None, rigid_body_ids=None,
                           rigid_local=None, carve_fn=None, surface_fn=None,
                           air: float = 30.0, margin: float = 6.0,
                           dtype=torch.float32, *,
                           device) -> tuple[CRMState, GridSpec]:
    """Box terrain patch: granular bed (lithostatic pre-stress) and wall BCE
    floor and side layers, on ``device``.

    ``size``: (Lx, Ly); ``depth``: bed depth; ``carve_fn(pts) -> keep
    mask`` removes granular markers; ``surface_fn(x, y) -> z`` shapes the
    bed surface from a heightmap (depths measured up to min(depth,
    surface)); ``air``: headroom above the bed in d0 units covered by the
    grid (and by the side walls, capped at 20·d0); ``margin``: the grid's
    margin beyond the bed box, in d0 units.  Rigid BCE markers
    (``rigid_pts`` in the world, with their bodies ``rigid_body_ids`` and
    body-local offsets ``rigid_local``) follow the bed and the walls.
    Returns (CRMState, GridSpec).
    """
    d0 = float(spacing if spacing is not None else params.d0)
    Lx, Ly = float(size[0]), float(size[1])
    H = float(depth)
    gran = grid_sample_box((0, 0, 0), (Lx, Ly, H), d0)
    if surface_fn is not None:
        zs = np.asarray(surface_fn(gran[:, 0], gran[:, 1]), float)
        gran = gran[gran[:, 2] < zs]
    if carve_fn is not None:
        gran = gran[np.asarray(carve_fn(gran), bool)]
    walls = bce.box_wall_markers(
        (0, 0, 0), (Lx, Ly, H + min(20.0, float(air)) * d0), d0,
        layers=3, top_open=True)
    sph = make_sph_state(params, gran, boundary_pts=walls,
                         rigid_pts=rigid_pts, rigid_body_ids=rigid_body_ids,
                         rigid_local=rigid_local, dtype=dtype, device=device)
    state = make_crm_state(sph, dtype)
    if surface_fn is None:
        surface = H
    else:
        # heightmap bed: per-marker lithostatic depth to the local surface
        pos = state.pos.cpu().numpy()
        surface = torch.as_tensor(
            np.minimum(np.asarray(surface_fn(pos[:, 0], pos[:, 1]), float),
                       H), dtype=dtype, device=device)
    state = lithostatic_init(state, params, crm, surface_z=surface)

    cell = KERNELS[params.kernel][2] * float(params.h)
    margin = float(margin) * d0
    zmax = H + float(air) * d0
    dims = (int(np.ceil((Lx + 2 * margin) / cell)),
            int(np.ceil((Ly + 2 * margin) / cell)),
            int(np.ceil((zmax + 2 * margin) / cell)))
    grid = GridSpec(origin=(-margin, -margin, -margin), cell_size=cell,
                    dims=dims)
    return state, grid


def wheel_bce_markers(radius, width, spacing, layers=2):
    """Cylinder-shell BCE markers for a wheel with axis y (vehicle
    lateral): (M, 3) local coordinates."""
    pts = []
    n_ax = max(2, int(np.ceil(width / spacing)) + 1)
    ys = np.linspace(-width / 2, width / 2, n_ax)
    for il in range(layers):
        r = radius - il * spacing
        if r <= spacing:
            break
        n_c = max(8, int(np.ceil(2 * np.pi * r / spacing)))
        ang = np.arange(n_c) * 2 * np.pi / n_c
        for y in ys:
            pts.append(np.stack([r * np.cos(ang), np.full(n_c, y),
                                 r * np.sin(ang)], axis=-1))
    return np.concatenate(pts, axis=0)


@dataclass(frozen=True)
class CRMFSIState:
    """The vehicle's bodies, the terrain and the time (a () tensor)."""

    bodies: BodyState
    terrain: CRMState
    time: torch.Tensor

    def replace(self, **changes) -> "CRMFSIState":
        return dataclasses.replace(self, **changes)


class MBSStep:
    """``step(bodies, t, f_ext, tau_ext) → bodies``: one
    ``step_euler_implicit_linearized`` of ``h`` with the given external
    loads.  On a CUDA state with the direct solver the first call warms a
    step up on a side stream and captures one step into a
    ``torch.cuda.CUDAGraph`` on static buffers; every call copies its
    inputs in, replays the graph and returns copies of the outputs.  With
    another solver (its loop tests read the host) or on the CPU each call
    steps eagerly.  The replay launches the eager step's kernels in the
    same order."""

    def __init__(self, model: Model, h: float, settings: SolverSettings):
        self.model, self.h, self.settings = model, h, settings
        self.graph = None

    def eager(self, bodies, t, f_ext, tau_ext):
        return step_euler_implicit_linearized(
            self.model, bodies, t, self.h, self.settings, f_ext=f_ext,
            tau_ext=tau_ext)[0]

    def __call__(self, bodies: BodyState, t, f_ext, tau_ext) -> BodyState:
        if not (bodies.x.is_cuda and self.settings.solver == "direct"):
            return self.eager(bodies, t, f_ext, tau_ext)
        if self.graph is None:
            self._capture(bodies, t, f_ext, tau_ext)
        for dst, src in zip(self.inputs, (bodies.x, bodies.q, bodies.v,
                                          bodies.w, t, f_ext, tau_ext)):
            dst.copy_(src)
        self.graph.replay()
        return BodyState(*(a.clone() for a in self.outputs))

    def _capture(self, bodies, t, f_ext, tau_ext):
        self.inputs = [a.clone() for a in (bodies.x, bodies.q, bodies.v,
                                            bodies.w, t, f_ext, tau_ext)]
        x, q, v, w, t0, f0, tau0 = self.inputs
        dev = x.device
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self.eager(BodyState(x, q, v, w), t0, f0, tau0)
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = self.eager(BodyState(x, q, v, w), t0, f0, tau0)
        self.outputs = (out.x, out.q, out.v, out.w)
        self.graph = graph


def _drive_loads(f_ext_fn, t, bodies, f_b, tau_local):
    """The terrain loads plus the caller's ``f_ext_fn(t, bodies) →
    (f_world, tau_local)`` (either may be None)."""
    if f_ext_fn is None:
        return f_b, tau_local
    f_drv, tau_drv = f_ext_fn(t, bodies)
    return (f_b if f_drv is None else f_b + f_drv,
            tau_local if tau_drv is None else tau_local + tau_drv)


def gather_substeps(params, crm: CRMParams, grid: GridSpec):
    """``substeps(st, n) → (st, dv, overflow)`` on the gather backend: the
    neighbour list rebuilt once, ``n`` ``crm_step``s on it, and the
    granular reaction ``crm_forces`` at the final state on the same list,
    as the JAX package's ``crm_fsi_step`` runs them."""
    def substeps(st: CRMState, n_substeps: int):
        st = rebuild_crm_neighbors(params, grid, st)
        for _ in range(n_substeps):
            st = crm_step(params, crm, grid, st)
        return st, crm_forces(params, crm, grid, st), st.nbr.overflow

    return substeps


def crm_fsi_step(model: Model, params, crm: CRMParams, grid: GridSpec,
                 state: CRMFSIState, n_substeps: int, wheel_bodies,
                 active: ActiveDomainSpec | None = None,
                 mbs_settings: SolverSettings = SolverSettings(
                     solver="direct"),
                 f_ext_fn=None, substeps_fn=None, mbs_step=None):
    """One coupled outer step: BCE kinematics → (active-domain) CRM
    substeps → BCE force and torque reduction → one multibody step of
    ``params.dt · n_substeps`` with the terrain loads.

    ``wheel_bodies``: the indices of the bodies carrying BCE markers (the
    anchors of the active boxes).  ``f_ext_fn(t, bodies) → (f_world,
    tau_local)`` adds the caller's loads (drive torques).
    ``substeps_fn(st, n) → (st, dv, overflow)`` runs the substeps (the
    CRM kernels' is ``fsi.sph.crm_pencil.make_crm_substeps_pencil``);
    without it the gather backend runs them (:func:`gather_substeps`), as
    in the JAX package.  ``mbs_step`` (an :class:`MBSStep`) replaces the
    eager multibody step; ``info`` is then None.  Returns (state, overflow
    () int32, info)."""
    if substeps_fn is None:
        substeps_fn = gather_substeps(params, crm, grid)
    bodies, terrain = state.bodies, state.terrain

    # 1. BCE marker kinematics from the current body states
    pos, vel = bce.update_rigid_markers(
        terrain.pos, terrain.vel, terrain.kind, terrain.body_id,
        terrain.bce_local, bodies.x, bodies.q, bodies.v, bodies.w)
    terrain = terrain.replace(pos=pos, vel=vel)

    if active is not None:
        wheels = torch.as_tensor(np.asarray(wheel_bodies, np.int64),
                                 device=bodies.x.device)
        strict, ext = activity_masks(active, terrain.pos, terrain.kind,
                                     bodies.x[wheels])
        idx, _, a_overflow = compact_indices(active, ext)
        sub = gather_state(terrain, idx, strict)
        sub, dv_sub, n_overflow = substeps_fn(sub, n_substeps)
        f_b, tau_b = bce.rigid_body_forces(
            params, dv_sub, sub.kind, sub.body_id, sub.pos, bodies.x,
            model.n_bodies)
        terrain = scatter_state(terrain, sub, idx)
        overflow = torch.maximum(a_overflow, n_overflow)
    else:
        terrain, dv, overflow = substeps_fn(terrain, n_substeps)
        f_b, tau_b = bce.rigid_body_forces(
            params, dv, terrain.kind, terrain.body_id, terrain.pos,
            bodies.x, model.n_bodies)
    tau_local = Q.qrotate_inv(bodies.q, tau_b)

    # 2. the vehicle's multibody step over the outer interval
    h_outer = params.dt * n_substeps
    f_tot, tau_tot = _drive_loads(f_ext_fn, state.time, bodies, f_b,
                                  tau_local)
    if mbs_step is None:
        bodies, info = step_euler_implicit_linearized(
            model, bodies, state.time, h_outer, mbs_settings,
            f_ext=f_tot, tau_ext=tau_tot)
    else:
        bodies, info = mbs_step(bodies, state.time, f_tot, tau_tot), None
    return (CRMFSIState(bodies=bodies, terrain=terrain,
                        time=state.time + h_outer), overflow, info)


def make_crm_fsi_advance_fn(model: Model, params, crm: CRMParams,
                            grid: GridSpec, n_substeps: int, wheel_bodies,
                            active: ActiveDomainSpec | None = None,
                            mbs_settings: SolverSettings = SolverSettings(
                                solver="direct"),
                            f_ext_fn=None, engine: str = "gather",
                            pencil_capacity: int = 16, pencil_Bxy: int = 4,
                            *, device):
    """``advance(state, n_outer) → (state, overflow)``: ``n_outer`` calls
    of :func:`crm_fsi_step` on ``device``.

    ``engine``: "gather", the JAX package's default, runs the substeps on
    a neighbour list rebuilt every outer step (:func:`gather_substeps`);
    "pencil" on the CRM kernels, the terrain binned and unbinned every
    outer step (``make_crm_substeps_pencil``, capacity
    ``pencil_capacity``).  ``pencil_Bxy`` is the TPU pencil's lane
    blocking: a GPU thread takes one marker, so it changes nothing here.
    The multibody step is an :class:`MBSStep` (a graph replay on the card
    with the direct solver).  ``overflow`` is the largest cell,
    neighbour-list or active-buffer excess over the call."""
    if engine == "gather":
        substeps_fn = gather_substeps(params, crm, grid)
    elif engine == "pencil":
        substeps_fn = make_crm_substeps_pencil(params, crm, grid,
                                               pencil_capacity,
                                               device=device)
    else:
        raise ValueError(f"unknown CRM engine {engine!r}")
    mbs_step = MBSStep(model, params.dt * n_substeps, mbs_settings)

    def advance(state: CRMFSIState, n_outer: int):
        state = _to(state, device)
        ovf = torch.zeros((), dtype=torch.int32, device=device)
        for _ in range(n_outer):
            state, ov, _ = crm_fsi_step(
                model, params, crm, grid, state, n_substeps, wheel_bodies,
                active, mbs_settings, f_ext_fn, substeps_fn=substeps_fn,
                mbs_step=mbs_step)
            ovf = torch.maximum(ovf, ov)
        return state, ovf

    return advance


def _to(state: CRMFSIState, device) -> CRMFSIState:
    return CRMFSIState(
        bodies=BodyState(*(getattr(state.bodies, f).to(device)
                           for f in "xqvw")),
        terrain=state.terrain.to(device), time=state.time.to(device))


def bce_extras(st: CRMState) -> torch.Tensor:
    """The aux rows the persistent driver bins with the planes, (4, N)
    float32: each rigid marker's body index + 1 (0: no body; an empty slot
    reads as no body) and its body-local offset."""
    is_r = st.kind == RIGID_BCE
    bid = torch.where(is_r, st.body_id + 1, 0).to(torch.float32)
    return torch.cat([bid[None], st.bce_local.T.to(torch.float32)])


@dataclass(frozen=True)
class RigidSlots:
    """The sorted positions of the wheels' BCE markers in a binning,
    grouped by body (a stable sort, so each body's markers keep their
    sorted order): ``slots`` (M,) int64, their bodies ``body`` (M,),
    body-local offsets ``local`` (M, 3), and ``offsets`` (n_bodies + 1,)
    where each body's run starts (a body with no markers has an empty
    run)."""

    slots: torch.Tensor
    body: torch.Tensor
    local: torch.Tensor
    offsets: torch.Tensor


def rigid_slots(aux: torch.Tensor, is_wheel: torch.Tensor,
                n_rigid: int) -> RigidSlots:
    """:class:`RigidSlots` of a binning from its sorted aux rows
    (:func:`bce_extras`); ``is_wheel`` (n_bodies,) bool marks the bodies
    whose markers count, ``n_rigid`` is their number of markers.  No host
    sync."""
    n_bodies = is_wheel.shape[0]
    bid = aux[0].round().long() - 1
    mine = (bid >= 0) & is_wheel[torch.clamp(bid, min=0)]
    key = torch.where(mine, bid, n_bodies)
    key_sorted, order = torch.sort(key, stable=True)
    slots = order[:n_rigid]
    return RigidSlots(
        slots=slots, body=key_sorted[:n_rigid],
        local=aux[1:4][:, slots].T.contiguous(),
        offsets=torch.searchsorted(key_sorted, torch.arange(
            n_bodies + 1, device=aux.device)))


def update_bce_planes(feat: torch.Tensor, rs: RigidSlots,
                      bodies: BodyState) -> None:
    """x_m = x_b + R ξ, v_m = v_b + ω × (R ξ) written in place into the
    sorted planes at the wheels' markers (``bce.update_rigid_markers`` on
    the binned layout, the same arithmetic)."""
    q = bodies.q[rs.body]
    r = Q.qrotate(q, rs.local)
    w = Q.qrotate(q, bodies.w[rs.body])
    feat[PX:PZ + 1, rs.slots] = (bodies.x[rs.body] + r).T
    feat[VX:VZ + 1, rs.slots] = (
        bodies.v[rs.body] + torch.linalg.cross(w, r, dim=-1)).T


def body_forces_planes(params, feat: torch.Tensor, acc: torch.Tensor,
                       rs: RigidSlots, bodies: BodyState):
    """``bce.rigid_body_forces`` on the sorted planes: f = Σ m a and
    τ = Σ (x_m − x_b) × m a over each wheel's markers, a segment sum over
    their runs (fixed order, no atomics).  Returns (force, torque), each
    (n_bodies, 3), world."""
    f_m = particle_mass(params) * acc[:, rs.slots].T
    r = feat[PX:PZ + 1, rs.slots].T - bodies.x[rs.body]
    both = segment_reduce_sum(
        torch.cat([f_m, torch.linalg.cross(r, f_m, dim=-1)], dim=1),
        rs.offsets)
    return both[:, :3], both[:, 3:]


def make_crm_fsi_advance_persistent(
        model: Model, params, crm: CRMParams, grid: GridSpec,
        n_substeps: int, wheel_bodies,
        mbs_settings: SolverSettings = SolverSettings(solver="direct"),
        f_ext_fn=None, pencil_capacity: int = 32, pencil_Bxy: int = 4,
        rebuild_outer: int = 5, interpret: bool = False,
        layout: str = "auto", dv_mode: str = "fresh", dual_CA=None,
        clip_z: float = None, whole_outer: bool = False, *, device):
    """Vehicle-on-CRM advance with the terrain kept binned:
    ``advance(state, n_outer) → (state, overflow)`` on ``device``.

    Every ``rebuild_outer`` outer steps (and for the remainder
    ``n_outer % rebuild_outer``) the wheels' markers are moved to their
    bodies, the terrain is binned once with the aux rows of
    :func:`bce_extras` (body index + 1 and local offset) through the same
    sort, and each outer step then updates the wheels' markers in the
    sorted planes (:func:`update_bce_planes`), runs the substeps, reduces
    the reaction on the planes (:func:`body_forces_planes`) and steps the
    multibody system (an :class:`MBSStep`); the terrain is unbinned at the
    chunk's end.  Cell assignments go stale by the markers' motion between
    rebuilds; keep ``rebuild_outer · n_substeps · dt · v_max`` well under
    the cell.

    ``dv_mode``: "fresh" runs one extra forces-only M sweep at the
    post-substep state for the reaction (as the per-outer driver does);
    "last" reuses the last substep's M acceleration (one substep staler,
    one sweep fewer).  ``whole_outer``: one ``crm_outer`` launch an outer
    step for all its substeps, with the last M sweep's acceleration (so
    "last", as in the JAX package, which switches to it); its
    neighbour-list overflow joins the returned overflow.

    ``pencil_capacity`` is the cells' capacity.  ``layout``,
    ``pencil_Bxy``, ``interpret``, ``dual_CA`` and ``clip_z`` choose the
    JAX engines' TPU layouts (pencil, flat or two-tier flat lanes, lane
    blocking, interpret mode, the tier split, a row trim) and have no
    counterpart here: the markers are sorted by cell into one structure of
    arrays and a GPU thread takes one marker, so empty or split regions
    cost nothing to lay out.  ``clip_z`` drops from the JAX binning only
    the wheel-rim markers above any granular marker's support; those get
    zero acceleration either way, so keeping them changes no result."""
    if dv_mode not in ("fresh", "last"):
        raise ValueError(f"unknown dv_mode {dv_mode!r}")
    if rebuild_outer < 1:
        raise ValueError("rebuild_outer must be at least 1")
    eng = make_crm_engine(params, crm, grid, pencil_capacity, device=device)
    wheel_list = sorted({int(w) for w in
                         np.asarray(wheel_bodies).reshape(-1)})
    is_wheel = torch.zeros(model.n_bodies, dtype=torch.bool, device=device)
    is_wheel[wheel_list] = True
    h_outer = params.dt * n_substeps
    mbs_step = MBSStep(model, h_outer, mbs_settings)

    def substeps(feat, cells, lists):
        if whole_outer:
            return eng["outer"](feat, cells, n_substeps)
        for _ in range(n_substeps - (dv_mode == "last")):
            feat = eng["substep"](feat, cells, lists=lists)
        if dv_mode == "last":
            feat, acc = eng["substep_acc"](feat, cells, lists=lists)
        else:
            acc = eng["forces"](feat, cells)
        return feat, acc, None

    def run_chunk(bodies, terrain, t, chunk_len, n_rigid, lists):
        pos, vel = bce.update_rigid_markers(
            terrain.pos, terrain.vel, terrain.kind, terrain.body_id,
            terrain.bce_local, bodies.x, bodies.q, bodies.v, bodies.w)
        terrain = terrain.replace(pos=pos, vel=vel)
        feat, order, cells, ovf, aux = eng["bin"](terrain,
                                                  bce_extras(terrain))
        rs = rigid_slots(aux, is_wheel, n_rigid)
        for _ in range(chunk_len):
            update_bce_planes(feat, rs, bodies)
            feat, acc, list_ovf = substeps(feat, cells, lists)
            if list_ovf is not None:
                ovf = torch.maximum(ovf, list_ovf)
            f_b, tau_b = body_forces_planes(params, feat, acc, rs, bodies)
            f_tot, tau_tot = _drive_loads(f_ext_fn, t, bodies, f_b,
                                          Q.qrotate_inv(bodies.q, tau_b))
            bodies = mbs_step(bodies, t, f_tot, tau_tot)
            t = t + h_outer
        return bodies, cells_to_crm_state(feat, order, terrain), t, ovf

    def advance(state: CRMFSIState, n_outer: int):
        state = _to(state, device)
        bodies, terrain, t = state.bodies, state.terrain, state.time
        ovf = torch.zeros((), dtype=torch.int32, device=device)
        # the wheels' markers: one count a call (a host read)
        b = torch.clamp(terrain.body_id, min=0).long()
        n_rigid = int(((terrain.kind == RIGID_BCE) & is_wheel[b]).sum())
        lists = NeighbourList.empty(terrain.n, device)
        n_chunks, rem = divmod(n_outer, rebuild_outer)
        for length in [rebuild_outer] * n_chunks + ([rem] if rem else []):
            bodies, terrain, t, ov = run_chunk(bodies, terrain, t, length,
                                               n_rigid, lists)
            ovf = torch.maximum(ovf, ov)
        return CRMFSIState(bodies=bodies, terrain=terrain, time=t), ovf

    return advance
