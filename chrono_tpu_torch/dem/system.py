"""The granular DEM system on the neighbour list: state, stepping and the
user-facing wrapper.

Counterpart of ``chrono_tpu/dem/system.py`` (``DEMState``,
``make_dem_state``, ``rebuild_neighbors``, ``dem_substep``,
``make_advance_fn``, ``DEMSystem``): one cycle is a neighbour-list rebuild
(``dem.neighbors``, the friction and rolling histories carried across by
``migrate_history``) and ``rebuild_every`` substeps of the list-based force
passes of ``dem.forces`` and one of four integrators.  The JAX package
scans the cycles inside one compiled program; here the rebuild runs
eagerly on the device and a cycle's substeps are a :class:`SubstepBlock`
(on the card one CUDA graph, captured once and replayed), and nothing
reads the host inside a call of ``advance``.

``DEMSystem`` holds its parameters as the JAX class does, rounded to the
state's dtype (float32 by default): the step size it suggests, the cycle
count of ``advance`` and the accumulated ``time`` follow from the same
rounded values.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import numpy as np
import torch

from chrono_tpu_torch.collision.cell_list import GridSpec, cell_occupancy_max
from chrono_tpu_torch.dem.bc import (
    DEMBoundaries, PlaneBCs, box_boundaries, n_walls,
)
from chrono_tpu_torch.dem.forces import particle_forces, wall_forces
from chrono_tpu_torch.dem.neighbors import (
    NeighborList, build_neighbor_list, migrate_history,
)
from chrono_tpu_torch.dem.params import (
    DEMMaterial, DEMParams, suggest_step_size,
)
from chrono_tpu_torch.utils.device import resolve_device
from chrono_tpu_torch.utils.graph import capture
from chrono_tpu_torch.utils.tree import tensor_dataclass

@tensor_dataclass
class DEMState:
    """The whole dynamic state, friction and rolling histories included (a
    checkpoint by itself)."""

    pos: torch.Tensor           # (N, 3)
    vel: torch.Tensor           # (N, 3)
    omega: torch.Tensor         # (N, 3) world frame
    nbr: NeighborList
    tan_disp: torch.Tensor      # (N, K, 3) pair friction history
    bc_tan_disp: torch.Tensor   # (N, B, 3) wall friction history
    time: torch.Tensor          # ()
    acc_old: Optional[torch.Tensor] = None      # (N, 3) Chung only
    alpha_old: Optional[torch.Tensor] = None
    roll_disp: Optional[torch.Tensor] = None    # (N, K, 3) elastic–plastic
    bc_roll_disp: Optional[torch.Tensor] = None  # (N, B, 3)

    @property
    def n(self) -> int:
        return self.pos.shape[0]

    def to(self, device) -> "DEMState":
        return _state_of([None if t is None else t.to(device)
                          for t in _state_leaves(self)])

    def clone(self) -> "DEMState":
        return _state_of([None if t is None else t.clone()
                          for t in _state_leaves(self)])


def _state_leaves(state: DEMState) -> list:
    """The state's tensors in field order (None where a field is unset)."""
    return [state.pos, state.vel, state.omega, state.nbr.idx,
            state.nbr.valid, state.nbr.overflow, state.tan_disp,
            state.bc_tan_disp, state.time, state.acc_old, state.alpha_old,
            state.roll_disp, state.bc_roll_disp]


def _state_of(leaves) -> DEMState:
    (pos, vel, omega, idx, valid, overflow, tan_disp, bc_tan_disp, time,
     acc_old, alpha_old, roll_disp, bc_roll_disp) = leaves
    return DEMState(pos=pos, vel=vel, omega=omega,
                    nbr=NeighborList(idx=idx, valid=valid,
                                     overflow=overflow),
                    tan_disp=tan_disp, bc_tan_disp=bc_tan_disp, time=time,
                    acc_old=acc_old, alpha_old=alpha_old,
                    roll_disp=roll_disp, bc_roll_disp=bc_roll_disp)


def make_dem_state(params: DEMParams, bcs: DEMBoundaries, pos, vel=None,
                   omega=None, dtype=torch.float32, *,
                   device=None) -> DEMState:
    """A state at rest (unless ``vel``/``omega`` are given) with an empty
    list and zero histories, on ``device`` (the card unless told
    otherwise); Chung's previous accelerations start at zero."""
    device = resolve_device(device, "make_dem_state")

    def arr(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    pos = arr(pos)
    n, k, nb = pos.shape[0], params.max_neighbors, n_walls(bcs)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    chung = params.integrator == "chung"
    ep = params.rolling_mode == "elastic_plastic"
    return DEMState(
        pos=pos, vel=zeros(n, 3) if vel is None else arr(vel),
        omega=zeros(n, 3) if omega is None else arr(omega),
        nbr=NeighborList.empty(n, k, device),
        tan_disp=zeros(n, k, 3), bc_tan_disp=zeros(n, nb, 3),
        time=zeros(),
        acc_old=zeros(n, 3) if chung else None,
        alpha_old=zeros(n, 3) if chung else None,
        roll_disp=zeros(n, k, 3) if ep else None,
        bc_roll_disp=zeros(n, nb, 3) if ep else None)


def rebuild_neighbors(params: DEMParams, grid: GridSpec,
                      state: DEMState) -> DEMState:
    """The list rebuilt at 2r(1 + skin), the pair friction history (and
    the rolling displacement) carried to the new slots of each pair."""
    cutoff = 2.0 * params.radius * (1.0 + params.skin)
    nbr = build_neighbor_list(grid, state.pos, cutoff, params.max_per_cell,
                              params.max_neighbors)
    changes = dict(nbr=nbr,
                   tan_disp=migrate_history(state.nbr, state.tan_disp, nbr))
    if state.roll_disp is not None:
        changes["roll_disp"] = migrate_history(state.nbr, state.roll_disp,
                                               nbr)
    return state.replace(**changes)


@functools.lru_cache(maxsize=16)
def _gravity(gravity: tuple, dtype, device) -> torch.Tensor:
    """The (3,) gravity tensor, made once per device (a copy from the host
    in every substep would wait for the device)."""
    return torch.tensor(gravity, dtype=dtype, device=device)


def dem_substep(params: DEMParams, bcs: DEMBoundaries, state: DEMState,
                return_reactions: bool = False):
    """One force and integration step on the state's neighbour list.

    With ``return_reactions=True`` returns ``(state, (bc_force,
    bc_torque0))``: the per-wall reaction force and torque about the
    origin, which moving-obstacle couplings feed back to the multibody
    system."""
    ep = params.rolling_mode == "elastic_plastic"
    pp = particle_forces(params, state.pos, state.vel, state.omega,
                         state.nbr.idx, state.nbr.valid, state.tan_disp,
                         state.roll_disp if ep else None)
    f_pp, tau_pp, xi_pp = pp[:3]
    xi_roll = pp[3] if ep else None
    w = wall_forces(params, bcs, state.pos, state.vel, state.omega,
                    state.bc_tan_disp, state.bc_roll_disp if ep else None)
    f_w, tau_w, xi_w, react = w[:4]
    # without walls (or without a wall rolling state) the wall pass keeps
    # no rolling displacement: the state's stays as it is
    xi_w_roll = w[4] if len(w) == 5 else state.bc_roll_disp

    g = _gravity(tuple(params.gravity), state.pos.dtype, state.pos.device)
    acc = (f_pp + f_w) * (1.0 / params.mass) + g
    alpha = (tau_pp + tau_w) * (1.0 / params.inertia)
    h = params.dt
    if params.integrator == "forward_euler":
        pos = state.pos + h * state.vel
        vel = state.vel + h * acc
        omega = state.omega + h * alpha
    elif params.integrator == "centered_difference":
        # kick, then drift with the new velocity
        vel = state.vel + h * acc
        omega = state.omega + h * alpha
        pos = state.pos + h * vel
    elif params.integrator == "extended_taylor":
        # second-order Taylor position, Euler velocity
        pos = state.pos + h * state.vel + 0.5 * h * h * acc
        vel = state.vel + h * acc
        omega = state.omega + h * alpha
    elif params.integrator == "chung":
        # Chung–Lee two-step scheme: v += h(3/2 a − 1/2 a_old),
        # x += h v_old + h²(28/27 a + (1/2 − 28/27) a_old)
        beta = 28.0 / 27.0
        vel = state.vel + h * (1.5 * acc + -0.5 * state.acc_old)
        omega = state.omega + h * (1.5 * alpha + -0.5 * state.alpha_old)
        pos = state.pos + h * state.vel + h * h * (
            beta * acc + (0.5 - beta) * state.acc_old)
    else:
        raise ValueError(f"unknown integrator {params.integrator!r}")

    new = state.replace(pos=pos, vel=vel, omega=omega, tan_disp=xi_pp,
                        bc_tan_disp=xi_w, time=state.time + h)
    if params.integrator == "chung":
        new = new.replace(acc_old=acc, alpha_old=alpha)
    if ep:
        new = new.replace(roll_disp=xi_roll, bc_roll_disp=xi_w_roll)
    return (new, react) if return_reactions else new


def _wall_leaves(bcs: DEMBoundaries) -> list:
    return [getattr(getattr(bcs, k), f.name) for k in bcs.kinds()
            for f in dataclasses.fields(getattr(bcs, k))]


def _walls_of(bcs: DEMBoundaries, leaves) -> DEMBoundaries:
    it = iter(leaves)
    return dataclasses.replace(bcs, **{
        k: dataclasses.replace(getattr(bcs, k), **{
            f.name: next(it) for f in dataclasses.fields(getattr(bcs, k))})
        for k in bcs.kinds()})


class SubstepBlock:
    """``block(state, bcs) → (state, (react_f, react_tau))``: ``n``
    substeps of :func:`dem_substep` on the state's neighbour list, with
    the per-wall reactions summed over them.

    On the CPU the substeps run eagerly.  On the card the first call (and
    any call whose shapes differ from the last capture's) captures the n
    substeps in one ``torch.cuda.CUDAGraph`` on static buffers; every call
    copies the state's and the walls' tensors in (so walls moved between
    calls, such as wheels, are seen) and replays the graph: the eager
    loop's kernels in the same order.  The state returned on the card
    holds the graph's buffers until the next call: ``clone`` it to keep
    it."""

    def __init__(self, params: DEMParams, n: int):
        self.params, self.n = params, n
        self.graph, self.key = None, None

    def eager(self, state: DEMState, bcs: DEMBoundaries):
        sum_f = sum_t = None
        for _ in range(self.n):
            state, (rf, rt) = dem_substep(self.params, bcs, state,
                                          return_reactions=True)
            sum_f = rf if sum_f is None else sum_f + rf
            sum_t = rt if sum_t is None else sum_t + rt
        return state, (sum_f, sum_t)

    def __call__(self, state: DEMState, bcs: DEMBoundaries):
        if not state.pos.is_cuda:
            return self.eager(state, bcs)
        state_leaves = _state_leaves(state)
        leaves = state_leaves + _wall_leaves(bcs)
        key = tuple(None if t is None else (tuple(t.shape), t.dtype)
                    for t in leaves)
        if key != self.key:
            self.graph = None
            self.inputs = [None if t is None else t.clone() for t in leaves]
            n = len(state_leaves)
            static = _state_of(self.inputs[:n])
            walls = _walls_of(bcs, self.inputs[n:])
            box = {}

            def run():
                box["out"] = self.eager(static, walls)

            self.graph = capture(run, run, state.pos.device)
            self.out, self.key = box["out"], key
        for dst, src in zip(self.inputs, leaves):
            if dst is not None:
                dst.copy_(src)
        self.graph.replay()
        return self.out


def make_advance_fn(params: DEMParams, bcs: DEMBoundaries, grid: GridSpec,
                    *, device=None):
    """``advance(state, n_cycles) → (state, overflow)`` on ``device`` (the
    card unless told otherwise).  One cycle is a neighbour rebuild and
    ``params.rebuild_every`` substeps (a :class:`SubstepBlock`: one graph
    replay on the card); ``overflow`` () int32 is the largest list
    overflow of the call (neighbours dropped, or a cell over
    ``max_per_cell``), read without a host sync."""
    device = resolve_device(device, "make_advance_fn")
    bcs = bcs.to(device)
    block = SubstepBlock(params, params.rebuild_every)

    def advance(state: DEMState, n_cycles: int):
        state = state.to(device)
        ovf = torch.zeros((), dtype=torch.int32, device=device)
        for _ in range(n_cycles):
            state = rebuild_neighbors(params, grid, state)
            state, _ = block(state, bcs)
            ovf = torch.maximum(ovf, state.nbr.overflow)
        return state.clone(), ovf

    return advance


def _cat_planes(a: PlaneBCs, b: PlaneBCs) -> PlaneBCs:
    return PlaneBCs(**{f.name: torch.cat([getattr(a, f.name),
                                          getattr(b, f.name).to(
                                              getattr(a, f.name))])
                       for f in dataclasses.fields(PlaneBCs)})


class DEMSystem:
    """Host-side wrapper, the JAX ``DEMSystem``::

        sys = DEMSystem(radius=0.01, density=2500, box=((0,0,0),(1,1,1)))
        sys.set_material(youngs=5e7, restitution=0.5, mu_s=0.5)
        sys.create_particles(points)           # (N, 3) array
        sys.advance(0.5)                       # simulate 0.5 s
        pos = sys.positions

    The box's six walls are always there; ``set_boundaries`` adds more.
    Builds on ``device`` (the card unless told otherwise)."""

    def __init__(self, radius, density=2500.0, box=((0, 0, 0), (1, 1, 1)),
                 dt=None, max_neighbors=16, max_per_cell=8, rebuild_every=8,
                 skin=0.2, integrator="centered_difference",
                 friction_mode="multi_step", rolling_mode="none",
                 force_model="mat_based", gravity=(0, 0, -9.81),
                 dtype=torch.float32, *, device=None):
        self.device = resolve_device(device, "DEMSystem")
        self.dtype = dtype
        mass = density * 4.0 / 3.0 * math.pi * radius ** 3
        self._mat = dict(youngs=1e7, poisson=0.3, restitution=0.5,
                         mu_s=0.5, mu_r=0.0, mu_sp=0.0, adhesion=0.0)
        self._wall_mat = dict(self._mat)
        self._radius = float(radius)
        self._mass = float(mass)
        self._gravity = gravity
        self._box = (np.asarray(box[0], float), np.asarray(box[1], float))
        self._static = dict(max_neighbors=max_neighbors,
                            max_per_cell=max_per_cell,
                            rebuild_every=rebuild_every, skin=skin,
                            integrator=integrator,
                            friction_mode=friction_mode,
                            rolling_mode=rolling_mode,
                            force_model=force_model)
        self._dt = dt
        self._extra_bcs = dict(planes=None, cylinders=None, spheres=None,
                               cones=None)
        self.state: Optional[DEMState] = None
        self._advance = None

    def _held(self, x) -> float:
        """``x`` as the state's dtype holds it."""
        return torch.tensor(float(x), dtype=self.dtype).item()

    def set_material(self, **kw):
        self._mat.update(kw)

    def set_wall_material(self, **kw):
        self._wall_mat.update(kw)

    def retune(self, material=None, wall_material=None, **static_kw):
        """Re-derive the parameters (and the advance) without discarding
        the particles.  The wall histories are resized to zeros when the
        wall count changed; switching to elastic–plastic rolling adds
        zero rolling displacements, and leaving it drops a wall rolling
        displacement of the wrong width."""
        if material:
            self._mat.update(material)
        if wall_material:
            self._wall_mat.update(wall_material)
        self._static.update(static_kw)
        state = self.state
        self._build()
        if state is None:
            return
        n, nw = state.n, n_walls(self.bcs)

        def zeros():
            return torch.zeros((n, nw, 3), dtype=self.dtype,
                               device=self.device)

        if state.bc_tan_disp.shape[1] != nw:
            state = state.replace(bc_tan_disp=zeros())
            if state.bc_roll_disp is not None:
                state = state.replace(bc_roll_disp=zeros())
        ep = self._static.get("rolling_mode") == "elastic_plastic"
        if ep and state.roll_disp is None:
            state = state.replace(roll_disp=torch.zeros_like(state.tan_disp),
                                  bc_roll_disp=zeros())
        if (not ep and state.bc_roll_disp is not None
                and state.bc_roll_disp.shape[1] != nw):
            state = state.replace(bc_roll_disp=None)
        self.state = state

    def set_boundaries(self, planes=None, cylinders=None, spheres=None,
                       cones=None):
        self._extra_bcs = dict(planes=planes, cylinders=cylinders,
                               spheres=spheres, cones=cones)

    def _build(self):
        def material(m):
            return DEMMaterial(**{k: self._held(v) for k, v in m.items()})

        params = DEMParams(
            radius=self._held(self._radius), mass=self._held(self._mass),
            material=material(self._mat),
            wall_material=material(self._wall_mat),
            gravity=tuple(self._held(g) for g in self._gravity),
            dt=self._held(1e-5 if self._dt is None else self._dt),
            **self._static)
        if self._dt is None:
            params = dataclasses.replace(
                params, dt=self._held(suggest_step_size(params)))
        lo, hi = self._box
        cell = 2.0 * self._radius * (1.0 + self._static["skin"])
        # one guard layer on each side
        dims = tuple(int(np.ceil((hi[i] - lo[i]) / cell)) + 2
                     for i in range(3))
        grid = GridSpec(origin=tuple(float(o) for o in lo - cell),
                        cell_size=cell, dims=dims)
        planes = box_boundaries(lo, hi, self.dtype)
        extra = self._extra_bcs
        if extra["planes"] is not None:
            planes = _cat_planes(planes, extra["planes"])
        bcs = DEMBoundaries(planes=planes, cylinders=extra["cylinders"],
                            spheres=extra["spheres"],
                            cones=extra["cones"]).to(self.device)
        self.params, self.bcs, self.grid = params, bcs, grid
        self._advance = make_advance_fn(params, bcs, grid,
                                        device=self.device)

    def create_particles(self, points, vel=None):
        self._build()
        self.state = make_dem_state(self.params, self.bcs, points, vel,
                                    dtype=self.dtype, device=self.device)

    @property
    def dt(self) -> float:
        return float(self.params.dt)

    @property
    def positions(self) -> np.ndarray:
        return self.state.pos.cpu().numpy()

    @property
    def velocities(self) -> np.ndarray:
        return self.state.vel.cpu().numpy()

    def advance(self, duration: float) -> DEMState:
        """Simulate ``duration`` seconds (rounded to whole rebuild
        cycles); raises on a list overflow."""
        cycle_dt = float(self.params.dt) * self._static["rebuild_every"]
        n_cycles = max(1, int(round(duration / cycle_dt)))
        self.state, overflow = self._advance(self.state, n_cycles)
        if int(overflow) > 0:
            occupancy = int(cell_occupancy_max(self.grid, self.state.pos))
            raise RuntimeError(
                f"neighbor-list overflow: {int(overflow)} neighbors "
                f"dropped; increase max_neighbors (occupancy check: "
                f"{occupancy}/cell)")
        return self.state

    def kinetic_energy(self) -> float:
        v2 = float(torch.sum(self.state.vel ** 2))
        w2 = float(torch.sum(self.state.omega ** 2))
        return 0.5 * self._mass * v2 + 0.5 * float(self.params.inertia) * w2
