"""The multibody system model and its time stepper.

Counterpart of ``chrono_tpu/physics/system.py``: the scene is a ``Model`` of
batched tensors, and one step is force accumulation, constraint lowering
(autodiff), the constraint solve (the dense direct Schur solve, or a VI or
Krylov solver over the bilateral and contact rows) and state integration.
The JAX package compiles ``simulate``'s whole ``lax.scan`` into one
program.  This port, on a CUDA device with the ``"direct"`` solver, captures
one step (no host sync, no branch on data) into a ``torch.cuda.CUDAGraph``
and replays it; the VI and Krylov solvers read their loop tests on the
host, so their steps run eagerly, and so does every step on the CPU.
Shafts (``physics.shafts``) are bodies with one live spin; their couplings
are rows of the same solve and their elements torques of the same
accumulation.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import Tensor

from chrono_tpu_torch.core import quaternion as Q
from chrono_tpu_torch.physics import force_elements as fe
from chrono_tpu_torch.physics.body import (
    BodyProps, BodyState, gyroscopic_torque, integrate_positions,
    integrate_positions_compensated,
)
from chrono_tpu_torch.physics.constraints import ConstraintRows, concat_rows
from chrono_tpu_torch.physics.joints import coupler_rows, joint_rows
from chrono_tpu_torch.physics.motors import motor_loads, motor_rows
from chrono_tpu_torch.physics.shafts import (
    SHAFT_ROW_GENERATORS, shaft_torques,
)
from chrono_tpu_torch.solver import descriptor as desc
from chrono_tpu_torch.solver import krylov
from chrono_tpu_torch.solver import vi as vi_solvers
from chrono_tpu_torch.solver.direct import solve_dense_schur
from chrono_tpu_torch.solver.projection import make_projector
from chrono_tpu_torch.utils.graph import capture
from chrono_tpu_torch.utils.segment import scatter_add
from chrono_tpu_torch.utils.tree import tensor_dataclass


@tensor_dataclass
class SolverSettings:
    """Solver configuration (the JAX package's fields and defaults)."""

    # apgd | bb | admm | pjacobi | cg | minres | gmres | direct
    solver: str = "apgd"
    max_iter: int = 100
    tol: float = 1e-6
    stab_factor: float = 1.0       # Baumgarte C/h scaling
    # soft-threshold on joint violations before stabilisation: set to the
    # fp32 position-roundoff floor (~1e-6 · pose scale) for long fp32 runs
    stab_deadband: float = 0.0
    # "baumgarte": rhs += -stab·C/h (velocity-level, the reference default).
    # "project": rhs stab term dropped; positions projected back onto the
    # constraint manifold AFTER each step (M⁻¹-weighted least squares).
    # "filtered": Baumgarte on a bias-corrected EMA of C carried across
    # steps in ``stab_state``: the smooth violation passes, the eps32·|x|
    # evaluation noise is averaged out; corrections stay velocity-level.
    stab_mode: str = "baumgarte"
    # "filtered" steady-state EMA gain (reached once 1/k < alpha_min)
    stab_alpha_min: float = 1.0 / 2048.0
    # contact −C/h clamp — the reference's default Qc_clamping
    # (max_penetration_recovery_speed = 0.6)
    max_recovery_speed: float = 0.6
    # per-movable-body row bound of the JAX package's Dᵀγ gather plan (past
    # it that package's solve falls back to its scatter form).  The port's
    # solve sums each body's rows through a side plan with no cap and does
    # not read it; descriptor.build_gather_plan takes it to report what the
    # capped plan would have done.
    valence_bound: int = 96


@tensor_dataclass
class Model:
    """Immutable scene description: bodies + joints + motors + force
    elements."""

    props: BodyProps
    gravity: Tensor                     # (3,)
    joints: dict                        # {kind: JointData}
    motors: dict                        # {kind: MotorData} constraint motors
    load_motors: dict                   # {kind: MotorData} torque/force motors
    tsda: Optional[fe.TSDAData]
    rsda: Optional[fe.RSDAData]
    shaft_constraints: dict = None      # {kind: Shaft*Data} (physics.shafts)
    shaft_elements: object = None       # ShaftTorqueElements
    couplers: dict = None               # {kind: JointData} velocity-level rows
    bushings: object = None             # fe.BushingData compliant mounts

    @property
    def n_bodies(self) -> int:
        return self.props.inv_mass.shape[0]


class StepInfo(NamedTuple):
    """Per-step diagnostics."""

    iterations: Tensor
    residual: Tensor
    joint_reactions: Tensor   # (M,) constraint impulses / h = forces
    n_rows: int


def applied_forces(model: Model, state: BodyState, t, f_ext=None,
                   tau_ext=None):
    """Accumulate all smooth forces → (f_world (N,3), tau_local (N,3)):
    gravity, gyroscopic torque, spring-dampers, bushings, motor loads,
    shaft elements and optional user external loads."""
    inv_m = model.props.inv_mass
    mass = torch.where(inv_m > 0, 1.0 / torch.clamp_min(inv_m, 1e-30),
                       torch.zeros_like(inv_m))
    f = mass[:, None] * model.gravity[None, :]
    tau = gyroscopic_torque(model.props, state)
    if f_ext is not None:
        f = f + f_ext
    if tau_ext is not None:
        tau = tau + tau_ext
    if model.tsda is not None:
        f, tau = fe.accumulate_tsda(model.tsda, state, f, tau)
    if model.rsda is not None:
        f, tau = fe.accumulate_rsda(model.rsda, state, f, tau)
    if model.bushings is not None:
        f, tau = fe.accumulate_bushing(model.bushings, state, f, tau)
    for kind, data in model.load_motors.items():
        fa, ta, fb, tb = motor_loads(kind, data, state.x, state.q, t)
        f = scatter_add(scatter_add(f, data.body_a, fa), data.body_b, fb)
        tau = scatter_add(
            scatter_add(tau, data.body_a,
                        Q.qrotate_inv(state.q[data.body_a], ta)),
            data.body_b, Q.qrotate_inv(state.q[data.body_b], tb))
    if model.shaft_elements is not None:
        tau = tau + shaft_torques(model.shaft_elements, state.q, state.w,
                                  model.n_bodies)
    return f, tau


def _concat(parts, state: BodyState) -> ConstraintRows:
    return concat_rows(parts, dtype=state.x.dtype, device=state.x.device)


def bilateral_rows(model: Model, state: BodyState, t, h,
                   settings: SolverSettings) -> ConstraintRows:
    """Lower all joints, constraint motors, shaft couplings and couplers to
    stabilised rows."""
    stab = (0.0 if settings.stab_mode in ("project", "filtered")
            else settings.stab_factor)
    parts = [
        joint_rows(kind, data, state.x, state.q, h, stab,
                   settings.stab_deadband)
        for kind, data in model.joints.items()
    ]
    parts += [
        motor_rows(kind, data, state.x, state.q, t, h, stab)
        for kind, data in model.motors.items()
    ]
    if model.shaft_constraints:
        parts += [SHAFT_ROW_GENERATORS[kind](data, state.x.dtype)
                  for kind, data in model.shaft_constraints.items()]
    if model.couplers:
        parts += [coupler_rows(kind, data, state.x, state.q)
                  for kind, data in model.couplers.items()]
    return _concat(parts, state)


def _position_rows(model: Model, state: BodyState, t) -> ConstraintRows:
    """Joints then ALL motors as pure position-error rows (rhs = −C)."""
    parts = [joint_rows(kind, data, state.x, state.q, 1.0, 1.0)
             for kind, data in model.joints.items()]
    parts += [
        motor_rows(kind, data, state.x, state.q, t, 1.0, 1.0, vel_scale=0.0)
        for kind, data in model.motors.items()
    ]
    return _concat(parts, state)


def bilateral_C(model: Model, state: BodyState, t, m_total: int) -> Tensor:
    """Position-level violation vector aligned with ``bilateral_rows`` order.

    joints → C; angle/pos motors → tracking error; speed motors, shafts and
    couplers (velocity-level rows, no position gap) → 0, padded at the tail
    to ``m_total``.
    """
    C = -_position_rows(model, state, t).rhs
    return torch.cat([C, C.new_zeros(m_total - C.shape[0])])


def init_stab_state(model: Model, state: BodyState, t, h,
                    settings: SolverSettings):
    """Zero-initialised carry for ``stab_mode='filtered'``: (C_ema, k)."""
    m = bilateral_rows(model, state, t, h, settings).m
    return (state.x.new_zeros((m,)),
            torch.zeros((), dtype=torch.int32, device=state.x.device))


def _direct(settings: SolverSettings, n_contacts: int) -> bool:
    """The dense direct solve: ``"direct"`` with bilateral rows only (with
    contact rows the JAX package falls back to APGD, and so does this
    port)."""
    return settings.solver == "direct" and n_contacts == 0


def _solve(rows: ConstraintRows, model: Model, v_free, w_free,
           settings: SolverSettings, n_contacts=0, mu=None, gamma0=None,
           n_rolling=0, mu_roll=0.0, mu_spin=0.0, D=None, plan=None):
    """Dispatch to the configured constraint solver → (γ, iterations,
    residual), every solver and branch of the JAX package's ``_solve``:

    - ``"direct"`` with no contact rows: the dense Schur solve (``D``, the
      dense Jacobian, may be given);
    - ``"apgd"``, ``"bb"``, ``"admm"``, ``"pjacobi"``, and ``"direct"``
      with contact rows (the APGD fallback): the VI solvers, with the cone
      projector of ``n_contacts`` contact triples after the bilateral rows
      and ``n_rolling`` rolling triples after them;
    - ``"cg"``, ``"minres"``, ``"gmres"``: the Krylov solvers on ``N γ =
      −r`` (bilateral systems: no cone projection).

    The VI and Krylov solvers read their loop tests on the host (see
    ``solver/vi.py``).  Their ``N γ`` sums ``Dᵀγ`` at contact scale with no
    atomics and in a fixed order: through the side plan of
    ``descriptor.build_side_plan`` (``plan``, built here when not given),
    the rows' sides sorted by body once a solve, each body's run summed in
    row order with no cap.  The JAX package sums through a gather plan
    capped at ``settings.valence_bound`` rows a body and falls back to its
    scatter form past the cap; both give the same sums, and this port does
    not cap.
    """
    m = rows.m
    if m == 0:
        return (v_free.new_zeros((0,)),
                torch.zeros((), dtype=torch.int32, device=v_free.device),
                v_free.new_zeros(()))
    if _direct(settings, n_contacts):
        gamma = solve_dense_schur(rows, model.props, v_free, w_free, D=D)
        return (gamma,
                torch.ones((), dtype=torch.int32, device=v_free.device),
                v_free.new_zeros(()))
    if settings.solver not in _ITERATIVE:
        raise ValueError(f"unknown solver {settings.solver!r}")

    packed, minv8 = _packed(rows, model)
    if plan is None:
        plan = desc.build_side_plan(packed, minv8)

    def Nop(g):
        return desc.schur_product_sorted(packed, minv8, plan, g)

    r = desc.schur_rhs_packed(packed, desc.pack_u(v_free, w_free))
    project = make_projector(m - 3 * n_contacts - 3 * n_rolling,
                             n_contacts, mu, n_rolling=n_rolling,
                             mu_roll=mu_roll, mu_spin=mu_spin)
    g0 = v_free.new_zeros((m,)) if gamma0 is None else gamma0
    if settings.solver in ("apgd", "direct"):
        sol = vi_solvers.solve_apgd(Nop, r, project, g0, settings.max_iter,
                                    settings.tol)
    elif settings.solver == "bb":
        sol = vi_solvers.solve_bb(Nop, r, project, g0, settings.max_iter,
                                  settings.tol)
    elif settings.solver == "admm":
        sol = vi_solvers.solve_admm(Nop, r, project, g0, settings.max_iter,
                                    settings.tol)
    elif settings.solver == "pjacobi":
        sol = vi_solvers.solve_pjacobi(
            Nop, r, project, g0, desc.diag_N_packed(packed, minv8),
            settings.max_iter, settings.tol)
    else:
        # the Krylov menu for BILATERAL-ONLY systems (the reference's
        # GMRES/MINRES engines); cone projection needs the VI solvers
        dinv = 1.0 / desc.diag_N_packed(packed, minv8)
        if settings.solver == "cg":
            ls = krylov.solve_cg(Nop, -r, Minv=lambda x: dinv * x,
                                 max_iter=settings.max_iter,
                                 tol=settings.tol)
        elif settings.solver == "minres":
            ls = krylov.solve_minres(Nop, -r, max_iter=settings.max_iter,
                                     tol=settings.tol)
        else:
            ls = krylov.solve_gmres(Nop, -r, tol=settings.tol)
        sol = vi_solvers.VISolution(gamma=ls.x, iterations=ls.iterations,
                                    residual=ls.residual)
    return sol.gamma, sol.iterations, sol.residual


_ITERATIVE = ("apgd", "bb", "admm", "pjacobi", "cg", "minres", "gmres",
              "direct")


def _packed(rows: ConstraintRows, model: Model):
    """Packed rows and the packed M⁻¹.  Only planetary shaft rows use the
    third-body slot, statically known from the model, so other scenes skip
    its gathers."""
    has_c = bool(model.shaft_constraints
                 and "planetary" in model.shaft_constraints)
    return desc.pack_rows(rows, has_c=has_c), desc.pack_minv(model.props)


def step_euler_implicit_linearized(
    model: Model,
    state: BodyState,
    t,
    h: float,
    settings: SolverSettings = SolverSettings(),
    f_ext=None,
    tau_ext=None,
    extra_rows: Optional[ConstraintRows] = None,
    n_contacts: int = 0,
    contact_mu: Optional[Tensor] = None,
    gamma_warm: Optional[Tensor] = None,
    position_comp=None,
    stab_state=None,
    n_rolling: int = 0,
    mu_roll: float = 0.0,
    mu_spin: float = 0.0,
):
    """One DVI step (Anitescu/Tasora one-Newton-iteration implicit Euler):
    forces at the step start, one solve for end-of-step velocities with
    stabilised constraints, then the symplectic position update.

    ``extra_rows`` appends rows after the bilateral ones (the contact
    pipeline's cone triples, then its rolling triples, LAST in the row
    order); ``n_contacts`` / ``contact_mu`` and ``n_rolling`` / ``mu_roll``
    / ``mu_spin`` configure the cone projector; ``gamma_warm`` warm-starts
    the VI solver.  With ``"direct"`` and no contact rows the step solves
    densely and updates the velocities from the dense D (no host sync: a
    CUDA graph can capture it); otherwise ``_solve``'s VI or Krylov solver
    reads its loop tests on the host and the velocities are updated
    through the same side plan as its ``N γ``.

    Returns ``(new_state, info)``, with ``(cx, cq)`` after the state when
    ``position_comp`` is given and ``stab_state`` before ``info`` when it is.
    """
    f, tau = applied_forces(model, state, t, f_ext, tau_ext)
    v_free = state.v + h * model.props.inv_mass[:, None] * f
    w_free = state.w + h * model.props.inv_inertia * tau

    rows = bilateral_rows(model, state, t, h, settings)
    if settings.stab_mode == "filtered" and stab_state is not None:
        # bias-corrected EMA of the violation: running mean until 1/k hits
        # alpha_min, then exponential with that gain.  THIS step's rhs uses
        # the updated mean (step 1 ≡ plain Baumgarte).
        C_ema, k = stab_state
        k = k + 1
        alpha = torch.clamp_min(1.0 / k.to(C_ema.dtype),
                                settings.stab_alpha_min)
        C_now = bilateral_C(model, state, t, rows.m)
        C_ema = C_ema + alpha * (C_now - C_ema)
        stab_state = (C_ema, k)
        rows = rows.replace(
            rhs=rows.rhs - (settings.stab_factor / h) * C_ema)
    if extra_rows is not None:
        rows = _concat([rows, extra_rows], state)

    if rows.m == 0:
        gamma, iters, res = _solve(rows, model, v_free, w_free, settings)
        v_new, w_new = v_free, w_free
    elif _direct(settings, n_contacts):
        D = desc.dense_D(rows, model.n_bodies)
        gamma, iters, res = _solve(rows, model, v_free, w_free, settings,
                                   D=D)
        # Dᵀγ from the dense D the solve built: a fixed sum order, no
        # atomics (the JAX package scatters the packed rows)
        v_new, w_new = desc.velocity_update_dense(D, model.props, gamma,
                                                  v_free, w_free)
    else:
        packed, minv8 = _packed(rows, model)
        plan = desc.build_side_plan(packed, minv8)
        gamma, iters, res = _solve(
            rows, model, v_free, w_free, settings, n_contacts=n_contacts,
            mu=contact_mu, gamma0=gamma_warm, n_rolling=n_rolling,
            mu_roll=mu_roll, mu_spin=mu_spin, plan=plan)
        # Dᵀγ through the solve's side plan: no atomics, a fixed order (the
        # JAX package scatters the packed rows)
        v_new, w_new = desc.velocity_update_sorted(
            plan, minv8, gamma, desc.pack_u(v_free, w_free))

    info = StepInfo(iterations=iters, residual=res,
                    joint_reactions=gamma / h, n_rows=rows.m)
    if position_comp is not None:
        # Kahan-compensated long-fp32-run variant: carry = (cx, cq)
        cx, cq = position_comp
        new_state, cx, cq = integrate_positions_compensated(
            state.replace(v=v_new, w=w_new), h, cx, cq)
        if settings.stab_mode == "project":
            new_state, cx = project_positions(model, new_state, t + h,
                                              comp_x=cx)
        if stab_state is not None:
            return new_state, (cx, cq), stab_state, info
        return new_state, (cx, cq), info
    new_state = integrate_positions(state.replace(v=v_new, w=w_new), h)
    if settings.stab_mode == "project":
        new_state, _ = project_positions(model, new_state, t + h)
    if stab_state is not None:
        return new_state, stab_state, info
    return new_state, info


def project_positions(model: Model, state: BodyState, t, n_iter: int = 1,
                      comp_x=None, C_offset=None):
    """Project positions back onto the constraint manifold (M⁻¹-weighted).

    Solves ``(D M⁻¹ Dᵀ) λ = −(C − C_offset)`` on the position-level rows
    (joints + motor tracking errors) and applies ``Δx = M⁻¹ Dᵀ λ`` to poses.
    ``C_offset`` must align with the ``bilateral_C`` layout (joints then
    ALL motors).  ``comp_x``: Kahan carry for x.  Returns (state, comp_x).
    """
    if _position_rows(model, state, t).m == 0:
        return state, comp_x
    for _ in range(n_iter):
        rows = _position_rows(model, state, t)
        if C_offset is not None:
            # rhs = −C + C_ema = −(C − C_ema): project the residual only
            rows = rows.replace(rhs=rows.rhs + C_offset[:rows.m])
        zero_v = torch.zeros_like(state.v)
        zero_w = torch.zeros_like(state.w)
        D = desc.dense_D(rows, model.n_bodies)
        lam = solve_dense_schur(rows, model.props, zero_v, zero_w, D=D)
        dv, dw = desc.velocity_update_dense(D, model.props, lam, zero_v,
                                            zero_w)
        if comp_x is None:
            x_new = state.x + dv
        else:
            y = dv - comp_x
            x_new = state.x + y
            comp_x = (x_new - state.x) - y
        proj = integrate_positions(state.replace(x=x_new, v=zero_v, w=dw),
                                   1.0)
        state = state.replace(x=x_new, q=proj.q)
    return state, comp_x


def make_step_fn(model: Model, h: float,
                 settings: SolverSettings = SolverSettings()):
    """A ``(state, t) -> (state, info)`` step closure."""

    def step(state: BodyState, t):
        return step_euler_implicit_linearized(model, state, t, h, settings)

    return step


def simulate(model: Model, state: BodyState, h: float, n_steps: int,
             settings: SolverSettings = SolverSettings(), t0=0.0,
             save_every: int = 1):
    """Run ``n_steps``; returns the final state and the trajectory
    ``(xs, qs)`` of every ``save_every``-th step (the states after steps 1,
    1 + save_every, …), or ``(state, None)`` when ``save_every == 0``.

    ``t`` is a float32 device scalar advanced by ``h`` each step, as the JAX
    package's scan carries it.  With the ``"direct"`` solver on a CUDA
    device one step is warmed up, captured into a ``torch.cuda.CUDAGraph``
    and replayed ``n_steps`` times: the graph advances the state and ``t``
    in place and, when ``save_every > 0``, copies x and q into preallocated
    trajectory buffers.  Any other solver reads its loop tests on the host,
    which a graph cannot hold: its steps run as an eager loop on the card,
    chosen here by ``settings.solver`` before any capture.  On the CPU
    every step runs eagerly.
    """
    t = torch.full((), t0, dtype=state.x.dtype, device=state.x.device)
    # route by the solver before any capture: only the direct solve's step
    # is free of host reads
    if state.x.is_cuda and settings.solver == "direct":
        return _simulate_graph(model, state, h, n_steps, settings, t,
                               save_every)
    xs, qs = [], []
    for k in range(n_steps):
        state, _ = step_euler_implicit_linearized(model, state, t, h,
                                                  settings)
        t = t + h
        if save_every and k % save_every == 0:
            xs.append(state.x)
            qs.append(state.q)
    if not save_every:
        return state, None
    return state, (torch.stack(xs), torch.stack(qs))


_STATE_FIELDS = ("x", "q", "v", "w")


def _simulate_graph(model, state, h, n_steps, settings, t, save_every):
    cur = BodyState(**{f: getattr(state, f).clone() for f in _STATE_FIELDS})
    n_saved = len(range(0, n_steps, save_every)) if save_every else 0
    if save_every:
        # one spare slot takes the writes of the steps that are not saved
        xs = cur.x.new_empty((n_saved + 1,) + cur.x.shape)
        qs = cur.q.new_empty((n_saved + 1,) + cur.q.shape)
        k = torch.zeros((), dtype=torch.int64, device=cur.x.device)

    def one_step():
        new, _ = step_euler_implicit_linearized(model, cur, t, h, settings)
        if save_every:
            slot = torch.where(k % save_every == 0, k // save_every,
                               torch.full_like(k, n_saved)).reshape(1)
            xs.index_copy_(0, slot, new.x[None])
            qs.index_copy_(0, slot, new.q[None])
            k.add_(1)
        for f in _STATE_FIELDS:
            getattr(cur, f).copy_(getattr(new, f))
        t.add_(h)

    # the warm-up step's result is dropped
    graph = capture(
        one_step,
        lambda: step_euler_implicit_linearized(model, cur, t, h, settings),
        cur.x.device)
    for _ in range(n_steps):
        graph.replay()
    final = BodyState(**{f: getattr(cur, f).clone() for f in _STATE_FIELDS})
    if not save_every:
        return final, None
    return final, (xs[:n_saved].clone(), qs[:n_saved].clone())
