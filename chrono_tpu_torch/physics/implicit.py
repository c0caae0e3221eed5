"""MBS-level implicit integration: HHT-α with Newton and step rejection.

Counterpart of ``chrono_tpu/physics/implicit.py``: the index-3 HHT DAE over
bodies and bilateral joints.  The residual is a pure function of the
unknown ``u = [accelerations, multipliers]`` and the Newton matrix is its
exact derivative by autodiff (``torch.func.jacrev``; the JAX package uses
forward mode), the constraint reaction included through
``∂(λᵀ C(x(a)))/∂a = β h² Jᵀ λ`` (``torch.func.grad``): no hand-assembled
or finite-difference Jacobian.
The dense Newton solve is ``torch.linalg.solve``.

The Newton loop and the step-rejection loop end on data: they run as
Python loops whose tests are host reads, counted as ``solver.vi`` counts
its loops (``host_test``).  A step whose Newton fails to converge is
retried at h/2, up to ``max_halvings`` times; the step taken is returned.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor

from chrono_tpu_torch.core import quaternion as Q
from chrono_tpu_torch.physics.body import BodyState, integrate_positions
from chrono_tpu_torch.physics.constraints import concat_rows
from chrono_tpu_torch.physics.joints import JOINT_TYPES, _params, joint_rows
from chrono_tpu_torch.physics.system import (
    Model, SolverSettings, applied_forces, step_euler_implicit_linearized,
)
from chrono_tpu_torch.solver import descriptor as desc
from chrono_tpu_torch.solver.direct import solve_dense_schur
from chrono_tpu_torch.solver.vi import host_test


class HHTStepOut(NamedTuple):
    state: BodyState
    acc: Tensor          # (N, 6) end-of-step accelerations (warm start)
    h_used: Tensor       # () actual step after any halvings
    iterations: Tensor   # () int32 Newton iterations of the step taken
    residual: Tensor     # () residual norm of the step taken


def _constraint_C(model: Model, x, q):
    """Position-level violations of all joints, concatenated (M,)."""
    parts = []
    for kind, data in model.joints.items():
        gap_fn, _ = JOINT_TYPES[kind]
        a, b = data.body_a, data.body_b
        parts.append(gap_fn(x[a], q[a], x[b], q[b],
                            _params(data)).reshape(-1))
    if not parts:
        return x.new_zeros((0,))
    return torch.cat(parts)


def make_hht_mbs_step(model: Model, alpha: float = -0.2,
                      newton_iters: int = 12, tol: float = 1e-6,
                      max_halvings: int = 3, beta: float = None,
                      gamma: float = None):
    """Build ``step(state, acc_prev, t, h) -> HHTStepOut``.

    Bodies, all joint types, TSDA/RSDA/shaft force elements and gravity
    (constraint motors stay on the DVI path).  ``acc_prev`` is the (N, 6)
    acceleration warm start (zeros at t = 0, or the previous step's).
    With default ``beta`` / ``gamma`` this is HHT-α; explicit values (with
    ``alpha=0``) give the Newmark family.
    """
    if beta is None:
        beta = (1.0 - alpha) ** 2 / 4.0
    if gamma is None:
        gamma = 0.5 - alpha
    n = model.n_bodies
    inv_m = model.props.inv_mass
    mass = torch.where(inv_m > 0, 1.0 / torch.clamp_min(inv_m, 1e-30),
                       torch.zeros_like(inv_m))
    inertia = torch.where(model.props.inv_inertia > 0, model.props.inertia,
                          torch.zeros_like(model.props.inertia))
    # free DOFs: fixed bodies (and dead shaft axes) keep a = 0 identity
    # rows; body-major layout [lin(3), ang(3)], as u's reshape
    free = torch.cat([(inv_m > 0)[:, None].expand(n, 3),
                      model.props.inv_inertia > 0], dim=1).reshape(-1)
    m_rows = sum(JOINT_TYPES[k][1] * d.n for k, d in model.joints.items())
    n_dof = 6 * n

    def new_pose(state, acc, a_lin, a_ang, h):
        x_new = state.x + h * state.v + h * h * (
            (0.5 - beta) * acc[:, 0:3] + beta * a_lin)
        rotvec = h * state.w + h * h * ((0.5 - beta) * acc[:, 3:6]
                                        + beta * a_ang)
        q_new = Q.qmul(state.q, Q.qexp_half(rotvec))
        v_new = state.v + h * ((1.0 - gamma) * acc[:, 0:3] + gamma * a_lin)
        w_new = state.w + h * ((1.0 - gamma) * acc[:, 3:6] + gamma * a_ang)
        return x_new, q_new, v_new, w_new

    def residual(u, state, acc, f_old, tau_old, t, h):
        a = u[:n_dof].reshape(n, 6)
        lam = u[n_dof:]
        a_lin, a_ang = a[:, 0:3], a[:, 3:6]
        x_new, q_new, v_new, w_new = new_pose(state, acc, a_lin, a_ang, h)
        st_new = BodyState(x=x_new, q=q_new, v=v_new, w=w_new)
        f_new, tau_new = applied_forces(model, st_new, t + h)

        def lamC(a_flat):
            aa = a_flat.reshape(n, 6)
            x2, q2, _, _ = new_pose(state, acc, aa[:, 0:3], aa[:, 3:6], h)
            return torch.sum(lam * _constraint_C(model, x2, q2))

        # Jᵀλ in the (v, w_local) basis = (1/βh²) ∂(λᵀC)/∂a
        JTlam = torch.func.grad(lamC)(u[:n_dof]) / (beta * h * h)

        r_lin = (mass[:, None] * a_lin
                 - (1.0 + alpha) * f_new + alpha * f_old).reshape(-1)
        r_ang = (inertia * a_ang
                 - (1.0 + alpha) * tau_new + alpha * tau_old).reshape(-1)
        r_a = (torch.stack([r_lin.reshape(n, 3), r_ang.reshape(n, 3)],
                           dim=1).reshape(-1) + JTlam)
        r_a = torch.where(free, r_a, u[:n_dof])      # fixed dofs: a = 0
        # velocity-scaled constraint rows (C/h): the index-3 1/(βh²) factor
        # would amplify fp32 position noise to O(1) residuals
        r_c = _constraint_C(model, x_new, q_new) / h
        return torch.cat([r_a, r_c])

    # the exact Newton matrix by reverse mode over the residual (which
    # holds a reverse-mode gradient itself): the JAX package takes it by
    # forward mode, whose functorch rules here run every op through
    # PyTorch's Python decompositions, ~20× slower on these small systems
    jac = torch.func.jacrev(residual, argnums=0)

    def newton_solve(state, acc, f_old, tau_old, t, h, u0):
        u = u0
        k = 0
        res = torch.full((), float("inf"), dtype=u0.dtype, device=u0.device)
        # a NaN residual compares False: divergence ends the loop
        while k < newton_iters and host_test(res > tol):
            r = residual(u, state, acc, f_old, tau_old, t, h)
            J = jac(u, state, acc, f_old, tau_old, t, h)
            u = u + torch.linalg.solve(J, -r)
            res = torch.linalg.norm(
                residual(u, state, acc, f_old, tau_old, t, h))
            k += 1
        return u, k, res

    def step(state: BodyState, acc_prev: Tensor, t, h) -> HHTStepOut:
        dt, dev = state.x.dtype, state.x.device
        t = torch.as_tensor(t, dtype=dt, device=dev)
        f_old, tau_old = applied_forces(model, state, t)
        u0 = torch.cat([acc_prev.reshape(-1),
                        state.x.new_zeros((m_rows,))])
        h_try = torch.as_tensor(h, dtype=dt, device=dev)
        u, iters, res = newton_solve(state, acc_prev, f_old, tau_old, t,
                                     h_try, u0)
        k_half = 0
        while k_half < max_halvings and host_test(
                (res > tol) | ~torch.isfinite(res)):
            h_try = 0.5 * h_try
            u, iters, res = newton_solve(state, acc_prev, f_old, tau_old, t,
                                         h_try, u0)
            k_half += 1

        a = u[:n_dof].reshape(n, 6)
        x_new, q_new, v_new, w_new = new_pose(state, acc_prev, a[:, 0:3],
                                              a[:, 3:6], h_try)
        return HHTStepOut(
            state=BodyState(x=x_new, q=q_new, v=v_new, w=w_new), acc=a,
            h_used=h_try,
            iterations=torch.tensor(iters, dtype=torch.int32, device=dev),
            residual=res)

    return step


def make_newmark_mbs_step(model: Model, beta: float = 0.25,
                          gamma: float = 0.5, **kw):
    """Newmark-β implicit stepper; defaults to the unconditionally stable
    average-acceleration rule."""
    return make_hht_mbs_step(model, alpha=0.0, beta=beta, gamma=gamma, **kw)


def make_trapezoidal_mbs_step(model: Model, **kw):
    """Implicit trapezoidal rule: the γ=1/2, β=1/4 member of the Newmark
    family (second order, non-dissipative)."""
    return make_hht_mbs_step(model, alpha=0.0, beta=0.25, gamma=0.5, **kw)


def make_euler_implicit_mbs_step(model: Model, **kw):
    """Fully implicit (backward) Euler with Newton: γ=1, β=1/2 — first
    order, maximally dissipative."""
    return make_hht_mbs_step(model, alpha=0.0, beta=0.5, gamma=1.0, **kw)


class ProjectedStepOut(NamedTuple):
    state: BodyState
    c_inf: Tensor       # max |C| after projection
    info: object        # StepInfo from the velocity solve


def make_euler_implicit_projected_step(model: Model, settings=None,
                                       n_proj: int = 2):
    """Euler-implicit-projected stepper: the velocity solve runs
    unstabilised and the end-of-step poses are projected back onto
    C(q) = 0 (``n_proj`` Gauss–Newton iterations of N·λ = −C with the
    dense Schur solve), followed by one velocity projection onto J·u = 0.
    Every call runs on the device with no host read."""
    if settings is None:
        settings = SolverSettings(solver="direct")
    nobau = settings.replace(stab_factor=0.0)
    n = model.n_bodies
    minv6 = torch.stack(
        [model.props.inv_mass[:, None].expand(n, 3),
         model.props.inv_inertia], dim=1).reshape(n * 6)

    def _rows(st, stab):
        parts = [joint_rows(k, d, st.x, st.q, 1.0, stab)
                 for k, d in model.joints.items()]
        return (concat_rows(parts, dtype=st.x.dtype, device=st.x.device)
                if parts else None)

    def _delta_u(rows, gam):
        D = desc.dense_D(rows, n)                       # (m, 6N)
        du = ((D.T @ gam) * minv6).reshape(n, 6)
        return du[:, 0:3], du[:, 3:6]

    def step(state: BodyState, t, h) -> ProjectedStepOut:
        st, info = step_euler_implicit_linearized(model, state, t, h, nobau)
        zv = torch.zeros_like(st.v)
        zw = torch.zeros_like(st.w)
        if _rows(st, 1.0) is None:
            return ProjectedStepOut(st, st.x.new_zeros(()), info)
        for _ in range(n_proj):
            rows = _rows(st, 1.0)          # rhs = −C at the current pose
            gam = solve_dense_schur(rows, model.props, zv, zw)
            dv, dw = _delta_u(rows, gam)
            moved = integrate_positions(st.replace(v=dv, w=dw), 1.0)
            st = moved.replace(v=st.v, w=st.w)
        # velocity projection: N γ = −D u at the projected pose
        rows_v = _rows(st, 0.0)            # rhs = 0
        gam_v = solve_dense_schur(rows_v, model.props, st.v, st.w)
        dv, dw = _delta_u(rows_v, gam_v)
        st = st.replace(v=st.v + dv, w=st.w + dw)
        c_inf = torch.max(torch.abs(_constraint_C(model, st.x, st.q)))
        return ProjectedStepOut(st, c_inf, info)

    return step
