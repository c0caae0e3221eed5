"""Explicit integrators for smooth (constraint-free) multibody systems.

Counterpart of ``chrono_tpu/physics/explicit.py``: the explicit members of
the reference's integrator menu (Euler explicit, Heun, RK4, leapfrog) for
free bodies and force elements.  Constrained systems use the implicit DVI
stepper (``physics.system``) or ``physics.implicit``.  Each step reads
nothing on the host.
"""

from __future__ import annotations

from chrono_tpu_torch.core import quaternion as Q
from chrono_tpu_torch.physics.body import BodyState, integrate_positions
from chrono_tpu_torch.physics.system import Model, applied_forces


def _accels(model: Model, state: BodyState, t, f_ext=None, tau_ext=None):
    f, tau = applied_forces(model, state, t, f_ext, tau_ext)
    return (model.props.inv_mass[:, None] * f,
            model.props.inv_inertia * tau)


def step_euler_explicit(model, state, t, h, f_ext=None, tau_ext=None):
    a, alpha = _accels(model, state, t, f_ext, tau_ext)
    new = state.replace(v=state.v + h * a, w=state.w + h * alpha)
    return integrate_positions(state.replace(v=new.v, w=new.w), h)


def step_heun(model, state, t, h, f_ext=None, tau_ext=None):
    """Explicit trapezoidal (RK2): average the derivative of both the
    velocity (accelerations) and the position (velocities)."""
    a1, al1 = _accels(model, state, t, f_ext, tau_ext)
    v_e = state.v + h * a1
    w_e = state.w + h * al1
    mid = integrate_positions(state.replace(v=v_e, w=w_e), h)
    a2, al2 = _accels(model, mid.replace(v=v_e, w=w_e), t + h, f_ext,
                      tau_ext)
    v = state.v + 0.5 * h * (a1 + a2)
    w = state.w + 0.5 * h * (al1 + al2)
    # trapezoidal position update: x += h/2 (v_old + v_euler)
    return integrate_positions(
        state.replace(v=0.5 * (state.v + v_e), w=0.5 * (state.w + w_e)), h
    ).replace(v=v, w=w)


def step_rk4(model, state, t, h, f_ext=None, tau_ext=None):
    """Classic RK4 on (x, q, v, ω) with geometric quaternion updates."""

    def deriv(s, tt):
        a, al = _accels(model, s, tt, f_ext, tau_ext)
        return s.v, s.w, a, al

    def advance(dx, dw_vec, dv, dal, fac):
        return BodyState(
            x=state.x + fac * dx,
            q=Q.qnormalize(Q.qmul(state.q, Q.qexp_half(dw_vec * fac))),
            v=state.v + fac * dv,
            w=state.w + fac * dal)

    k1 = deriv(state, t)
    k2 = deriv(advance(*k1, 0.5 * h), t + 0.5 * h)
    k3 = deriv(advance(*k2, 0.5 * h), t + 0.5 * h)
    k4 = deriv(advance(*k3, h), t + h)

    def wsum(i):
        return (k1[i] + 2 * k2[i] + 2 * k3[i] + k4[i]) / 6.0

    return BodyState(
        x=state.x + h * wsum(0),
        q=Q.qnormalize(Q.qmul(state.q, Q.qexp_half(h * wsum(1)))),
        v=state.v + h * wsum(2),
        w=state.w + h * wsum(3))


def step_leapfrog(model, state, t, h, f_ext=None, tau_ext=None):
    """Kick-drift-kick leapfrog: half-kick on the start accelerations, full
    geometric drift, half-kick on the end accelerations (evaluated at the
    mid-velocities, as the reference does for velocity-dependent
    forces)."""
    a1, al1 = _accels(model, state, t, f_ext, tau_ext)
    v_half = state.v + 0.5 * h * a1
    w_half = state.w + 0.5 * h * al1
    drifted = integrate_positions(state.replace(v=v_half, w=w_half), h)
    a2, al2 = _accels(model, drifted, t + h, f_ext, tau_ext)
    return drifted.replace(v=v_half + 0.5 * h * a2,
                           w=w_half + 0.5 * h * al2)


EXPLICIT_STEPPERS = {
    "euler_explicit": step_euler_explicit,
    "heun": step_heun,
    "rk4": step_rk4,
    "leapfrog": step_leapfrog,
}
