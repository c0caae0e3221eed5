"""User ODE blocks coupled to the MBS + hydraulic actuators.

Counterpart of ``chrono_tpu/physics/external.py`` (the reference's
ChExternalDynamicsODE and ChHydraulicActuator): an ODE block is ``(y0,
rhs)`` with ``rhs(t, y, body_state) -> (dy, f_ext (N,3), tau_ext (N,3))``;
``make_ode_coupled_step`` interleaves the block's explicit midpoint update
with one DVI body step.
"""

from __future__ import annotations

from typing import Callable, Union

import torch
from torch import Tensor

from chrono_tpu_torch.core import quaternion as Q
from chrono_tpu_torch.physics.system import (
    Model, SolverSettings, step_euler_implicit_linearized,
)
from chrono_tpu_torch.utils.tree import tensor_dataclass

Num = Union[float, Tensor]


def make_ode_coupled_step(model: Model, rhs: Callable, h: float,
                          settings: SolverSettings = SolverSettings(
                              solver="direct")):
    """``step(state, y, t) -> (state', y', info)``: explicit midpoint update
    of the user ODE interleaved with one MBS step (the block is treated
    explicitly at MBS step sizes, as the reference does by default)."""

    def step(state, y, t):
        dy1, f1, tau1 = rhs(t, y, state)
        y_mid = y + 0.5 * h * dy1
        dy2, f2, tau2 = rhs(t + 0.5 * h, y_mid, state)
        new_state, info = step_euler_implicit_linearized(
            model, state, t, h, settings, f_ext=f2, tau_ext=tau2)
        return new_state, y + h * dy2, info

    return step


# ---------------------------------------------------------------------------
# hydraulic actuator (two-chamber cylinder + proportional valve)
# ---------------------------------------------------------------------------

@tensor_dataclass
class HydraulicParams:
    """Cylinder + valve constants (ChHydraulicActuator's essential set)."""

    area_head: Num = 1e-3        # piston head area [m²]
    area_rod: Num = 6e-4         # rod-side annulus area [m²]
    bulk_modulus: Num = 1.2e9    # oil stiffness [Pa]
    vol_head0: Num = 4e-4        # dead volume, head side [m³]
    vol_rod0: Num = 4e-4
    p_pump: Num = 10e6           # supply pressure [Pa]
    p_tank: Num = 1e5
    q_nominal: Num = 2e-4        # valve flow at full opening, Δp_nom [m³/s]
    dp_nominal: Num = 3.5e6
    stroke0: Num = 0.5           # length at which chambers split evenly
    visc_friction: Num = 5e3     # seal/rod viscous friction [N·s/m]


def make_hydraulic_actuator(model: Model, body_a: int, body_b: int,
                            pa_loc, pb_loc, hp: HydraulicParams,
                            valve_fn: Callable):
    """Hydraulic cylinder between anchor points on two bodies.

    ``valve_fn(t) -> u ∈ [−1, 1]`` commands the proportional valve
    (+u: pump→head / rod→tank, extends; −u retracts).  Returns ``(y0,
    rhs)`` for :func:`make_ode_coupled_step`; y = (p_head, p_rod), on the
    model's device.
    """
    like = model.props.inv_mass
    pa_loc = torch.as_tensor(pa_loc, dtype=like.dtype, device=like.device)
    pb_loc = torch.as_tensor(pb_loc, dtype=like.dtype, device=like.device)

    def geometry(state):
        xa = state.x[body_a] + Q.qrotate(state.q[body_a], pa_loc)
        xb = state.x[body_b] + Q.qrotate(state.q[body_b], pb_loc)
        d = xb - xa
        L = torch.sqrt(torch.sum(d * d) + 1e-12)
        axis = d / L
        va = state.v[body_a] + torch.linalg.cross(
            Q.qrotate(state.q[body_a], state.w[body_a]),
            Q.qrotate(state.q[body_a], pa_loc), dim=-1)
        vb = state.v[body_b] + torch.linalg.cross(
            Q.qrotate(state.q[body_b], state.w[body_b]),
            Q.qrotate(state.q[body_b], pb_loc), dim=-1)
        Ldot = torch.sum((vb - va) * axis)
        return xa, xb, axis, L, Ldot

    def valve_flow(u, p_from, p_to):
        """Turbulent orifice: Q = u·Qn·sign(Δp)·√(|Δp|/Δp_n)."""
        dp = p_from - p_to
        return (u * hp.q_nominal
                * torch.sign(dp) * torch.sqrt(torch.abs(dp) / hp.dp_nominal))

    def rhs(t, y, state):
        p1, p2 = y[0], y[1]
        xa, xb, axis, L, Ldot = geometry(state)
        s = L - hp.stroke0                      # piston displacement
        V1 = hp.vol_head0 + hp.area_head * s
        V2 = hp.vol_rod0 - hp.area_rod * s
        V1 = torch.clamp_min(V1, 0.1 * hp.vol_head0)
        V2 = torch.clamp_min(V2, 0.1 * hp.vol_rod0)

        u = torch.clamp(torch.as_tensor(valve_fn(t), dtype=y.dtype,
                                        device=y.device), -1.0, 1.0)
        up = torch.clamp_min(u, 0.0)
        um = torch.clamp_min(-u, 0.0)
        q1 = valve_flow(up, hp.p_pump, p1) - valve_flow(um, p1, hp.p_tank)
        q2 = valve_flow(um, hp.p_pump, p2) - valve_flow(up, p2, hp.p_tank)

        dp1 = hp.bulk_modulus / V1 * (q1 - hp.area_head * Ldot)
        dp2 = hp.bulk_modulus / V2 * (q2 + hp.area_rod * Ldot)

        # piston force + seal viscous friction (damps the trapped-oil mode)
        F = p1 * hp.area_head - p2 * hp.area_rod - hp.visc_friction * Ldot
        f = y.new_zeros((model.n_bodies, 3))
        f[body_b] += F * axis
        f[body_a] += -F * axis
        tau = y.new_zeros((model.n_bodies, 3))
        # torque about each body's COM from the anchor offset (body-local)
        ra = xa - state.x[body_a]
        rb = xb - state.x[body_b]
        tau[body_a] += Q.qrotate_inv(
            state.q[body_a], torch.linalg.cross(ra, -F * axis, dim=-1))
        tau[body_b] += Q.qrotate_inv(
            state.q[body_b], torch.linalg.cross(rb, F * axis, dim=-1))
        return torch.stack([dp1, dp2]), f, tau

    y0 = torch.full((2,), float(hp.p_tank), dtype=like.dtype,
                    device=like.device)
    return y0, rhs
