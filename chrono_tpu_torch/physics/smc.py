"""Penalty (SMC) contact for the core MBS — the ChSystemSMC role.

Counterpart of ``chrono_tpu/physics/smc.py``: contacts come from the same
fixed-capacity pipeline as NSC (``collision/pipeline.py``), every
per-contact force law (Hertz, Hooke, Flores; constant, DMT or Perko
adhesion; no or one-step tangential displacement) is one masked batch, and
the resulting body forces enter the same implicit-linearized step as the
joints (``smc_step``).

Conventions (those of ``collision/pipeline.py``): the contact normal points
A→B, ``gap < 0`` means penetrating, angular velocities are body-frame.
"""

from __future__ import annotations

import math

import torch
from torch import Tensor

from chrono_tpu_torch.core import quaternion as Q
from chrono_tpu_torch.utils.segment import segment_sum_sorted, sorted_segments
from chrono_tpu_torch.utils.tree import static_field, tensor_dataclass


@tensor_dataclass
class SMCParams:
    """Scene-wide smooth-contact material + model selection (floats, and
    the model choices as static fields)."""

    youngs: float = 1e7          # E [Pa]
    poisson: float = 0.3         # ν
    restitution: float = 0.5     # e
    adhesion: float = 0.0        # Constant model: F_adh [N]
    adhesion_mult_dmt: float = 0.0   # DMT model: F = mult · √R_eff
    adhesion_s_perko: float = 0.0    # Perko model: F = s · R_eff
    char_vel: float = 1.0        # characteristic velocity (Hooke/Flores)
    force_model: str = static_field(default="hertz")   # hertz|hooke|flores
    adhesion_model: str = static_field(default="constant")  # constant|dmt|perko
    tangential_model: str = static_field(default="one_step")  # none|one_step


def _cross(a: Tensor, b: Tensor) -> Tensor:
    return torch.linalg.cross(*torch.broadcast_tensors(a, b), dim=-1)


def smc_contact_forces(params: SMCParams, model, state, contacts, h
                       ) -> tuple[Tensor, Tensor]:
    """Per-body forces/torques from penalty contact → ``(f, tau)`` (N,3),
    ``tau`` body-frame.

    The material constants are float32 scalars on the state's device (the
    JAX package traces them as float32).  Each body's contact forces are
    summed with no atomics and in a fixed order, through the contacts'
    sides sorted by body (``utils.segment``): a body's B-sides in contact
    order, then its A-sides, the order of the JAX package's two sequential
    ``.at[].add``; contacts not in touch add exact zeros and are left out.
    """
    dt, dev = state.x.dtype, state.x.device

    def c(v):
        return torch.as_tensor(v, dtype=dt, device=dev)

    props = model.props
    a, b = contacts.body_a.long(), contacts.body_b.long()
    n = contacts.normal                                  # A→B
    delta = torch.clamp_min(-contacts.gap, 0.0)          # penetration ≥ 0
    act = contacts.active & (contacts.gap < 0.0)
    ok = act.to(dt)

    # kinematics at the contact point
    ra = contacts.point - state.x[a]
    rb = contacts.point - state.x[b]
    wa = Q.qrotate(state.q[a], state.w[a])               # world ω
    wb = Q.qrotate(state.q[b], state.w[b])
    v_rel = (state.v[b] + _cross(wb, rb) - state.v[a] - _cross(wa, ra))
    vn = torch.sum(v_rel * n, dim=-1)                    # >0 separating
    vt = v_rel - vn[:, None] * n

    m_eff = 1.0 / torch.clamp_min(props.inv_mass[a] + props.inv_mass[b],
                                  1e-12)
    r_eff = torch.clamp_min(contacts.r_eff, 1e-9)
    E, nu = c(params.youngs), c(params.poisson)
    E_star = E / (2.0 * (1.0 - nu * nu))
    G_star = E / (4.0 * (2.0 - nu) * (1.0 + nu))
    e = torch.clamp(c(params.restitution), 1e-3, 1.0 - 1e-6)
    char_vel = c(params.char_vel)
    pi = math.pi

    if params.force_model == "hertz":
        ln_e = torch.log(e)
        beta = ln_e / torch.sqrt(ln_e * ln_e + pi * pi)
        sqrt_Rd = torch.sqrt(r_eff * delta + 1e-30)
        Sn = 2.0 * E_star * sqrt_Rd
        St = 8.0 * G_star * sqrt_Rd
        kn = (4.0 / 3.0) * E_star * sqrt_Rd              # × δ → force
        kt = St
        gn = -2.0 * math.sqrt(5.0 / 6.0) * beta * torch.sqrt(Sn * m_eff)
        gt = -2.0 * math.sqrt(5.0 / 6.0) * beta * torch.sqrt(St * m_eff)
        forceN = kn * delta - gn * vn
    elif params.force_model == "hooke":
        sqrt_R = torch.sqrt(r_eff)
        kn = (16.0 / 15.0) * sqrt_R * E_star * (
            15.0 * m_eff * char_vel**2 / (16.0 * sqrt_R * E_star)) ** 0.2
        ln_e = torch.log(e)
        gn = torch.sqrt(4.0 * m_eff * kn / (1.0 + (pi / ln_e) ** 2))
        kt, gt = kn, gn
        forceN = kn * delta - gn * vn
    elif params.force_model == "flores":
        # hysteretic damping folded into the stiffness term
        kn = (4.0 / 3.0) * E_star * torch.sqrt(r_eff)
        cr = e
        forceN = (kn * delta ** 1.5
                  * (1.0 + 8.0 * (1.0 - cr) / (5.0 * cr)
                     * (-vn) / char_vel))
        # tangential like Hertz
        sqrt_Rd = torch.sqrt(r_eff * delta + 1e-30)
        St = 8.0 * G_star * sqrt_Rd
        ln_e = torch.log(e)
        beta = ln_e / torch.sqrt(ln_e * ln_e + pi * pi)
        kt = St
        gt = -2.0 * math.sqrt(5.0 / 6.0) * beta * torch.sqrt(St * m_eff)
    else:
        raise ValueError(f"unknown SMC force model {params.force_model!r}")

    forceN = torch.clamp_min(forceN, 0.0)

    # adhesion menu
    if params.adhesion_model == "constant":
        forceN = forceN - c(params.adhesion)
    elif params.adhesion_model == "dmt":
        forceN = forceN - c(params.adhesion_mult_dmt) * torch.sqrt(r_eff)
    elif params.adhesion_model == "perko":
        forceN = forceN - c(params.adhesion_s_perko) * r_eff
    else:
        raise ValueError(
            f"unknown adhesion model {params.adhesion_model!r}")

    F = forceN[:, None] * n                              # on body B

    if params.tangential_model != "none":
        # OneStep: tangential displacement ≈ vt·h
        Ft = -(kt * h + gt)[:, None] * vt
        ft_mag = torch.linalg.norm(Ft, dim=-1)
        clamp = torch.clamp_max(
            contacts.mu * torch.clamp_min(forceN, 0.0)
            / torch.clamp_min(ft_mag, 1e-12), 1.0)
        F = F + clamp[:, None] * Ft

    F = F * ok[:, None]

    N = props.inv_mass.shape[0]
    tau_b = Q.qrotate_inv(state.q[b], _cross(rb, F))
    tau_a = Q.qrotate_inv(state.q[a], _cross(ra, -F))
    seg = sorted_segments(torch.cat([b, a]), N, keep=torch.cat([act, act]))
    f = segment_sum_sorted(seg, torch.cat([F, -F]))
    tau = segment_sum_sorted(seg, torch.cat([tau_b, tau_a]))
    return f, tau


def smc_step(model, coll, state, t, h, params: SMCParams = SMCParams(),
             settings=None, f_ext=None, tau_ext=None):
    """One SMC step: detect → penalty forces → implicit-linearized step.
    Contact forces are explicit (evaluated at the step start); joints and
    motors stay in the velocity solve.  Returns ``(new_state, contacts,
    StepInfo)``."""
    from chrono_tpu_torch.collision.pipeline import detect_contacts
    from chrono_tpu_torch.physics.system import (
        SolverSettings, step_euler_implicit_linearized,
    )

    if settings is None:
        settings = SolverSettings(solver="apgd")
    contacts = detect_contacts(coll, state)
    f_c, tau_c = smc_contact_forces(params, model, state, contacts, h)
    if f_ext is not None:
        f_c = f_c + f_ext
    if tau_ext is not None:
        tau_c = tau_c + tau_ext
    new_state, info = step_euler_implicit_linearized(
        model, state, t, h, settings, f_ext=f_c, tau_ext=tau_c)
    return new_state, contacts, info
