"""Projection operators onto the feasible multiplier set.

Counterpart of ``chrono_tpu/solver/projection.py``: the friction-cone
projection of every contact at once (Anitescu–Tasora), and the projector of
the mixed multiplier vector ``gamma = [gamma_bilateral (Mb,),
gamma_contact (3·Mc,), gamma_rolling (3·Mr,)]`` with contact triples
``(γ_n, γ_u, γ_v)`` contiguous.
"""

from __future__ import annotations

import torch
from torch import Tensor


def project_friction_cone(gc: Tensor, mu: Tensor, eps: float = 1e-12
                          ) -> Tensor:
    """Project contact triples onto the Coulomb cone ``|γ_t| ≤ μ γ_n``.

    gc: (Mc, 3) triples, mu: (Mc,). Three regimes (Anitescu–Tasora):
      inside the cone        → unchanged
      inside the polar cone  → zero
      otherwise              → closest point on the cone surface
    Frictionless (μ=0) degenerates to ``γ_n ← max(γ_n, 0), γ_t ← 0``.
    """
    gn = gc[:, 0]
    gt = gc[:, 1:]
    tnorm = torch.sqrt(torch.sum(gt * gt, dim=-1) + eps)

    inside = tnorm <= mu * gn
    in_polar = mu * tnorm <= -gn

    # projection onto the cone surface
    gn_s = torch.clamp_min((tnorm * mu + gn) / (mu * mu + 1.0), 0.0)
    scale_t = mu * gn_s / tnorm
    zero = torch.zeros_like(gn)
    gn_new = torch.where(inside, gn, torch.where(in_polar, zero, gn_s))
    t_scale = torch.where(inside, torch.ones_like(gn),
                          torch.where(in_polar, zero, scale_t))
    return torch.cat([gn_new[:, None], gt * t_scale[:, None]], dim=-1)


def make_projector(n_bilateral: int, n_contacts: int, mu: Tensor | None,
                   n_rolling: int = 0, mu_roll=0.0, mu_spin=0.0):
    """Build ``project(gamma) -> gamma`` for the mixed multiplier vector.

    Bilateral rows are free; the next ``3·n_contacts`` entries are
    cone-projected per (n, u, v) triple.  With ``n_rolling = n_contacts`` a
    trailing block of rolling triples ``(τ_spin, τ_u, τ_v)`` is projected
    onto the spinning cone, then the rolling cone, against the SAME normal
    multiplier, which each projection updates (μ_roll, μ_spin carry length
    units: torque limit = μ·γ_n).
    """
    if n_contacts == 0:
        return lambda g: g

    def project(gamma: Tensor) -> Tensor:
        gb = gamma[:n_bilateral]
        gc = gamma[n_bilateral:n_bilateral + 3 * n_contacts].reshape(
            n_contacts, 3)
        gc = project_friction_cone(gc, mu)
        if n_rolling == 0:
            return torch.cat([gb, gc.reshape(-1)])
        gr = gamma[n_bilateral + 3 * n_contacts:].reshape(n_rolling, 3)
        gn = gc[:, 0]
        zero = torch.zeros_like(gn)
        # spinning cone on (γ_n, τ_spin)
        sp = project_friction_cone(torch.stack([gn, gr[:, 0], zero], dim=1),
                                   torch.full_like(gn, mu_spin))
        gn, t_spin = sp[:, 0], sp[:, 1]
        # rolling cone on (γ_n, τ_u, τ_v)
        rl = project_friction_cone(
            torch.cat([gn[:, None], gr[:, 1:3]], dim=1),
            torch.full_like(gn, mu_roll))
        gn, t_uv = rl[:, 0], rl[:, 1:3]
        gc = torch.cat([gn[:, None], gc[:, 1:3]], dim=1)
        gr = torch.cat([t_spin[:, None], t_uv], dim=1)
        return torch.cat([gb, gc.reshape(-1), gr.reshape(-1)])

    return project
