"""Hertz–Mindlin contact forces: the kernels' pair function and the
neighbour-list force passes with history.

Counterpart of ``chrono_tpu/dem/forces.py`` (``_pair_force``,
``particle_forces``, ``_wall_reactions``, ``wall_forces``) and of the
27-neighbour pair sum of ``chrono_tpu/dem/cell_dense.py``
``cell_dense_forces``.  Two forms live here:

* the cell-slot kernels' pair function (:func:`_pair_force`,
  :func:`cell_pair_forces`, :func:`row_pair_forces`,
  :func:`plane_wall_forces`): frictionless or single-step friction, no
  per-contact history, vectors as tuples of three component tensors, the
  form of the CUDA kernels' pair loop, so that no op reduces over a
  length-3 axis;
* the neighbour-list system's force passes (:func:`particle_forces` over
  the (N, K) list, :func:`wall_forces` over the (N, B) walls), the JAX
  functions op for op on (…, 3) tensors: every friction mode with the
  tangential history kept in the tangent plane and cut back at the
  Coulomb cap, Schwartz and elastic–plastic rolling resistance, and the
  user-stiffness model.  Each particle's sum runs over its own row of
  slots (a masked row reduction in a fixed order: no scatter, no atomics).

  normal      F_n = max(kn·√δ·δ − gn·q·v_n, 0), q = δ^¼ (δ^½ for "user")
  tangential  F_t = kt·√δ·ξ + gt·q·v_t, capped at μ·F_n
"""

from __future__ import annotations

import torch

from chrono_tpu_torch.dem.bc import (
    CONTACTS, DEMBoundaries, PlaneBCs, plane_contacts,
)
from chrono_tpu_torch.dem.params import DEMParams, contact_coefficients
from chrono_tpu_torch.dem.rows import neighbour_runs

_OFFSETS = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
            for dz in (-1, 0, 1)]


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _pair_force(nh, delta, vr, active, kn, gn, kt, gt, mu, dt,
                friction: bool):
    """Force on this particle from one contact, and its torque.

    nh: unit normal from this particle toward the other surface; delta ≥ 0:
    overlap; vr: velocity of the other surface relative to this particle at
    the contact.  The torque arm is r − δ/2 along nh (times the caller's r).
    """
    sq = torch.sqrt(delta)
    q4 = torch.sqrt(sq)
    vn = vr[0] * nh[0] + vr[1] * nh[1] + vr[2] * nh[2]
    fn = torch.clamp(kn * sq * delta - gn * q4 * vn, min=0.0)
    f = [-fn * n for n in nh]
    if friction:
        coef = kt * sq * dt + gt * q4
        ft = [coef * (v - vn * n) for v, n in zip(vr, nh)]
        ft2 = ft[0] * ft[0] + ft[1] * ft[1] + ft[2] * ft[2] + 1e-18
        scale = torch.clamp(mu * fn * torch.rsqrt(ft2), max=1.0)
        f = [a + b * scale for a, b in zip(f, ft)]
    return tuple(torch.where(active, a, 0.0) for a in f)


def cell_pair_forces(pos, vel, omega, mask, radius, kn, gn, kt, gt, mu, dt,
                     friction: bool):
    """Per-slot force and torque from the 27 neighbour cells.

    pos, vel, omega: (3, nx, ny, nz, C) planes; mask: (nx, ny, nz, C) bool.
    The grid is padded by one ghost cell of empty slots on every side, so
    the 27 neighbour blocks are plain slices and edge cells need no masks.
    Each pair is evaluated from both sides.  Returns (3, nx, ny, nz, C)
    force and torque.
    """
    nx, ny, nz, C = mask.shape

    def padded(a):
        out = a.new_zeros(a.shape[:-4] + (nx + 2, ny + 2, nz + 2, C))
        out[..., 1:-1, 1:-1, 1:-1, :] = a
        return out

    def me(a):    # self slot on axis −2 of the (…, C_self, C_nbr) lattice
        return a[..., :, None]

    def nb(a):    # neighbour slot on axis −1
        return a[..., None, :]

    P, V, W, M = (padded(a) for a in (pos, vel, omega, mask))
    not_self = ~torch.eye(C, dtype=torch.bool, device=mask.device)
    force = torch.zeros_like(pos)
    torque = torch.zeros_like(pos)
    for dx, dy, dz in _OFFSETS:
        sl = (..., slice(1 + dx, 1 + dx + nx), slice(1 + dy, 1 + dy + ny),
              slice(1 + dz, 1 + dz + nz), slice(None))
        npos, nvel, nomega = P[sl], V[sl], W[sl]
        d = [nb(npos[a]) - me(pos[a]) for a in range(3)]
        dist2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        inv = torch.rsqrt(dist2 + 1e-18)
        overlap = 2.0 * radius - dist2 * inv
        ok = me(mask) & nb(M[sl]) & (overlap > 0)
        if (dx, dy, dz) == (0, 0, 0):
            ok &= not_self
        nh = [a * inv for a in d]
        delta = torch.clamp(overlap, min=0.0)
        arm = radius - 0.5 * delta
        ws = [nb(nomega[a]) + me(omega[a]) for a in range(3)]
        cr = _cross(ws, nh)
        vr = [nb(nvel[a]) - me(vel[a]) - arm * cr[a] for a in range(3)]
        pf = _pair_force(nh, delta, vr, ok, kn, gn, kt, gt, mu, dt, friction)
        tq = _cross(nh, pf)
        for a in range(3):
            force[a] += pf[a].sum(-1)
            torque[a] += (arm * tq[a]).sum(-1)
    return force, torque


def row_pair_forces(state, cell, table, dims, radius, kn, gn, kt, gt, mu,
                    dt, friction: bool, chunk_pairs: int = 2 ** 22):
    """Per-row force and torque (each (3, R)) of cell-sorted rows by the
    kernels' walk: for each row, the nine runs of ``neighbour_runs`` in
    (dx, dy) order, each in row order (dz, then slot), the row itself
    skipped; each pair from both sides.  state: (3, R, 4) pos, vel, omega;
    cell (R,), −1 on a dead row; table (n_cells, 2) (start, count).  Works
    on slabs of rows with at most ``chunk_pairs`` candidates per run."""
    n_rows = state.shape[1]
    force = state.new_zeros((3, n_rows))
    torque = state.new_zeros((3, n_rows))
    span = 3 * int(table[:, 1].max()) if table.numel() else 0
    if span == 0:
        return force, torque
    runs = neighbour_runs(cell, table, dims)
    pos, vel, omega = (state[k, :, :3] for k in range(3))
    offsets = torch.arange(span, device=state.device)
    rows = torch.arange(n_rows, device=state.device)
    step = max(1, chunk_pairs // span)
    for r0 in range(0, n_rows, step):
        me = slice(r0, min(n_rows, r0 + step))
        for lo, hi in runs:
            t = lo[me, None] + offsets
            ok = (t < hi[me, None]) & (t != rows[me, None])
            t = torch.where(ok, t, 0)
            d = [pos[t, a] - pos[me, a, None] for a in range(3)]
            dist2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
            inv = torch.rsqrt(dist2 + 1e-18)
            overlap = 2.0 * radius - dist2 * inv
            nh = [a * inv for a in d]
            delta = torch.clamp(overlap, min=0.0)
            arm = radius - 0.5 * delta
            ws = [omega[t, a] + omega[me, a, None] for a in range(3)]
            cr = _cross(ws, nh)
            vr = [vel[t, a] - vel[me, a, None] - arm * cr[a]
                  for a in range(3)]
            pf = _pair_force(nh, delta, vr, ok & (overlap > 0), kn, gn, kt,
                             gt, mu, dt, friction)
            tq = _cross(nh, pf)
            for a in range(3):
                force[a, me] += pf[a].sum(-1)
                torque[a, me] += (arm * tq[a]).sum(-1)
    return force, torque


def plane_wall_forces(planes: PlaneBCs, pos, vel, omega, radius, kn, gn,
                      kt, gt, mu, dt, friction: bool):
    """Dense particle × plane pass on (3, M) planes → force, torque (3, M),
    with the caller's coefficients: the wall term of the fused substep
    (kernel K1), which caps wall friction at the wall material's μ."""
    gap, n_into, wall_v = plane_contacts(planes, pos.T, radius)   # (M, B)
    nh = (-n_into).unbind(-1)            # from the particle toward the wall
    delta = torch.clamp(-gap, min=0.0)
    arm = radius - 0.5 * delta
    cr = _cross([w[:, None] for w in omega], nh)
    vr = [wall_v[..., a] - vel[a][:, None] - arm * cr[a] for a in range(3)]
    pf = _pair_force(nh, delta, vr, delta > 0, kn, gn, kt, gt, mu, dt,
                     friction)
    tq = _cross(nh, pf)
    return (torch.stack([f.sum(-1) for f in pf]),
            torch.stack([(arm * t).sum(-1) for t in tq]))


def _history_pair_force(params: DEMParams, n, overlap, v_rel, xi, active,
                        kn, gn, kt, gt):
    """The JAX ``_pair_force`` on (…, 3) tensors, shared by pairs and
    walls: n from this particle toward the other surface, v_rel the other
    surface's velocity relative to this particle at the contact, xi the
    tangential history.  Returns (force, new history, F_n); friction is
    capped at ``params.material.mu_s`` for walls too, as in JAX."""
    delta = torch.clamp(overlap, min=0.0)
    sq = torch.sqrt(delta)
    q4 = sq if params.force_model == "user" else torch.sqrt(sq)
    vn_s = torch.sum(v_rel * n, dim=-1)
    vt = v_rel - vn_s[..., None] * n
    fn = torch.clamp(kn * sq * delta - gn * q4 * vn_s, min=0.0)
    f_normal = -fn[..., None] * n
    act = active[..., None]
    if params.friction_mode == "frictionless":
        return (torch.where(act, f_normal, 0.0), torch.zeros_like(xi), fn)
    if params.friction_mode == "single_step":
        xi = vt * params.dt
    else:
        xi = xi + vt * params.dt
        xi = xi - torch.sum(xi * n, dim=-1, keepdim=True) * n
    ft = kt * sq[..., None] * xi + gt * q4[..., None] * vt
    ft_mag = torch.sqrt(torch.sum(ft * ft, dim=-1) + 1e-18)
    cap = params.material.mu_s * fn
    scale = torch.where(ft_mag > cap, cap / ft_mag, 1.0)[..., None]
    ft = ft * scale
    xi = torch.where(act, xi * scale, 0.0)
    return (torch.where(act, f_normal + ft, 0.0), xi,
            torch.where(active, fn, 0.0))


def _schwartz_torque(mu_r, arm, fn, w_rel, active):
    """Rolling torque μ_r·arm·F_n along the relative spin, off below a
    rolling speed arm·|ω| of 1e-4 m/s (the dead zone that lets a pile come
    to rest); summed over the contacts of each particle."""
    w_mag = torch.sqrt(torch.sum(w_rel * w_rel, dim=-1) + 1e-12)
    keep = active & (arm * w_mag > 1e-4)
    t_roll = (mu_r * arm * fn / w_mag)[..., None] * w_rel
    return torch.sum(torch.where(keep[..., None], t_roll, 0.0), dim=1)


def _rolling_spring(mu_r, k_roll, arm, fn, xi_r, active):
    """Elastic–plastic rolling: the wound rolling displacement xi_r cut
    back at the torque cap μ_r·F_n·arm.  Returns (summed torque, new
    displacement)."""
    t_mag = k_roll * torch.sqrt(torch.sum(xi_r * xi_r, dim=-1) + 1e-18)
    cap = mu_r * fn * arm
    scale = torch.clamp(cap / torch.clamp(t_mag, min=1e-18), max=1.0)
    xi_r = torch.where(active[..., None], xi_r * scale[..., None], 0.0)
    return torch.sum(torch.where(active[..., None], k_roll * xi_r, 0.0),
                     dim=1), xi_r


def particle_forces(params: DEMParams, pos, vel, omega, nbr_idx, nbr_valid,
                    tan_disp, roll_disp=None):
    """Pair forces over the (N, K) neighbour rows → per-particle force and
    torque (N, 3) and the new (N, K, 3) tangential history; with
    ``rolling_mode="elastic_plastic"`` also the new rolling displacement
    (``roll_disp`` is required then)."""
    r = params.radius
    kn, gn, kt, gt = contact_coefficients(params, params.material,
                                          0.5 * params.mass, 0.5 * r)
    j = torch.clamp(nbr_idx, min=0).long()
    d = pos[j] - pos[:, None, :]
    dist = torch.sqrt(torch.sum(d * d, dim=-1) + 1e-18)
    n = d / dist[..., None]
    overlap = 2.0 * r - dist
    active = nbr_valid & (overlap > 0)
    arm = r - 0.5 * overlap
    lever = arm[..., None] * n
    w_j = omega[j]
    v_rel = (vel[j] + torch.linalg.cross(w_j, -lever, dim=-1)
             - (vel[:, None, :]
                + torch.linalg.cross(omega[:, None, :].expand_as(lever),
                                     lever, dim=-1)))
    f_pair, xi_new, fn = _history_pair_force(
        params, n, overlap, v_rel, tan_disp, active, kn, gn, kt, gt)
    force = torch.sum(f_pair, dim=1)
    tau = torch.sum(torch.linalg.cross(lever, f_pair, dim=-1), dim=1)
    if params.rolling_mode == "schwartz":
        tau = tau + _schwartz_torque(params.material.mu_r, arm, fn,
                                     w_j - omega[:, None, :], active)
    elif params.rolling_mode == "elastic_plastic":
        if roll_disp is None:
            raise ValueError("elastic_plastic rolling needs roll_disp state")
        xi_r = roll_disp + (w_j - omega[:, None, :]) * params.dt
        t_roll, xi_r = _rolling_spring(params.material.mu_r, kt * r * r,
                                       arm, fn, xi_r, active)
        return force, tau + t_roll, xi_new, xi_r
    return force, tau, xi_new


def _wall_reactions(pos, arm, n, f_pair):
    """Per-wall reaction (B, 3) force and torque about the origin: minus
    the summed contact forces, and minus their moments taken at the
    contact points (shift to a body centre c by τ_c = τ_0 − c × F)."""
    react_f = -torch.sum(f_pair, dim=0)
    p_c = pos[:, None, :] + arm[..., None] * n
    react_tau = -torch.sum(torch.linalg.cross(p_c, f_pair, dim=-1), dim=0)
    return react_f, react_tau


def wall_forces(params: DEMParams, bcs: DEMBoundaries, pos, vel, omega,
                bc_tan_disp=None, bc_roll_disp=None):
    """Dense particle × wall pass over every kind of ``bcs``, the JAX
    ``wall_forces``.

    pos, vel, omega: (N, 3); ``bc_tan_disp`` (N, B, 3) the wall friction
    history (None: zero, as the cell-slot paths pass it).  Returns
    ``(force, torque, new history, (react_f, react_tau))``, and with
    elastic–plastic rolling and a ``bc_roll_disp`` the new wall rolling
    displacement as a fifth item.  The coefficients are the wall
    material's (m* = m, r* = r) while friction is capped at
    ``params.material.mu_s``; rolling at walls uses the wall material's
    μ_r and the elastic part of F_n.
    """
    r = params.radius
    kinds = bcs.kinds()
    if not kinds:
        z = torch.zeros_like(pos)
        zb = pos.new_zeros((0, 3))
        return z, z, bc_tan_disp, (zb, zb)
    parts = [CONTACTS[k](getattr(bcs, k), pos, r) for k in kinds]
    gap = torch.cat([p.gap for p in parts], dim=1)             # (N, B)
    n = -torch.cat([p.normal for p in parts], dim=1)   # toward the wall
    wall_v = torch.cat([p.vel for p in parts], dim=1)
    if bc_tan_disp is None:
        bc_tan_disp = torch.zeros_like(n)
    kn, gn, kt, gt = contact_coefficients(params, params.wall_material,
                                          params.mass, r)
    overlap = -gap
    active = overlap > 0
    arm = r - 0.5 * overlap
    lever = arm[..., None] * n
    v_rel = wall_v - (vel[:, None, :] + torch.linalg.cross(
        omega[:, None, :].expand_as(lever), lever, dim=-1))
    f_pair, xi_new, _ = _history_pair_force(
        params, n, overlap, v_rel, bc_tan_disp, active, kn, gn, kt, gt)
    force = torch.sum(f_pair, dim=1)
    tau = torch.sum(torch.linalg.cross(lever, f_pair, dim=-1), dim=1)
    react = _wall_reactions(pos, arm, n, f_pair)
    delta = torch.clamp(overlap, min=0.0)
    fn = torch.where(active, torch.clamp(kn * torch.sqrt(delta) * delta,
                                         min=0.0), 0.0)
    w_rel = -omega[:, None, :]                            # walls don't spin
    if params.rolling_mode == "schwartz":
        tau = tau + _schwartz_torque(params.wall_material.mu_r, arm, fn,
                                     w_rel.expand_as(lever), active)
    elif (params.rolling_mode == "elastic_plastic"
          and bc_roll_disp is not None):
        t_roll, xi_r = _rolling_spring(params.wall_material.mu_r,
                                       kt * r * r, arm, fn,
                                       bc_roll_disp + w_rel * params.dt,
                                       active)
        return force, tau + t_roll, xi_new, react, xi_r
    return force, tau, xi_new, react
