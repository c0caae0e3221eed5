"""Hertz–Mindlin contact forces without tangential history.

Counterpart of ``chrono_tpu/dem/forces.py`` (``_pair_force``,
``_wall_reactions``, ``wall_forces``) and of the 27-neighbour pair sum of
``chrono_tpu/dem/cell_dense.py`` ``cell_dense_forces``.  Frictionless or
single-step friction only (the cell-slot paths keep no per-contact history).
Vectors are tuples of three component tensors, the form of the TPU kernel's
pair function, so that no op reduces over a length-3 axis.

  normal      F_n = max(kn·√δ·δ − gn·δ^¼·v_n, 0)
  tangential  F_t = (kt·√δ·dt + gt·δ^¼)·v_t, capped at μ·F_n
"""

from __future__ import annotations

import torch

from chrono_tpu_torch.dem.bc import (
    CONTACTS, DEMBoundaries, PlaneBCs, plane_contacts,
)
from chrono_tpu_torch.dem.params import DEMParams, hertz_coefficients
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


def wall_forces(params: DEMParams, bcs: DEMBoundaries, pos, vel, omega):
    """Dense particle × wall pass over every kind of ``bcs``.

    pos, vel, omega: (N, 3).  Returns force and torque (N, 3) on the
    particles and the per-wall reactions ``(react_f, react_tau)``, each
    (B, 3): minus the summed contact forces, and minus their moments about
    the origin taken at the contact points (shift to a body centre c by
    τ_c = τ_0 − c × F).  The Hertz coefficients are the wall material's
    (m* = m, r* = r) while friction is capped at ``params.material.mu_s``,
    as in the JAX ``wall_forces`` whose pair function serves pairs and
    walls alike (the fused substep caps at the wall material's μ instead).
    """
    if params.friction_mode not in ("frictionless", "single_step"):
        raise ValueError("wall_forces keeps no tangential history: "
                         f"friction_mode {params.friction_mode!r}")
    r = params.radius
    kinds = bcs.kinds()
    if not kinds:
        z = torch.zeros_like(pos)
        zb = pos.new_zeros((0, 3))
        return z, z, (zb, zb)
    parts = [CONTACTS[k](getattr(bcs, k), pos, r) for k in kinds]
    gap = torch.cat([p.gap for p in parts], dim=1)             # (N, B)
    n_into = torch.cat([p.normal for p in parts], dim=1)       # (N, B, 3)
    wall_v = torch.cat([p.vel for p in parts], dim=1)
    kn, gn, kt, gt = hertz_coefficients(params.wall_material, params.mass, r)

    overlap = -gap
    nh = (-n_into).unbind(-1)          # from the particle toward the wall
    arm = r - 0.5 * overlap
    cr = _cross([w[:, None] for w in omega.unbind(-1)], nh)
    vr = [wall_v[..., a] - vel[:, None, a] - arm * cr[a] for a in range(3)]
    pf = _pair_force(nh, torch.clamp(overlap, min=0.0), vr, overlap > 0, kn,
                     gn, kt, gt, params.material.mu_s, params.dt,
                     params.friction_mode == "single_step")
    tq = _cross(nh, pf)
    force = torch.stack([f.sum(-1) for f in pf], dim=-1)
    torque = torch.stack([(arm * t).sum(-1) for t in tq], dim=-1)
    # reactions: contact points p + arm·n̂, moments about the origin
    p_c = [pos[:, None, a] + arm * nh[a] for a in range(3)]
    react_f = -torch.stack([f.sum(0) for f in pf], dim=-1)
    react_tau = -torch.stack([t.sum(0) for t in _cross(p_c, pf)], dim=-1)
    return force, torque, (react_f, react_tau)
