"""NSC/DVI many-body stepper for scenes of uniform spheres (BASELINE config
#2: mixers, drums, hoppers).

Counterpart of ``chrono_tpu/solver/nsc_pencil.py`` (``NSCPencilParams``,
``theta_next``, ``wall_cs_list``, ``n_rotbox``, ``_reaction_from``,
``_blade_torque_fns``, ``make_nsc_pencil_advance``).  The name is kept so
that a reader finds the counterpart, but the layout is not pencils: one DVI
step bins the bodies by cell (a stable sort, ``fsi.sph.pencil.
bin_to_cells``), detects the contacts once (``ops.cuda.nsc_detect``), runs
``n_iter`` APGD iterations of sweeps U and G (``ops.cuda.nsc_sweep``) from a
cold start, a last U with β = 0, and then updates x explicitly.  The step's
first U writes each body's wall mask, which its later U launches read.  The JAX
package's backends choose TPU layouts (``backend``, ``Bxy``, ``interpret``);
this port has one.

APGD: Nesterov's recurrence on the multipliers with a per-row diagonal step
s = ω / diag(N).  The θ/β sequence depends on nothing but ``n_iter`` and
``restart_every``, so it is computed once on the host, in float32 as the
JAX package computes it, and the loop never waits for the device.  A rotbox
wall's pose (cos θ, sin θ) and spin ω live in a small device tensor; in the
dynamic-blade mode (``blade_inertia > 0``) ω is a solver variable that each
iteration updates from the wall multipliers by a device reduction.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from chrono_tpu_torch.collision.cell_list import GridSpec, refuse_periodic
from chrono_tpu_torch.fsi.sph.pencil import bin_to_cells
from chrono_tpu_torch.ops.cuda.nsc_detect import (
    DetectConsts, nsc_detect, reverse_table,
)
from chrono_tpu_torch.ops.cuda.nsc_sweep import (
    MAX_WALLS, NSCConsts, nsc_sweep_g, nsc_sweep_u,
)
from chrono_tpu_torch.ops.nsc_pair import (
    n_rotbox, tangents, wall_geometry,
)

_F32 = np.float32


@dataclass(frozen=True)
class NSCPencilParams:
    """Parameters of the uniform-sphere NSC scene (the JAX package's fields
    and defaults)."""

    radius: float = 0.01
    mass: float = 1.0
    mu: float = 0.3
    gravity: tuple = (0.0, 0.0, -9.81)
    dt: float = 1e-3
    envelope: float = 0.0          # detection margin (m)
    stab_factor: float = 0.2
    max_recovery: float = 0.5
    omega: float = 0.3             # relaxation safety factor
    n_iter: int = 50
    restart_every: int = 0         # Nesterov θ reset period (0 = off)
    track_residual: bool = False   # per-iteration ‖Δγ‖ of the last step
    # per-wall (force, torque about the wall centre) from the last step's
    # final wall multipliers: an ideal speed motor's reaction torque
    track_wall_reactions: bool = False
    # > 0 makes every rotbox wall's spin a solver variable (a revolute joint
    # to ground in reduced coordinates) driven by blade_torque
    blade_inertia: float = 0.0
    blade_torque: float = 0.0

    @property
    def inertia(self) -> float:
        return 0.4 * self.mass * self.radius * self.radius

    def replace(self, **kw) -> "NSCPencilParams":
        return replace(self, **kw)


def nsc_static_params(p: NSCPencilParams, walls) -> NSCConsts:
    """The sweeps' constants from the parameters and the walls."""
    return NSCConsts(
        radius=p.radius, inv_m=1.0 / p.mass, inv_I=1.0 / p.inertia,
        envelope=p.envelope, mu=p.mu, omega=p.omega,
        stab_over_h=p.stab_factor / p.dt, inv_h=1.0 / p.dt,
        max_recovery=p.max_recovery,
        inv_Ib=1.0 / p.blade_inertia if p.blade_inertia > 0 else 0.0,
        walls=tuple(walls))


def theta_next(theta):
    """Nesterov's θ recurrence, in the type of ``theta`` (float32 numpy
    scalars on the host)."""
    return _F32(0.5) * (-theta * theta
                        + theta * np.sqrt(theta * theta + _F32(4.0)))


def beta_sequence(n_iter: int, restart_every: int = 0) -> np.ndarray:
    """(n_iter,) float32: the β each APGD iteration extrapolates with (0 in
    the first), with θ reset to 1 every ``restart_every`` iterations."""
    theta, beta = _F32(1.0), _F32(0.0)
    out = np.empty((n_iter,), np.float32)
    for k in range(n_iter):
        out[k] = beta
        if restart_every and k > 0 and k % restart_every == 0:
            theta = _F32(1.0)
        th_n = theta_next(theta)
        beta = theta * (_F32(1.0) - theta) / (theta * theta + th_n)
        theta = th_n
    return out


def wall_cs_list(walls, theta):
    """Per wall, a rotbox's pose (cos θ, sin θ) as 0-d tensors, None for
    the other kinds; ``theta`` (n_rotbox,) in wall order."""
    out, k = [], 0
    for wall in walls:
        if wall[0] == "rotbox":
            out.append((torch.cos(theta[k]), torch.sin(theta[k])))
            k += 1
        else:
            out.append(None)
    return out


def _wall_center(wall):
    return (0.0, 0.0, 0.0) if wall[0] == "plane" else wall[2]


def _wall_contact(p, wall, px, py, pz, cs):
    """A wall's contact rows at the bodies: ``(ok, (n, t1, t2), r)``, with
    ``r`` the contact point relative to the wall centre."""
    nhat, gap, _ = wall_geometry(wall, px, py, pz, p.radius, cs)
    ok = (gap < p.envelope).to(px.dtype)
    arm = p.radius + 0.5 * torch.clamp(gap, max=0.0)
    c = _wall_center(wall)
    r = [(px, py, pz)[a] + arm * nhat[a] - c[a] for a in range(3)]
    return ok, (nhat, *tangents(*nhat)), r


def _impulse(ok, rows, yn, yu, yv):
    """ok · (γn n + γu t1 + γv t2), per component."""
    nhat, t1, t2 = rows
    return [ok * (yn * nhat[a] + yu * t1[a] + yv * t2[a]) for a in range(3)]


def _reaction_from(p, wall, px, py, pz, yn, yu, yv, cs):
    """A wall's total (force (3,), torque (3,) about its centre) from the
    final contact impulses γ: force = γ/dt, and the reaction on the wall is
    the opposite of the force on the bodies."""
    ok, rows, r = _wall_contact(p, wall, px, py, pz, cs)
    f = _impulse(ok * (1.0 / p.dt), rows, yn, yu, yv)
    tq = (r[1] * f[2] - r[2] * f[1], r[2] * f[0] - r[0] * f[2],
          r[0] * f[1] - r[1] * f[0])
    return (torch.stack([x.sum() for x in f]),
            torch.stack([x.sum() for x in tq]))


def wall_reactions(p, walls, pos, wgam, cs_list):
    """(force (W, 3), torque (W, 3)) of every wall from (3, N) positions
    and (3, N, W) wall multipliers."""
    out = [_reaction_from(p, wall, pos[0], pos[1], pos[2], wgam[0, :, w],
                          wgam[1, :, w], wgam[2, :, w], cs_list[w])
           for w, wall in enumerate(walls)]
    return (torch.stack([f for f, _ in out]),
            torch.stack([t for _, t in out]))


def _blade_torque_fns(p, walls, px, py, pz, cs_list):
    """Per rotbox wall, ``(w, tau(yn, yu, yv))``: the angular impulse about
    the rotation axis from the wall multipliers (the reaction on the blade,
    +γ along the rows), with the contact geometry taken once at the step's
    pose (θ is fixed within a step)."""
    fns = []
    for w, wall in enumerate(walls):
        if wall[0] != "rotbox":
            continue
        ok, rows, r = _wall_contact(p, wall, px, py, pz, cs_list[w])
        i1, i2 = ((1, 2), (2, 0), (0, 1))[wall[1]]

        def tau(yn, yu, yv, ok=ok, rows=rows, r=r, i1=i1, i2=i2):
            f = _impulse(ok, rows, yn, yu, yv)
            return torch.sum(r[i1] * f[i2] - r[i2] * f[i1])

        fns.append((w, tau))
    return fns


def make_nsc_pencil_advance(p: NSCPencilParams, grid: GridSpec, walls,
                            capacity: int = 8, partners: int = 12, *,
                            device):
    """``advance(pos, vel, omega, n_steps, theta0=None, wspin0=None) →
    (pos, vel, omega, ovf) + extras``, on ``device``.

    ``ovf`` () int32 is the largest capacity excess over the call: a cell's
    bodies beyond ``capacity``, or an owner's contacts beyond ``partners``.
    This port drops neither (the JAX package drops bodies past the capacity
    and contacts past the budget), so its results match the JAX package's
    only where ``ovf`` is 0.  Extras, in order: the last step's per-
    iteration ‖Δγ‖ with ``track_residual`` (each contact counted once);
    the last step's wall (force, torque) with ``track_wall_reactions``;
    the rotbox spins in the dynamic-blade mode.  ``theta0`` sets the
    rotbox poses (0 by default), ``wspin0`` the dynamic spins (the walls'
    ``spin`` by default).  The cells must be at least 2r + envelope wide
    for the 27-cell stencil to see every contact, as in the JAX package.
    """
    refuse_periodic(grid, "the NSC pencil")
    walls = tuple(walls)
    if len(walls) > MAX_WALLS:
        raise ValueError(f"at most {MAX_WALLS} walls")
    if partners < 1:
        raise ValueError("partners must be at least 1")
    c = nsc_static_params(p, walls)
    dc = DetectConsts.of(p.radius, p.envelope)
    R = n_rotbox(walls)
    dyn = p.blade_inertia > 0.0
    if dyn and not R:
        raise ValueError("blade_inertia set but no rotbox walls")
    betas = [float(b) for b in beta_sequence(p.n_iter, p.restart_every)]
    f32 = dict(dtype=torch.float32, device=device)
    spins = torch.tensor([w[4] for w in walls if w[0] == "rotbox"], **f32)
    gvec = torch.tensor(p.gravity, **f32)
    W = len(walls)

    def solve(pos_s, ufree, cells, cs, poses, ws_free, track):
        """The APGD iterations and the final U of one step: ``(u, partner
        overflow, wall multipliers, ws, Δγ series)``; ``poses`` is
        :func:`wall_cs_list` at the step's pose."""
        n = pos_s.shape[1]
        part, count = nsc_detect(pos_s, cells, partners, dc)
        pov = torch.clamp(count.max() - partners, min=0).to(torch.int32)
        rev = reverse_table(part)
        gam, gprev, gfree = (torch.zeros((3, n, partners), **f32)
                             for _ in range(3))
        wgam, wgprev, wfree = (torch.zeros((3, n, W), **f32)
                               for _ in range(3))
        u = torch.empty((6, n), **f32)
        # the step's wall masks: U's first launch writes them, every later
        # one reads them
        masks = torch.empty((n,), dtype=torch.int32, device=device)
        ws = None
        if dyn:
            tq_fns = _blade_torque_fns(p, walls, pos_s[0], pos_s[1],
                                       pos_s[2], poses)
            ws = ws_free.clone()
        dgam = []
        for k in range(p.n_iter):
            nsc_sweep_u(pos_s, ufree, gam, gprev, wgam, wgprev, betas[k],
                        part, rev, cs, c, u, masks, write=k == 0)
            nsc_sweep_g(pos_s, u, gam, gprev, wgam, wgprev, betas[k], part,
                        cs, c, gfree, wfree)
            if track:
                dgam.append(torch.sqrt(((gfree - gam) ** 2).sum()
                                       + ((wfree - wgam) ** 2).sum()))
            if dyn:
                # the blade spin from the fresh wall impulses, under-relaxed
                taus = torch.stack([fn(wfree[0, :, w], wfree[1, :, w],
                                       wfree[2, :, w]) for w, fn in tq_fns])
                ws = 0.5 * ws + 0.5 * (ws_free + taus / p.blade_inertia)
                cs[:, 2] = ws
            gam, gprev, gfree = gfree, gam, gprev
            wgam, wgprev, wfree = wfree, wgam, wgprev
        nsc_sweep_u(pos_s, ufree, gam, gam, wgam, wgam, 0.0, part, rev, cs,
                    c, u, masks, write=p.n_iter == 0)
        return u, pov, wgam, ws, dgam

    def step(pos, vel, omega, theta, wspin, last):
        ufree_v = vel + p.dt * gvec
        order, cells, ovf = bin_to_cells(grid, capacity, pos)
        pos_s = pos[order].T.contiguous()
        ufree = torch.cat([ufree_v[order].T, omega[order].T]).contiguous()
        ws_free = (wspin + p.dt * p.blade_torque / p.blade_inertia
                   if dyn else None)
        poses = wall_cs_list(walls, theta)
        cs = torch.stack([torch.cos(theta), torch.sin(theta),
                          ws_free if dyn else spins], 1).contiguous()
        u, pov, wgam, ws, dgam = solve(pos_s, ufree, cells, cs, poses,
                                       ws_free, last and p.track_residual)
        vel2 = torch.empty_like(vel)
        om2 = torch.empty_like(omega)
        vel2[order] = u[0:3].T
        om2[order] = u[3:6].T
        pos2 = pos + p.dt * vel2
        theta2 = theta + p.dt * (ws if dyn else spins)
        reac = None
        if last and p.track_wall_reactions:
            reac = wall_reactions(p, walls, pos_s, wgam, poses)
        extras = (torch.stack(dgam) if dgam else None, reac)
        return (pos2, vel2, om2, theta2, ws if dyn else wspin,
                torch.maximum(ovf, pov), extras)

    def advance(pos, vel, omega, n_steps: int, theta0=None, wspin0=None):
        pos, vel, omega = (torch.as_tensor(a, **f32)
                           for a in (pos, vel, omega))
        theta = (torch.zeros((R,), **f32) if theta0 is None
                 else torch.as_tensor(theta0, **f32).reshape(R))
        wspin = (spins if wspin0 is None
                 else torch.as_tensor(wspin0, **f32).reshape(R))
        ovf = torch.zeros((), dtype=torch.int32, device=device)
        dgam = reac = None
        for s in range(n_steps):
            pos, vel, omega, theta, wspin, ov, (dg, rc) = step(
                pos, vel, omega, theta, wspin, s == n_steps - 1)
            ovf = torch.maximum(ovf, ov)
            dgam, reac = (dg, rc) if s == n_steps - 1 else (dgam, reac)
        extras = ()
        if p.track_residual:
            extras += (dgam,)
        if p.track_wall_reactions:
            extras += (reac,)
        if dyn:
            extras += (wspin,)
        return (pos, vel, omega, ovf) + extras

    return advance

