"""The two sweeps of one APGD iteration of the NSC/DVI solve, on cell-sorted
bodies with single-sided multipliers.

Replaces the TPU kernels ``chrono_tpu/ops/pallas/nsc_half_kernel.py``
``nsc_half_sweep_u_pallas`` / ``nsc_half_sweep_g_pallas`` (on ``_call_half``)
and the two layouts that came before them, ``nsc_partner_kernel.py``
(``_call_sweep``) and ``nsc_pencil_kernel.py`` (``nsc_sweep_u_pallas``,
``nsc_sweep_g_pallas``): the same physics, which the JAX package's dense
reference (``chrono_tpu/solver/nsc_pencil.py`` ``dense_sweep_u``,
``dense_sweep_g``) defines term by term, without the TPU's pencils, code
matching and reaction window.

  U  ``nsc_sweep_u``: u = u_free + M⁻¹ Dᵀ y with y = γ + β(γ − γ_prev),
     (6, N) velocities and spins;
  G  ``nsc_sweep_g``: γ⁺ = Π_cone(y − s(D u − b)) with the per-row
     diagonal step s = ω / diag(N), (3, N, P) pair and (3, N, W) wall
     multipliers.

Each contact is stored once, on its owner (see ``ops.cuda.nsc_detect``), as
(γn, γu, γv) in the owner's frame (normal owner → partner).  The partner's
view of it is (γn, γu, −γv) with −n, −t1, t2, so its reaction on the
partner is −force and +torque.  U runs one thread per body over its owned
contacts, then the contacts that name it as partner (the reverse table),
then its walls; G one thread per row of its output, a contact's or a wall's.
Neither needs atomics, and each sums in a fixed order.

Within a step the positions and the rotbox poses stay fixed, so whether a
body lies within a wall's envelope is the step's constant.  U's first launch
of a step writes it as each body's wall mask (bit w for wall w); every later
launch takes only the walls in the mask.  The contact frames are rebuilt
from the positions in every launch: as per-step records they cost more to
read than to rebuild (PERF.md).  The mask holds geometry only: the dynamic
blade's spin, which changes every iteration, is read from ``cs``.

Walls and the per-body arrays: pos (3, N), u_free and u (6, N: v, ω),
partner table (N, P) int32, wall multipliers (3, N, W) in wall order.  The
rotbox poses ``cs`` (R, 3) float32 hold (cos θ, sin θ, ω) per rotbox wall
in wall order, on the device, so that a solver variable ω needs no host
sync.  With ``inv_Ib > 0`` (a dynamic blade) G adds ρ²/I_b to a rotbox
row's diagonal, ρ the contact's distance from the axis.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from chrono_tpu_torch.ops.cuda import _build
from chrono_tpu_torch.ops.cuda.nsc_detect import ReverseTable
from chrono_tpu_torch.ops.cuda.sph_substep import check_planes, overlaps
from chrono_tpu_torch.ops.nsc_pair import (
    KINDS, contact_rhs, cone_project, n_rotbox, pair_geometry, pair_velocity,
    tangents, wall_geometry, wall_mu,
)

MAX_WALLS = 8


@dataclass(frozen=True)
class NSCConsts:
    """Host-side constants of the sweeps (Python floats) and the walls."""

    radius: float
    inv_m: float
    inv_I: float
    envelope: float
    mu: float
    omega: float
    stab_over_h: float
    inv_h: float
    max_recovery: float
    inv_Ib: float
    walls: tuple

    @functools.cached_property
    def kernel_params(self) -> "_Params":
        """The kernels' argument struct, packed once."""
        return _kernel_params(self)


def wall_poses(c: NSCConsts, cs: torch.Tensor):
    """Per wall, its pose for ``wall_geometry``: the (cos θ, sin θ, ω) row
    of ``cs`` for a rotbox, None for the other kinds."""
    out, k = [], 0
    for wall in c.walls:
        if wall[0] == "rotbox":
            out.append(tuple(cs[k]))
            k += 1
        else:
            out.append(None)
    return out


# ------------------------------------------------------------ plain twins


def _pairs(pos, partners):
    """Owner and partner indices (N, P) int64 (the owner itself in an empty
    slot) and the mask of the filled slots."""
    n = partners.shape[0]
    valid = partners >= 0
    i = torch.arange(n, device=pos.device)[:, None].expand_as(partners)
    j = torch.where(valid, partners.long(), i)
    return i, j, valid


def _wall_rows(c: NSCConsts, pos, cs):
    """Per wall: (w, wall, nhat, gap, vsurf, ok, arm, t1, t2)."""
    px, py, pz = pos[0], pos[1], pos[2]
    for w, (wall, pose) in enumerate(zip(c.walls, wall_poses(c, cs))):
        nhat, gap, vsurf = wall_geometry(wall, px, py, pz, c.radius, pose)
        ok = (gap < c.envelope).to(pos.dtype)
        arm = c.radius + 0.5 * torch.clamp(gap, max=0.0)
        t1, t2 = tangents(*nhat)
        yield w, wall, nhat, gap, vsurf, ok, arm, t1, t2


def nsc_sweep_u_plain(pos, ufree, gam, gprev, wgam, wgprev, beta: float,
                      partners, cs, c: NSCConsts,
                      masks=None) -> torch.Tensor:
    """Twin of sweep U: the (6, N) u = u_free + M⁻¹ Dᵀ y.  With ``masks``
    (the wall masks that U reads) a wall's row counts only where the body's
    mask sets its bit, as in U reading them."""
    i, j, valid = _pairs(pos, partners)
    y = gam + beta * (gam - gprev)
    nhat, _, arm, t1, t2 = pair_geometry(pos[0][i], pos[1][i], pos[2][i],
                                         pos[0][j], pos[1][j], pos[2][j],
                                         c.radius)
    yn, yu, yv = y[0], y[1], y[2]
    zero = torch.zeros_like(yn)
    F = [torch.where(valid, yn * nhat[a] + yu * t1[a] + yv * t2[a], zero)
         for a in range(3)]
    T = [torch.where(valid, arm * (yv * t1[a] - yu * t2[a]), zero)
         for a in range(3)]
    f = torch.stack([-Fa.sum(1) for Fa in F])
    tau = torch.stack([Ta.sum(1) for Ta in T])
    # the partner's reaction: −force, +torque
    jj = j.reshape(-1)
    f.index_add_(1, jj, torch.stack([Fa.reshape(-1) for Fa in F]))
    tau.index_add_(1, jj, torch.stack([Ta.reshape(-1) for Ta in T]))
    yw = wgam + beta * (wgam - wgprev)
    for w, _, nh, _, _, ok, armw, wt1, wt2 in _wall_rows(c, pos, cs):
        if masks is not None:
            ok = ((masks >> w) & 1).to(pos.dtype)
        yn, yu, yv = yw[0, :, w], yw[1, :, w], yw[2, :, w]
        f = f + torch.stack([ok * -(yn * nh[a] + yu * wt1[a] + yv * wt2[a])
                             for a in range(3)])
        tau = tau + torch.stack([ok * armw * (yv * wt1[a] - yu * wt2[a])
                                 for a in range(3)])
    return torch.cat([ufree[0:3] + c.inv_m * f, ufree[3:6] + c.inv_I * tau])


def wall_masks_plain(pos, cs, c: NSCConsts) -> torch.Tensor:
    """Twin of U's wall masks: (N,) int32, bit w set where the body lies
    within the envelope of wall w."""
    masks = torch.zeros(pos.shape[1], dtype=torch.int32, device=pos.device)
    for w, *_, ok, _, _, _ in _wall_rows(c, pos, cs):
        masks |= (ok > 0).to(torch.int32) << w
    return masks


def nsc_sweep_g_plain(pos, u, gam, gprev, wgam, wgprev, beta: float,
                      partners, cs, c: NSCConsts):
    """Twin of sweep G: ``(γ⁺ (3, N, P), wγ⁺ (3, N, W))``."""
    i, j, valid = _pairs(pos, partners)
    y = gam + beta * (gam - gprev)
    nhat, gap, arm, t1, t2 = pair_geometry(pos[0][i], pos[1][i], pos[2][i],
                                           pos[0][j], pos[1][j], pos[2][j],
                                           c.radius)
    gn, gu, gv = pair_velocity(nhat, t1, t2, arm,
                               [u[a][i] for a in range(3)],
                               [u[a][j] for a in range(3)],
                               [u[3 + a][i] for a in range(3)],
                               [u[3 + a][j] for a in range(3)])
    bn = contact_rhs(gap, c.stab_over_h, c.inv_h, c.max_recovery)
    s = c.omega / (2.0 * c.inv_m + 2.0 * arm * arm * c.inv_I)
    pn, pu, pv = cone_project(y[0] - s * (gn - bn), y[1] - s * gu,
                              y[2] - s * gv, c.mu)
    zero = torch.zeros_like(pn)
    gout = torch.stack([torch.where(valid, q, zero) for q in (pn, pu, pv)])

    wout = torch.zeros_like(wgam)
    yw = wgam + beta * (wgam - wgprev)
    v0, w0 = [u[a] for a in range(3)], [u[3 + a] for a in range(3)]
    z3 = (torch.zeros_like(pos[0]),) * 3
    for w, wall, nh, gap, vs, ok, armw, wt1, wt2 in _wall_rows(c, pos, cs):
        gn, gu, gv = pair_velocity(nh, wt1, wt2, armw, v0, vs, w0, z3)
        bn = contact_rhs(gap, c.stab_over_h, c.inv_h, c.max_recovery)
        denom = c.inv_m + armw * armw * c.inv_I
        if wall[0] == "rotbox" and c.inv_Ib > 0.0:
            # the dynamic blade's rotational compliance joins the diagonal
            d3 = [pos[a] - wall[2][a] for a in range(3)]
            i1, i2 = ((1, 2), (2, 0), (0, 1))[wall[1]]
            denom = denom + (d3[i1] * d3[i1] + d3[i2] * d3[i2]) * c.inv_Ib
        s = c.omega / denom
        pn, pu, pv = cone_project(yw[0, :, w] - s * (gn - bn),
                                  yw[1, :, w] - s * gu, yw[2, :, w] - s * gv,
                                  wall_mu(wall))
        wout[:, :, w] = torch.stack([ok * pn, ok * pu, ok * pv])
    return gout, wout


# ---------------------------------------------------------------- kernels


class _Wall(ctypes.Structure):
    # a: plane normal | centre; off: plane offset | cylinder radius;
    # v: plane surface velocity | rotbox half extents; rb: rotbox index
    _fields_ = [("kind", ctypes.c_int), ("axis", ctypes.c_int),
                ("rb", ctypes.c_int), ("a", ctypes.c_float * 3),
                ("off", ctypes.c_float), ("v", ctypes.c_float * 3),
                ("spin", ctypes.c_float), ("mu", ctypes.c_float)]


class _Params(ctypes.Structure):
    _fields_ = ([(k, ctypes.c_float) for k in
                 ("radius", "inv_m", "inv_I", "envelope", "mu", "omega",
                  "stab_over_h", "inv_h", "max_recovery", "inv_Ib")]
                + [("n_walls", ctypes.c_int), ("walls", _Wall * MAX_WALLS)])


def _kernel_params(c: NSCConsts) -> _Params:
    if len(c.walls) > MAX_WALLS:
        raise ValueError(f"at most {MAX_WALLS} walls")
    k = _Params(c.radius, c.inv_m, c.inv_I, c.envelope, c.mu, c.omega,
                c.stab_over_h, c.inv_h, c.max_recovery, c.inv_Ib,
                len(c.walls))
    f3 = ctypes.c_float * 3
    rb = 0
    for b, wall in enumerate(c.walls):
        kind = KINDS.index(wall[0])
        if wall[0] == "plane":
            k.walls[b] = _Wall(kind, 0, -1, f3(*wall[1]), wall[2],
                               f3(*wall[3]), 0.0, wall_mu(wall))
        elif wall[0] == "cyl":
            k.walls[b] = _Wall(kind, wall[1], -1, f3(*wall[2]), wall[3],
                               f3(0.0, 0.0, 0.0), wall[4], wall_mu(wall))
        else:
            k.walls[b] = _Wall(kind, wall[1], rb, f3(*wall[2]), 0.0,
                               f3(*wall[3]), wall[4], wall_mu(wall))
            rb += 1
    return k


def _launcher(name: str):
    return _bind(name, _build.DEFINES)


@functools.cache
def _bind(name: str, defines: tuple):
    """The launcher of the build that ``_build.load`` returns under
    ``defines`` (the cache key: each build binds its own)."""
    fn = getattr(_build.load("nsc_sweep"), f"{name}_launch")
    n_ptr = {"nsc_sweep_u": 13, "nsc_sweep_g": 10}[name]
    mode = [ctypes.c_int] if name == "nsc_sweep_u" else []
    fn.argtypes = ([ctypes.c_void_p] * n_ptr
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_float] + mode
                   + [ctypes.POINTER(_Params), ctypes.c_void_p,
                      ctypes.c_int])
    fn.restype = ctypes.c_int
    return fn


def _check_int(label, t, size, dev):
    if (t.dtype != torch.int32 or not t.is_contiguous() or t.numel() != size
            or t.device != dev):
        raise ValueError(f"{label} must be contiguous int32 of {size} on "
                         f"{dev}")


def _check_overlaps(ins, outs):
    for k, (label, out) in enumerate(outs):
        if out.numel() and any(t.numel() and overlaps(t, out) for t in
                               ins + tuple(o for _, o in outs[:k])):
            raise ValueError(f"{label} overlaps another array: the sweeps "
                             "run out of place")


def _check(pos, u_in, gam, gprev, wgam, wgprev, partners, cs, c, outs,
           more_ins=(), more_outs=()):
    """Raise unless every array is contiguous, of its type and shape, on
    one device, and no output (``more_outs`` (label, tensor) too) overlaps
    an input (``more_ins`` too) or another output."""
    n, P = partners.shape
    W = len(c.walls)
    dev = pos.device
    check_planes("pos", pos, 3, n, dev)
    check_planes("u", u_in, 6, n, dev)
    arrays = (("gam", gam, (3, n, P)), ("gprev", gprev, (3, n, P)),
              ("wgam", wgam, (3, n, W)), ("wgprev", wgprev, (3, n, W)),
              ("cs", cs, (n_rotbox(c.walls), 3)))
    for label, t, shape in arrays + tuple(outs):
        if (t.dtype != torch.float32 or not t.is_contiguous()
                or tuple(t.shape) != shape or t.device != dev):
            raise ValueError(f"{label} must be contiguous float32 {shape} "
                             f"on {dev}")
    if (partners.dtype != torch.int32 or not partners.is_contiguous()
            or partners.device != dev):
        raise ValueError(f"partners must be contiguous int32 on {dev}")
    if n == 0 or P < 1 or 3 * n * max(P, W) >= 2 ** 31:
        raise ValueError(f"{n} bodies x {P} partners is outside the kernels' "
                         "range")
    _check_overlaps((pos, u_in, gam, gprev, wgam, wgprev, partners, cs)
                    + tuple(more_ins),
                    [(label, t) for label, t, _ in outs] + list(more_outs))


def nsc_sweep_u(pos, ufree, gam, gprev, wgam, wgprev, beta: float,
                partners, rev: ReverseTable, cs, c: NSCConsts,
                out: torch.Tensor, masks: torch.Tensor | None = None,
                write: bool = False) -> None:
    """Sweep U: out (6, N) ← u_free + M⁻¹ Dᵀ y.

    ``masks`` (N,) int32 are the step's wall masks: with ``write`` this
    launch tests every wall and writes them (a step's first launch),
    without it takes only the walls they hold, which must have been
    written from these positions and poses.  With no ``masks`` (a
    convenience for a single call outside a step, as in the tests) the
    launch allocates scratch masks and writes them, testing every wall.
    A CUDA tensor launches the kernel; a CPU tensor runs the twins."""
    n, P = partners.shape
    if masks is None:
        masks, write = torch.empty(n, dtype=torch.int32,
                                   device=pos.device), True
    if pos.device.type == "cuda":
        _check_int("masks", masks, n, pos.device)
        _check(pos, ufree, gam, gprev, wgam, wgprev, partners, cs, c,
               (("out", out, (6, n)),),
               more_ins=() if write else (masks,),
               more_outs=(("masks", masks),) if write else ())
        for label, t, size in (("rev.start", rev.start, n),
                               ("rev.count", rev.count, n),
                               ("rev.entry", rev.entry, n * P)):
            _check_int(label, t, size, pos.device)
        err = _launcher("nsc_sweep_u")(
            pos.data_ptr(), ufree.data_ptr(), gam.data_ptr(),
            gprev.data_ptr(), wgam.data_ptr(), wgprev.data_ptr(),
            partners.data_ptr(), rev.start.data_ptr(), rev.count.data_ptr(),
            rev.entry.data_ptr(), cs.data_ptr(), masks.data_ptr(),
            out.data_ptr(), n, P, beta, int(write),
            ctypes.byref(c.kernel_params),
            torch.cuda.current_stream(pos.device).cuda_stream,
            pos.device.index)
        if err != 0:
            raise RuntimeError(f"nsc_sweep_u launch failed: cudaError {err}")
        nsc_sweep_u.launches += 1
    elif pos.device.type == "cpu":
        if write:
            masks.copy_(wall_masks_plain(pos, cs, c))
            out.copy_(nsc_sweep_u_plain(pos, ufree, gam, gprev, wgam, wgprev,
                                        beta, partners, cs, c))
        else:
            out.copy_(nsc_sweep_u_plain(pos, ufree, gam, gprev, wgam, wgprev,
                                        beta, partners, cs, c, masks))
    else:
        raise ValueError(f"no nsc_sweep_u for device {pos.device}")


def nsc_sweep_g(pos, u, gam, gprev, wgam, wgprev, beta: float, partners,
                cs, c: NSCConsts, gout: torch.Tensor,
                wout: torch.Tensor) -> None:
    """Sweep G: gout (3, N, P), wout (3, N, W) ← the projected multipliers.
    A CUDA tensor launches the kernel; a CPU tensor runs the twin."""
    if pos.device.type == "cuda":
        n, P = partners.shape
        _check(pos, u, gam, gprev, wgam, wgprev, partners, cs, c,
               (("gout", gout, (3, n, P)),
                ("wout", wout, (3, n, len(c.walls)))))
        err = _launcher("nsc_sweep_g")(
            pos.data_ptr(), u.data_ptr(), gam.data_ptr(), gprev.data_ptr(),
            wgam.data_ptr(), wgprev.data_ptr(), partners.data_ptr(),
            cs.data_ptr(), gout.data_ptr(), wout.data_ptr(), n, P, beta,
            ctypes.byref(c.kernel_params),
            torch.cuda.current_stream(pos.device).cuda_stream,
            pos.device.index)
        if err != 0:
            raise RuntimeError(f"nsc_sweep_g launch failed: cudaError {err}")
        nsc_sweep_g.launches += 1
    elif pos.device.type == "cpu":
        g, w = nsc_sweep_g_plain(pos, u, gam, gprev, wgam, wgprev, beta,
                                 partners, cs, c)
        gout.copy_(g)
        wout.copy_(w)
    else:
        raise ValueError(f"no nsc_sweep_g for device {pos.device}")


nsc_sweep_u.launches = 0
nsc_sweep_g.launches = 0
