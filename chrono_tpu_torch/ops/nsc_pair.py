"""Per-contact NSC/DVI math: pair and wall geometry, the normal-row right-hand
side, the friction-cone projection and the constraint-space velocity.

Counterpart of the elementwise helpers of
``chrono_tpu/ops/pallas/nsc_pencil_kernel.py`` (``pair_geometry``,
``contact_rhs``, ``cone_project``, ``pair_velocity``, ``wall_geometry``) and
of the wall tangent basis (``chrono_tpu/solver/nsc_pencil.py``
``_wall_tangents``, ``nsc_partner_kernel.py`` ``_wall_tangent``).  Every
function is elementwise over tensors of one shape; parameters are Python
floats, except the rotbox pose ``cs``, whose entries may be 0-d tensors.
``csrc/nsc_pair.cuh`` holds the same math for the CUDA sweeps, and the
sweeps' plain twins are written with these functions.

Walls are the JAX package's tuples:

* ``("plane", (nx, ny, nz), offset, (vx, vy, vz), mu)``;
* ``("cyl", axis, (cx, cy, cz), R, spin, mu)``, the inner surface of a
  drum spinning about the world ``axis``;
* ``("rotbox", axis, (cx, cy, cz), (ha, hb, hc), spin, mu)``, a box
  rotating about the world ``axis`` through its centre; its pose is
  ``cs = (cos θ, sin θ)`` or, with a third entry, ``(cos θ, sin θ, ω)``,
  where ω replaces the wall's ``spin`` (the dynamic blade).
"""

from __future__ import annotations

import torch

KINDS = ("plane", "cyl", "rotbox")


def tangents(nx, ny, nz):
    """Tangent basis (t1, t2) of the normal n, branch-free: t1 = n × a /
    |n × a| with a = e_x where |n_x| < 0.9, else e_y, and t2 = n × t1.  It
    maps exactly under a side swap: t1(−n) = −t1(n), t2(−n) = t2(n)."""
    use_x = (torch.abs(nx) < 0.9).to(nx.dtype)
    t1x = (1.0 - use_x) * (-nz)
    t1y = use_x * nz
    t1z = use_x * (-ny) + (1.0 - use_x) * nx
    tn = torch.rsqrt(t1x * t1x + t1y * t1y + t1z * t1z + 1e-18)
    t1x, t1y, t1z = t1x * tn, t1y * tn, t1z * tn
    return (t1x, t1y, t1z), (ny * t1z - nz * t1y, nz * t1x - nx * t1z,
                             nx * t1y - ny * t1x)


def pair_geometry(spx, spy, spz, npx, npy, npz, radius):
    """Normal (self → neighbour), signed gap, lever arm and tangent basis
    of a sphere pair."""
    dx, dy, dz = npx - spx, npy - spy, npz - spz
    d2 = dx * dx + dy * dy + dz * dz
    inv = torch.rsqrt(d2 + 1e-18)
    gap = d2 * inv - 2.0 * radius
    arm = radius + 0.5 * torch.clamp(gap, max=0.0)
    nhat = (dx * inv, dy * inv, dz * inv)
    t1, t2 = tangents(*nhat)
    return nhat, gap, arm, t1, t2


def contact_rhs(gap, stab_over_h, inv_h, max_recovery):
    """Normal-row b_n: the clamped penetration recovery where gap < 0, the
    free approach up to the gap where gap > 0."""
    rec = torch.clamp(-stab_over_h * gap, max=max_recovery)
    return torch.where(gap < 0.0, rec, -inv_h * gap)


def cone_project(gn, gu, gv, mu):
    """Projection onto the friction cone (inside, polar cone, or onto its
    surface)."""
    tnorm = torch.sqrt(gu * gu + gv * gv + 1e-18)
    inside = (tnorm <= mu * gn).to(gn.dtype)
    polar = (mu * tnorm <= -gn).to(gn.dtype)
    gn_s = torch.clamp((tnorm * mu + gn) / (mu * mu + 1.0), min=0.0)
    scale_t = mu * gn_s / tnorm
    gn_new = inside * gn + (1.0 - inside) * (1.0 - polar) * gn_s
    ts = inside + (1.0 - inside) * (1.0 - polar) * scale_t
    return gn_new, gu * ts, gv * ts


def pair_velocity(nhat, t1, t2, arm, sv, nv, sw, nw):
    """(n·v_r, t1·v_r, t2·v_r) with v_r = v_nbr − v_self − arm (ω_self +
    ω_nbr) × n."""
    nx, ny, nz = nhat
    wsx, wsy, wsz = sw[0] + nw[0], sw[1] + nw[1], sw[2] + nw[2]
    vrx = nv[0] - sv[0] - arm * (wsy * nz - wsz * ny)
    vry = nv[1] - sv[1] - arm * (wsz * nx - wsx * nz)
    vrz = nv[2] - sv[2] - arm * (wsx * ny - wsy * nx)
    return (vrx * nx + vry * ny + vrz * nz,
            vrx * t1[0] + vry * t1[1] + vrz * t1[2],
            vrx * t2[0] + vry * t2[1] + vrz * t2[2])


def n_rotbox(walls) -> int:
    return sum(1 for w in walls if w[0] == "rotbox")


def wall_mu(wall) -> float:
    """A wall's friction coefficient: a plane's is its 5th entry, every
    other kind's its 6th."""
    return wall[4] if wall[0] == "plane" else wall[5]


def _rotbox(wall, px, py, pz, radius, cs):
    axis, (cx, cy, cz), (ha, hb, hc), spin = wall[1:5]
    if len(cs) == 3:
        cth, sth, spin = cs
    else:
        cth, sth = cs
    dx, dy, dz = px - cx, py - cy, pz - cz
    # permute so that the rotation axis is the local third component
    a1, a2, a3 = ((dy, dz, dx), (dz, dx, dy), (dx, dy, dz))[axis]
    u = cth * a1 + sth * a2                       # blade-frame coordinates
    v = -sth * a1 + cth * a2
    w = a3
    qu, qv, qw = torch.abs(u) - ha, torch.abs(v) - hb, torch.abs(w) - hc
    ou, ov, ow = (torch.clamp(q, min=0.0) for q in (qu, qv, qw))
    d_out = torch.sqrt(ou * ou + ov * ov + ow * ow + 1e-18)
    q_in = torch.clamp(torch.maximum(torch.maximum(qu, qv), qw), max=0.0)
    sdf = torch.where(q_in < 0.0, q_in, d_out)
    # outward normal in the blade frame: from the nearest surface point
    # outside, the face of least penetration inside (sign(0) = 0)
    is_out = (q_in >= 0.0).to(px.dtype)
    inv_do = 1.0 / d_out
    iu = ((qu >= qv) & (qu >= qw)).to(px.dtype)
    iv = ((qv > qu) & (qv >= qw)).to(px.dtype)
    iw = 1.0 - iu - iv
    su, sv, sw = torch.sign(u), torch.sign(v), torch.sign(w)
    nl_u = is_out * (su * ou * inv_do) + (1.0 - is_out) * (su * iu)
    nl_v = is_out * (sv * ov * inv_do) + (1.0 - is_out) * (sv * iv)
    nl_w = is_out * (sw * ow * inv_do) + (1.0 - is_out) * (sw * iw)
    n1 = cth * nl_u - sth * nl_v
    n2 = sth * nl_u + cth * nl_v
    n3 = nl_w
    # surface velocity spin · axis × (p − c), in the permuted frame
    s1, s2, s3 = -spin * a2, spin * a1, torch.zeros_like(px)
    order = ((2, 0, 1), (1, 2, 0), (0, 1, 2))[axis]
    nl, sl = (n1, n2, n3), (s1, s2, s3)
    n = tuple(nl[k] for k in order)
    s = tuple(sl[k] for k in order)
    # the contact normal points self → wall, against the outward normal
    return (-n[0], -n[1], -n[2]), sdf - radius, s


def wall_geometry(wall, px, py, pz, radius, cs=None):
    """Normal (self → wall), gap and surface velocity at the contact of a
    sphere with a wall."""
    kind = wall[0]
    if kind == "rotbox":
        return _rotbox(wall, px, py, pz, radius, cs)
    if kind == "plane":
        (wnx, wny, wnz), off, (vx, vy, vz) = wall[1], wall[2], wall[3]
        gap = wnx * px + wny * py + wnz * pz - off - radius
        return ((torch.full_like(px, -wnx), torch.full_like(px, -wny),
                 torch.full_like(px, -wnz)), gap,
                (torch.full_like(px, vx), torch.full_like(px, vy),
                 torch.full_like(px, vz)))
    if kind == "cyl":
        axis, (cx, cy, cz), R, spin = wall[1:5]
        r = [px - cx, py - cy, pz - cz]
        r[axis] = torch.zeros_like(px)
        d2 = r[0] * r[0] + r[1] * r[1] + r[2] * r[2]
        inv = torch.rsqrt(d2 + 1e-18)
        nx, ny, nz = r[0] * inv, r[1] * inv, r[2] * inv   # radial, outward
        gap = (R - d2 * inv) - radius
        z = torch.zeros_like(px)
        s = ((z, spin * R * (-nz), spin * R * ny),
             (spin * R * nz, z, spin * R * (-nx)),
             (spin * R * (-ny), spin * R * nx, z))[axis]
        return (nx, ny, nz), gap, s
    raise ValueError(f"unknown wall kind {kind!r}")
