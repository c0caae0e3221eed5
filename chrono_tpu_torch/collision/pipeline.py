"""Collision model + NSC contact pipeline for the multibody system.

Counterpart of ``chrono_tpu/collision/pipeline.py``: collision shapes are
batched tensors attached to bodies; detection emits a fixed-capacity masked
``Contacts`` buffer; contacts lower to cone-constrained triples appended to
the bilateral rows and solved in the same VI (``nsc_step``).

Every pair kind of the JAX package: sphere–sphere through the cell-slot
feature table, sphere–box dense, general convex shapes through the MPR
narrowphase (``collision/mpr.py``: convex–convex on the dense ``i < j``
pairs, convex–sphere on every sphere and shape), triangle meshes against
spheres (closed form) and convex shapes (``mpr.convex_triangle``), dense
or on the ``mesh_candidates`` nearest triangles, and rolling friction.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import Tensor

from chrono_tpu_torch.collision import narrowphase as nphase
from chrono_tpu_torch.collision.mpr import (
    SPHERE as _MPR_SPHERE, ConvexShape, convex_triangle, mpr_contact,
)
from chrono_tpu_torch.collision.cell_list import (
    GridSpec, build_feature_table, cell_ijk, neighbor_feature_rows,
    refuse_periodic, topk_select,
)
from chrono_tpu_torch.core import quaternion as Q
from chrono_tpu_torch.physics.body import BodyState
from chrono_tpu_torch.physics.constraints import ConstraintRows, concat_rows
from chrono_tpu_torch.utils.device import resolve_device
from chrono_tpu_torch.utils.tree import tensor_dataclass


def _cross(a: Tensor, b: Tensor) -> Tensor:
    return torch.linalg.cross(*torch.broadcast_tensors(a, b), dim=-1)


@tensor_dataclass
class SphereShapes:
    """S collision spheres attached to bodies (body-local offsets)."""

    body: Tensor     # (S,) int32
    offset: Tensor   # (S, 3) local
    radius: Tensor   # (S,)
    mu: Tensor       # (S,) friction coefficient of the shape's material

    @property
    def n(self) -> int:
        return self.body.shape[0]


@tensor_dataclass
class BoxShapes:
    """B collision boxes attached to bodies (walls, bins, paddles...)."""

    body: Tensor     # (B,) int32
    pos: Tensor      # (B, 3) local frame origin
    rot: Tensor      # (B, 4) local frame rotation
    half: Tensor     # (B, 3) half extents
    mu: Tensor       # (B,)

    @property
    def n(self) -> int:
        return self.body.shape[0]


@tensor_dataclass
class ConvexShapes:
    """K general convex shapes attached to bodies (MPR narrowphase);
    ``kind`` / ``data`` / ``verts`` follow ``collision.mpr.ConvexShape``."""

    body: Tensor     # (K,) int32
    kind: Tensor     # (K,) int32 mpr type code
    pos: Tensor      # (K, 3) local offset
    rot: Tensor      # (K, 4) local rotation
    data: Tensor     # (K, 3) sized parameters
    verts: Tensor    # (K, V, 3) local hull vertices (zeros for non-hulls)
    mu: Tensor       # (K,)
    family: Tensor = None  # (K,) int32 — shapes sharing a family > 0 never
    #                        collide with each other (collision families)

    @property
    def n(self) -> int:
        return self.body.shape[0]


@tensor_dataclass
class MeshShapes:
    """T collision triangles attached to bodies (triangle soup, body-local
    vertices re-posed each step)."""

    body: Tensor     # (T,) int32
    v0: Tensor       # (T, 3) local vertices
    v1: Tensor       # (T, 3)
    v2: Tensor       # (T, 3)
    mu: Tensor       # (T,)

    @property
    def n(self) -> int:
        return self.body.shape[0]

    @staticmethod
    def from_mesh(body: int, verts, faces, mu: float = 0.5, device=None):
        """Build from a (V,3) vertex array + (T,3) face index array, on the
        card unless ``device`` says otherwise."""
        device = resolve_device(device, "MeshShapes.from_mesh")
        verts = np.asarray(verts, np.float32)
        faces = np.asarray(faces, np.int32)
        T = faces.shape[0]

        def t(a):
            return torch.as_tensor(np.ascontiguousarray(a), device=device)

        return MeshShapes(
            body=torch.full((T,), body, dtype=torch.int32, device=device),
            v0=t(verts[faces[:, 0]]), v1=t(verts[faces[:, 1]]),
            v2=t(verts[faces[:, 2]]),
            mu=torch.full((T,), mu, dtype=torch.float32, device=device))


@tensor_dataclass
class CollisionModel:
    """All collision geometry of a scene + the pipeline's capacities."""

    spheres: SphereShapes
    boxes: Optional[BoxShapes]
    convex: Optional[ConvexShapes] = None
    meshes: Optional[MeshShapes] = None
    grid: GridSpec = GridSpec()
    max_per_cell: int = 8
    max_contacts: int = 1024
    envelope: float = 0.0            # detection margin
    # scene-level rolling/spinning friction coefficients (length units:
    # torque limit = μ·γ_n); non-zero → 3 extra rolling rows per contact
    mu_roll: float = 0.0
    mu_spin: float = 0.0
    # mesh narrowphase candidate pruning: 0 = dense S×T / K×T pairs; >0 =
    # the mesh_candidates nearest triangles a sphere or convex shape by
    # bounding-sphere score
    mesh_candidates: int = 0

    def __post_init__(self):
        refuse_periodic(self.grid, "the contact pipeline")

    @property
    def use_rolling(self) -> bool:
        return self.mu_roll > 0.0 or self.mu_spin > 0.0


class Contacts(NamedTuple):
    """Fixed-capacity contact manifold (masked)."""

    body_a: Tensor   # (C,) int32
    body_b: Tensor   # (C,) int32
    point: Tensor    # (C, 3) world
    normal: Tensor   # (C, 3) world, A→B
    gap: Tensor      # (C,) signed (<0 penetrating)
    mu: Tensor       # (C,) combined friction
    r_eff: Tensor    # (C,) effective curvature radius (SMC penalty models)
    active: Tensor   # (C,) bool
    count: Tensor    # () int32 — true number found (may exceed capacity)


#: effective contact-curvature radius used when shapes give none
DEFAULT_EFF_RADIUS = 0.1


def _sphere_world(shapes: SphereShapes, state: BodyState) -> Tensor:
    b = shapes.body.long()
    return state.x[b] + Q.qrotate(state.q[b], shapes.offset)


def _convex_world(cv: ConvexShapes, state: BodyState) -> ConvexShape:
    """The convex shapes posed in the world by their bodies."""
    b = cv.body.long()
    return ConvexShape(kind=cv.kind,
                       pos=state.x[b] + Q.qrotate(state.q[b], cv.pos),
                       rot=Q.qmul(state.q[b], cv.rot), data=cv.data,
                       verts=cv.verts)


def detect_contacts(coll: CollisionModel, state: BodyState) -> Contacts:
    """Broadphase (uniform grid) + narrowphase → masked contact buffer.

    Sphere–sphere through the cell-slot feature table, sphere–box dense,
    convex–convex (dense ``i < j``, families respected) and convex–sphere
    through MPR, then sphere–triangle and convex–triangle dense or on the
    ``mesh_candidates`` nearest triangles; friction combined by the minimum
    rule.  Each segment packs its candidates as 11-channel rows ``[gap,
    n(3), p(3), mu, r_eff, body_a, body_b]`` and one stable sort keeps the
    first ``max_contacts`` valid ones, in the JAX package's segment order
    (``topk_select``).

    Float-coded indices: the feature rows and the packed rows carry body
    and sphere indices as channels of the state's float type, as the JAX
    package's do; in float32 they are exact below 2^24 bodies and spheres.
    """
    sp = coll.spheres
    S = sp.n
    dt = state.x.dtype
    centers = _sphere_world(sp, state)                     # (S,3)
    segs_pack, segs_ok = [], []

    def pack(ok, a, b, gap, n, p, mu, r_eff):
        rows = torch.stack([
            gap, n[..., 0], n[..., 1], n[..., 2],
            p[..., 0], p[..., 1], p[..., 2], mu,
            torch.broadcast_to(r_eff, gap.shape),
            torch.broadcast_to(a, gap.shape).to(gap.dtype),
            torch.broadcast_to(b, gap.shape).to(gap.dtype)], dim=-1)
        segs_pack.append(rows.reshape(-1, 11))
        segs_ok.append(ok.reshape(-1))

    if S > 0:
        # channels: [x, y, z, radius, mu, body, index, valid]
        feat = torch.stack([
            centers[:, 0], centers[:, 1], centers[:, 2],
            sp.radius, sp.mu, sp.body.to(dt),
            torch.arange(S, dtype=dt, device=centers.device),
            torch.ones((S,), dtype=dt, device=centers.device),
        ], dim=1)
        # the table's overflow flag is dropped, as the JAX package drops it
        table, _ovf = build_feature_table(coll.grid, centers, feat,
                                          coll.max_per_cell)
        qijk = cell_ijk(coll.grid, centers)
        nf, in_range = neighbor_feature_rows(coll.grid, table, qijk,
                                             coll.max_per_cell, 8)
        # neighbour channels (S, 27, K); own quantities broadcast (S, 1, 1)
        cb = nf[..., 0:3]
        ca = centers[:, None, None, :]
        gap, n, p = nphase.sphere_sphere(ca, sp.radius[:, None, None], cb,
                                         nf[..., 3])
        i_f = torch.arange(S, dtype=dt,
                           device=centers.device)[:, None, None]
        body_f = sp.body.to(dt)[:, None, None]
        pair_ok = ((nf[..., 7] > 0.0) & in_range[..., None]
                   & (nf[..., 6] > i_f)                    # dedupe i<j
                   & (nf[..., 5] != body_f)                # no self-body
                   & (gap < coll.envelope))
        ra_ = sp.radius[:, None, None]
        rb_ = nf[..., 3]
        pack(pair_ok, body_f, nf[..., 5], gap, n, p,
             torch.minimum(sp.mu[:, None, None], nf[..., 4]),
             ra_ * rb_ / torch.clamp_min(ra_ + rb_, 1e-30))

    # sphere–box dense pairs
    if S > 0 and coll.boxes is not None and coll.boxes.n > 0:
        bx = coll.boxes
        bb = bx.body.long()
        bpos = state.x[bb] + Q.qrotate(state.q[bb], bx.pos)
        brot = Q.qmul(state.q[bb], bx.rot)
        gap_b, n_b, p_b = nphase.sphere_box(
            centers[:, None, :], sp.radius[:, None],
            bpos[None, :, :], brot[None, :, :], bx.half[None, :, :])
        sb_ok = (gap_b < coll.envelope) & (sp.body[:, None]
                                           != bx.body[None, :])
        pack(sb_ok, sp.body[:, None], bx.body[None, :], gap_b, n_b, p_b,
             torch.minimum(sp.mu[:, None], bx.mu[None, :]),
             sp.radius[:, None])

    # general convex shapes via MPR: convex–convex (dense i<j) and
    # convex–sphere
    if coll.convex is not None and coll.convex.n > 0:
        cv = coll.convex
        K = cv.n
        world = _convex_world(cv, state)
        dev = centers.device
        if K > 1:
            iu, ju = torch.triu_indices(K, K, 1, device=dev)
            gap_cc, n_cc, p_cc = mpr_contact(
                ConvexShape(*(x[iu] for x in world)),
                ConvexShape(*(x[ju] for x in world)))
            cc_ok = (gap_cc < min(coll.envelope, 0.0)) & (cv.body[iu]
                                                          != cv.body[ju])
            if cv.family is not None:
                fam = cv.family
                cc_ok &= ~((fam[iu] == fam[ju]) & (fam[iu] > 0))
            pack(cc_ok, cv.body[iu], cv.body[ju], gap_cc, n_cc, p_cc,
                 torch.minimum(cv.mu[iu], cv.mu[ju]),
                 torch.full_like(gap_cc, DEFAULT_EFF_RADIUS))
        if S > 0:
            ii = torch.arange(S, device=dev)[:, None].expand(S, K).reshape(-1)
            jj = torch.arange(K, device=dev)[None, :].expand(S, K).reshape(-1)
            zero = torch.zeros_like(sp.radius[ii])
            sph = ConvexShape(
                kind=torch.full((S * K,), _MPR_SPHERE, dtype=torch.int32,
                                device=dev),
                pos=centers[ii],
                rot=Q.qidentity((S * K,), dtype=dt, device=dev),
                data=torch.stack([sp.radius[ii], zero, zero], -1),
                verts=torch.zeros((S * K,) + tuple(cv.verts.shape[1:]),
                                  dtype=dt, device=dev))
            gap_sc, n_sc, p_sc = mpr_contact(
                sph, ConvexShape(*(x[jj] for x in world)))
            sc_ok = (gap_sc < min(coll.envelope, 0.0)) & (sp.body[ii]
                                                          != cv.body[jj])
            pack(sc_ok, sp.body[ii], cv.body[jj], gap_sc, n_sc, p_sc,
                 torch.minimum(sp.mu[ii], cv.mu[jj]), sp.radius[ii])

    # triangle-mesh shapes: sphere–triangle closed form, convex–triangle
    # through the support-plane narrowphase
    if coll.meshes is not None and coll.meshes.n > 0:
        ms = coll.meshes
        T = ms.n
        mb = ms.body.long()
        w0 = state.x[mb] + Q.qrotate(state.q[mb], ms.v0)   # (T,3) world
        w1 = state.x[mb] + Q.qrotate(state.q[mb], ms.v1)
        w2 = state.x[mb] + Q.qrotate(state.q[mb], ms.v2)
        cen_t = (w0 + w1 + w2) / 3.0
        rad_t = torch.sqrt(torch.maximum(torch.maximum(
            torch.sum((w0 - cen_t) ** 2, dim=1),
            torch.sum((w1 - cen_t) ** 2, dim=1)),
            torch.sum((w2 - cen_t) ** 2, dim=1)))
        Kc = coll.mesh_candidates
        if S > 0 and Kc and Kc < T:
            # bounding-sphere scored candidates: the exact narrowphase on
            # the Kc nearest triangles a sphere, nearest first (a stable
            # sort: equal scores in triangle order, as lax.top_k keeps them)
            d2 = torch.sum((centers[:, None, :] - cen_t[None]) ** 2, dim=2)
            score = d2 - (rad_t[None] + sp.radius[:, None]
                          + coll.envelope) ** 2
            tidx = torch.sort(score, dim=1, stable=True).indices[:, :Kc]
            gap_t, n_t, p_t = nphase.sphere_triangle(
                centers[:, None, :], sp.radius[:, None],
                w0[tidx], w1[tidx], w2[tidx])              # (S, Kc)
            st_ok = (gap_t < coll.envelope) & (sp.body[:, None]
                                               != ms.body[tidx])
            pack(st_ok, sp.body[:, None], ms.body[tidx], gap_t, n_t, p_t,
                 torch.minimum(sp.mu[:, None], ms.mu[tidx]),
                 sp.radius[:, None])
        elif S > 0:
            gap_t, n_t, p_t = nphase.sphere_triangle(
                centers[:, None, :], sp.radius[:, None],
                w0[None], w1[None], w2[None])              # (S, T)
            st_ok = (gap_t < coll.envelope) & (sp.body[:, None]
                                               != ms.body[None, :])
            pack(st_ok, sp.body[:, None], ms.body[None, :], gap_t, n_t,
                 p_t, torch.minimum(sp.mu[:, None], ms.mu[None, :]),
                 sp.radius[:, None])
        if coll.convex is not None and coll.convex.n > 0:
            # support-plane narrowphase (mpr.convex_triangle), not MPR: the
            # portal depth along MPR's interior ray overestimates shallow
            # penetrations against off-center triangles
            cv = coll.convex
            K = cv.n
            world = _convex_world(cv, state)
            dev = centers.device
            if Kc and Kc < T:
                # the same pruning: the shape's bounding radius from its
                # data and vertices (a coarse upper bound)
                r_cv = torch.maximum(
                    torch.sqrt(torch.sum(cv.data ** 2, dim=1)),
                    torch.sqrt(torch.amax(torch.sum(cv.verts ** 2, dim=2),
                                          dim=1)))
                d2c = torch.sum((world.pos[:, None, :] - cen_t[None]) ** 2,
                                dim=2)
                scc = d2c - (rad_t[None] + r_cv[:, None]
                             + coll.envelope) ** 2
                tjj = torch.sort(scc, dim=1, stable=True).indices[:, :Kc]
                ii = torch.arange(K, device=dev)[:, None].expand(
                    K, Kc).reshape(-1)
                jj = tjj.reshape(-1)
            else:
                ii = torch.arange(K, device=dev)[:, None].expand(
                    K, T).reshape(-1)
                jj = torch.arange(T, device=dev)[None, :].expand(
                    K, T).reshape(-1)
            # (pairs, 5) manifold points: the perturbed-support face
            # manifold and the edge fallback
            gap_ct, n_ct, p_ct, ok_m = convex_triangle(
                ConvexShape(*(x[ii] for x in world)), w0[jj], w1[jj],
                w2[jj])
            ct_ok = (ok_m & (gap_ct < coll.envelope)
                     & (cv.body[ii] != ms.body[jj])[:, None])
            pack(ct_ok, cv.body[ii][:, None], ms.body[jj][:, None], gap_ct,
                 n_ct, p_ct, torch.broadcast_to(
                     torch.minimum(cv.mu[ii], ms.mu[jj])[:, None],
                     gap_ct.shape),
                 torch.full_like(gap_ct, DEFAULT_EFF_RADIUS))

    if not segs_ok:
        # geometry-free scene (contacts supplied entirely through
        # extra_contacts_fn): one inactive dummy row with a UNIT normal (a
        # zero normal NaNs the tangent basis even on inactive rows)
        dummy = torch.zeros((1, 11), dtype=dt, device=state.x.device)
        dummy[0, 0] = 1.0        # gap = +1 (separated)
        dummy[0, 3] = 1.0        # normal = +z
        segs_ok = [torch.zeros((1,), dtype=torch.bool,
                               device=state.x.device)]
        segs_pack = [dummy]
    all_ok = torch.cat(segs_ok)
    all_rows = torch.cat(segs_pack, dim=0)                 # (n_tot, 11)
    sel, active, count = topk_select(all_ok, coll.max_contacts)
    got = all_rows[sel]                                    # one row gather
    return Contacts(
        body_a=got[:, 9].to(torch.int32), body_b=got[:, 10].to(torch.int32),
        point=got[:, 4:7], normal=got[:, 1:4], gap=got[:, 0],
        mu=got[:, 7], r_eff=got[:, 8], active=active, count=count)


def _tangent_basis(n: Tensor):
    """Robust orthonormal tangent pair for each normal (branch-free)."""
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=n.dtype, device=n.device)
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=n.dtype, device=n.device)
    # pick the axis least aligned with n
    a = torch.where(torch.abs(n[..., 0:1]) < 0.9, ex, ey)
    t1 = _cross(n, a)
    t1 = t1 / torch.linalg.norm(t1, dim=-1, keepdim=True)
    t2 = _cross(n, t1)
    return t1, t2


def _interleave(xs):
    """(C,·) triples → (3C,·) contact-major."""
    return torch.stack(xs, dim=1).reshape((-1,) + tuple(xs[0].shape[1:]))


def contact_rows(contacts: Contacts, state: BodyState, h,
                 stab_factor: float = 0.2,
                 max_recovery_speed: float = 1e30) -> ConstraintRows:
    """Lower contacts to (normal, t1, t2) cone triples.

    Row order: contact-major ``[n0,u0,v0, n1,u1,v1, ...]``, the projector's
    layout.  The normal row's rhs is the penetration-recovery speed,
    clamped by ``max_recovery_speed``.
    """
    a, b = contacts.body_a, contacts.body_b
    al, bl = a.long(), b.long()
    Cn = contacts.normal
    t1, t2 = _tangent_basis(Cn)
    ra = contacts.point - state.x[al]
    rb = contacts.point - state.x[bl]

    def rows_for(d):
        # gap rate along d: d·(v_b + ω_b×r_b − v_a − ω_a×r_a)
        return (-d, -Q.qrotate_inv(state.q[al], _cross(ra, d)), d,
                Q.qrotate_inv(state.q[bl], _cross(rb, d)))

    n_rows = rows_for(Cn)
    t1_rows = rows_for(t1)
    t2_rows = rows_for(t2)

    pen = torch.clamp_max(contacts.gap, 0.0)
    rhs_n = torch.clamp_max(-(stab_factor / h) * pen, max_recovery_speed)
    zero = torch.zeros_like(rhs_n)
    act = contacts.active
    return ConstraintRows.two_body(
        body_a=_interleave([a, a, a]), body_b=_interleave([b, b, b]),
        Ja_v=_interleave([n_rows[0], t1_rows[0], t2_rows[0]]),
        Ja_w=_interleave([n_rows[1], t1_rows[1], t2_rows[1]]),
        Jb_v=_interleave([n_rows[2], t1_rows[2], t2_rows[2]]),
        Jb_w=_interleave([n_rows[3], t1_rows[3], t2_rows[3]]),
        rhs=_interleave([rhs_n, zero, zero]),
        active=_interleave([act, act, act]))


def rolling_rows(contacts: Contacts, state: BodyState) -> ConstraintRows:
    """Rolling/spinning reaction rows — 3 per contact, contact-major
    ``[spin(n), roll(t1), roll(t2)]``, appended AFTER the sliding triples;
    their Jacobians act on the relative angular velocity about the contact
    frame."""
    a, b = contacts.body_a, contacts.body_b
    Cn = contacts.normal
    t1, t2 = _tangent_basis(Cn)
    qa, qb = state.q[a.long()], state.q[b.long()]

    def wrows(d):
        return -Q.qrotate_inv(qa, d), Q.qrotate_inv(qb, d)

    n_r, u_r, v_r = wrows(Cn), wrows(t1), wrows(t2)
    zero3 = torch.zeros_like(Cn)
    zrhs = torch.zeros_like(contacts.gap)
    act = contacts.active
    return ConstraintRows.two_body(
        body_a=_interleave([a, a, a]), body_b=_interleave([b, b, b]),
        Ja_v=_interleave([zero3, zero3, zero3]),
        Ja_w=_interleave([n_r[0], u_r[0], v_r[0]]),
        Jb_v=_interleave([zero3, zero3, zero3]),
        Jb_w=_interleave([n_r[1], u_r[1], v_r[1]]),
        rhs=_interleave([zrhs, zrhs, zrhs]),
        active=_interleave([act, act, act]))


def concat_contacts(a: Contacts, b: Contacts) -> Contacts:
    """Concatenate two fixed-capacity contact buffers."""
    return Contacts(*[torch.cat([x, y]) for x, y in zip(a[:-1], b[:-1])],
                    count=a.count + b.count)


def nsc_step(model, coll: CollisionModel, state: BodyState, t, h,
             settings=None, gamma_warm=None, extra_contacts_fn=None):
    """One NSC (DVI) step with contacts: detect → lower → mixed VI solve.
    Returns ``(new_state, contacts, StepInfo)``.

    ``extra_contacts_fn(state) -> Contacts``: an optional analytic contact
    generator appended to the detected set; its capacity adds to
    ``coll.max_contacts`` in the cone row count.  The solve is the VI
    solver of ``settings`` (APGD when ``"direct"``), which reads its loop
    tests on the host: the step runs eagerly.
    """
    from chrono_tpu_torch.physics.system import (
        SolverSettings, step_euler_implicit_linearized,
    )

    if settings is None:
        settings = SolverSettings(solver="apgd", stab_factor=0.2)
    contacts = detect_contacts(coll, state)
    if extra_contacts_fn is not None:
        contacts = concat_contacts(contacts, extra_contacts_fn(state))
    n_c = contacts.gap.shape[0]          # detected + analytic capacity
    rows = contact_rows(contacts, state, h, settings.stab_factor,
                        settings.max_recovery_speed)
    n_rolling = 0
    if coll.use_rolling:
        # 3 rolling reaction rows per contact, after the sliding triples
        rows = concat_rows([rows, rolling_rows(contacts, state)],
                           dtype=state.x.dtype, device=state.x.device)
        n_rolling = n_c
    new_state, info = step_euler_implicit_linearized(
        model, state, t, h, settings, extra_rows=rows, n_contacts=n_c,
        contact_mu=contacts.mu, gamma_warm=gamma_warm, n_rolling=n_rolling,
        mu_roll=coll.mu_roll, mu_spin=coll.mu_spin)
    return new_state, contacts, info
