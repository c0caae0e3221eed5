"""Matrix-free Schur-complement machinery over constraint rows.

Counterpart of ``chrono_tpu/solver/descriptor.py``: the packed-row
operators (``pack_rows``, ``apply_D_packed``, ``apply_DT_packed``,
``schur_product_packed``, ``diag_N_packed``, …), the per-body incidence
gather plan (``GatherPlan``, ``build_gather_plan``, ``apply_DT_gather``,
``schur_product_plan``), the channel-split forms (``apply_D``,
``apply_DT``, ``schur_product``, ``schur_rhs``, ``velocity_update``,
``diag_N``) and ``dense_D``.

Every ``Dᵀ γ`` here sums a body's rows without atomics, in a fixed order:
from the dense ``D`` (:func:`apply_DT_dense`, the direct path), by
``utils.segment.segment_sum`` (bodies × rows, the multibody scenes), or
through a :class:`SidePlan` (the VI and Krylov solvers' path: the sides
sorted by body once a solve, each body's run summed in order, no cap on a
body's rows).  ``dense_D`` places each row's blocks by one-hot products,
not by a scatter.

The JAX package's solve uses its ``GatherPlan`` while every movable body
has at most ``valence_bound`` rows, and the scatter form past it
(``physics/system.py:212-226``); on the card neither fits a contact-sized
solve (the plan's cap overflows on a stirrer that touches 11 spheres, the
scatter needs atomics), so the port's solve takes the side plan always and
keeps ``build_gather_plan`` as the JAX package has it, overflow flag
included, for what reads that flag.
"""

from __future__ import annotations

import torch
from torch import Tensor

from chrono_tpu_torch.physics.body import BodyProps
from chrono_tpu_torch.physics.constraints import ConstraintRows
from chrono_tpu_torch.utils.segment import (
    rank_in_run, scatter_add, segment_reduce_sum, sorted_segments,
)
from chrono_tpu_torch.utils.tree import tensor_dataclass


@tensor_dataclass
class PackedRows:
    """Constraint rows packed as (M, 8) rows ``[J_v | J_w | 0 0]``.

    ``active`` is folded into the Jacobian channels (inactive rows are all
    zero), so operator outputs vanish on inactive rows with no extra mask.
    """

    body_a: Tensor  # (M,) int32
    body_b: Tensor  # (M,) int32
    body_c: Tensor  # (M,) int32 — None when the model has no 3-body rows
    Ja: Tensor      # (M, 8) = [Ja_v, Ja_w, 0, 0] (zeroed when inactive)
    Jb: Tensor      # (M, 8)
    Jc: Tensor      # (M, 8) = [0, 0, 0, Jc_w, 0, 0] — None when no 3-body rows
    rhs: Tensor     # (M,) (zeroed when inactive)
    active: Tensor  # (M,) bool

    @property
    def m(self) -> int:
        return self.body_a.shape[0]


def pack_rows(rows: ConstraintRows, has_c: bool = True) -> PackedRows:
    """``has_c=False`` (statically known: only planetary-shaft rows use the
    third body slot) drops the c channel."""
    m = rows.m
    z2 = rows.Ja_v.new_zeros((m, 2))
    z3 = rows.Ja_v.new_zeros((m, 3))
    act = rows.active[:, None].to(rows.Ja_v.dtype)
    return PackedRows(
        body_a=rows.body_a, body_b=rows.body_b,
        body_c=rows.body_c if has_c else None,
        Ja=torch.cat([rows.Ja_v, rows.Ja_w, z2], dim=1) * act,
        Jb=torch.cat([rows.Jb_v, rows.Jb_w, z2], dim=1) * act,
        Jc=(torch.cat([z3, rows.Jc_w, z2], dim=1) * act if has_c else None),
        rhs=torch.where(rows.active, rows.rhs, torch.zeros_like(rows.rhs)),
        active=rows.active,
    )


def pack_u(v: Tensor, w: Tensor) -> Tensor:
    """(N,3)+(N,3) → (N,8) padded velocity rows."""
    return torch.cat([v, w, v.new_zeros((v.shape[0], 2))], dim=1)


def pack_minv(props: BodyProps) -> Tensor:
    """(N,8) diagonal of M⁻¹ in packed layout (trailing pad = 0)."""
    n = props.inv_mass.shape[0]
    im = props.inv_mass[:, None].expand(n, 3)
    return torch.cat([im, props.inv_inertia, im.new_zeros((n, 2))], dim=1)


def apply_D_packed(p: PackedRows, u8: Tensor) -> Tensor:
    """``D u``: (M,) row dot products via two (or three) row gathers."""
    out = (torch.sum(p.Ja * u8[p.body_a], dim=-1)
           + torch.sum(p.Jb * u8[p.body_b], dim=-1))
    if p.Jc is not None:
        out = out + torch.sum(p.Jc * u8[p.body_c], dim=-1)
    return out


def apply_DT_packed(p: PackedRows, gamma: Tensor, n_bodies: int) -> Tensor:
    """``Dᵀ γ`` → packed per-body impulse rows (N,8)."""
    g = gamma[:, None]
    acc = gamma.new_zeros((n_bodies, 8))
    acc = scatter_add(scatter_add(acc, p.body_a, p.Ja * g), p.body_b,
                      p.Jb * g)
    if p.Jc is not None:
        acc = scatter_add(acc, p.body_c, p.Jc * g)
    return acc


def schur_rhs_packed(p: PackedRows, u_free8: Tensor) -> Tensor:
    return apply_D_packed(p, u_free8) - p.rhs


def velocity_update_packed(p: PackedRows, minv8: Tensor, gamma: Tensor,
                           u_free8: Tensor) -> tuple[Tensor, Tensor]:
    """``u⁺ = u_free + M⁻¹ Dᵀ γ`` → (v (N,3), w_local (N,3))."""
    u8 = u_free8 + apply_DT_packed(p, gamma, minv8.shape[0]) * minv8
    return u8[:, 0:3], u8[:, 3:6]


def schur_product_packed(p: PackedRows, minv8: Tensor, gamma: Tensor
                         ) -> Tensor:
    """``N γ = D M⁻¹ Dᵀ γ`` in packed layout."""
    return apply_D_packed(p, apply_DT_packed(p, gamma, minv8.shape[0])
                          * minv8)


def diag_N_packed(p: PackedRows, minv8: Tensor) -> Tensor:
    """Exact diagonal of N in packed layout (1.0 on inactive rows)."""
    d = (torch.sum(p.Ja * p.Ja * minv8[p.body_a], dim=-1)
         + torch.sum(p.Jb * p.Jb * minv8[p.body_b], dim=-1))
    if p.Jc is not None:
        d = d + torch.sum(p.Jc * p.Jc * minv8[p.body_c], dim=-1)
    return torch.where(p.active, d, torch.ones_like(d))


def _sides(p: PackedRows):
    """The side-major ``[a-sides | b-sides | c-sides]`` bodies and
    Jacobian rows."""
    if p.Jc is None:
        return (torch.cat([p.body_a, p.body_b]),
                torch.cat([p.Ja, p.Jb], dim=0))
    return (torch.cat([p.body_a, p.body_b, p.body_c]),
            torch.cat([p.Ja, p.Jb, p.Jc], dim=0))


# ---------------------------------------------------------------------------
# The JAX package's gather plan: a per-body incidence table capped at V rows
# ---------------------------------------------------------------------------


@tensor_dataclass
class GatherPlan:
    """Per-body incidence table turning ``Dᵀ γ`` scatter into a gather.

    ``table[n, v]`` indexes into the side-major contribution array
    ``[a-sides | b-sides | c-sides]`` of length 3M (index 3M = zero pad).
    Fixed bodies are excluded.  ``overflow > 0`` means some movable body
    exceeded ``V`` rows and contributions were dropped.
    """

    table: Tensor     # (N, V) int64 into the padded (sides·M + 1,) array
    J_sides: Tensor   # (sides·M, 8) side-major Jacobian rows
    overflow: Tensor  # () int32


def build_gather_plan(p: PackedRows, minv8: Tensor,
                      max_rows_per_body: int = 96) -> GatherPlan:
    """Build the per-body incidence table (once per solve).

    The JAX package writes every side past a body's V-th into slot V−1, so
    which one lands there is undefined; this port writes only the sides
    under the cap (the first V of each body, in side order), so its table
    is deterministic and equals the JAX package's wherever no body
    overflows.
    """
    n_bodies = minv8.shape[0]
    V = max_rows_per_body
    sides, J_sides = _sides(p)
    sm = sides.shape[0]
    movable = torch.any(minv8 > 0, dim=1)
    key = torch.where(movable[sides.long()], sides.long(),
                      torch.full_like(sides, n_bodies, dtype=torch.int64))
    key_sorted, order = torch.sort(key, stable=True)
    rank = rank_in_run(key_sorted)
    live = key_sorted < n_bodies
    most = torch.max(torch.where(live, rank, torch.zeros_like(rank)))
    overflow = torch.clamp_min(most + 1 - V, 0).to(torch.int32)
    # slots past the cap and dead sides write to a dump slot cut off below
    flat = torch.where(live & (rank < V), key_sorted * V + rank,
                       torch.full_like(rank, n_bodies * V))
    table = torch.full((n_bodies * V + 1,), sm, dtype=torch.int64,
                       device=sides.device)
    table[flat] = order
    return GatherPlan(table=table[:-1].reshape(n_bodies, V), J_sides=J_sides,
                      overflow=overflow)


def apply_DT_gather(plan: GatherPlan, gamma: Tensor) -> Tensor:
    """``Dᵀ γ`` (N,8) with zero scatter: contributions are computed
    side-major and pulled through the incidence table."""
    n_sides = plan.J_sides.shape[0] // gamma.shape[0]
    gs = torch.cat([gamma] * n_sides)[:, None]
    c = plan.J_sides * gs                                  # (sides·M, 8)
    c = torch.cat([c, c.new_zeros((1, 8))], dim=0)
    return torch.sum(c[plan.table], dim=1)                 # (N, V, 8) → (N, 8)


def schur_product_plan(p: PackedRows, minv8: Tensor, plan: GatherPlan,
                       gamma: Tensor) -> Tensor:
    """``N γ`` with the gather-plan accumulation."""
    return apply_D_packed(p, apply_DT_gather(plan, gamma) * minv8)


# ---------------------------------------------------------------------------
# The port's solve path: the sides sorted by body, no cap
# ---------------------------------------------------------------------------


@tensor_dataclass
class SidePlan:
    """The kept sides of the rows, sorted by body (a stable sort, once per
    solve: the contact set is fixed within a step), and the rows' bodies as
    flat indices into a packed (N, 8) table.

    A side is kept if its body is movable and its row active: the others
    add exact zeros (``M⁻¹`` annihilates a fixed body's rows, an inactive
    row's Jacobian is zero), and leaving them out keeps a body's run short
    (every inactive contact row points at one body pair) and costs nothing
    (the sides left out sort last, past every body's run).  Sorted place j
    holds row ``row[j]``'s side with Jacobian ``J[j]``; body i's run is
    places ``offsets[i]`` to ``offsets[i + 1]``.  Body i's sum adds its
    a-sides in row order, then its b-sides, then its c-sides: the order of
    the JAX package's sequential scatter.

    ``take[s]`` holds side s's body rows as flat indices (8 a row) for
    ``torch.take``: on the card a flat gather of 8·M floats is much faster
    than the row gather ``u8[body]`` of M rows of 8 (``chip_smoke.py``
    phase 12 times both), with the same values.
    """

    J: Tensor        # (K, 8) sorted side Jacobians
    row: Tensor      # (K,) int64 row of each sorted side
    offsets: Tensor  # (N + 1,) int64
    take: tuple      # per side (a, b[, c]): (8·M,) int64 flat indices


def build_side_plan(p: PackedRows, minv8: Tensor) -> SidePlan:
    """Sort the sides of ``p`` by body; no host sync (the offsets come from
    ``searchsorted`` on the sorted keys)."""
    n_bodies = minv8.shape[0]
    sides, J_sides = _sides(p)
    rows = torch.arange(p.m, device=sides.device).repeat(
        sides.shape[0] // max(p.m, 1))
    movable = torch.any(minv8 > 0, dim=1)
    seg = sorted_segments(sides, n_bodies,
                          keep=movable[sides.long()] & p.active[rows])
    lane = torch.arange(8, device=sides.device)
    bodies = [p.body_a, p.body_b] + ([] if p.Jc is None else [p.body_c])
    return SidePlan(J=J_sides[seg.order], row=rows[seg.order],
                    offsets=seg.offsets,
                    take=tuple((b.long()[:, None] * 8 + lane).reshape(-1)
                               for b in bodies))


def apply_D_sorted(p: PackedRows, plan: SidePlan, u8: Tensor) -> Tensor:
    """``D u`` as :func:`apply_D_packed` computes it (the same products and
    sums), its body rows fetched by the plan's flat gathers."""
    Js = [p.Ja, p.Jb] + ([] if p.Jc is None else [p.Jc])
    out = None
    for J, take in zip(Js, plan.take):
        term = torch.sum(J * torch.take(u8, take).view(-1, 8), dim=-1)
        out = term if out is None else out + term
    return out


def apply_DT_sorted(plan: SidePlan, gamma: Tensor) -> Tensor:
    """``Dᵀ γ`` (N,8) through the side plan: each body's run of sorted
    sides summed in order by ``torch.segment_reduce`` (no atomics, any run
    length)."""
    return segment_reduce_sum(plan.J * gamma[plan.row][:, None],
                              plan.offsets)


def schur_product_sorted(p: PackedRows, minv8: Tensor, plan: SidePlan,
                         gamma: Tensor) -> Tensor:
    """``N γ = D M⁻¹ Dᵀ γ`` through the side plan (the solvers' operator)."""
    return apply_D_sorted(p, plan, apply_DT_sorted(plan, gamma) * minv8)


def velocity_update_sorted(plan: SidePlan, minv8: Tensor, gamma: Tensor,
                           u_free8: Tensor) -> tuple[Tensor, Tensor]:
    """``u⁺ = u_free + M⁻¹ Dᵀ γ`` through the side plan → (v (N,3), w_local
    (N,3))."""
    u8 = u_free8 + apply_DT_sorted(plan, gamma) * minv8
    return u8[:, 0:3], u8[:, 3:6]


# ---------------------------------------------------------------------------
# Channel-split forms
# ---------------------------------------------------------------------------


def apply_DT(rows: ConstraintRows, gamma: Tensor, n_bodies: int):
    """``Dᵀ γ``: per-body generalised impulses (f_world (N,3), tau_local
    (N,3))."""
    g = torch.where(rows.active, gamma, torch.zeros_like(gamma))[:, None]
    f = gamma.new_zeros((n_bodies, 3))
    tau = gamma.new_zeros((n_bodies, 3))
    f = scatter_add(scatter_add(f, rows.body_a, rows.Ja_v * g),
                    rows.body_b, rows.Jb_v * g)
    tau = scatter_add(scatter_add(tau, rows.body_a, rows.Ja_w * g),
                      rows.body_b, rows.Jb_w * g)
    return f, scatter_add(tau, rows.body_c, rows.Jc_w * g)


def apply_D(rows: ConstraintRows, v: Tensor, w: Tensor) -> Tensor:
    """``D u``: per-row constraint-space velocities (M,)."""
    out = (
        torch.sum(rows.Ja_v * v[rows.body_a], dim=-1)
        + torch.sum(rows.Ja_w * w[rows.body_a], dim=-1)
        + torch.sum(rows.Jb_v * v[rows.body_b], dim=-1)
        + torch.sum(rows.Jb_w * w[rows.body_b], dim=-1)
        + torch.sum(rows.Jc_w * w[rows.body_c], dim=-1)
    )
    return torch.where(rows.active, out, torch.zeros_like(out))


def apply_Minv(props: BodyProps, f: Tensor, tau: Tensor):
    """Block-diagonal ``M⁻¹``: (N,3)×2 → velocity-space (dv, dw)."""
    return f * props.inv_mass[:, None], tau * props.inv_inertia


def schur_product(rows: ConstraintRows, props: BodyProps, gamma: Tensor
                  ) -> Tensor:
    """``N γ = D M⁻¹ Dᵀ γ`` (matrix-free)."""
    f, tau = apply_DT(rows, gamma, props.inv_mass.shape[0])
    dv, dw = apply_Minv(props, f, tau)
    return apply_D(rows, dv, dw)


def schur_rhs(rows: ConstraintRows, v_free: Tensor, w_free: Tensor
              ) -> Tensor:
    """Right-hand side of the velocity-level VI: ``r = D v_free - b`` on
    the active rows (0 elsewhere)."""
    r = apply_D(rows, v_free, w_free) - rows.rhs
    return torch.where(rows.active, r, torch.zeros_like(r))


def velocity_update(rows: ConstraintRows, props: BodyProps, gamma: Tensor,
                    v_free: Tensor, w_free: Tensor):
    """Final velocities ``u⁺ = u_free + M⁻¹ Dᵀ γ`` → (v (N,3), w_local
    (N,3))."""
    f, tau = apply_DT(rows, gamma, props.inv_mass.shape[0])
    dv, dw = apply_Minv(props, f, tau)
    return v_free + dv, w_free + dw


def diag_N(rows: ConstraintRows, props: BodyProps) -> Tensor:
    """Diagonal of N (per-row ``J M⁻¹ Jᵀ``), exact and row-local."""
    ima = props.inv_mass[rows.body_a][:, None]
    imb = props.inv_mass[rows.body_b][:, None]
    d = (
        torch.sum(rows.Ja_v**2 * ima, dim=-1)
        + torch.sum(rows.Ja_w**2 * props.inv_inertia[rows.body_a], dim=-1)
        + torch.sum(rows.Jb_v**2 * imb, dim=-1)
        + torch.sum(rows.Jb_w**2 * props.inv_inertia[rows.body_b], dim=-1)
        + torch.sum(rows.Jc_w**2 * props.inv_inertia[rows.body_c], dim=-1)
    )
    return torch.where(rows.active, d, torch.ones_like(d))


def dense_D(rows: ConstraintRows, n_bodies: int) -> Tensor:
    """Assemble the dense Jacobian D (M, 6N) for the direct solver path.

    Layout: body u = [v (world), w (local)] interleaved per body.  Each row's
    blocks are placed by one-hot products over the bodies (in the JAX
    package's order: a's, then b's, then c's), not by a scatter.
    """
    bodies = torch.arange(n_bodies, device=rows.body_a.device)
    mask = rows.active[:, None]
    zero3 = torch.zeros_like(rows.Ja_v)

    def place(body, J_v, J_w):
        J = torch.cat([torch.where(mask, J_v, zero3),
                       torch.where(mask, J_w, zero3)], dim=1)  # (M, 6)
        onehot = (body[:, None] == bodies[None, :]).to(J.dtype)  # (M, N)
        return onehot[:, :, None] * J[:, None, :]

    D = (place(rows.body_a, rows.Ja_v, rows.Ja_w)
         + place(rows.body_b, rows.Jb_v, rows.Jb_w)
         + place(rows.body_c, zero3, rows.Jc_w))
    return D.reshape(rows.m, n_bodies * 6)


def apply_DT_dense(D: Tensor, gamma: Tensor) -> Tensor:
    """``Dᵀ γ`` from the dense D: (N, 6) rows ``[f_world | tau_local]``
    (a matrix-vector product: no atomics, a fixed sum order)."""
    return (D.T @ gamma).reshape(-1, 6)


def velocity_update_dense(D: Tensor, props: BodyProps, gamma: Tensor,
                          v_free: Tensor, w_free: Tensor):
    """``u⁺ = u_free + M⁻¹ Dᵀ γ`` from the dense D → (v (N,3), w (N,3))."""
    imp = apply_DT_dense(D, gamma)
    return (v_free + imp[:, 0:3] * props.inv_mass[:, None],
            w_free + imp[:, 3:6] * props.inv_inertia)

