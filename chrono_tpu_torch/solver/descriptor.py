"""Schur-complement machinery over constraint rows: the direct path's part.

Counterpart of the parts of ``chrono_tpu/solver/descriptor.py`` that the
dense direct solve and the velocity update use: ``pack_rows``, ``pack_u``,
``pack_minv``, ``apply_D_packed``, ``apply_DT_packed``,
``schur_rhs_packed``, ``velocity_update_packed``, ``dense_D``, ``apply_D``,
``apply_DT``.  The per-body incidence gather plan (``build_gather_plan`` and
its products) is for the iterative VI solvers and comes with them.

Every ``Dᵀ γ`` here sums a body's rows without atomics, in a fixed order:
from the dense ``D`` (:func:`apply_DT_dense`, the step's direct path) or by
``utils.segment.segment_sum``.  ``dense_D`` places each row's blocks by
one-hot products, not by a scatter.
"""

from __future__ import annotations

import torch
from torch import Tensor

from chrono_tpu_torch.physics.body import BodyProps
from chrono_tpu_torch.physics.constraints import ConstraintRows
from chrono_tpu_torch.utils.segment import scatter_add
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

