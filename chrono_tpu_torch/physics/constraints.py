"""Unified constraint-row representation and autodiff Jacobian lowering.

Counterpart of ``chrono_tpu/physics/constraints.py``: all scalar constraint
rows live in one padded struct of arrays; rows reference at most three
bodies.  Jacobians are exact: each joint type defines its position-level gap
function ``c(x_a, q_a, x_b, q_b)`` and rows come from forward-mode autodiff
along the 12 tangent directions ``(δx_a, δθ_a^local, δx_b, δθ_b^local)``.

The JAX package lowers with ``jax.vmap(jax.jacfwd(...))``; this port with
one batched forward-mode pass over the joints that pushes the 12 basis
tangents through at once, on the dual numbers of ``core.dual``
(``torch.func.vmap(torch.func.jacfwd(...))`` gives the same Jacobians in
~12× the host time: ``mbs_host_cost.py``).  It needs no host
sync and no branch on data, so the step that lowers the joints can be
captured in a CUDA graph.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import Tensor

from chrono_tpu_torch.core import quaternion as Q
from chrono_tpu_torch.core.dual import Dual
from chrono_tpu_torch.utils.tree import tensor_dataclass


@tensor_dataclass
class ConstraintRows:
    """M scalar constraint rows, each coupling up to THREE bodies.

    The velocity-level constraint is
        ``Ja_v·v_a + Ja_w·w_a + Jb_v·v_b + Jb_w·w_b + Jc_w·w_c = rhs``
    with ``v`` world linear velocity and ``w`` body-local angular velocity.
    ``rhs`` already contains Baumgarte stabilisation ``-C/h`` and motor
    velocity set-points.  The third slot is for drivetrain rows that couple
    three 1-DOF variables; ordinary rows leave it at body 0 with zero
    Jacobians.
    """

    body_a: Tensor  # (M,) int32
    body_b: Tensor  # (M,) int32
    body_c: Tensor  # (M,) int32 (0 + zero Jacobian when unused)
    Ja_v: Tensor    # (M, 3)
    Ja_w: Tensor    # (M, 3)
    Jb_v: Tensor    # (M, 3)
    Jb_w: Tensor    # (M, 3)
    Jc_w: Tensor    # (M, 3) third slot is rotational-only (shaft coupling)
    rhs: Tensor     # (M,)
    active: Tensor  # (M,) bool

    @property
    def m(self) -> int:
        return self.body_a.shape[0]

    @staticmethod
    def two_body(body_a, body_b, Ja_v, Ja_w, Jb_v, Jb_w, rhs, active
                 ) -> "ConstraintRows":
        """Standard two-body rows (third slot inert)."""
        return ConstraintRows(
            body_a=body_a, body_b=body_b,
            body_c=torch.zeros_like(body_a),
            Ja_v=Ja_v, Ja_w=Ja_w, Jb_v=Jb_v, Jb_w=Jb_w,
            Jc_w=torch.zeros_like(Ja_w),
            rhs=rhs, active=active,
        )

    @staticmethod
    def empty(dtype=torch.float32, device=None) -> "ConstraintRows":
        z3 = torch.zeros((0, 3), dtype=dtype, device=device)
        zi = torch.zeros((0,), dtype=torch.int32, device=device)
        return ConstraintRows(
            body_a=zi, body_b=zi, body_c=zi,
            Ja_v=z3, Ja_w=z3, Jb_v=z3, Jb_w=z3, Jc_w=z3,
            rhs=torch.zeros((0,), dtype=dtype, device=device),
            active=torch.zeros((0,), dtype=torch.bool, device=device),
        )


_ROW_FIELDS = ("body_a", "body_b", "body_c", "Ja_v", "Ja_w", "Jb_v", "Jb_w",
               "Jc_w", "rhs", "active")


def concat_rows(rows_list, dtype=torch.float32, device=None
                ) -> ConstraintRows:
    """Rows of every non-empty block, in order (empty rows of ``dtype`` on
    ``device`` when there is none)."""
    rows_list = [r for r in rows_list if r is not None and r.m > 0]
    if not rows_list:
        return ConstraintRows.empty(dtype, device)
    if len(rows_list) == 1:
        return rows_list[0]
    return ConstraintRows(**{
        f: torch.cat([getattr(r, f) for r in rows_list], dim=0)
        for f in _ROW_FIELDS})


def _perturbed_pose(x, q, basis, col):
    """The pose ``(x + δx, q + ½ q ⊗ (0, δθ))`` as duals along the 12 basis
    tangents, ``(δx, δθ)`` being tangent columns ``col … col+5``."""
    dx = basis[:, None, col:col + 3]                       # (12, 1, 3)
    dth = basis[:, None, col + 3:col + 6]
    zero = torch.zeros_like(dth[..., :1])
    dq = 0.5 * Q.qmul(q[None], torch.cat([zero, dth], dim=-1))  # (12, J, 4)
    return Dual(x, dx), Dual(q, dq)


def lower_gap_function(gap_fn: Callable, n_rows: int) -> Callable:
    """Build a batched lowering for a joint type.

    ``gap_fn(x_a, q_a, x_b, q_b, params) -> (..., n_rows)`` is the
    position-level gap, batched over leading axes.  Returns ``lower(xs, qs,
    body_a, body_b, params, h, stab_factor) -> ConstraintRows`` producing
    ``n_rows`` rows per joint with exact velocity Jacobians and stabilised
    rhs ``-C·stab_factor/h``.

    One evaluation of ``gap_fn`` on dual poses (``core.dual``) gives the gap
    (the dual's value) and its 12 tangent columns (the Jacobian).
    """

    def lower(states_x, states_q, body_a, body_b, params, h, stab_factor=1.0,
              deadband=0.0):
        nj = body_a.shape[0]
        basis = torch.eye(12, dtype=states_x.dtype, device=states_x.device)
        xa, qa = _perturbed_pose(states_x[body_a], states_q[body_a], basis, 0)
        xb, qb = _perturbed_pose(states_x[body_b], states_q[body_b], basis, 6)
        gap = gap_fn(xa, qa, xb, qb, params)
        C = gap.p                                             # (J, n)
        J = gap.t.expand((12,) + C.shape).permute(1, 2, 0)    # (J, n, 12)
        if deadband:
            # soft-threshold the violation at the fp32 position-roundoff
            # floor: Baumgarte would otherwise convert eps32·|x| jitter into
            # stab/h-scaled velocity kicks every step
            C = torch.sign(C) * torch.clamp_min(torch.abs(C) - deadband, 0.0)

        def flat(a):
            return a.reshape(nj * n_rows, -1)

        def rep(a):
            return a[:, None].expand(nj, n_rows).reshape(-1)

        return ConstraintRows.two_body(
            body_a=rep(body_a),
            body_b=rep(body_b),
            Ja_v=flat(J[..., 0:3]),
            Ja_w=flat(J[..., 3:6]),
            Jb_v=flat(J[..., 6:9]),
            Jb_w=flat(J[..., 9:12]),
            rhs=-(stab_factor / h) * C.reshape(-1),
            active=torch.ones((nj * n_rows,), dtype=torch.bool,
                              device=states_x.device),
        )

    return lower
