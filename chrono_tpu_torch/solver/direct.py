"""Dense direct Schur solver for bilateral-only systems.

Counterpart of ``chrono_tpu/solver/direct.py``: small and medium multibody
systems (10²–10⁴ constraint rows) solve fastest as a DENSE Schur complement,
``N = D M⁻¹ Dᵀ``: two matrix products and a Cholesky factorisation, with no
host factorisation and no host sync, so the step that calls it can be
captured in a CUDA graph.

Error-free arithmetic.  Dekker's ``_two_prod`` and the Neumaier two-sums in
``_comp_sum``/``_comp_sum_axis`` are exact only if every product and every
sum rounds on its own.  Eager PyTorch ops do (each op is its own kernel, and
its float32 result is stored).  ``torch.compile``, or any fused kernel, may
contract ``a*b - p`` into an FMA or reassociate ``(a - (s - bv))`` and
silently lose the digits these functions exist to keep.  Do not compile
them; whoever fuses them later must keep each operation's rounding (no FMA
contraction, no reassociation).

The float32 matrix products need full float32: with TF32 enabled
(``torch.backends.cuda.matmul.allow_tf32``) ``N`` keeps ~3 digits and the
compensated refinement cannot repair the factor.  PyTorch leaves TF32 off
for matrix products by default.
"""

from __future__ import annotations

import torch
from torch import Tensor

from chrono_tpu_torch.physics.body import BodyProps
from chrono_tpu_torch.physics.constraints import ConstraintRows
from chrono_tpu_torch.solver import descriptor as desc


def _two_prod(a: Tensor, b: Tensor):
    """Dekker error-free product: a·b = p + err exactly (Veltkamp split)."""
    split = 4097.0 if a.dtype == torch.float32 else 134217729.0  # 2^s + 1
    p = a * b
    ca = split * a
    ah = ca - (ca - a)
    al = a - ah
    cb = split * b
    bh = cb - (cb - b)
    bl = b - bh
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


def _comp_sum(terms):
    """Neumaier-compensated sum of a list of equal-shaped tensors."""
    s = terms[0]
    c = torch.zeros_like(s)
    for t in terms[1:]:
        s1 = s + t
        bv = s1 - s
        c = c + (s - (s1 - bv)) + (t - bv)
        s = s1
    return s, c


def _comp_sum_axis(P: Tensor, axis: int = -1):
    """Compensated reduction along ``axis``: a pairwise tree of two-sums
    with the rounding errors accumulated separately (log2(n) vector ops
    instead of n)."""
    P = torch.movedim(P, axis, -1)
    c = P.new_zeros(P.shape[:-1])
    while P.shape[-1] > 1:
        if P.shape[-1] % 2:
            P = torch.cat([P, P.new_zeros(P.shape[:-1] + (1,))], dim=-1)
        a = P[..., 0::2]
        b = P[..., 1::2]
        s = a + b
        bv = s - a
        err = (a - (s - bv)) + (b - bv)       # Neumaier branchless two_sum
        c = c + torch.sum(err, dim=-1)
        P = s
    return P[..., 0], c


def compensated_schur_rhs(rows: ConstraintRows, v_free, w_free) -> Tensor:
    """``r = D u_free − b`` with error-free products + compensated summation.

    The constrained-direction relative velocities cancel O(|v|·|J|) terms to
    O(h): at fp32 the plain contraction's rounding passes through N⁻¹ into γ
    and is amplified by 1/h in the reactions.  One (m, 16) error-free
    product and a log-depth compensated reduction.
    """
    J = torch.cat([rows.Ja_v, rows.Ja_w, rows.Jb_v, rows.Jb_w, rows.Jc_w,
                   -rows.rhs[:, None]], dim=1)
    u = torch.cat([v_free[rows.body_a], w_free[rows.body_a],
                   v_free[rows.body_b], w_free[rows.body_b],
                   w_free[rows.body_c], torch.ones_like(rows.rhs)[:, None]],
                  dim=1)
    p, e = _two_prod(J, u)
    s, c = _comp_sum_axis(p, axis=1)
    r = s + (c + torch.sum(e, dim=1))
    return torch.where(rows.active, r, torch.zeros_like(r))


def _solve_at(N0: Tensor, r: Tensor, active: Tensor, scale: Tensor,
              reg: float):
    """γ of ``(N0 + reg·scale·I) γ = −r`` and whether its factorisation
    succeeded (a device bool).

    Cholesky failure semantics.  The JAX package's ``cho_factor`` returns
    NaN when the factorisation fails, and its fallback keys on a non-finite
    γ.  ``torch.linalg.cholesky`` raises instead (a host sync), and
    ``cholesky_ex`` returns ``info`` and may leave finite garbage in the
    factor.  So the factor comes from ``cholesky_ex(check_errors=False)``
    and ``info != 0`` counts as non-finite.
    """
    m = N0.shape[0]
    eye = torch.eye(m, dtype=N0.dtype, device=N0.device)
    N = N0 + (reg * scale) * eye
    # inactive rows: force gamma=0 via identity rows
    N = torch.where(active[:, None] & active[None, :], N, eye)
    # Jacobi equilibration: joint rows mix translational (|J|~1, 1/m) and
    # rotational (|J|~arm, 1/I) scales; symmetric scaling drops cond(N) to
    # the scaled matrix's
    s = 1.0 / torch.sqrt(torch.clamp_min(torch.diagonal(N), 1e-30))
    Ns = N * s[:, None] * s[None, :]
    L, info = torch.linalg.cholesky_ex(Ns, check_errors=False)
    # ONE pair of triangular solves for the scaled inverse (the JAX
    # package's cho_solve against I): the refinement corrections are then
    # matrix-vector products
    inv_s = torch.linalg.solve_triangular(
        L.mT, torch.linalg.solve_triangular(L, eye, upper=False), upper=True)
    gamma = s * (inv_s @ (-(s * r)))
    # two steps of iterative refinement with a COMPENSATED residual (a plain
    # fp32 N@γ+r has the same rounding as the error being corrected)
    for _ in range(2):
        p, e = _two_prod(N, gamma[None, :])
        ssum, c = _comp_sum_axis(p, axis=1)
        resid = (ssum + r) + (c + torch.sum(e, dim=1))
        gamma = gamma - s * (inv_s @ (s * resid))
    return gamma, (info == 0) & torch.isfinite(gamma).all()


def solve_dense_schur(
    rows: ConstraintRows,
    props: BodyProps,
    v_free: Tensor,
    w_free: Tensor,
    reg: float = 1e-9,
    reg_fallback: float = 3e-6,
    D: Tensor = None,
) -> Tensor:
    """Solve ``N γ = -(D u_free - b)`` exactly (equality constraints only).

    Inactive rows are masked out of D, and the Tikhonov term keeps N
    invertible for redundant constraint sets.  Regularisation is two-tier:
    the primary ``reg`` (1e-9) keeps fp32 fidelity for well-posed systems;
    closed loops of PARALLEL revolutes (leaf-spring shackles, planar 4-bars)
    make N exactly rank-deficient, and the equilibrated Cholesky then hits
    rounding-negative pivots.  Then the solve at ``reg_fallback`` (3e-6)
    is taken; the redundant multiplier directions it damps lie in null(Dᵀ)
    and do not affect body motion.

    Both solves run on the device every call and ``torch.where`` selects
    between them: the JAX package's ``lax.cond`` would be a host branch
    here, which a CUDA graph cannot hold.  ``D`` (the dense Jacobian of
    ``rows``) may be passed in by a caller that needs it too.
    """
    n_bodies = props.inv_mass.shape[0]
    if D is None:
        D = desc.dense_D(rows, n_bodies)  # (m, 6N)
    minv = torch.stack(
        [props.inv_mass[:, None].expand(n_bodies, 3), props.inv_inertia],
        dim=1).reshape(n_bodies * 6)
    N0 = (D * minv[None, :]) @ D.T
    m = rows.m
    scale = torch.clamp_min(torch.trace(N0) / max(m, 1), 1.0)
    r = compensated_schur_rhs(rows, v_free, w_free)
    gamma, ok = _solve_at(N0, r, rows.active, scale, reg)
    fallback, _ = _solve_at(N0, r, rows.active, scale, reg_fallback)
    return torch.where(ok, gamma, fallback)
