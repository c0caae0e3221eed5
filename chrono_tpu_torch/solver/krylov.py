"""Matrix-free Krylov linear solvers: CG, BiCGStab, MINRES, GMRES(m).

Counterpart of ``chrono_tpu/solver/krylov.py``: each solver runs on a
user-supplied operator ``A: (n,) -> (n,)``, with an optional left
preconditioner ``Minv: (n,) -> (n,)`` applying M⁻¹ where the JAX package
takes one.

CG, BiCGStab and MINRES end on data: their loop test is read on the host
once an iteration (``vi.host_test``, counted), as the VI solvers read
theirs.  GMRES reads its test once a restart cycle; inside a cycle its
Arnoldi steps are a fixed-length loop of ``restart`` steps whose results
are masked once the cycle has converged (the JAX package's ``lax.cond``
keeps the carried state as it is then; here every step runs and
``torch.where`` keeps the state), so a cycle reads nothing.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
from torch import Tensor

from chrono_tpu_torch.solver.vi import host_test


class LSSolution(NamedTuple):
    x: Tensor
    iterations: Tensor   # () int32
    residual: Tensor     # () float — final ‖r‖ / ‖b‖ (relative)


def _nrm(x: Tensor) -> Tensor:
    return torch.sqrt(torch.sum(x * x))


def _dot(a: Tensor, b: Tensor) -> Tensor:
    # jnp.dot's counterpart, a BLAS dot (see solver/vi.py)
    return torch.dot(a, b)


def _ident(x):
    return x


def _safe_div(num: Tensor, den: Tensor, eps: float = 1e-30) -> Tensor:
    """num/den with a sign-preserving breakdown guard (dots can be
    negative)."""
    safe = torch.where(torch.abs(den) > eps, den,
                       torch.where(den < 0, torch.full_like(den, -eps),
                                   torch.full_like(den, eps)))
    return num / safe


def _count(k: int, like: Tensor) -> Tensor:
    return torch.tensor(k, dtype=torch.int32, device=like.device)


def solve_cg(A: Callable, b: Tensor, x0: Optional[Tensor] = None,
             Minv: Callable = _ident, max_iter: int = 200,
             tol: float = 1e-8) -> LSSolution:
    """Preconditioned conjugate gradient (SPD operators)."""
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - A(x)
    z = Minv(r)
    p = z
    rz = _dot(r, z)
    bnorm = torch.clamp_min(_nrm(b), 1e-30)
    k = 0
    while k < max_iter and host_test(_nrm(r) / bnorm > tol):
        Ap = A(p)
        alpha = _safe_div(rz, _dot(p, Ap))
        x = x + alpha * p
        r = r - alpha * Ap
        z = Minv(r)
        rz_new = _dot(r, z)
        beta = _safe_div(rz_new, rz)
        p = z + beta * p
        rz = rz_new
        k += 1
    return LSSolution(x=x, iterations=_count(k, b), residual=_nrm(r) / bnorm)


def solve_bicgstab(A: Callable, b: Tensor, x0: Optional[Tensor] = None,
                   Minv: Callable = _ident, max_iter: int = 200,
                   tol: float = 1e-8) -> LSSolution:
    """Preconditioned BiCGStab for general (non-symmetric) operators."""
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - A(x)
    rhat = r
    one = torch.ones((), dtype=b.dtype, device=b.device)
    rho, alpha, omega = one, one, one
    v = torch.zeros_like(b)
    p = torch.zeros_like(b)
    bnorm = torch.clamp_min(_nrm(b), 1e-30)
    k = 0
    while k < max_iter and host_test(_nrm(r) / bnorm > tol):
        rho_new = _dot(rhat, r)
        beta = _safe_div(rho_new, rho) * _safe_div(alpha, omega)
        p = r + beta * (p - omega * v)
        phat = Minv(p)
        v = A(phat)
        alpha = _safe_div(rho_new, _dot(rhat, v))
        s_vec = r - alpha * v
        shat = Minv(s_vec)
        t = A(shat)
        omega = _safe_div(_dot(t, s_vec), _dot(t, t))
        x = x + alpha * phat + omega * shat
        r = s_vec - omega * t
        rho = rho_new
        k += 1
    return LSSolution(x=x, iterations=_count(k, b), residual=_nrm(r) / bnorm)


def solve_minres(A: Callable, b: Tensor, x0: Optional[Tensor] = None,
                 max_iter: int = 200, tol: float = 1e-8) -> LSSolution:
    """MINRES for symmetric (possibly indefinite) operators (Lanczos +
    Givens recurrences, Paige & Saunders)."""
    x = torch.zeros_like(b) if x0 is None else x0
    r0 = b - A(x)
    bnorm = torch.clamp_min(_nrm(b), 1e-30)
    beta1 = _nrm(r0)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    zero = torch.zeros((), dtype=b.dtype, device=b.device)

    v_prev = torch.zeros_like(b)
    v = r0 / torch.clamp_min(beta1, 1e-30)
    w = torch.zeros_like(b)
    w_prev = torch.zeros_like(b)
    beta = beta1
    c, s, c_prev, s_prev = one, zero, one, zero
    eta = beta1
    res = beta1 / bnorm
    k = 0
    while k < max_iter and host_test(res > tol):
        Av = A(v)
        alpha = _dot(v, Av)
        v_next = Av - alpha * v - beta * v_prev
        beta_next = _nrm(v_next)
        v_next = v_next / torch.clamp_min(beta_next, 1e-30)

        # apply the previous two Givens rotations to the new column
        delta = c * alpha - c_prev * s * beta
        rho2 = s * alpha + c_prev * c * beta
        rho3 = s_prev * beta
        # new rotation annihilating beta_next
        rho1 = torch.sqrt(delta * delta + beta_next * beta_next)
        rho1 = torch.clamp_min(rho1, 1e-30)
        c_new = delta / rho1
        s_new = beta_next / rho1

        w_next = (v - rho2 * w - rho3 * w_prev) / rho1
        x = x + c_new * eta * w_next
        eta = -s_new * eta
        v_prev, v, w_prev, w = v, v_next, w, w_next
        beta = beta_next
        c_prev, s_prev, c, s = c, s, c_new, s_new
        res = torch.abs(eta) / bnorm
        k += 1
    return LSSolution(x=x, iterations=_count(k, b), residual=res)


def solve_gmres(A: Callable, b: Tensor, x0: Optional[Tensor] = None,
                Minv: Callable = _ident, restart: int = 30,
                max_restarts: int = 10, tol: float = 1e-8) -> LSSolution:
    """Restarted GMRES(m) with Arnoldi + Givens QR.

    The Krylov basis is a fixed (m+1, n) buffer; a cycle's m Arnoldi steps
    all run, and each step's results are masked away once the cycle has
    converged (a fixed-length loop with masks: no host read inside a
    cycle)."""
    n = b.shape[0]
    m = restart
    x = torch.zeros_like(b) if x0 is None else x0
    bnorm = torch.clamp_min(_nrm(b), 1e-30)
    idx = torch.arange(m + 1, device=b.device)

    def arnoldi_step(j, V, H, cs, sn, g):
        w = Minv(A(V[j]))
        # modified Gram-Schmidt against all basis vectors (masked > j)
        Vm = torch.where((idx <= j)[:, None], V, torch.zeros_like(V))
        hcol = torch.sum(Vm * w[None, :], dim=1)
        w = w - torch.sum(Vm * hcol[:, None], dim=0)
        hj1 = _nrm(w)
        V = V.clone()
        V[j + 1] = w / torch.clamp_min(hj1, 1e-30)
        hcol = hcol.clone()
        hcol[j + 1] = hj1
        # apply the existing Givens rotations to the new column
        for i in range(j):
            hi, hi1 = hcol[i], hcol[i + 1]
            hcol = hcol.clone()
            hcol[i] = cs[i] * hi + sn[i] * hi1
            hcol[i + 1] = -sn[i] * hi + cs[i] * hi1
        denom = torch.sqrt(hcol[j] ** 2 + hcol[j + 1] ** 2)
        denom = torch.clamp_min(denom, 1e-30)
        c_j = hcol[j] / denom
        s_j = hcol[j + 1] / denom
        hcol = hcol.clone()
        hcol[j] = denom
        hcol[j + 1] = 0.0
        cs, sn, g, H = cs.clone(), sn.clone(), g.clone(), H.clone()
        cs[j] = c_j
        sn[j] = s_j
        g_j = g[j]
        g[j + 1] = -s_j * g_j
        g[j] = c_j * g_j
        H[:, j] = hcol
        return V, H, cs, sn, g

    def one_cycle(x):
        r = Minv(b - A(x))
        beta = _nrm(r)
        V = torch.zeros((m + 1, n), dtype=b.dtype, device=b.device)
        V[0] = r / torch.clamp_min(beta, 1e-30)
        H = torch.zeros((m + 1, m), dtype=b.dtype, device=b.device)
        cs = torch.zeros((m,), dtype=b.dtype, device=b.device)
        sn = torch.zeros((m,), dtype=b.dtype, device=b.device)
        g = torch.zeros((m + 1,), dtype=b.dtype, device=b.device)
        g[0] = beta
        done = torch.zeros((), dtype=torch.bool, device=b.device)
        # the cycle's m steps, masked once converged (fixed length, no read)
        for j in range(m):
            new = arnoldi_step(j, V, H, cs, sn, g)
            V, H, cs, sn, g = (torch.where(done, old, nw) for old, nw in
                               zip((V, H, cs, sn, g), new))
            done = done | (torch.abs(g[j + 1]) / bnorm < tol)

        # back-substitution on the m×m upper-triangular H (masked full solve)
        y = torch.zeros((m,), dtype=b.dtype, device=b.device)
        for i in reversed(range(m)):
            rhs = g[i] - _dot(H[i, :], y)
            ok = torch.abs(H[i, i]) > 1e-30
            yi = rhs / torch.where(ok, H[i, i], torch.ones_like(rhs))
            y = y.clone()
            y[i] = torch.where(ok, yi, torch.zeros_like(yi))
        x = x + V[:m].T @ y
        return x, _nrm(b - A(x)) / bnorm

    res = torch.ones((), dtype=b.dtype, device=b.device)
    outer = 0
    # the restart test, read on the host once a cycle
    while outer < max_restarts and host_test(res > tol):
        x, res = one_cycle(x)
        outer += 1
    return LSSolution(x=x, iterations=_count(outer * m, b), residual=res)
