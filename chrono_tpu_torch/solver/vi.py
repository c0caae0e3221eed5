"""Matrix-free cone-complementarity (VI) solvers.

Counterpart of ``chrono_tpu/solver/vi.py``: APGD, Barzilai–Borwein,
projected Jacobi, ADMM and the APGD variant that records its history, on a
generic operator ``Nop`` (the Schur complement, see ``descriptor.py``) and
a projector onto the feasible cone.

Problem: minimize ``q(γ) = ½ γᵀNγ + rᵀγ``  s.t. ``γ ∈ K``  (K = ℝ^mb × ∏ cones).

The solvers' loops end on data.  The JAX package runs each as a
``lax.while_loop`` on the device; this port runs each as a Python loop
over device tensors that reads each loop test on the host, one small read
(:func:`host_test`) a test: the outer test ``k < max_iter and res_best >
tol`` once an iteration, and APGD's backtracking test (up to 12 tries) and
BB's nonmonotone line-search test (up to 10) once a try.  This is the
reference's own control flow (``ChSolverAPGD`` runs on the CPU), gives the
JAX package's iteration counts and returns its ``g_best``, the best
iterate, not the last.  :func:`host_reads` counts the reads.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch import Tensor


class VISolution(NamedTuple):
    gamma: Tensor
    iterations: Tensor   # () int32
    residual: Tensor     # () float


_READS = [0]


def host_test(flag: Tensor) -> bool:
    """Read a device boolean on the host (one read, counted)."""
    _READS[0] += 1
    return bool(flag)


def host_reads() -> int:
    """Host reads of loop tests since the last :func:`reset_host_reads`."""
    return _READS[0]


def reset_host_reads() -> None:
    _READS[0] = 0


def _norm(x: Tensor) -> Tensor:
    return torch.sqrt(torch.sum(x * x))


def _dot(a: Tensor, b: Tensor) -> Tensor:
    # jnp.dot's counterpart: a BLAS dot, not torch.sum(a * b), whose float32
    # rounding stalls APGD's backtracking test (q(γ) of order 1e4 against
    # its 1e-12 margin) two orders of magnitude above the JAX package's
    # residual on the mixer's rows
    return torch.dot(a, b)


def _count(k: int, like: Tensor) -> Tensor:
    return torch.tensor(k, dtype=torch.int32, device=like.device)


def _scalar(v, like: Tensor) -> Tensor:
    return torch.full((), v, dtype=like.dtype, device=like.device)


def solve_apgd(
    Nop: Callable[[Tensor], Tensor],
    r: Tensor,
    project: Callable[[Tensor], Tensor],
    gamma0: Tensor,
    max_iter: int = 100,
    tol: float = 1e-6,
) -> VISolution:
    """Accelerated projected gradient descent (Nesterov) with adaptive
    Lipschitz estimate, backtracking and gradient-based restart; each
    iteration costs 1 + (backtracks) Schur products."""
    gamma = project(gamma0)
    ones = torch.ones_like(gamma)
    dg0 = _norm(ones - gamma)
    L0 = torch.where(
        dg0 > 0, _norm(Nop(ones) - Nop(gamma)) / torch.clamp_min(dg0, 1e-30),
        torch.ones_like(dg0))
    L = torch.clamp_min(L0, 1e-10)

    def q_val(g, Ng):
        return 0.5 * _dot(g, Ng) + _dot(g, r)

    one = _scalar(1.0, r)
    theta = one
    y = gamma
    g_best = gamma
    res_best = _scalar(float("inf"), r)
    k = 0
    # the outer test, read on the host once an iteration
    while k < max_iter and host_test(res_best > tol):
        Ny = Nop(y)
        grad_y = Ny + r
        qy = q_val(y, Ny)

        def backtrack(L, g_new, Ng_new):
            d = g_new - y
            ub = qy + _dot(grad_y, d) + 0.5 * L * torch.sum(d * d)
            return q_val(g_new, Ng_new) > ub + 1e-12

        # backtracking: find L s.t. q(g+) <= q(y) + grad·d + L/2 |d|^2, up
        # to 12 doublings, the test read on the host once a try
        g_new = project(y - grad_y / L)
        Ng_new = Nop(g_new)
        tries = 0
        while tries < 12 and host_test(backtrack(L, g_new, Ng_new)):
            L = 2.0 * L
            g_new = project(y - grad_y / L)
            Ng_new = Nop(g_new)
            tries += 1

        # Nesterov momentum
        th = theta
        th_new = 0.5 * (-th * th + th * torch.sqrt(th * th + 4.0))
        beta = th * (1.0 - th) / (th * th + th_new)
        y_new = g_new + beta * (g_new - gamma)

        # restart on non-descent
        restart = _dot(grad_y, g_new - gamma) > 0
        y_new = torch.where(restart, g_new, y_new)
        th_new = torch.where(restart, one, th_new)

        # natural-map residual at g_new (Ng_new from the backtracking)
        res = _norm(g_new - project(g_new - (Ng_new + r))) / torch.clamp_min(
            _norm(g_new), 1.0)
        better = res < res_best
        g_best = torch.where(better, g_new, g_best)
        res_best = torch.where(better, res, res_best)

        k += 1
        gamma, y, theta, L = g_new, y_new, th_new, 0.9 * L
    return VISolution(g_best, _count(k, r), res_best)


def solve_bb(
    Nop: Callable[[Tensor], Tensor],
    r: Tensor,
    project: Callable[[Tensor], Tensor],
    gamma0: Tensor,
    max_iter: int = 100,
    tol: float = 1e-6,
    history: int = 10,
) -> VISolution:
    """Projected Barzilai–Borwein spectral gradient with nonmonotone
    (Grippo-style) line search."""
    gamma = project(gamma0)

    def q_and_grad(g):
        Ng = Nop(g)
        return 0.5 * _dot(g, Ng) + _dot(g, r), Ng + r

    q0, grad = q_and_grad(gamma)
    fhist = torch.full((history,), float("-inf"), dtype=r.dtype,
                       device=r.device)
    fhist[0] = q0
    alpha = _scalar(1.0, r)
    g_best = gamma
    res_best = _scalar(float("inf"), r)
    k = 0
    # the outer test, read on the host once an iteration
    while k < max_iter and host_test(res_best > tol):
        f_ref = torch.max(fhist)

        # projected step along the spectral step length, halving until the
        # nonmonotone Armijo condition holds (up to 10 halvings, the test
        # read on the host once a try)
        lam = _scalar(1.0, r)
        g_new = project(gamma - alpha * grad)
        q_new, _ = q_and_grad(g_new)
        tries = 0
        while tries < 10 and host_test(
                q_new > f_ref + 1e-4 * _dot(grad, g_new - gamma)):
            lam = 0.5 * lam
            g_new = project(gamma - lam * alpha * grad)
            q_new, _ = q_and_grad(g_new)
            tries += 1
        _, grad_new = q_and_grad(g_new)

        # BB1 spectral step from (s_k, y_k)
        sk = g_new - gamma
        yk = grad_new - grad
        sy = _dot(sk, yk)
        ss = _dot(sk, sk)
        alpha = torch.where(sy > 1e-30, ss / torch.clamp_min(sy, 1e-30),
                            alpha)
        alpha = torch.clamp(alpha, 1e-12, 1e12)

        fhist = torch.cat([q_new[None], fhist[:-1]])
        res = _norm(g_new - project(g_new - grad_new)) / torch.clamp_min(
            _norm(g_new), 1.0)
        better = res < res_best
        g_best = torch.where(better, g_new, g_best)
        res_best = torch.where(better, res, res_best)
        k += 1
        gamma, grad = g_new, grad_new
    return VISolution(g_best, _count(k, r), res_best)


def solve_pjacobi(
    Nop: Callable[[Tensor], Tensor],
    r: Tensor,
    project: Callable[[Tensor], Tensor],
    gamma0: Tensor,
    diag: Tensor,
    max_iter: int = 200,
    tol: float = 1e-6,
    omega: float = 0.3,
) -> VISolution:
    """Projected (under-relaxed) Jacobi iteration with per-row diagonal
    scaling: the data-parallel stand-in for the reference's PSOR."""
    inv_d = 1.0 / torch.clamp_min(diag, 1e-30)
    g = project(gamma0)
    res = _scalar(float("inf"), r)
    k = 0
    # the loop test, read on the host once an iteration
    while k < max_iter and host_test(res > tol):
        grad = Nop(g) + r
        g_new = project(g - omega * inv_d * grad)
        res = _norm(g_new - g) / torch.clamp_min(_norm(g_new), 1.0)
        g = g_new
        k += 1
    return VISolution(g, _count(k, r), res)


def solve_admm(
    Nop: Callable[[Tensor], Tensor],
    r: Tensor,
    project: Callable[[Tensor], Tensor],
    gamma0: Tensor,
    max_iter: int = 60,
    tol: float = 1e-6,
    rho: float = 1.0,
    inner_cg: int = 8,
    adaptive_rho: bool = True,
) -> VISolution:
    """ADMM with cone splitting and residual-balancing ρ adaptation:

      γ-update  (N + ρI) γ = ρ(z − u) − r     (``inner_cg`` CG iterations)
      z-update  z = Π(γ + u)
      u-update  u += γ − z
      ρ-update  ρ·τ when the primal residual dominates, ρ/τ when the dual
                does (u rescaled to keep the scaled dual consistent)
    """
    z = project(gamma0)
    u = torch.zeros_like(z)

    def cg(b, x0, rho_k):
        # fixed-iteration CG on (N + ρI) x = b: no host read
        def Aop(x):
            return Nop(x) + rho_k * x

        x = x0
        res = b - Aop(x0)
        p = res
        rs = _dot(res, res)
        for _ in range(inner_cg):
            Ap = Aop(p)
            alpha = rs / torch.clamp_min(_dot(p, Ap), 1e-30)
            x = x + alpha * p
            res = res - alpha * Ap
            rs_new = _dot(res, res)
            beta = rs_new / torch.clamp_min(rs, 1e-30)
            p = res + beta * p
            rs = rs_new
        return x

    gamma = z
    rho_t = _scalar(rho, r)
    res = _scalar(float("inf"), r)
    k = 0
    # the loop test, read on the host once an iteration
    while k < max_iter and host_test(res > tol):
        gamma = cg(rho_t * (z - u) - r, gamma, rho_t)
        z_new = project(gamma + u)
        u_new = u + gamma - z_new
        r_pri = _norm(gamma - z_new)
        r_dua = rho_t * _norm(z_new - z)
        res = (r_pri + r_dua) / torch.clamp_min(_norm(z_new), 1.0)
        rho_new = rho_t
        if adaptive_rho:
            mu_b, tau = 10.0, 2.0
            up = r_pri > mu_b * r_dua
            dn = r_dua > mu_b * r_pri
            rho_new = torch.where(up, rho_t * tau,
                                  torch.where(dn, rho_t / tau, rho_t))
            u_new = u_new * rho_t / rho_new   # keep the scaled dual variable
        z, u, rho_t = z_new, u_new, rho_new
        k += 1
    return VISolution(z, _count(k, r), res)


class VIHistory(NamedTuple):
    """Per-iteration records (the reference's ChIterativeSolverVI
    violation histories)."""

    violation: Tensor    # (max_iter,) residual/violation per iteration
    delta_gamma: Tensor  # (max_iter,) ‖Δγ‖ per iteration


def solve_apgd_with_history(Nop, r, project, gamma0, max_iter: int = 100,
                            tol: float = 1e-6):
    """APGD for exactly ``max_iter`` iterations (no loop test, no host
    read), recording each iteration's violation and ‖Δγ‖: the
    observability variant of :func:`solve_apgd` (``tol`` is not read, as in
    the JAX package's scan)."""
    gamma = project(gamma0)
    ones = torch.ones_like(gamma)
    dg0 = _norm(ones - gamma)
    L = torch.where(dg0 > 0, _norm(Nop(ones) - Nop(gamma))
                    / torch.clamp_min(dg0, 1e-30), torch.ones_like(dg0))
    L = torch.clamp_min(L, 1e-10)
    y, theta = gamma, _scalar(1.0, r)
    viols, dgams = [], []
    for _ in range(max_iter):
        grad_y = Nop(y) + r
        g_new = project(y - grad_y / L)
        # simple backtracking (one doubling test)
        q_y = 0.5 * _dot(y, Nop(y)) + _dot(y, r)
        q_new = 0.5 * _dot(g_new, Nop(g_new)) + _dot(g_new, r)
        lin = q_y + _dot(grad_y, g_new - y) \
            + 0.5 * L * torch.sum((g_new - y) ** 2)
        L = torch.where(q_new > lin, 2.0 * L, L)
        g_new = project(y - (Nop(y) + r) / L)
        theta_new = 0.5 * (torch.sqrt(theta**4 + 4 * theta**2) - theta**2)
        beta = theta * (1 - theta) / (theta**2 + theta_new)
        y = g_new + beta * (g_new - gamma)
        dgams.append(_norm(g_new - gamma))
        viols.append(_norm(g_new - project(g_new - (Nop(g_new) + r))))
        gamma, theta = g_new, theta_new
    viols = torch.stack(viols)
    return (VISolution(gamma=gamma, iterations=_count(max_iter, r),
                       residual=viols[-1]),
            VIHistory(violation=viols, delta_gamma=torch.stack(dgams)))
