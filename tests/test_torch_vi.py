"""The VI and Krylov solvers, the cone projector and the gather plan: the
port against the JAX package.

The operators are made with numpy from a seed: a dense SPD Schur-like
matrix N over 4 bilateral rows and 6 contact triples (and 6 rolling
triples), a non-symmetric matrix for BiCGStab and GMRES, and packed rows
over 7 bodies (the first fixed) for the gather plan.  The JAX solvers run
jitted, with ``tol`` traced so that one compile serves every tolerance.
At ``tol = 0`` both sides run exactly ``max_iter`` iterations; at a finite
``tol`` both must stop at the same iteration.  Last, ``_solve`` with CG,
MINRES and GMRES on ``bench_mbs``'s bilateral rows (the port's rows, fed
to both packages).

Both sides run in float32 on the CPU and sum in other orders, so γ is held
at rtol 1e-4 with an absolute floor of 1e-5 of its largest entry unless a
test says why not.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chrono_tpu.core import functions as JF
from chrono_tpu.physics import system as jsys
from chrono_tpu.physics.builder import SystemBuilder as JBuilder
from chrono_tpu.physics.constraints import ConstraintRows as JRows
from chrono_tpu.solver import descriptor as jdesc
from chrono_tpu.solver import krylov as jkry
from chrono_tpu.solver import projection as jproj
from chrono_tpu.solver import vi as jvi

from chrono_tpu_torch import convert
from chrono_tpu_torch.physics import system as tsys
from chrono_tpu_torch.solver import descriptor as tdesc
from chrono_tpu_torch.solver import krylov as tkry
from chrono_tpu_torch.solver import projection as tproj
from chrono_tpu_torch.solver import vi as tvi

from test_torch_mbs import bench_mbs, leaves

NB, NC = 4, 6                     # bilateral rows, contact triples
M = NB + 3 * NC
O0 = {"xla_backend_optimization_level": 0}


def jit(fn):
    return jax.jit(fn, compiler_options=O0)


def close(got, ref, rtol=1e-4, floor=1e-5, what=""):
    ref = np.asarray(ref)
    np.testing.assert_allclose(
        got.numpy() if isinstance(got, torch.Tensor) else got, ref,
        rtol=rtol, atol=floor * max(float(np.abs(ref).max()), 1e-30),
        err_msg=what)


def spd(n, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, n + 4))
    return (scale * (A @ A.T / (n + 4) + 0.05 * np.eye(n))).astype(
        np.float32)


@pytest.fixture(scope="module")
def problem():
    """A mixed VI: N (M×M SPD), r, μ, and rolling coefficients."""
    rng = np.random.default_rng(11)
    N = spd(M, 12)
    r = rng.normal(size=M).astype(np.float32)
    mu = rng.uniform(0.2, 0.8, NC).astype(np.float32)
    return N, r, mu


def projectors(mu, rolling):
    nr = NC if rolling else 0
    kw = dict(n_rolling=nr, mu_roll=0.05 if rolling else 0.0,
              mu_spin=0.02 if rolling else 0.0)
    return (jproj.make_projector(NB, NC, jnp.asarray(mu), **kw),
            tproj.make_projector(NB, NC, torch.tensor(mu), **kw))


# ------------------------------------------------------------- projection

@pytest.mark.parametrize("rolling", [False, True])
def test_cone_projection(rolling):
    """Every regime of the cone (inside, polar, surface, frictionless) and,
    with rolling, the spinning and rolling cones on the same normal."""
    rng = np.random.default_rng(3 + rolling)
    mu = rng.uniform(0.0, 0.8, NC).astype(np.float32)
    mu[0] = 0.0
    jp, tp = projectors(mu, rolling)
    m = M + (3 * NC if rolling else 0)
    g = (rng.normal(size=(5, m)) * (1 + 3 * np.arange(5))[:, None]).astype(
        np.float32)
    ref = np.asarray(jit(jax.vmap(jp))(jnp.asarray(g)))
    for k in range(5):
        got = tp(torch.tensor(g[k]))
        np.testing.assert_allclose(got.numpy(), ref[k], rtol=1e-6,
                                   atol=1e-6)
    gc = rng.normal(size=(50, 3)).astype(np.float32)
    muc = rng.uniform(0, 1, 50).astype(np.float32)
    np.testing.assert_allclose(
        tproj.project_friction_cone(torch.tensor(gc), torch.tensor(muc)),
        np.asarray(jit(jproj.project_friction_cone)(jnp.asarray(gc),
                                                    jnp.asarray(muc))),
        rtol=1e-6, atol=1e-7)


# ------------------------------------------------------------ VI solvers

VI = ["apgd", "bb", "pjacobi", "admm"]
MAX_ITER = 15


def _jax_vi(name, N, mu, rolling):
    """A jitted JAX solve ``(r, γ0, tol, max_iter) -> VISolution`` over N
    (``tol`` and ``max_iter`` traced: one compile)."""
    jN = jnp.asarray(N)
    jp, _ = projectors(mu, rolling)

    def Nop(g):
        return jN @ g

    def run(r, g0, tol, max_iter=MAX_ITER):
        if name == "apgd":
            return jvi.solve_apgd(Nop, r, jp, g0, max_iter, tol)
        if name == "bb":
            return jvi.solve_bb(Nop, r, jp, g0, max_iter, tol)
        if name == "admm":
            return jvi.solve_admm(Nop, r, jp, g0, max_iter, tol)
        return jvi.solve_pjacobi(Nop, r, jp, g0, jnp.diag(jN), max_iter,
                                 tol)

    return jax.jit(run, compiler_options=O0)


def _port_vi(name, N, mu, rolling, r, g0, tol, max_iter=MAX_ITER):
    tN = torch.tensor(N)
    _, tp = projectors(mu, rolling)

    def Nop(g):
        return tN @ g

    args = (Nop, torch.tensor(r), tp, torch.tensor(g0))
    if name == "apgd":
        return tvi.solve_apgd(*args, max_iter, tol)
    if name == "bb":
        return tvi.solve_bb(*args, max_iter, tol)
    if name == "admm":
        return tvi.solve_admm(*args, max_iter, tol)
    return tvi.solve_pjacobi(*args, torch.diagonal(tN), max_iter, tol)


# a finite tolerance each solver reaches inside max_iter, and that max_iter
# (projected Jacobi at ω = 0.3 converges slowly)
FINITE = {"apgd": (1e-2, MAX_ITER), "bb": (1e-2, MAX_ITER),
          "pjacobi": (1e-2, 80), "admm": (1e-2, 30)}


@pytest.mark.parametrize("name", VI)
def test_vi_solver(name, problem):
    """At tol = 0 both run MAX_ITER iterations and agree on γ (the best
    iterate for APGD and BB) and its residual; at a finite tol both stop at
    the same iteration.  A warm start γ0 ≠ 0 on the mixed problem, then a
    cold one on the rolling problem (APGD and BB).  Past ~15 iterations
    float32 APGD's path on this problem turns on rounding (its restart and
    backtracking tests), so APGD and BB also run 40 iterations in float64
    on both sides (γ within 1e-9)."""
    N, r, mu = problem
    g0 = np.random.default_rng(5).normal(size=M).astype(np.float32) * 0.1
    run = _jax_vi(name, N, mu, False)
    for tol, max_iter in ((0.0, MAX_ITER), FINITE[name]):
        ref = run(jnp.asarray(r), jnp.asarray(g0), jnp.float32(tol),
                  jnp.int32(max_iter))
        got = _port_vi(name, N, mu, False, r, g0, tol, max_iter)
        assert int(got.iterations) == int(ref.iterations), tol
        if tol == 0.0:
            assert int(got.iterations) == MAX_ITER
        else:
            assert int(got.iterations) < max_iter
        close(got.gamma, ref.gamma, what=f"{name} tol={tol}")
        close(got.residual, ref.residual, rtol=1e-3, what="residual")

    if name not in ("apgd", "bb"):
        return          # their float32 paths hold: no float64 or rolling run
    # float64 on both sides: 40 iterations, past float32's floor
    with jax.enable_x64(True):
        ref = _jax_vi(name, N.astype(np.float64), mu.astype(np.float64),
                      False)(jnp.asarray(r, jnp.float64),
                             jnp.asarray(g0, jnp.float64), 0.0, 40)
        got = _port_vi(name, N.astype(np.float64), mu.astype(np.float64),
                       False, r.astype(np.float64), g0.astype(np.float64),
                       0.0, 40)
    assert got.gamma.dtype == torch.float64
    assert int(got.iterations) == int(ref.iterations) == 40
    close(got.gamma, ref.gamma, rtol=1e-9, floor=1e-10, what="float64")

    m = M + 3 * NC
    Nr = spd(m, 13)
    rr = np.random.default_rng(14).normal(size=m).astype(np.float32)
    z = np.zeros(m, np.float32)
    ref = _jax_vi(name, Nr, mu, True)(jnp.asarray(rr), jnp.asarray(z),
                                      jnp.float32(0.0))
    got = _port_vi(name, Nr, mu, True, rr, z, 0.0)
    assert int(got.iterations) == int(ref.iterations) == MAX_ITER
    close(got.gamma, ref.gamma, what=f"{name}, rolling")


def test_apgd_with_history(problem):
    N, r, mu = problem
    jN, tN = jnp.asarray(N), torch.tensor(N)
    jp, tp = projectors(mu, False)
    ref_sol, ref_hist = jax.jit(lambda rr: jvi.solve_apgd_with_history(
        lambda g: jN @ g, rr, jp, jnp.zeros(M), 30),
        compiler_options=O0)(jnp.asarray(r))
    sol, hist = tvi.solve_apgd_with_history(lambda g: tN @ g,
                                            torch.tensor(r), tp,
                                            torch.zeros(M), 30)
    assert int(sol.iterations) == int(ref_sol.iterations) == 30
    close(sol.gamma, ref_sol.gamma)
    close(hist.violation, ref_hist.violation, rtol=2e-3, floor=1e-4)
    close(hist.delta_gamma, ref_hist.delta_gamma, rtol=2e-3, floor=1e-4)


def test_host_reads_are_counted(problem):
    """Every loop test is one counted read: APGD at tol = 0 reads its outer
    test MAX_ITER times and its backtracking test at least once an
    iteration."""
    N, r, mu = problem
    tvi.reset_host_reads()
    _port_vi("apgd", N, mu, False, r, np.zeros(M, np.float32), 0.0)
    assert tvi.host_reads() >= 2 * MAX_ITER
    tvi.reset_host_reads()
    assert tvi.host_reads() == 0


# -------------------------------------------------------- Krylov solvers

def _krylov(pkg, name, A, b, restart, tol):
    """One Krylov solve in ``pkg`` (jkry or tkry) on the matrix A."""
    if pkg is jkry:
        A = jnp.asarray(A)
        dinv = 1.0 / jnp.diag(A)
    else:
        A = torch.as_tensor(A)
        dinv = 1.0 / torch.diagonal(A)

    def Aop(x):
        return A @ x

    def Minv(x):
        return dinv * x

    if name == "cg":
        return pkg.solve_cg(Aop, b, Minv=Minv, max_iter=80, tol=tol)
    if name == "bicgstab":
        return pkg.solve_bicgstab(Aop, b, Minv=Minv, max_iter=80, tol=tol)
    if name == "minres":
        return pkg.solve_minres(Aop, b, max_iter=80, tol=tol)
    return pkg.solve_gmres(Aop, b, Minv=Minv, restart=restart,
                           max_restarts=10, tol=tol)


def _krylov_pair(name, n, restart, dtype, tol):
    rng = np.random.default_rng(20 + n)
    A = spd(n, 21 + n, scale=2.0)
    if name in ("bicgstab", "gmres"):
        S = rng.normal(size=(n, n)).astype(np.float32) * 0.05
        A = (A + S - S.T).astype(np.float32)
    b = rng.normal(size=n).astype(np.float32)
    A, b = A.astype(dtype), b.astype(dtype)
    ref = jax.jit(lambda bb: _krylov(jkry, name, A, bb, restart, tol),
                  compiler_options=O0)(jnp.asarray(b))
    got = _krylov(tkry, name, A, torch.tensor(b), restart, tol)
    return got, ref


KRYLOV = [("cg", 24, 0, 1e-5), ("bicgstab", 24, 0, 1e-4),
          ("minres", 60, 0, 1e-5),
          # GMRES converging inside its first cycle (the masked steps past
          # convergence), and restarting
          ("gmres", 16, 30, 1e-5), ("gmres", 40, 12, 1e-4)]


@pytest.mark.parametrize("name,n,restart,tol32", KRYLOV)
def test_krylov_solver(name, n, restart, tol32):
    """In float64 (both packages) at tol 1e-9: the same iteration count
    and x within 1e-9.  In float32 at a tolerance above its floor for a
    relative residual: both converge, x within rtol 1e-3, the counts
    within 2 (near convergence these methods gain orders of magnitude an
    iteration, so where float32 rounding crosses the tolerance a step
    early or late depends on the summation order)."""
    with jax.enable_x64(True):
        got, ref = _krylov_pair(name, n, restart, np.float64, 1e-9)
    assert got.x.dtype == torch.float64
    assert int(got.iterations) == int(ref.iterations)
    close(got.x, ref.x, rtol=1e-9, floor=1e-10)
    if name == "gmres" and restart == 30:
        assert int(got.iterations) == 30    # one cycle, masked past its end
    got, ref = _krylov_pair(name, n, restart, np.float32, tol32)
    assert abs(int(got.iterations) - int(ref.iterations)) <= 2
    assert float(got.residual) <= tol32 and float(ref.residual) <= tol32
    close(got.x, ref.x, rtol=1e-3, floor=1e-4)


# ---------------------------------------------------------- gather plan

def _packed_rows(seed, n_bodies=7, m=40):
    """Random packed rows over ``n_bodies`` bodies, body 0 fixed, a few
    rows inactive; the same rows in both packages."""
    rng = np.random.default_rng(seed)
    ba = rng.integers(0, n_bodies, m).astype(np.int32)
    bb = rng.integers(0, n_bodies, m).astype(np.int32)
    J = rng.normal(size=(4, m, 3)).astype(np.float32)
    active = rng.uniform(size=m) > 0.15
    rhs = rng.normal(size=m).astype(np.float32)
    inv_mass = rng.uniform(0.5, 2.0, n_bodies).astype(np.float32)
    inv_inertia = rng.uniform(0.5, 2.0, (n_bodies, 3)).astype(np.float32)
    inv_mass[0], inv_inertia[0] = 0.0, 0.0
    fields = dict(body_a=ba, body_b=bb, Ja_v=J[0], Ja_w=J[1], Jb_v=J[2],
                  Jb_w=J[3], rhs=rhs, active=active)
    jrows = JRows.two_body(**{k: jnp.asarray(v) for k, v in fields.items()})
    trows = tsys.ConstraintRows.two_body(
        **{k: torch.as_tensor(v) for k, v in fields.items()})
    jm = jnp.concatenate([jnp.broadcast_to(jnp.asarray(inv_mass)[:, None],
                                           (n_bodies, 3)),
                          jnp.asarray(inv_inertia),
                          jnp.zeros((n_bodies, 2))], axis=1)
    tm = torch.as_tensor(np.asarray(jm))
    return (jdesc.pack_rows(jrows, has_c=False), jm,
            tdesc.pack_rows(trows, has_c=False), tm)


def test_gather_plan():
    """``build_gather_plan`` equals the JAX package's table and overflow
    when no body passes the cap, and its ``Dᵀγ`` equals the scatter form
    and the side plan; with a small V both packages flag the overflow."""
    jp, jm, tp, tm = _packed_rows(30)
    gamma = np.random.default_rng(31).normal(size=tp.m).astype(np.float32)
    jg, tg = jnp.asarray(gamma), torch.tensor(gamma)
    ref = jit(lambda p, m: jdesc.build_gather_plan(p, m, 64))(jp, jm)
    plan = tdesc.build_gather_plan(tp, tm, max_rows_per_body=64)
    assert int(ref.overflow) == int(plan.overflow) == 0
    np.testing.assert_array_equal(plan.table.numpy(), np.asarray(ref.table))
    np.testing.assert_array_equal(plan.J_sides.numpy(),
                                  np.asarray(ref.J_sides))
    dt = tdesc.apply_DT_gather(plan, tg)
    close(dt, jdesc.apply_DT_gather(ref, jg), rtol=1e-6, floor=1e-6)
    # the scatter form and the side plan (fixed body 0 aside: the plans
    # leave it out, M⁻¹ annihilates it)
    scatter = tdesc.apply_DT_packed(tp, tg, tm.shape[0])
    sides = tdesc.apply_DT_sorted(tdesc.build_side_plan(tp, tm), tg)
    np.testing.assert_allclose(dt[1:].numpy(), scatter[1:].numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(sides[1:].numpy(), scatter[1:].numpy(),
                               rtol=1e-5, atol=1e-5)
    assert not sides[0].any()
    close(tdesc.schur_product_plan(tp, tm, plan, tg),
          jdesc.schur_product_plan(jp, jm, ref, jg), rtol=1e-5, floor=1e-5)
    close(tdesc.schur_product_sorted(tp, tm, tdesc.build_side_plan(tp, tm),
                                     tg),
          jdesc.schur_product_packed(jp, jm, jg), rtol=1e-5, floor=1e-5)
    close(tdesc.diag_N_packed(tp, tm), jdesc.diag_N_packed(jp, jm),
          rtol=1e-6, floor=1e-7)
    # a small V: the same overflow flag
    for V in (3,):
        ref = jit(lambda p, m: jdesc.build_gather_plan(p, m, V))(jp, jm)
        plan = tdesc.build_gather_plan(tp, tm, max_rows_per_body=V)
        assert int(plan.overflow) == int(ref.overflow) > 0


def test_side_plan_sums_in_scatter_order():
    """The side plan adds a body's a-sides in row order, then its b-sides:
    the order of a sequential scatter, so its sums equal a float64-free
    Python loop in that order to the bit."""
    _, _, tp, tm = _packed_rows(32, n_bodies=5, m=60)
    g = torch.tensor(np.random.default_rng(33).normal(
        size=tp.m).astype(np.float32))
    got = tdesc.apply_DT_sorted(tdesc.build_side_plan(tp, tm), g)
    want = torch.zeros_like(got)
    for J, body in ((tp.Ja, tp.body_a), (tp.Jb, tp.body_b)):
        for i in range(tp.m):
            b = int(body[i])
            if b > 0 and bool(tp.active[i]):
                want[b] = want[b] + J[i] * g[i]
    assert torch.equal(got, want)


def test_channel_split_operators():
    """``schur_product``, ``schur_rhs``, ``velocity_update``, ``diag_N``
    and ``apply_Minv`` on three-body rows (a third body with rotational
    Jacobians)."""
    rng = np.random.default_rng(40)
    n, m = 6, 25
    f = dict(body_a=rng.integers(0, n, m).astype(np.int32),
             body_b=rng.integers(0, n, m).astype(np.int32),
             body_c=rng.integers(0, n, m).astype(np.int32),
             **{k: rng.normal(size=(m, 3)).astype(np.float32)
                for k in ("Ja_v", "Ja_w", "Jb_v", "Jb_w", "Jc_w")},
             rhs=rng.normal(size=m).astype(np.float32),
             active=rng.uniform(size=m) > 0.2)
    jrows = JRows(**{k: jnp.asarray(v) for k, v in f.items()})
    trows = tsys.ConstraintRows(**{k: torch.as_tensor(v)
                                   for k, v in f.items()})
    pr = dict(inv_mass=rng.uniform(0.5, 2, n).astype(np.float32),
              inertia=np.ones((n, 3), np.float32),
              inv_inertia=rng.uniform(0.5, 2, (n, 3)).astype(np.float32))
    from chrono_tpu.physics.body import BodyProps as JProps
    from chrono_tpu_torch.physics.body import BodyProps as TProps
    jprops = JProps(**{k: jnp.asarray(v) for k, v in pr.items()})
    tprops = TProps(**{k: torch.as_tensor(v) for k, v in pr.items()})
    g = rng.normal(size=m).astype(np.float32)
    v, w = (rng.normal(size=(n, 3)).astype(np.float32) for _ in range(2))
    close(tdesc.schur_product(trows, tprops, torch.tensor(g)),
          jdesc.schur_product(jrows, jprops, jnp.asarray(g)), rtol=1e-5)
    close(tdesc.schur_rhs(trows, torch.tensor(v), torch.tensor(w)),
          jdesc.schur_rhs(jrows, jnp.asarray(v), jnp.asarray(w)), rtol=1e-5)
    for a, b in zip(tdesc.velocity_update(trows, tprops, torch.tensor(g),
                                          torch.tensor(v), torch.tensor(w)),
                    jdesc.velocity_update(jrows, jprops, jnp.asarray(g),
                                          jnp.asarray(v), jnp.asarray(w))):
        close(a, b, rtol=1e-5)
    close(tdesc.diag_N(trows, tprops), jdesc.diag_N(jrows, jprops),
          rtol=1e-6)
    for a, b in zip(tdesc.apply_Minv(tprops, torch.tensor(v),
                                     torch.tensor(w)),
                    jdesc.apply_Minv(jprops, jnp.asarray(v),
                                     jnp.asarray(w))):
        close(a, b, rtol=1e-7, floor=0)


# ------------------------------------------------ _solve on bench_mbs rows

@pytest.mark.parametrize("solver", ["cg", "minres", "gmres"])
def test_solve_krylov_on_bench_mbs(solver):
    """``_solve`` with a Krylov solver on ``bench_mbs``'s bilateral rows at
    random free velocities: the same rows in both packages (the port's,
    carried across), the same iteration count, γ within the tolerance."""
    jm, js = bench_mbs(JBuilder(), JF)
    tm = convert.mbs_model_from_numpy(leaves(jm), device="cpu")
    ts = convert.body_state_from_numpy(
        {f: np.asarray(getattr(js, f)) for f in "xqvw"}, device="cpu")
    rows = tsys.bilateral_rows(tm, ts, torch.tensor(0.0), 1e-3,
                               tsys.SolverSettings())
    jrows = JRows(**{f: jnp.asarray(getattr(rows, f).numpy())
                     for f in ("body_a", "body_b", "body_c", "Ja_v", "Ja_w",
                               "Jb_v", "Jb_w", "Jc_w", "rhs", "active")})
    rng = np.random.default_rng(50)
    v = rng.normal(size=ts.v.shape).astype(np.float32)
    w = rng.normal(size=ts.w.shape).astype(np.float32)
    kw = dict(solver=solver, max_iter=60, tol=1e-6)
    ref = jax.jit(lambda vv, ww: jsys._solve(
        jrows, jm, vv, ww, jsys.SolverSettings(**kw)),
        compiler_options=O0)(jnp.asarray(v), jnp.asarray(w))
    got = tsys._solve(rows, tm, torch.tensor(v), torch.tensor(w),
                      tsys.SolverSettings(**kw))
    assert int(got[1]) == int(ref[1])
    close(got[0], ref[0], rtol=1e-3, floor=1e-4)
