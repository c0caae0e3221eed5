"""The multibody core as a whole: the port against the JAX package.

``bench_suite.py:37-80`` ``bench_mbs`` (config #1: a double pendulum and a
slider-crank), the slider-crank of ``demos/demo_mbs_slider_crank.py`` and a
scene that calls every other builder method are built by both builders;
the port's ``finalize`` must equal the JAX model carried across by
``convert.mbs_model_from_numpy``, to the bit on integer leaves and within
1e-7 on float leaves, and the last one's applied forces must agree.  Then the dense Schur solve
(also on a planar 4-bar, whose parallel revolutes make N rank-deficient
and send both packages to the fallback regularisation), one step in every
``stab_mode`` with and without the Kahan position carry, and 200 steps of
``bench_mbs`` held to the JAX steps at x atol 2e-4 — the JAX package's own
direct-vs-Krylov bound (tests/test_mbs.py:246); the double pendulum is
chaotic, so longer runs are held to invariants on the card instead.  Last,
what the port refuses (an unknown solver) and that it takes shafts, once
refused.

Both sides run in float32 on the CPU.  The JAX step runs eagerly around its
two heavy pieces, the joint lowering and the dense solve, which a
module-scoped fixture jits where the step calls them (XLA's backend
optimisations off to keep the compiles short), so every variant and every
step reuses one compile of each.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chrono_tpu.core import functions as JF
from chrono_tpu.physics import system as jsys
from chrono_tpu.physics.builder import SystemBuilder as JBuilder
from chrono_tpu.physics.joints import joint_rows as j_joint_rows
from chrono_tpu.solver.direct import solve_dense_schur as j_solve

from chrono_tpu_torch import convert
from chrono_tpu_torch.core import functions as TF
from chrono_tpu_torch.physics import system as tsys
from chrono_tpu_torch.physics.builder import SystemBuilder as TBuilder
from chrono_tpu_torch.physics.joints import joint_violation
from chrono_tpu_torch.solver import descriptor as tdesc
from chrono_tpu_torch.solver import direct as tdirect

H = 1e-3
STEP_TOL = dict(rtol=1e-5, atol=1e-6)   # one step, float32 on both sides
X_ATOL_200 = 2e-4                       # tests/test_mbs.py:246


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The tiny LAPACK calls cost milliseconds each with a thread pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# XLA's backend optimisations off: the compiles dominate these tests
O0 = {"xla_backend_optimization_level": 0}


@pytest.fixture(scope="module", autouse=True)
def jax_pieces_compiled_once():
    """The JAX step's two heavy pieces, the joint lowering and the dense
    solve, jitted where the step calls them, so that every step variant and
    every step reuses one trace and one compile of each (per joint kind and
    static setting); the glue between them runs eagerly.  ``jit`` changes
    no result, and nothing in the JAX package is edited."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsys, "joint_rows", jax.jit(
            j_joint_rows, static_argnums=(0, 4, 5, 6), compiler_options=O0))
        mp.setattr(jsys, "solve_dense_schur", jax.jit(j_solve,
                                                      compiler_options=O0))
        yield


# ------------------------------------------------------------------ scenes

def bench_mbs(bld, F):
    """``bench_suite.py:37-80``: double pendulum + slider-crank."""
    g = bld.add_ground()
    p1 = bld.add_body(mass=1.0, pos=(0.5, 0, 0))
    p2 = bld.add_body(mass=1.0, pos=(1.0, 0, 0))
    bld.add_joint("revolute", g, p1, world_pos=(0, 0, 0),
                  world_axis=(0, 1, 0))
    bld.add_joint("revolute", p1, p2, world_pos=(0.5, 0, 0),
                  world_axis=(0, 1, 0))
    crank = bld.add_body(mass=2.0, inertia=(0.1, 0.1, 0.1), pos=(0, 2, 0))
    rod = bld.add_body(mass=1.0, pos=(0.3, 2, 0))
    slider = bld.add_body(mass=0.5, pos=(0.6, 2, 0))
    bld.add_joint("revolute", g, crank, world_pos=(0, 2, 0),
                  world_axis=(0, 1, 0))
    bld.add_joint("spherical", crank, rod, world_pos=(0.15, 2, 0))
    bld.add_joint("spherical", rod, slider, world_pos=(0.6, 2, 0))
    bld.add_joint("prismatic", g, slider, world_pos=(0.6, 2, 0),
                  world_axis=(1, 0, 0))
    return bld.finalize()


R_CRANK, L_ROD = 0.5, 2.0


def slider_crank(bld, F):
    """``demos/demo_mbs_slider_crank.py:18-36``: crank driven at 2 rad/s."""
    r, l = R_CRANK, L_ROD
    ground = bld.add_ground()
    crank = bld.add_body(mass=1.0, inertia=(0.1,) * 3, pos=(r / 2, 0, 0))
    rod = bld.add_body(mass=1.0, inertia=(0.1,) * 3, pos=(r + l / 2, 0, 0))
    slider = bld.add_body(mass=1.0, inertia=(0.1,) * 3, pos=(r + l, 0, 0))
    c = jnp.asarray(2.0) if F is JF else torch.tensor(2.0)
    bld.add_motor_rotation_speed(ground, crank, world_pos=(0, 0, 0),
                                 world_axis=(0, 1, 0), profile=F.FConst(c=c))
    bld.add_joint("spherical", crank, rod, world_pos=(r, 0, 0))
    bld.add_joint("universal", rod, slider, world_pos=(r + l, 0, 0),
                  world_axis=(1, 0, 0))
    bld.add_joint("prismatic", ground, slider, world_pos=(r + l, 0, 0),
                  world_axis=(1, 0, 0))
    return bld.finalize()


def double_pendulum(bld, F):
    g = bld.add_ground()
    p1 = bld.add_body(mass=1.0, inertia=(0.02, 0.03, 0.04),
                      pos=(0.5, 0, 0.1))
    p2 = bld.add_body(mass=0.7, inertia=(0.01, 0.02, 0.02),
                      pos=(1.0, 0, 0.3), vel=(0.0, 0.0, 0.4))
    bld.add_joint("revolute", g, p1, world_pos=(0, 0, 0),
                  world_axis=(0, 1, 0))
    bld.add_joint("revolute", p1, p2, world_pos=(0.8, 0, 0.2),
                  world_axis=(0, 1, 0))
    return bld.finalize()


def four_bar(bld, F):
    """A planar parallelogram 4-bar on four parallel revolutes: 20 rows on
    18 coordinates, so N = D M⁻¹ Dᵀ is rank-deficient."""
    g = bld.add_ground()
    crank = bld.add_body(mass=1.0, inertia=(0.02,) * 3, pos=(0, 0, 0.25))
    coupler = bld.add_body(mass=2.0, inertia=(0.1,) * 3, pos=(0.5, 0, 0.5))
    rocker = bld.add_body(mass=1.0, inertia=(0.02,) * 3, pos=(1, 0, 0.25))
    for a, b, p in ((g, crank, (0, 0, 0)), (crank, coupler, (0, 0, 0.5)),
                    (coupler, rocker, (1, 0, 0.5)), (rocker, g, (1, 0, 0))):
        bld.add_joint("revolute", a, b, world_pos=p, world_axis=(0, 1, 0))
    return bld.finalize()


def every_element(bld, F):
    """Every other builder method once: joints by frames, rev-spherical and
    distance, the four couplers, the six motors (two with a stacked
    profile), a bushing, a TSDA and an RSDA."""
    f32 = jnp.float32 if F is JF else torch.float32

    def num(v):
        return jnp.asarray(v, f32) if F is JF else torch.tensor(v, dtype=f32)

    bld.set_gravity((0.0, -9.81, -1.0))
    g = bld.add_ground()
    b = [bld.add_body(mass=1.0 + i, inertia=(0.1, 0.2 + 0.1 * i, 0.3),
                      pos=(i, 0.5 * i, 0.2), rot=(np.cos(0.3 * i), 0.0,
                                                  np.sin(0.3 * i), 0.0),
                      vel=(0.1, 0.0, -0.2 * i), omega_local=(0.0, 0.3, i))
         for i in range(4)]
    bld.add_joint_frames("weld", g, b[0], fa_pos=(0.1, 0, 0),
                         fb_rot=(np.cos(0.2), np.sin(0.2), 0, 0))
    bld.add_rev_spherical(b[0], b[1], axis_point_world=(0.5, 0, 0.2),
                          axis_world=(0, 0, 1))
    bld.add_distance(b[1], b[2], (1, 0.5, 0.2), (2, 1, 0.2))
    bld.add_gear(b[0], b[1], 2.0, internal=True)
    bld.add_pulley(b[1], b[2], 0.5, axis_a=(0, 1, 0))
    bld.add_rack_pinion(b[2], b[3], 0.1)
    bld.add_screw(b[2], b[3], 0.01, world_pos=(2.5, 1.2, 0.2),
                  world_axis=(1, 0, 0))
    for k, i in ((0, 1), (2, 3)):
        bld.add_motor_rotation_speed(b[k], b[i], (k, 0, 0), (0, 0, 1),
                                     F.FSine(amp=num(1.0 + k), freq=num(0.5),
                                             phase=num(0.1 * k)))
    bld.add_motor_rotation_angle(g, b[1], (1, 0, 0), (0, 1, 0), 0.3)
    bld.add_motor_rotation_torque(g, b[2], (2, 0, 0), (1, 0, 0), 1.5,
                                  add_joint=False)
    bld.add_motor_linear_speed(g, b[3], (3, 0, 0), (1, 0, 0), 0.2)
    bld.add_motor_linear_position(b[0], b[3], (3, 0, 0), (0, 1, 0), -0.1)
    bld.add_motor_linear_force(b[1], b[2], (1, 0, 0), (0, 0, 1), 4.0)
    bld.add_bushing(b[1], b[3], (2, 1, 0.2), world_axis=(0, 1, 1))
    bld.add_tsda(g, b[2], (2, 0, 1), (2, 1, 0.2), k=100.0, c=2.0,
                 f_actuation=0.5)
    bld.add_rsda(b[0], b[2], world_axis=(0, 0, 1), k=3.0, c=0.1,
                 rest_angle=0.2, t_actuation=0.05)
    return bld.finalize()


SCENES = {"bench_mbs": bench_mbs, "slider_crank": slider_crank,
          "double_pendulum": double_pendulum, "four_bar": four_bar,
          "every_element": every_element}


def leaves(obj):
    """A JAX pytree dataclass as the numpy leaves ``convert`` reads."""
    if obj is None:
        return None
    if isinstance(obj, dict):
        return {k: leaves(v) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return [leaves(v) for v in obj]
    if dataclasses.is_dataclass(obj):
        out = {f.name: leaves(getattr(obj, f.name))
               for f in dataclasses.fields(obj)}
        if isinstance(obj, JF.MotionFunction):
            out["class"] = type(obj).__name__
        return out
    return np.asarray(obj)


@pytest.fixture(scope="module")
def scenes():
    """name -> (JAX model, JAX state, port model, port state); the port's
    from its own builder."""
    out = {}
    for name, build in SCENES.items():
        jm, js = build(JBuilder(), JF)
        tm, ts = build(TBuilder(device="cpu"), TF)
        out[name] = (jm, js, tm, ts)
    return out


def to_np(state):
    return {f: np.asarray(getattr(state, f)) for f in "xqvw"}


def assert_same_leaves(got, ref, path="model"):
    """Leaf by leaf: integers to the bit, floats within 1e-7."""
    if dataclasses.is_dataclass(ref):
        assert type(got) is type(ref), path
        for f in dataclasses.fields(ref):
            assert_same_leaves(getattr(got, f.name), getattr(ref, f.name),
                               f"{path}.{f.name}")
    elif isinstance(ref, dict):
        assert sorted(got) == sorted(ref), path
        for k in ref:
            assert_same_leaves(got[k], ref[k], f"{path}[{k}]")
    elif isinstance(ref, (tuple, list)):
        assert len(got) == len(ref), path
        for i, (g, r) in enumerate(zip(got, ref)):
            assert_same_leaves(g, r, f"{path}[{i}]")
    elif isinstance(ref, torch.Tensor):
        assert got.dtype == ref.dtype and got.shape == ref.shape, path
        if ref.dtype.is_floating_point:
            np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                                       atol=1e-7, err_msg=path)
        else:
            np.testing.assert_array_equal(got.numpy(), ref.numpy(),
                                          err_msg=path)
    else:
        assert got == ref, path


# ---------------------------------------------------------------- finalize

@pytest.mark.parametrize("name", ["bench_mbs", "slider_crank",
                                  "every_element"])
def test_finalize_equals_converted_jax_model(name, scenes):
    jm, js, tm, ts = scenes[name]
    model = convert.mbs_model_from_numpy(leaves(jm), device="cpu")
    state = convert.body_state_from_numpy(to_np(js), device="cpu")
    assert_same_leaves(tm, model)
    assert_same_leaves(ts, state, "state")


def test_applied_forces_of_every_element(scenes):
    """Gravity, gyroscopic torques, the TSDA, RSDA, bushing and both load
    motors accumulated on the scene's random-looking poses and speeds."""
    jm, js, tm, ts = scenes["every_element"]
    ref = jax.jit(lambda s: jsys.applied_forces(jm, s, jnp.float32(0.4)),
                  compiler_options=O0)(js)
    got = tsys.applied_forces(tm, ts, torch.tensor(0.4))
    for g, r, what in zip(got, ref, ("force", "torque")):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-5,
                                   atol=1e-6 * np.abs(r).max(), err_msg=what)


def test_builder_device():
    """The builder defaults to the card, and never falls back to the CPU."""
    if torch.cuda.is_available():
        assert TBuilder().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TBuilder()
    assert TBuilder(device="cpu").device.type == "cpu"


def test_make_body_state_device():
    """``make_body_state`` defaults to the card as the builder does, and
    never falls back to the CPU; ``device="cpu"`` builds there."""
    from chrono_tpu_torch.physics.body import make_body_state

    if torch.cuda.is_available():
        assert make_body_state([[1.0, 2.0, 3.0]]).x.is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_body_state([[1.0, 2.0, 3.0]])
    st = make_body_state([[1.0, 2.0, 3.0]], device="cpu")
    assert st.x.device.type == "cpu" and st.q.tolist() == [[1, 0, 0, 0]]
    with pytest.raises(TypeError):                 # device is required
        convert.motion_function_from_numpy({"class": "FConst", "c": 1.0})


# ------------------------------------------------------------- the solve

def _free_velocities(js, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=js.v.shape).astype(np.float32),
            rng.normal(size=js.w.shape).astype(np.float32))


def _port_rows(tm, ts):
    """``bilateral_rows`` at t = 0 (Baumgarte)."""
    return tsys.bilateral_rows(tm, ts, torch.tensor(0.0), H,
                               tsys.SolverSettings(solver="direct"))


def _jax_solve(jm, js, v, w, reg_fallback):
    """The JAX solve (jitted once, ``reg_fallback`` traced) on the rows of
    ``bilateral_rows`` at t = 0."""
    rows = jsys.bilateral_rows(jm, js, 0.0, H,
                               jsys.SolverSettings(solver="direct"))
    return np.asarray(jsys.solve_dense_schur(
        rows, jm.props, jnp.asarray(v), jnp.asarray(w),
        reg_fallback=jnp.float32(reg_fallback)))


@pytest.fixture(scope="module")
def bench_step(scenes):
    """The JAX step of ``bench_mbs`` jitted whole (one O0 compile; the
    eager pieces' jits are undone for its trace, since a nested jit takes
    no compiler options)."""
    jm = scenes["bench_mbs"][0]
    settings = jsys.SolverSettings(solver="direct")
    step = jax.jit(lambda s, t: jsys.step_euler_implicit_linearized(
        jm, s, t, H, settings), compiler_options=O0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsys, "joint_rows", j_joint_rows)
        mp.setattr(jsys, "solve_dense_schur", j_solve)
        step(scenes["bench_mbs"][1], jnp.float32(0))   # traced and compiled
    return step


def test_solve_dense_schur_bench_mbs(scenes, bench_step):
    """γ of ``solve_dense_schur`` on ``bench_mbs``'s rows at a state with
    random velocities, against the JAX step's reactions γ/h there."""
    jm, js, tm, ts = scenes["bench_mbs"]
    v, w = _free_velocities(js, 5)
    _, info = bench_step(js.replace(v=jnp.asarray(v), w=jnp.asarray(w)),
                         jnp.float32(0))
    ref = np.asarray(info.joint_reactions) * np.float32(H)
    st = ts.replace(v=torch.tensor(v), w=torch.tensor(w))
    f, tau = tsys.applied_forces(tm, st, torch.tensor(0.0))
    got = tdirect.solve_dense_schur(
        _port_rows(tm, st), tm.props, st.v + H * tm.props.inv_mass[:, None]
        * f, st.w + H * tm.props.inv_inertia * tau)
    # γ = impulses of order m·|v|: tolerance relative to the largest
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5,
                               atol=1e-6 * np.abs(ref).max())


def test_solve_dense_schur_four_bar_takes_the_fallback(scenes):
    """Both packages find the primary factorisation failed (the JAX
    package's solve with the fallback set to the primary comes back
    non-finite; the port's ``_solve_at`` reports failure) and both return
    the fallback's finite γ, which moves the bodies alike."""
    jm, js, tm, ts = scenes["four_bar"]
    v, w = _free_velocities(js, 6)
    ref = _jax_solve(jm, js, v, w, 3e-6)
    ref_primary = _jax_solve(jm, js, v, w, 1e-9)
    assert not np.isfinite(ref_primary).all()
    trows = _port_rows(tm, ts)
    tv, tw = torch.tensor(v), torch.tensor(w)
    got = tdirect.solve_dense_schur(trows, tm.props, tv, tw)
    assert torch.isfinite(got).all()
    D = tdesc.dense_D(trows, tm.n_bodies)
    minv = torch.stack([tm.props.inv_mass[:, None].expand(-1, 3),
                        tm.props.inv_inertia], 1).reshape(-1)
    N0 = (D * minv) @ D.T
    scale = torch.clamp_min(torch.trace(N0) / trows.m, 1.0)
    r = tdirect.compensated_schur_rhs(trows, tv, tw)
    _, ok = tdirect._solve_at(N0, r, trows.active, scale, 1e-9)
    assert not bool(ok)
    again, ok = tdirect._solve_at(N0, r, trows.active, scale, 3e-6)
    assert bool(ok) and torch.equal(got, again)
    # the redundant multiplier directions lie in null(Dᵀ): compare motion
    vel = [tdesc.velocity_update_dense(D, tm.props, torch.as_tensor(g), tv,
                                       tw) for g in (got, ref)]
    for a, b in zip(*vel):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-5)


# --------------------------------------------------------------- one step

MODES = [(mode, comp) for mode in ("baumgarte", "project", "filtered")
         for comp in (False, True)]


def _step_args(sys, state, mode, comp, zeros, m_rows):
    settings = sys.SolverSettings(solver="direct", stab_mode=mode,
                                  stab_deadband=1e-7)
    kw = {}
    if comp:
        kw["position_comp"] = (zeros(state.x) + 3e-8, zeros(state.q) - 1e-8)
    if mode == "filtered":
        # init_stab_state's zeros, built without an eager JAX lowering
        c = zeros(state.x).reshape(-1)[:1] * 0
        kw["stab_state"] = (c.repeat(m_rows) if sys is tsys else
                            jnp.tile(c, m_rows),
                            zeros(state.x)[0, 0].astype(jnp.int32)
                            if sys is jsys else
                            torch.zeros((), dtype=torch.int32))
    return settings, kw


@pytest.mark.parametrize("mode,comp", MODES)
def test_one_step(mode, comp, scenes):
    jm, js, tm, ts = scenes["double_pendulum"]
    m_rows = tsys.init_stab_state(tm, ts, 0.0, H, tsys.SolverSettings(
        solver="direct", stab_mode=mode))[0].shape[0]
    settings, kw = _step_args(jsys, js, mode, comp, jnp.zeros_like, m_rows)

    ref = jsys.step_euler_implicit_linearized(jm, js, jnp.float32(0.25), H,
                                              settings, **kw)
    tsettings, tkw = _step_args(tsys, ts, mode, comp, torch.zeros_like,
                                m_rows)
    got = tsys.step_euler_implicit_linearized(
        tm, ts, torch.tensor(0.25), H, tsettings, **tkw)
    assert len(got) == len(ref)
    for f in "xqvw":
        np.testing.assert_allclose(getattr(got[0], f).numpy(),
                                   np.asarray(getattr(ref[0], f)),
                                   err_msg=f, **STEP_TOL)
    if comp:
        for g, r in zip(got[1], ref[1]):
            # the carries are rounding residues (~1e-8): absolute bound
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                       atol=1e-9)
    if mode == "filtered":
        np.testing.assert_allclose(got[-2][0].numpy(),
                                   np.asarray(ref[-2][0]), **STEP_TOL)
        assert int(got[-2][1]) == int(ref[-2][1]) == 1
    np.testing.assert_allclose(got[-1].joint_reactions.numpy(),
                               np.asarray(ref[-1].joint_reactions),
                               rtol=1e-4, atol=1e-3)
    assert got[-1].n_rows == ref[-1].n_rows


# ------------------------------------------------------------ 200 steps

SAVE_EVERY = 50


@pytest.fixture(scope="module")
def bench_200(scenes, bench_step):
    """200 steps of ``bench_mbs``: the JAX states after steps 1, 51, 101,
    151 and 200 (a jitted step in a loop), and the port's ``simulate``
    saving the same (on the CPU its eager loop)."""
    jm, js, tm, ts = scenes["bench_mbs"]
    jt, saved = jnp.float32(0), []
    for k in range(200):
        js = bench_step(js, jt)[0]
        jt = jt + H
        if k % SAVE_EVERY == 0 or k == 199:
            saved.append(to_np(js))
    final, traj = tsys.simulate(tm, ts, H, 200,
                                tsys.SolverSettings(solver="direct"),
                                save_every=SAVE_EVERY)
    return saved, final, traj


def test_200_steps_of_bench_mbs(bench_200, scenes):
    saved, final, (xs, qs) = bench_200
    assert xs.shape == (4, 6, 3) and qs.shape == (4, 6, 4)
    for ref, got in zip(saved, list(xs) + [final.x]):
        np.testing.assert_allclose(got.numpy(), ref["x"], rtol=0,
                                   atol=X_ATOL_200)
    _, _, tm, _ = scenes["bench_mbs"]
    for kind, data in tm.joints.items():
        C = joint_violation(kind, data, final.x, final.q)
        assert float(C.abs().max()) < 1e-3, kind


def test_simulate_on_the_cpu_is_the_step_loop(scenes):
    """``simulate`` (the CPU's eager loop) saves the states after steps 1,
    4, 7, … and ends where a loop of steps ends, bit for bit."""
    _, _, tm, ts = scenes["bench_mbs"]
    settings = tsys.SolverSettings(solver="direct")
    final, (xs, qs) = tsys.simulate(tm, ts, H, 10, settings, save_every=3)
    t, st, k = torch.tensor(0.0), ts, 0
    for k in range(10):
        st, _ = tsys.step_euler_implicit_linearized(tm, st, t, H, settings)
        t = t + H
        if k % 3 == 0:
            assert torch.equal(xs[k // 3], st.x)
            assert torch.equal(qs[k // 3], st.q)
    assert len(xs) == 4 and torch.equal(final.x, st.x)
    final, traj = tsys.simulate(tm, ts, H, 3, settings, save_every=0)
    assert traj is None and torch.isfinite(final.x).all()


def test_slider_crank_strokes_on_the_cpu(scenes):
    """The demo's invariants over 100 steps (the card runs its 3,000): the
    slider stays inside [l − r, l + r] and the crank turns at the motor's
    2 rad/s."""
    _, _, tm, ts = scenes["slider_crank"]
    final, (xs, _) = tsys.simulate(tm, ts, H, 100,
                                   tsys.SolverSettings(solver="direct"))
    sx = xs[:, 3, 0]
    assert float(sx.min()) > L_ROD - R_CRANK - 0.01
    assert float(sx.max()) < L_ROD + R_CRANK + 0.01
    assert abs(float(final.w[1, 1]) - 2.0) < 1e-2


# ------------------------------------------------------------- refusals

def test_refusals(scenes):
    """An unknown solver is refused.  Shafts, once refused here, are now
    taken: the builder's shaft methods, the shaft terms of the applied
    forces and of the rows, and the converter (tests/test_torch_shafts.py
    holds them to the JAX package)."""
    _, _, tm, ts = scenes["bench_mbs"]
    t = torch.tensor(0.0)
    with pytest.raises(ValueError, match="unknown solver"):
        tsys.step_euler_implicit_linearized(
            tm, ts, t, H, tsys.SolverSettings(solver="psor"))
    direct = tsys.SolverSettings(solver="direct")
    bld = TBuilder(device="cpu")
    body = bld.add_body(mass=1.0)
    shafts = [bld.add_shaft(inertia=0.5) for _ in range(3)]
    bld.add_shaft_gear(shafts[0], shafts[1], 2.0)
    bld.add_shaft_planetary(*shafts, 1.5)
    bld.add_shaft_body(shafts[2], body)
    bld.add_shaft_clutch(shafts[0], shafts[1], 10.0)
    bld.add_shaft_torsion_spring(shafts[1], shafts[2], 5.0)
    bld.add_shaft_torque(shafts[0], shafts[2], 1.0)
    model, state = bld.finalize()
    f, tau = tsys.applied_forces(model, state, t)
    # the torque pair; the clutch transmits nothing between shafts at rest
    assert float(tau[shafts[0], 2]) == 1.0
    rows = tsys.bilateral_rows(model, state, t, H, direct)
    assert rows.m == 3 and int(rows.body_c[1]) == shafts[2]
    new, _ = tsys.step_euler_implicit_linearized(model, state, t, H, direct)
    assert bool(torch.isfinite(new.w).all())
    conv = convert.mbs_model_from_numpy(
        {"props": {k: getattr(model.props, k).numpy()
                   for k in ("inv_mass", "inertia", "inv_inertia")},
         "gravity": model.gravity.numpy(),
         "shaft_elements": {f.name: getattr(model.shaft_elements,
                                            f.name).numpy()
                            for f in dataclasses.fields(
                                model.shaft_elements)}},
        device="cpu")
    assert conv.shaft_elements.kind.tolist() == [0, 1, 2]
