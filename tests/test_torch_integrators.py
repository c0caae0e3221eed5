"""PyTorch port (chrono_tpu_torch) vs the JAX package: the other steppers.

Scenes are built with the JAX builder and carried across with ``convert``;
each is stepped by both packages from the same state and held step by
step:

- the explicit integrators (tests/test_explicit.py: the projectile under
  Euler, Heun, RK4 and leapfrog, 100 steps; the torque-free gyroscope under
  RK4, 300 of its 2,000 steps; tests/test_implicit_mbs.py's elliptic
  oscillator under leapfrog and explicit Euler, 400 of 4,000 steps);
- HHT-α and the Newmark family (tests/test_implicit_mbs.py: the stiff
  spring, 15 of its 300 steps; the pendulum at 4× the DVI step, 15 of
  250; a step rejected down to h/8; the trapezoidal and backward-Euler
  oscillators, 15 of 150 steps; the projected Euler pendulum, 40 of 1,500
  steps), with the same Newton iteration counts and ``h_used`` at every
  step;
- the ODE blocks (tests/test_external_ode.py: the decaying scalar ODE, 100
  steps; the hydraulic actuator, 120 steps with its valve closing at step
  60 in place of the test's 3,000);
- the rotation functions (tests/test_rotation_functions.py): values and
  angular velocities.

Tolerances: the North star's (x rtol 1e-4 / atol 1e-5, v and ω rtol 1e-3 /
atol 1e-4), for HHT widened where the JAX run's own response to ~1e-7
perturbations of its start is larger (to twice it); the hydraulic
pressures rtol 1e-4 of their 1e7 Pa scale.  The
JAX steps are jitted once per model structure, with the model and the
stepper's constants as arguments.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chrono_tpu.core import functions as JF
from chrono_tpu.core import quaternion as JQ
from chrono_tpu.core import rotation_functions as JR
from chrono_tpu.physics import explicit as jex
from chrono_tpu.physics import external as jext
from chrono_tpu.physics import implicit as jimp
from chrono_tpu.physics.builder import SystemBuilder as JBuilder

from chrono_tpu_torch import convert
from chrono_tpu_torch.core import functions as TF
from chrono_tpu_torch.core import rotation_functions as TR
from chrono_tpu_torch.physics import explicit as tex
from chrono_tpu_torch.physics import external as text
from chrono_tpu_torch.physics import implicit as timp
from chrono_tpu_torch.solver import vi

O0 = {"xla_backend_optimization_level": 0}
X_TOL = dict(rtol=1e-4, atol=1e-5)
V_TOL = dict(rtol=1e-3, atol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jit(fn, **kw):
    return jax.jit(fn, compiler_options=O0, **kw)


def leaves(obj):
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


def carry(model, state):
    return (convert.mbs_model_from_numpy(leaves(model), device="cpu"),
            convert.body_state_from_numpy(
                {f: np.asarray(getattr(state, f)) for f in "xqvw"},
                device="cpu"))


def assert_state(got, ref, what):
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x),
                               err_msg=f"{what} x", **X_TOL)
    np.testing.assert_allclose(got.q.numpy(), np.asarray(ref.q),
                               err_msg=f"{what} q", **X_TOL)
    for f in "vw":
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)),
                                   err_msg=f"{what} {f}", **V_TOL)


# -------------------------------------------------------------- scenes

def projectile():
    b = JBuilder()
    b.add_body(mass=1.0, pos=(0, 0, 0), vel=(10.0, 0, 10.0))
    return b.finalize()


def gyroscope():
    b = JBuilder()
    b.set_gravity((0, 0, 0))
    b.add_body(mass=1.0, inertia=(1.0, 1.0, 2.0), omega_local=(0.1, 0.0, 5.0))
    return b.finalize()


def oscillator(k=100.0, x0=0.2, damped=0.0):
    """A body on a TSDA to the ground (rest length 1), no gravity."""
    b = JBuilder()
    b.set_gravity((0, 0, 0))
    g = b.add_ground()
    blk = b.add_body(mass=1.0, inertia=(0.1, 0.1, 0.1), pos=(1.0 + x0, 0, 0))
    b.add_tsda(g, blk, (0, 0, 0), (1.0 + x0, 0, 0), k=k, c=damped,
               rest_length=1.0)
    return b.finalize()


def stiff_spring(k=1e7):
    """tests/test_implicit_mbs.py's 1 kg block on a stiff vertical TSDA."""
    b = JBuilder()
    b.set_gravity((0, 0, -9.81))
    g = b.add_ground()
    blk = b.add_body(mass=1.0, inertia=(0.1, 0.1, 0.1), pos=(0, 0, -1.0))
    b.add_tsda(g, blk, (0, 0, 0), (0, 0, -1.0), k=k, c=200.0)
    return b.finalize()


def pendulum():
    b = JBuilder()
    b.set_gravity((0, 0, -9.81))
    g = b.add_ground()
    p = b.add_body(mass=1.0, inertia=(0.04, 0.1, 0.1), pos=(2, 0, 0))
    b.add_joint("revolute", p, g, world_pos=(0, 0, 0), world_axis=(0, 1, 0))
    return b.finalize()


# ----------------------------------------------------------- explicit

EXPLICIT = [("projectile", projectile, name, 1e-2, 100)
            for name in ("euler_explicit", "heun", "rk4", "leapfrog")]
EXPLICIT += [("gyroscope", gyroscope, "rk4", 1e-3, 300),
             ("oscillator", oscillator, "leapfrog", 5e-3, 400),
             ("oscillator", oscillator, "euler_explicit", 5e-3, 400)]


@pytest.mark.parametrize("scene,build,name,h,n", EXPLICIT,
                         ids=[f"{s}-{n}" for s, _, n, _, _ in EXPLICIT])
def test_explicit(scene, build, name, h, n):
    jmodel, jstate = build()
    tmodel, tstate = carry(jmodel, jstate)
    jstep = jit(jex.EXPLICIT_STEPPERS[name])
    tstep = tex.EXPLICIT_STEPPERS[name]
    assert tex.EXPLICIT_STEPPERS.keys() == jex.EXPLICIT_STEPPERS.keys()
    for k in range(n):
        jstate = jstep(jmodel, jstate, jnp.float32(k * h), h)
        tstate = tstep(tmodel, tstate, torch.tensor(k * h), h)
        if k % 25 == 24 or k == n - 1:
            assert_state(tstate, jstate, f"{scene} {name} step {k}")


# ----------------------------------------------------------- implicit

def _hht(model, s, acc, t, h, alpha, beta, gamma, iters, tol, halvings):
    return jimp.make_hht_mbs_step(model, alpha=alpha, newton_iters=iters,
                                  tol=tol, max_halvings=halvings, beta=beta,
                                  gamma=gamma)(s, acc, t, h)


@pytest.fixture(scope="module")
def jhht():
    """The JAX HHT step jitted with the model and every constant as an
    argument: one compile per model structure."""
    return jit(_hht)


def _hht_params(alpha=-0.2, beta=None, gamma=None):
    if beta is None:
        beta = (1.0 - alpha) ** 2 / 4.0
    if gamma is None:
        gamma = 0.5 - alpha
    return alpha, beta, gamma


HHT = {
    # name: (scene, (alpha, beta, gamma), newton_iters, tol, halvings, h, n)
    "stiff_spring": (stiff_spring, _hht_params(-0.2), 10, 1e-4, 3, 1e-3, 15),
    "pendulum": (pendulum, _hht_params(-0.1), 8, 1e-4, 3, 2e-3, 15),
    "rejection": (lambda: stiff_spring(1e9), _hht_params(-0.2), 2, 1e-12, 3,
                  1e-2, 1),
    "trapezoidal": (lambda: oscillator(x0=0.1), (0.0, 0.25, 0.5), 6, 1e-6, 3,
                    0.02, 15),
    "backward_euler": (lambda: oscillator(x0=0.1), (0.0, 0.5, 1.0), 6, 1e-6,
                       3, 0.02, 15),
}


def _perturbed(state, rng, scale=1e-7):
    return state.replace(**{f: jnp.asarray(np.asarray(getattr(state, f)) * (
        1.0 + scale * rng.normal(size=np.shape(getattr(state, f)))),
        jnp.float32) for f in "xqvw"})


@pytest.mark.parametrize("case", sorted(HHT))
def test_hht(case, jhht):
    """Every step: the same Newton iterations and ``h_used``, and the state
    within the North star's tolerances, each field's atol widened to twice
    the JAX trajectory's own response to two ~1e-7 perturbations of its
    start where that is larger (Newton stops once the residual is below
    ``tol``, 1e-4 for the pendulum, so a state is fixed only that far)."""
    build, (alpha, beta, gamma), iters, tol, halvings, h, n = HHT[case]
    jmodel, jstate = build()
    tmodel, tstate = carry(jmodel, jstate)
    tstep = timp.make_hht_mbs_step(tmodel, alpha=alpha, newton_iters=iters,
                                   tol=tol, max_halvings=halvings, beta=beta,
                                   gamma=gamma)

    def jrun(s):
        acc, t, outs = jnp.zeros((jmodel.n_bodies, 6)), 0.0, []
        for _ in range(n):
            out = jhht(jmodel, s, acc, jnp.float32(t), jnp.float32(h),
                       alpha, beta, gamma, iters, tol, halvings)
            outs.append(jax.tree_util.tree_map(np.asarray, out))
            s, acc, t = out.state, out.acc, t + float(out.h_used)
        return outs

    ref = jrun(jstate)
    rng = np.random.default_rng(5)
    resp = [{f: 0.0 for f in "xqvw"} for _ in range(n)]
    for _ in range(2):
        for k, o in enumerate(jrun(_perturbed(jstate, rng))):
            for f in "xqvw":
                resp[k][f] = max(resp[k][f], float(np.abs(
                    getattr(o.state, f) - getattr(ref[k].state, f)).max()))
    tacc = torch.zeros((tmodel.n_bodies, 6))
    tt = 0.0
    for k in range(n):
        vi.reset_host_reads()
        tout = tstep(tstate, tacc, torch.tensor(tt), h)
        jout, what = ref[k], f"{case} step {k}"
        assert int(tout.iterations) == int(jout.iterations), what
        assert float(tout.h_used) == float(jout.h_used), what
        # one host read a Newton test, one a rejection test
        assert vi.host_reads() >= int(tout.iterations) + 1
        for f, tol_f in (("x", X_TOL), ("q", X_TOL), ("v", V_TOL),
                         ("w", V_TOL)):
            np.testing.assert_allclose(
                getattr(tout.state, f).numpy(), getattr(jout.state, f),
                rtol=tol_f["rtol"],
                atol=max(tol_f["atol"], 2.0 * resp[k][f]),
                err_msg=f"{what} {f} (JAX's own response {resp[k][f]:.2e})")
        tstate, tacc = tout.state, tout.acc
        tt += float(tout.h_used)
    if case == "rejection":
        assert float(tout.h_used) < 1e-2


def test_projected_euler():
    """tests/test_implicit_mbs.py's projected Euler pendulum, 40 steps:
    the state and the constraint residual after each projection."""
    jmodel, jstate = pendulum()
    tmodel, tstate = carry(jmodel, jstate)
    h = 2e-3
    jstep = jit(lambda s, t: jimp.make_euler_implicit_projected_step(
        jmodel, n_proj=2)(s, t, h))
    tstep = timp.make_euler_implicit_projected_step(tmodel, n_proj=2)
    for k in range(40):
        jout = jstep(jstate, jnp.float32(k * h))
        tout = tstep(tstate, torch.tensor(k * h), h)
        jstate, tstate = jout.state, tout.state
    assert_state(tstate, jstate, "projected Euler")
    assert float(tout.c_inf) < 1e-5
    c = timp._constraint_C(tmodel, tstate.x, tstate.q).numpy()
    np.testing.assert_allclose(c, np.asarray(jimp._constraint_C(
        jmodel, jstate.x, jstate.q)), rtol=0, atol=1e-6)


# ----------------------------------------------------------- external ODE

def test_ode_block_decay():
    b = JBuilder()
    b.set_gravity((0, 0, 0))
    b.add_ground()
    b.add_body(mass=1.0, pos=(0, 0, 1))
    jmodel, jstate = b.finalize()
    tmodel, tstate = carry(jmodel, jstate)
    lam, h = 3.0, 1e-2

    def jrhs(t, y, st):
        z = jnp.zeros((jmodel.n_bodies, 3))
        return -lam * y, z, z

    def trhs(t, y, st):
        z = torch.zeros((tmodel.n_bodies, 3))
        return -lam * y, z, z

    jstep = jit(jext.make_ode_coupled_step(jmodel, jrhs, h))
    tstep = text.make_ode_coupled_step(tmodel, trhs, h)
    jy, ty = jnp.asarray([1.0]), torch.tensor([1.0])
    for k in range(100):
        jstate, jy, _ = jstep(jstate, jy, jnp.float32(k * h))
        tstate, ty, _ = tstep(tstate, ty, torch.tensor(k * h))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-6)
    assert_state(tstate, jstate, "ODE block")


def test_hydraulic_actuator():
    """tests/test_external_ode.py's cylinder under a hanging load on a
    rail: the valve open for 60 steps, then closed."""
    b = JBuilder()
    b.set_gravity((0, 0, -9.81))
    g = b.add_ground()
    load = b.add_body(mass=100.0, inertia=(1, 1, 1), pos=(0, 0, -0.5))
    b.add_joint("prismatic", load, g, world_pos=(0, 0, -0.5),
                world_axis=(0, 0, 1))
    jmodel, jstate = b.finalize()
    tmodel, tstate = carry(jmodel, jstate)
    h, n, t_close = 2e-4, 120, 60 * 2e-4
    jhp = jext.HydraulicParams(stroke0=jnp.asarray(0.7))
    thp = convert.hydraulic_params_from_numpy(
        {f.name: np.asarray(getattr(jhp, f.name))
         for f in dataclasses.fields(jhp)}, device="cpu")
    jy, jrhs = jext.make_hydraulic_actuator(
        jmodel, g, load, (0, 0, -1.2), (0, 0, 0), jhp,
        lambda t: jnp.where(t < t_close, 0.8, 0.0))
    ty, trhs = text.make_hydraulic_actuator(
        tmodel, g, load, (0, 0, -1.2), (0, 0, 0), thp,
        lambda t: torch.where(t < t_close, 0.8, 0.0))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    jstep = jit(jext.make_ode_coupled_step(jmodel, jrhs, h))
    tstep = text.make_ode_coupled_step(tmodel, trhs, h)
    for k in range(n):
        jstate, jy, _ = jstep(jstate, jy, jnp.float32(k * h))
        tstate, ty, _ = tstep(tstate, ty, torch.tensor(k * h))
        if k in (59, n - 1):
            np.testing.assert_allclose(ty.numpy(), np.asarray(jy),
                                       rtol=1e-4, atol=1e-4 * 1e7,
                                       err_msg=f"pressures step {k}")
            assert_state(tstate, jstate, f"hydraulic step {k}")
    assert float(tstate.x[load, 2]) > -0.5


# ------------------------------------------------------ rotation functions

def _both(jcls, tcls, **fields):
    """The same rotation function in both packages: array fields as
    float32, scalar programs as (JAX, port) pairs."""
    jkw, tkw = {}, {}
    for k, v in fields.items():
        if isinstance(v, tuple) and len(v) == 2 and callable(v[0]):
            jkw[k], tkw[k] = v
        else:
            a = np.asarray(v, np.float32)
            jkw[k], tkw[k] = jnp.asarray(a), torch.as_tensor(a)
    return jcls(**jkw), tcls(**tkw)


def _fn(name, **kw):
    return (getattr(JF, name)(**{k: jnp.float32(v) for k, v in kw.items()}),
            getattr(TF, name)(**{k: torch.tensor(v, dtype=torch.float32)
                                 for k, v in kw.items()}))


ROTATIONS = {
    "const": lambda: _both(JR.RotConst, TR.RotConst, q=np.asarray(
        JQ.qexp_half(jnp.asarray([0.2, -0.1, 0.4])))),
    "axis_ramp": lambda: _both(JR.RotAxisAngle, TR.RotAxisAngle,
                               axis=[0.0, 0.0, 1.0],
                               angle=_fn("FRamp", y0=0.0, slope=2.0)),
    "axis_sine": lambda: _both(JR.RotAxisAngle, TR.RotAxisAngle,
                               axis=[1.0, 0.0, 0.0],
                               angle=_fn("FSine", amp=0.5, freq=1.0)),
    "slerp": lambda: _both(JR.RotSlerp, TR.RotSlerp, ts=[0.0, 1.0, 2.5],
                           qs=np.stack([
                               [1.0, 0.0, 0.0, 0.0],
                               np.asarray(JQ.qexp_half(jnp.asarray(
                                   [0.0, 0.0, np.pi / 2]))),
                               np.asarray(JQ.qexp_half(jnp.asarray(
                                   [0.3, -0.4, 1.0])))])),
    "abc": lambda: _both(JR.RotABC, TR.RotABC,
                         fa=_fn("FConst", c=0.3),
                         fb=_fn("FSine", amp=0.2, freq=0.5),
                         fc=_fn("FRamp", y0=0.1, slope=-0.4)),
}


@pytest.mark.parametrize("name", sorted(ROTATIONS))
def test_rotation_functions(name):
    jf, tf = ROTATIONS[name]()
    leaves_j = leaves(jf)
    leaves_j["class"] = type(jf).__name__
    carried = convert.rotation_function_from_numpy(leaves_j, device="cpu")
    for t in (0.0, 0.3, 0.5, 1.0, 1.7, 3.0):
        q_ref = np.asarray(jf.value(jnp.float32(t)))
        w_ref = np.asarray(jf.omega(t))
        for f in (tf, carried):
            np.testing.assert_allclose(f.value(torch.tensor(t)).numpy(),
                                       q_ref, rtol=0, atol=1e-6)
            np.testing.assert_allclose(f.omega(t).numpy(), w_ref, rtol=1e-5,
                                       atol=1e-5)
