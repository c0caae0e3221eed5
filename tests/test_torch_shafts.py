"""PyTorch port (chrono_tpu_torch) vs the JAX package: shafts (1-D
drivetrain elements) in the multibody solve.

Each analytic case of tests/test_shafts.py (a gear's effective inertia,
the planetary Willis equation, a clutch locking two shafts with momentum
conserved, a torsion spring's frequency, a shaft bound to a body with the
driveline winding up) is built by both builders, stepped in both packages
with the same applied torques, held to its analytic oracle in each, and
the port's speeds and angles held to the JAX package's.  The builders'
models are held to each other through ``convert.mbs_model_from_numpy``.
The JAX steps run as one jitted scan a case; the port's as a Python loop.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from chrono_tpu.physics import shafts as jsh
from chrono_tpu.physics import system as jsys
from chrono_tpu.physics.builder import SystemBuilder as JBuilder

from chrono_tpu_torch import convert
from chrono_tpu_torch.physics import shafts as tsh
from chrono_tpu_torch.physics import system as tsys
from chrono_tpu_torch.physics.builder import SystemBuilder as TBuilder

O0 = {"xla_backend_optimization_level": 0}
# the two packages' speeds after thousands of float32 steps: the error of
# the float32 solve, 1e-6 relative a step, accumulated
W_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def leaves(obj):
    if obj is None:
        return None
    if isinstance(obj, dict):
        return {k: leaves(v) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return [leaves(v) for v in obj]
    if dataclasses.is_dataclass(obj):
        return {f.name: leaves(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    return np.asarray(obj)


def gear(b):
    b.set_gravity((0, 0, 0))
    s1 = b.add_shaft(inertia=1.0)
    s2 = b.add_shaft(inertia=2.0)
    b.add_shaft_gear(s1, s2, ratio=2.0)
    b.add_shaft_torque(s1, s2, 0.0)   # a zero pair, to run the path
    return (s1, s2)


PSI = 2.5


def planetary(b):
    b.set_gravity((0, 0, 0))
    c = b.add_shaft(inertia=1.0)
    s = b.add_shaft(inertia=0.5)
    r = b.add_shaft(inertia=2.0)
    b.add_shaft_planetary(c, s, r, ratio=PSI)
    return (c, s, r)


def clutch(b):
    b.set_gravity((0, 0, 0))
    s1 = b.add_shaft(inertia=1.0, speed=10.0)
    s2 = b.add_shaft(inertia=3.0, speed=0.0)
    b.add_shaft_clutch(s1, s2, torque_max=50.0, c_slip=20.0)
    return (s1, s2)


K_SPRING, J1, J2 = 50.0, 1.0, 2.0


def spring(b):
    b.set_gravity((0, 0, 0))
    s1 = b.add_shaft(inertia=J1, speed=1.0)
    s2 = b.add_shaft(inertia=J2, speed=-0.5)   # zero total momentum
    b.add_shaft_torsion_spring(s1, s2, k=K_SPRING)
    return (s1, s2)


def windup(b):
    b.set_gravity((0, 0, 0))
    flywheel = b.add_body(mass=1.0, inertia=(0.5, 0.5, 1.0))
    s_engine = b.add_shaft(inertia=0.2)
    s_out = b.add_shaft(inertia=0.2)
    b.add_shaft_torsion_spring(s_engine, s_out, k=200.0, c=2.0)
    b.add_shaft_body(s_out, flywheel, axis_local=(0, 0, 1))
    return (flywheel, s_engine, s_out)


def torques(case, ids, n_bodies):
    """(n, N, 3) applied local torques of each step, and h."""
    if case == "gear":
        tau = np.zeros((200, n_bodies, 3), np.float32)
        tau[:, ids[0], 2] = 1.0
        return tau, 1e-3
    if case == "planetary":
        rng = np.random.default_rng(0)
        tau = np.zeros((100, n_bodies, 3), np.float32)
        for k in range(100):
            tau[k, ids[0], 2] = rng.normal()
            tau[k, ids[1], 2] = rng.normal()
        return tau, 1e-3
    if case == "clutch":
        return np.zeros((3000, n_bodies, 3), np.float32), 1e-3
    if case == "spring":
        return np.zeros((2000, n_bodies, 3), np.float32), 2e-4
    tau = np.zeros((3000, n_bodies, 3), np.float32)
    tau[:, ids[1], 2] = 5.0
    return tau, 5e-4


CASES = {"gear": gear, "planetary": planetary, "clutch": clutch,
         "spring": spring, "windup": windup}
SET_J = jsys.SolverSettings(solver="direct")
SET_T = tsys.SolverSettings(solver="direct")


def run_jax(model, state, tau, h):
    """Every step's (w, q), one jitted scan."""
    @functools.partial(jax.jit, compiler_options=O0)
    def run(state, tau):
        def body(st, tk):
            st, _ = jsys.step_euler_implicit_linearized(
                model, st, 0.0, h, SET_J, tau_ext=tk)
            return st, (st.w, st.q)
        return jax.lax.scan(body, state, tau)[1]

    ws, qs = run(state, jnp.asarray(tau))
    return np.asarray(ws), np.asarray(qs)


def run_port(model, state, tau, h):
    ws, qs = [], []
    t = torch.zeros(())
    for tk in torch.as_tensor(tau):
        state, _ = tsys.step_euler_implicit_linearized(model, state, t, h,
                                                       SET_T, tau_ext=tk)
        ws.append(state.w)
        qs.append(state.q)
    return torch.stack(ws).numpy(), torch.stack(qs).numpy()


@pytest.fixture(scope="module")
def runs():
    out = {}
    for case, build in CASES.items():
        jb, tb = JBuilder(), TBuilder(device="cpu")
        ids = build(jb)
        assert build(tb) == ids
        jm, js = jb.finalize()
        tm, ts = tb.finalize()
        tau, h = torques(case, ids, tm.n_bodies)
        out[case] = dict(ids=ids, jm=jm, tm=tm, h=h,
                         jax=run_jax(jm, js, tau, h),
                         port=run_port(tm, ts, tau, h))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_model_equals_converted_jax_model(case, runs):
    """The shaft mask (translation fixed, spin about z live), the shaft
    rows' data and the torque elements, leaf for leaf."""
    r = runs[case]
    conv = convert.mbs_model_from_numpy(leaves(r["jm"]), device="cpu")
    for name in ("inv_mass", "inertia", "inv_inertia"):
        np.testing.assert_array_equal(getattr(r["tm"].props, name).numpy(),
                                      getattr(conv.props, name).numpy())
    assert list(r["tm"].shaft_constraints) == list(conv.shaft_constraints)
    for kind, data in conv.shaft_constraints.items():
        for f in dataclasses.fields(data):
            np.testing.assert_array_equal(
                getattr(r["tm"].shaft_constraints[kind], f.name).numpy(),
                getattr(data, f.name).numpy())
    assert (r["tm"].shaft_elements is None) == (conv.shaft_elements is None)
    if conv.shaft_elements is not None:
        for f in dataclasses.fields(conv.shaft_elements):
            np.testing.assert_array_equal(
                getattr(r["tm"].shaft_elements, f.name).numpy(),
                getattr(conv.shaft_elements, f.name).numpy())


@pytest.mark.parametrize("case", list(CASES))
def test_port_follows_jax(case, runs):
    r = runs[case]
    (jw, jq), (tw, tq) = r["jax"], r["port"]
    np.testing.assert_allclose(tw, jw, **W_TOL)
    np.testing.assert_allclose(tq, jq, rtol=1e-4, atol=1e-5)


def final(runs, case, package):
    ws, qs = runs[case][package]
    return ws[-1], qs[-1]


@pytest.mark.parametrize("package", ["jax", "port"])
def test_gear_effective_inertia(package, runs):
    """τ on shaft 1 geared (ω1 = 2 ω2) to shaft 2: ω̇1 = τ / (J1 + J2/4)."""
    s1, s2 = runs["gear"]["ids"]
    w, _ = final(runs, "gear", package)
    np.testing.assert_allclose(w[s1, 2], 1.0 * 200 * 1e-3 / 1.5, rtol=1e-4)
    np.testing.assert_allclose(w[s1, 2], 2.0 * w[s2, 2], rtol=1e-5)


@pytest.mark.parametrize("package", ["jax", "port"])
def test_planetary_willis_equation(package, runs):
    c, s, r = runs["planetary"]["ids"]
    w, _ = final(runs, "planetary", package)
    wc, ws, wr = w[c, 2], w[s, 2], w[r, 2]
    assert abs((1 + PSI) * wc - ws - PSI * wr) < 1e-4 * max(
        1.0, abs(wc), abs(ws), abs(wr))
    assert abs(wc) + abs(ws) + abs(wr) > 0.01


@pytest.mark.parametrize("package", ["jax", "port"])
def test_clutch_locks_with_momentum_conserved(package, runs):
    s1, s2 = runs["clutch"]["ids"]
    w, _ = final(runs, "clutch", package)
    w_common = (1.0 * 10.0 + 3.0 * 0.0) / 4.0
    np.testing.assert_allclose(w[s1, 2], w_common, rtol=1e-2)
    np.testing.assert_allclose(w[s2, 2], w_common, rtol=1e-2)


@pytest.mark.parametrize("package", ["jax", "port"])
def test_torsion_spring_frequency(package, runs):
    s1, s2 = runs["spring"]["ids"]
    ws, _ = runs["spring"][package]
    rel = ws[:, s1, 2] - ws[:, s2, 2]
    # Δω starts at its extremum, so the first zero crossing is at a quarter
    # period
    first = np.where(np.diff(np.sign(rel)))[0][0]
    period = 4.0 * first * runs["spring"]["h"]
    np.testing.assert_allclose(2 * np.pi / period,
                               np.sqrt(K_SPRING * (1 / J1 + 1 / J2)),
                               rtol=2e-2)


@pytest.mark.parametrize("package", ["jax", "port"])
def test_shaft_body_coupling_and_windup(package, runs):
    flywheel, s_engine, s_out = runs["windup"]["ids"]
    w, q = final(runs, "windup", package)
    np.testing.assert_allclose(w[s_out, 2], w[flywheel, 2], rtol=1e-4)
    J_total = 0.2 + 0.2 + 1.0
    np.testing.assert_allclose(w[flywheel, 2], 5.0 * 3000 * 5e-4 / J_total,
                               rtol=5e-2)
    angle = tsh.shaft_angle if package == "port" else jsh.shaft_angle
    lib = torch if package == "port" else jnp
    dth = float(angle(lib.asarray(q[s_out])) - angle(lib.asarray(
        q[s_engine])))
    np.testing.assert_allclose(-dth * 200.0, 5.0 * (1.2 / J_total),
                               rtol=0.1)


def test_shaft_torques_and_rows():
    """``shaft_torques`` (all three kinds, with shafts shared between
    elements and an angle difference past ±π) and the three row kinds on
    random data."""
    rng = np.random.default_rng(3)
    n, T = 7, 9
    a = rng.integers(0, n, T).astype(np.int32)
    b = (a + rng.integers(1, n, T)).astype(np.int32) % n
    data = dict(shaft_a=a, shaft_b=b,
                kind=rng.integers(0, 3, T).astype(np.int32),
                k=rng.uniform(1, 50, T).astype(np.float32),
                c=rng.uniform(0, 5, T).astype(np.float32),
                rest=rng.uniform(-0.5, 1.0, T).astype(np.float32))
    ang = rng.uniform(-np.pi, np.pi, n)
    q = np.zeros((n, 4), np.float32)
    q[:, 0], q[:, 3] = np.cos(ang / 2), np.sin(ang / 2)
    w = rng.normal(0, 3, (n, 3)).astype(np.float32)
    ref = jsh.shaft_torques(jsh.ShaftTorqueElements(
        **{k: jnp.asarray(v) for k, v in data.items()}), jnp.asarray(q),
        jnp.asarray(w), n)
    got = tsh.shaft_torques(tsh.ShaftTorqueElements(
        **{k: torch.as_tensor(v) for k, v in data.items()}),
        torch.as_tensor(q), torch.as_tensor(w), n)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-4)
    rows = {
        "gear": dict(shaft_a=a[:3], shaft_b=b[:3],
                     ratio=rng.normal(0, 2, 3).astype(np.float32)),
        "planetary": dict(carrier=a[:2], sun=b[:2], ring=a[2:4],
                          c_carrier=np.float32([3.5, 2.0]),
                          c_sun=np.float32([-1, -1]),
                          c_ring=np.float32([-2.5, -1.0])),
        "shaft_body": dict(shaft=a[:2], body=b[:2],
                           axis_local=rng.normal(0, 1, (2, 3)).astype(
                               np.float32)),
    }
    classes = {"gear": (jsh.ShaftGearData, tsh.ShaftGearData),
               "planetary": (jsh.ShaftPlanetaryData, tsh.ShaftPlanetaryData),
               "shaft_body": (jsh.ShaftBodyData, tsh.ShaftBodyData)}
    for kind, d in rows.items():
        jcls, tcls = classes[kind]
        jr = jsh.SHAFT_ROW_GENERATORS[kind](
            jcls(**{k: jnp.asarray(v) for k, v in d.items()}))
        tr = tsh.SHAFT_ROW_GENERATORS[kind](
            tcls(**{k: torch.as_tensor(v) for k, v in d.items()}))
        for f in ("body_a", "body_b", "body_c", "Ja_v", "Ja_w", "Jb_v",
                  "Jb_w", "Jc_w", "rhs", "active"):
            np.testing.assert_array_equal(getattr(tr, f).numpy(),
                                          np.asarray(getattr(jr, f)),
                                          err_msg=f"{kind} {f}")
