"""PyTorch port (chrono_tpu_torch) vs the JAX package: the copter, the
turtlebot and RoboSimian.

- ``create_copter`` / ``create_turtlebot`` / ``set_turtlebot_speeds``
  against the JAX builders carried across by ``convert`` (integer leaves
  and static indices to the bit, floats within 1e-7); then
  tests/test_robots.py's scenes (hover, climb at +5 % ω, differential yaw;
  the turtlebot straight and turning) for 100 steps each: every JAX state
  stepped once by the port at ``test_torch_mbs.py``'s ``STEP_TOL``, and the
  port's own run within x atol 2e-4 of the JAX run;
- ``create_robosimian`` field for field (model, state, collision model,
  chassis and wheel ids; the limb frames within 1e-6, float32 chains of
  eight rotations) on the driving table that ``chip_smoke.py``
  writes (a made-up table in the reference's 33-column format; the
  reference's own actuation files are not in the repository), with
  tests/test_robosimian.py's stance checks;
- ``gait_programs`` on that table (start + 2 cycles, as
  tests/test_robosimian.py:42-53) against the JAX programs, and
  ``load_actuation``'s refusal of a table of the wrong width;
- RoboSimian's ``nsc_step`` (APGD, 60 iterations, stab 0.2, h = 2 ms):
  the JAX package's float64 run from rest, each of its states stepped
  once by the port in float64, held at the North star's tolerances (x
  rtol 1e-4 / atol 1e-5, v and ω rtol 1e-3 / atol 1e-4) with the same
  iteration count and contact count.  APGD stops at its 60 iterations
  unconverged here, so in float32 its path turns on rounding (the port
  and JAX part by ~4e-5 m of advance in 500 steps,
  tools/robosimian_reference.py); float64 takes rounding out of the
  comparison, as tests/test_torch_contact.py does for APGD.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chrono_tpu.collision import pipeline as jpipe
from chrono_tpu.models import robosimian as JR
from chrono_tpu.models import robots as JB
from chrono_tpu.physics.system import SolverSettings as JSettings

from chrono_tpu_torch import convert
from chrono_tpu_torch.collision import pipeline as tpipe
from chrono_tpu_torch.models import robosimian as TR
from chrono_tpu_torch.models import robots as TB
from chrono_tpu_torch.physics.body import BodyState
from chrono_tpu_torch.physics.system import SolverSettings as TSettings

import chip_smoke
from test_torch_mbs import STEP_TOL, assert_same_leaves, leaves
from test_torch_tracked import j64, t64

O0 = {"xla_backend_optimization_level": 0}
X_TOL = dict(rtol=1e-4, atol=1e-5)
V_TOL = dict(rtol=1e-3, atol=1e-4)
X_ATOL_RUN = 2e-4
N_STEPS = 100
RS_STEPS = 12
RS_H = 2e-3
RS_FRAME_ATOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jit(fn):
    return jax.jit(fn, compiler_options=O0)


def port_state(s, dtype=None):
    return BodyState(**{f: torch.tensor(np.asarray(getattr(s, f)),
                                        dtype=dtype) for f in "xqvw"})


def assert_state_equal(tstate, jstate):
    for f in "xqvw":
        np.testing.assert_array_equal(getattr(tstate, f).numpy(),
                                      np.asarray(getattr(jstate, f)))


def run_both(jstep, tstep, jstate, tstate, h, n=N_STEPS, v_tol=STEP_TOL):
    """``n`` steps: each JAX state stepped once by the port (``STEP_TOL``;
    v and ω at ``v_tol``), and the port's own run within x atol 2e-4 of
    the JAX run."""
    js, ts, t = jstate, tstate, torch.zeros(())
    for k in range(n):
        nxt = jstep(js, jnp.float32(k * h))
        one = tstep(port_state(js), torch.tensor(k * h, dtype=torch.float32))
        for f in "xqvw":
            np.testing.assert_allclose(
                getattr(one, f).numpy(), np.asarray(getattr(nxt, f)),
                err_msg=f"step {k} {f}", **(v_tol if f in "vw" else STEP_TOL))
        ts = tstep(ts, t)
        t = t + h
        js = nxt
    np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x), rtol=0,
                               atol=X_ATOL_RUN)
    return js, ts


# ------------------------------------------------------------------ copter

@pytest.fixture(scope="module")
def copters():
    jc, js = JB.create_copter()
    tc, ts = TB.create_copter(device="cpu")
    h = chip_smoke.COPTER_H
    jstep = jit(lambda s, om, t: JB.copter_step(jc, s, om, t, h)[0])
    return jc, js, tc, ts, jstep


def test_create_copter_field_for_field(copters):
    jc, js, tc, ts, _ = copters
    assert_same_leaves(tc, convert.copter_from_numpy(leaves(jc),
                                                     device="cpu"))
    assert_state_equal(ts, js)
    np.testing.assert_allclose(float(TB.copter_hover_omega(tc)),
                               float(JB.copter_hover_omega(jc)), rtol=1e-7)


@pytest.mark.parametrize("scene", ["hover", "climb", "yaw"])
def test_copter_steps(scene, copters):
    jc, js, tc, ts, jstep = copters
    w = float(JB.copter_hover_omega(jc))
    om = {"hover": [w] * 4, "climb": [1.05 * w] * 4,
          "yaw": [1.1 * w, 0.9 * w, 1.1 * w, 0.9 * w]}[scene]
    om_j = jnp.asarray(om, jnp.float32)
    om_t = torch.tensor(om, dtype=torch.float32)
    f_j, tau_j = JB.copter_forces(jc, js, om_j)
    f_t, tau_t = TB.copter_forces(tc, ts, om_t)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), **STEP_TOL)
    np.testing.assert_allclose(tau_t.numpy(), np.asarray(tau_j), **STEP_TOL)
    h = chip_smoke.COPTER_H
    run_both(lambda s, t: jstep(s, om_j, t),
             lambda s, t: TB.copter_step(tc, s, om_t, t, h)[0], js, ts, h)


# --------------------------------------------------------------- turtlebot

@pytest.fixture(scope="module")
def turtlebots():
    jb, js = JB.create_turtlebot()
    tb, ts = TB.create_turtlebot(device="cpu")
    h = chip_smoke.TURTLE_H
    jstep = jit(lambda b, s, t: JB.turtlebot_step(b, s, t, h)[0])
    return jb, js, tb, ts, jstep


def test_create_turtlebot_field_for_field(turtlebots):
    jb, js, tb, ts, _ = turtlebots
    assert_same_leaves(tb, convert.turtlebot_from_numpy(leaves(jb),
                                                        device="cpu"))
    assert_state_equal(ts, js)
    assert_same_leaves(
        TB.set_turtlebot_speeds(tb, 9.0, 5.0),
        convert.turtlebot_from_numpy(leaves(JB.set_turtlebot_speeds(
            jb, 9.0, 5.0)), device="cpu"))


@pytest.mark.parametrize("speeds", [(8.0, 8.0), (9.0, 5.0)])
def test_turtlebot_steps(speeds, turtlebots):
    jb, js, tb, ts, jstep = turtlebots
    jb = JB.set_turtlebot_speeds(jb, *speeds)
    tb = TB.set_turtlebot_speeds(tb, *speeds)
    h = chip_smoke.TURTLE_H
    jf, tf = run_both(lambda s, t: jstep(jb, s, t),
                      lambda s, t: TB.turtlebot_step(tb, s, t, h)[0],
                      js, ts, h)
    assert float(tf.x[tb.chassis, 0]) > float(ts.x[tb.chassis, 0])


# --------------------------------------------------------------- RoboSimian

@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    return chip_smoke.robosimian_tables(str(tmp_path_factory.mktemp("rs")))


def driving(mod, cycle, **kw):
    progs, posture, T = mod.gait_programs(cycle, **kw)
    post = posture.reshape(4, 8).copy()
    speeds = 4.0 * post[:, 7]
    post[:, 7] = 0.0
    return post.reshape(-1), speeds


@pytest.fixture(scope="module")
def robosimians(tables):
    post, speeds = driving(JR, tables[0])
    tpost, tspeeds = driving(TR, tables[0], device="cpu")
    np.testing.assert_array_equal(tpost, post)
    np.testing.assert_array_equal(tspeeds, speeds)
    return (JR.create_robosimian(post, speeds),
            TR.create_robosimian(post, speeds, device="cpu"))


def assert_leaves_close(got, ref, atol, path="model"):
    """Leaf by leaf: integers and static fields to the bit, floats within
    ``atol``."""
    if dataclasses.is_dataclass(ref):
        assert type(got) is type(ref), path
        for f in dataclasses.fields(ref):
            assert_leaves_close(getattr(got, f.name), getattr(ref, f.name),
                                atol, f"{path}.{f.name}")
    elif isinstance(ref, dict):
        assert sorted(got) == sorted(ref), path
        for k in ref:
            assert_leaves_close(got[k], ref[k], atol, f"{path}[{k}]")
    elif isinstance(ref, (tuple, list)):
        assert len(got) == len(ref), path
        for i, (g, r) in enumerate(zip(got, ref)):
            assert_leaves_close(g, r, atol, f"{path}[{i}]")
    elif isinstance(ref, torch.Tensor):
        assert got.dtype == ref.dtype and got.shape == ref.shape, path
        if ref.dtype.is_floating_point:
            np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                                       atol=atol, err_msg=path)
        else:
            np.testing.assert_array_equal(got.numpy(), ref.numpy(),
                                          err_msg=path)
    else:
        assert got == ref, path


def test_create_robosimian_field_for_field(robosimians):
    """Integers, static fields and the ids to the bit; floats within
    ``RS_FRAME_ATOL``: each limb's frames are a chain of eight float32
    rotations whose sines and cosines XLA and PyTorch round to different
    neighbouring floats, which moves a frame by up to a few 1e-7."""
    (jm, js, jc, jch, jw), (tm, ts, tc, tch, tw) = robosimians
    assert_leaves_close(tm, convert.mbs_model_from_numpy(leaves(jm),
                                                         device="cpu"),
                        RS_FRAME_ATOL)
    ref = convert.collision_model_from_numpy(leaves(jc), device="cpu")
    assert_same_leaves(tc, ref)
    for f in "xqvw":
        np.testing.assert_allclose(getattr(ts, f).numpy(),
                                   np.asarray(getattr(js, f)), rtol=0,
                                   atol=RS_FRAME_ATOL, err_msg=f)
    assert tch == jch and list(tw) == list(jw)
    assert tm.n_bodies == 34 and len(tw) == 4
    assert sum(m.n for m in tm.motors.values()) == 32
    # tests/test_robosimian.py's stance checks, on the port
    wp = ts.x[tw].numpy()
    np.testing.assert_allclose(wp[:, 2], TR.WHEEL_RADIUS, atol=1e-5)
    assert abs(wp[0, 0] + wp[1, 0]) < 1e-4 and abs(wp[0, 1] + wp[3, 1]) < 1e-4
    assert float(ts.x[tch, 2]) > 0.5
    np.testing.assert_allclose(ts.q[tch].numpy(), [0, 1, 0, 0], atol=1e-6)


def test_gait_programs_start_and_cycles(tables):
    """Start + 2 cycles: the JAX programs to the bit, and
    tests/test_robosimian.py:42-53's checks on the port's."""
    cycle, start = tables
    jp, jpost, jT = JR.gait_programs(cycle, n_cycles=2, start_path=start)
    tp, tpost, tT = TR.gait_programs(cycle, n_cycles=2, start_path=start,
                                     device="cpu")
    assert tT == jT and len(tp) == len(jp) == 32
    np.testing.assert_array_equal(tpost, jpost)
    for a, b in zip(tp, jp):
        np.testing.assert_array_equal(a.ts.numpy(), np.asarray(b.ts))
        np.testing.assert_array_equal(a.ys.numpy(), np.asarray(b.ys))
    ts0, _ = TR.load_actuation(start)
    tsc, _ = TR.load_actuation(cycle)
    assert tT > float(ts0[-1] + 2 * tsc[-1]) - 0.1
    for p in tp[:4]:
        assert bool((torch.diff(p.ts) > 0).all())
        assert abs(float(p.value(torch.tensor(0.0)))) < 1e-6


def test_load_actuation_refuses_a_wrong_table(tmp_path):
    path = tmp_path / "short.txt"
    np.savetxt(path, np.zeros((3, 20)))
    with pytest.raises(ValueError, match="33 columns"):
        TR.load_actuation(str(path))


def test_robosimian_nsc_steps(robosimians):
    """The JAX float64 run from rest, each state stepped once by the port
    in float64: the North star's tolerances, the same iteration and
    contact counts."""
    (jm, js, jc, _, _), (tm, _, tc, _, _) = robosimians
    kw = dict(solver="apgd", max_iter=60, stab_factor=0.2)
    with jax.enable_x64(True):
        jm64, jc64, js64 = j64(jm), j64(jc), j64(js)
        step = jit(lambda s, t: jpipe.nsc_step(jm64, jc64, s, t, RS_H,
                                               JSettings(**kw)))
        states, outs = [js64], []
        for k in range(RS_STEPS):
            s, con, info = step(states[-1], jnp.float64(k * RS_H))
            states.append(s)
            outs.append((int(con.count), int(info.iterations)))
    tm64, tc64 = t64(tm), t64(tc)
    settings = TSettings(**kw)
    for k in range(RS_STEPS):
        got, con, info = tpipe.nsc_step(
            tm64, tc64, port_state(states[k], torch.float64),
            torch.tensor(k * RS_H, dtype=torch.float64), RS_H, settings)
        assert (int(con.count), int(info.iterations)) == outs[k], k
        ref = states[k + 1]
        np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x),
                                   err_msg=f"step {k} x", **X_TOL)
        np.testing.assert_allclose(got.q.numpy(), np.asarray(ref.q), rtol=0,
                                   atol=X_TOL["atol"] / 10,
                                   err_msg=f"step {k} q")
        for f in "vw":
            np.testing.assert_allclose(getattr(got, f).numpy(),
                                       np.asarray(getattr(ref, f)),
                                       err_msg=f"step {k} {f}", **V_TOL)
    assert outs[-1][0] == 4                  # the four wheels on the ground
