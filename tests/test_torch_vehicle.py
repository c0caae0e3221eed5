"""PyTorch port (chrono_tpu_torch) vs the JAX package: the wheeled vehicle
and its subsystems.

The drivers (``pid_step``, the speed controller and path follower over a
random sequence, ``DataDriver``, ``HumanDriver``, ``acc_speed_command``),
``interp`` at and past its knots, ``select_gear`` at the shift speeds
exactly, the engine map and the driveline, the five tire models on random
wheel states over flat ground and over a heightmap, the SCM pass
(``scm_wheel_forces``, ``scm_erosion_step``, ``scm_relocate``), one
``vehicle_step`` at rest and one while steering and braking, and the
HMMWV double lane change of demos/demo_vehicle_dlc.py for 200 steps.  Both
packages take the same seeded numpy inputs in float32 on the CPU.

Tolerances.  One evaluation in float32 on both sides: rtol 1e-5 with an
atol of 1e-5 of the largest reference magnitude (``F32``).  The closed
loop is different: its path follower's derivative gain (kd / h = 150)
multiplies the rounding of the lateral error, and its steering saturates
at ±1, so two float32 implementations part at the float32 floor and the
gap grows along the run.  ``test_dlc_float32_floor`` measures that floor
against the port in float64, and the 200-step loop is held to JAX at
``DLC_X_ATOL``, above it.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from chrono_tpu.core import functions as JF
from chrono_tpu.core import quaternion as JQ
from chrono_tpu.models import create_hmmwv as j_create_hmmwv
from chrono_tpu.vehicle import driver as jd
from chrono_tpu.vehicle import powertrain as jp
from chrono_tpu.vehicle import terrain as jt
from chrono_tpu.vehicle import tire as jtire
from chrono_tpu.vehicle import wheeled as jw

from chrono_tpu_torch import convert
from chrono_tpu_torch.core.functions import interp
from chrono_tpu_torch.models import create_hmmwv
from chrono_tpu_torch.vehicle import driver as td
from chrono_tpu_torch.vehicle import powertrain as tp
from chrono_tpu_torch.vehicle import terrain as tt
from chrono_tpu_torch.vehicle import tire as ttire
from chrono_tpu_torch.vehicle import wheeled as tw
from chrono_tpu_torch.vehicle.closed_loop import run_closed_loop

H = 1e-3
F32 = dict(rtol=1e-5, atol_rel=1e-5)
# the 200-step DLC loop against JAX: over 2x the larger chassis-position
# gap between a float32 run and the port's float64 run (test_dlc_float32_
# floor: the port's 2.7e-4 m; JAX's 1.6e-3 m as the demo's scan compiles
# at XLA's default, 1.9e-3 m at O0, and as this file runs it)
DLC_X_ATOL = 5e-3
DLC_STEPS = 200
TARGET = 12.0
# XLA's backend optimisations off: the compiles dominate these tests
O0 = {"xla_backend_optimization_level": 0}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The tiny LAPACK calls cost milliseconds each with a thread pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def close(got, ref, rtol=F32["rtol"], atol_rel=F32["atol_rel"], what=""):
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    scale = max(float(np.abs(ref).max()) if ref.size else 0.0, 1.0)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol_rel * scale,
                               err_msg=what)


def t32(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def j32(a):
    return jnp.asarray(np.asarray(a, np.float32))


# ------------------------------------------------------------------ drivers

def test_pid_step():
    rng = np.random.default_rng(0)
    for _ in range(20):
        integ, prev, err = rng.normal(0, 2.0, 3).astype(np.float32)
        kp, ki, kd = rng.uniform(0, 1.5, 3)
        jo, js = jd.pid_step(jd.PIDState(j32(integ), j32(prev)), j32(err),
                             kp, ki, kd, H)
        to, ts = td.pid_step(td.PIDState(t32(integ), t32(prev)), t32(err),
                             kp, ki, kd, H)
        close(to, jo)
        close(ts.integral, js.integral)
        close(ts.prev_err, js.prev_err)


def test_controllers_over_a_random_sequence():
    """The speed controller and the path follower carry their PID state
    over 50 random calls."""
    rng = np.random.default_rng(1)
    path = jd.double_lane_change_path()
    jsc = jd.SpeedController(kp=0.6, ki=0.2)
    jpf = jd.PathFollower(path_xy=path, look_ahead=8.0, kp=0.25, kd=0.15)
    tsc = convert.driver_from_numpy("SpeedController", leaves(jsc),
                                    device="cpu")
    tpf = convert.driver_from_numpy("PathFollower", leaves(jpf),
                                    device="cpu")
    np.testing.assert_array_equal(
        td.double_lane_change_path(device="cpu").numpy(), np.asarray(path))
    for k in range(50):
        speed = np.float32(rng.uniform(0, 15))
        pos = rng.uniform([0, -1], [190, 5]).astype(np.float32)
        head = np.float32(rng.normal(0, 0.3))
        jthr, jbrk, jsc = jsc(TARGET, j32(speed), H)
        tthr, tbrk, tsc = tsc(TARGET, t32(speed), H)
        jst, jpf = jpf(j32(pos), j32(head), H)
        tst, tpf = tpf(t32(pos), t32(head), H)
        for g, r in ((tthr, jthr), (tbrk, jbrk), (tst, jst),
                     (tsc.state.integral, jsc.state.integral),
                     (tpf.state.integral, jpf.state.integral)):
            close(g, r, what=f"call {k}")


def test_data_driver_and_straight_path():
    ts = np.array([0.0, 0.5, 1.5, 2.0], np.float32)
    cols = np.array([[0.0, 0.3, -0.2, 0.1], [0.0, 1.0, 0.5, 0.0],
                     [0.2, 0.0, 0.0, 1.0]], np.float32)
    jdd = jd.DataDriver(*map(jnp.asarray, (ts, *cols)))
    tdd = td.DataDriver(*map(torch.as_tensor, (ts, *cols)))
    for t in (-1.0, 0.0, 0.25, 0.5, 1.7, 2.0, 3.0):
        for g, r in zip(tdd(t32(t)), jdd(j32(t))):
            close(g, r, what=f"t = {t}")
    close(td.straight_path(1.0, 2.0, 300.0, 31, device="cpu"),
          jd.straight_path(1.0, 2.0, 300.0, 31))


def test_human_driver_and_acc():
    rng = np.random.default_rng(2)
    path = jd.double_lane_change_path()
    jh = jd.HumanDriver(path=path, Kug=0.2)
    th = td.HumanDriver(path=td.double_lane_change_path(device="cpu"),
                        Kug=0.2)
    jdelta, tdelta = j32(0.0), t32(0.0)
    for k in range(30):
        pos = rng.uniform([0, -1], [190, 5]).astype(np.float32)
        head = np.float32(rng.normal(0, 0.3))
        speed = np.float32(rng.uniform(0, 20))
        jdelta, ji = jh(jdelta, j32(pos), j32(head), j32(speed), H)
        tdelta, ti = th(tdelta, t32(pos), t32(head), t32(speed), H)
        close(tdelta, jdelta, what=f"call {k}")
        for g, r in zip(ti, ji):
            close(g, r, what=f"call {k}")
    gap = rng.uniform(0, 60, 16).astype(np.float32)
    rate = rng.normal(0, 3, 16).astype(np.float32)
    close(td.acc_speed_command(t32(20.0), t32(gap), t32(rate)),
          jd.acc_speed_command(20.0, j32(gap), j32(rate)))


# ------------------------------------------------------------ powertrain

def test_interp_at_and_past_the_knots():
    """``jnp.interp``: held at the end values outside the knots, exact at
    them, linear between (a repeated knot takes the left value)."""
    xp = np.array([0.0, 1.0, 1.0, 2.5, 4.0], np.float32)
    fp = np.array([3.0, -1.0, 2.0, 0.5, 7.0], np.float32)
    x = np.concatenate([xp, [-5.0, -1e-7, 0.3, 1.5, 3.9999, 4.0001, 9.0]]
                       ).astype(np.float32)
    got = interp(t32(x), t32(xp), t32(fp))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jnp.interp(x, xp, fp)))


def powertrains():
    speeds, torques, losses = jp.default_engine_map(
        max_torque=330.0, max_power_speed=333.3, max_speed=10000.0)
    return jp.PowertrainParams(
        map_speed=speeds, map_torque=torques, map_losses=losses,
        max_speed=jnp.asarray(10000.0),
        gear_ratios=jnp.asarray([5.0, 2.5, 1.25]),
        shift_speeds=jnp.asarray([6.0, 12.0, 19.0]),
        final_drive=jnp.asarray(5.0),
        driven_wheels=jnp.asarray([0.0, 0.0, 1.0, 1.0]),
        efficiency=jnp.asarray(0.85))


def test_select_gear_at_the_shift_speeds():
    """A speed exactly at a shift speed stays in the lower gear
    (``jnp.searchsorted``'s side "left")."""
    jpt = powertrains()
    tpt = convert.powertrain_params_from_numpy(leaves(jpt), device="cpu")
    for v in (0.0, 5.999, 6.0, 6.001, -12.0, 12.0, 18.9, 19.0, 19.5, 40.0):
        g = tp.select_gear(tpt, t32(v))
        assert int(g) == int(jp.select_gear(jpt, j32(v))), v
        assert g.dtype == torch.int64 and g.dim() == 0


def test_engine_map_and_driveline():
    rng = np.random.default_rng(3)
    jpt = powertrains()
    tpt = convert.powertrain_params_from_numpy(leaves(jpt), device="cpu")
    w = rng.uniform(-1200, 11000, 64).astype(np.float32)
    thr = rng.uniform(0, 1, 64).astype(np.float32)
    close(tp.engine_torque(tpt, t32(w), t32(thr)),
          jp.engine_torque(jpt, j32(w), j32(thr)))
    for k in range(12):
        om = rng.normal(10.0, 8.0, 4).astype(np.float32)
        v = np.float32(rng.uniform(0, 25))
        th = np.float32(rng.uniform(0, 1))
        got = tp.driveline_torques(tpt, t32(om), t32(v), t32(th))
        ref = jp.driveline_torques(jpt, j32(om), j32(v), j32(th))
        for g, r in zip(got, ref):
            close(g, r, what=f"draw {k}")
        close(tp.brake_torques(t32(th), t32(3000.0), t32(om)),
              jp.brake_torques(j32(th), j32(3000.0), j32(om)))


# ----------------------------------------------------------------- tires

TIRES = {"tmeasy": (jtire.TMeasyParams, jtire.tmeasy_forces,
                    ttire.tmeasy_forces),
         "fiala": (jtire.FialaParams, jtire.fiala_forces,
                   ttire.fiala_forces),
         "pac89": (jtire.Pac89Params, jtire.pac89_forces,
                   ttire.pac89_forces),
         "pac02": (jtire.Pac02Params, jtire.pac02_forces,
                   ttire.pac02_forces),
         "tmsimple": (jtire.TMsimpleParams, jtire.tmsimple_forces,
                      ttire.tmsimple_forces)}


def wheel_states(n, seed):
    """Random wheel states around contact: heights within ±6 cm of the
    radius, a few degrees of camber and any yaw, speeds to 15 m/s and
    spins to ±60 rad/s."""
    rng = np.random.default_rng(seed)
    x = np.column_stack([rng.uniform(0.1, 1.9, n), rng.uniform(0.1, 0.9, n),
                         0.35 + rng.uniform(-0.06, 0.06, n)])
    yaw = rng.uniform(-np.pi, np.pi, n)
    roll = rng.normal(0, 0.05, n)
    q = np.column_stack([np.cos(yaw / 2) * np.cos(roll / 2),
                         np.cos(yaw / 2) * np.sin(roll / 2),
                         np.sin(yaw / 2) * np.sin(roll / 2),
                         np.sin(yaw / 2) * np.cos(roll / 2)])
    v = rng.normal(0, 6.0, (n, 3)) * [1.0, 1.0, 0.1]
    w = rng.normal(0, 20.0, (n, 3))
    return [np.asarray(a, np.float32) for a in (x, q, v, w)]


@pytest.fixture(scope="module")
def heightmaps():
    rng = np.random.default_rng(5)
    z = rng.uniform(-0.03, 0.03, (21, 11)).astype(np.float32)
    jh = jt.Heightmap(z=jnp.asarray(z), origin=jnp.asarray([0.0, 0.0]),
                      spacing=jnp.asarray(0.1))
    th = tt.Heightmap(z=torch.as_tensor(z), origin=t32([0.0, 0.0]),
                      spacing=t32(0.1))
    return {"flat": (jt.flat_terrain(0.01), tt.flat_terrain(0.01)),
            "heightmap": (jh.height, th.height)}


@pytest.mark.parametrize("terrain", ["flat", "heightmap"])
@pytest.mark.parametrize("kind", list(TIRES))
def test_tire(kind, terrain, heightmaps):
    jcls, jfn, tfn = TIRES[kind]
    jparams = jcls()
    tparams = convert.tire_params_from_numpy(kind, leaves(jparams),
                                             device="cpu")
    jh, th = heightmaps[terrain]
    x, q, v, w = wheel_states(16, seed=len(kind))
    ref = jfn(jparams, *map(jnp.asarray, (x, q, v, w)), jh)
    got = tfn(tparams, *map(torch.as_tensor, (x, q, v, w)), th)
    assert float(np.asarray(ref[2]).max()) > 0, "no wheel in contact"
    for g, r, what in zip(got, ref, ("force", "spin torque", "fz")):
        close(g, r, what=what)


def test_heightmap_query(heightmaps):
    xy = np.random.default_rng(6).uniform(-0.3, 2.3, (40, 2))
    close(heightmaps["heightmap"][1](t32(xy)),
          heightmaps["heightmap"][0](j32(xy)))


# ------------------------------------------------------------------- SCM

def scm_pair(seed=7):
    """A 1.2 × 0.7 m patch at 2 cm with some plastic sinkage already in
    it, in both packages."""
    rng = np.random.default_rng(seed)
    js = jt.make_scm_state((0.0, 0.0), (1.2, 0.7), 0.02,
                           z0_fn=lambda x, y: 0.01 * np.sin(3 * x) * y)
    sink = rng.uniform(0, 0.004, js.sinkage.shape).astype(np.float32)
    js = js.replace(sinkage=jnp.asarray(sink))
    made = tt.make_scm_state((0.0, 0.0), (1.2, 0.7), 0.02,
                             z0_fn=lambda x, y: 0.01 * np.sin(3 * x) * y,
                             device="cpu")
    ts = convert.scm_state_from_numpy(leaves(js), device="cpu")
    for f in ("z0", "origin", "spacing"):
        np.testing.assert_array_equal(getattr(made, f).numpy(),
                                      getattr(ts, f).numpy())
    return js, ts


def test_scm_wheel_forces():
    js, ts = scm_pair()
    jparams = jt.SCMParams(Kphi=jnp.asarray(6e5), n_exp=jnp.asarray(1.1),
                           cohesion=jnp.asarray(800.0))
    tparams = convert.scm_params_from_numpy(leaves(jparams), device="cpu")
    x = np.array([[0.35, 0.3, 0.28], [0.8, 0.4, 0.27]], np.float32)
    q = np.array([[1, 0, 0, 0], [0.9950042, 0, 0, 0.0998334]], np.float32)
    v = np.array([[0.6, 0.05, -0.1], [0.4, -0.1, 0.02]], np.float32)
    w = np.array([[0, 3.0, 0], [0.1, 1.0, 0]], np.float32)
    ref = jax.jit(functools.partial(jt.scm_wheel_forces, wheel_radius=0.3,
                                    wheel_width=0.2), compiler_options=O0)(
        jparams, js, *map(jnp.asarray, (x, q, v, w)))
    got = tt.scm_wheel_forces(tparams, ts, *map(torch.as_tensor,
                                                (x, q, v, w)),
                              wheel_radius=0.3, wheel_width=0.2)
    assert float(np.abs(ref.force).max()) > 10.0
    close(got.force, ref.force, what="force")
    close(got.torque_spin, ref.torque_spin, what="torque")
    close(got.new_state.sinkage, ref.new_state.sinkage, what="sinkage")
    close(got.sinkage_max, ref.sinkage_max, what="sinkage_max")


def test_scm_erosion_and_relocate():
    js, ts = scm_pair(8)
    js = js.replace(sinkage=js.sinkage.at[20:24, 10:14].add(0.08))
    ts = ts.replace(sinkage=ts.sinkage.clone())
    ts.sinkage[20:24, 10:14] += 0.08
    close(tt.scm_erosion_step(ts).sinkage, jt.scm_erosion_step(js).sinkage)

    def z0_fn(x, y):
        return 0.02 * x - 0.01 * y

    for center in ((0.9, 0.2), (0.1, 0.7), (0.6, 0.35)):
        ref = jt.scm_relocate(js, center, z0_fn=z0_fn)
        got = tt.scm_relocate(ts, center, z0_fn=z0_fn)
        for f in ("z0", "sinkage", "origin"):
            close(getattr(got, f), getattr(ref, f), what=f"{center} {f}")


# ------------------------------------------------------------ the vehicle

@pytest.fixture(scope="module")
def hmmwv():
    jv, js = j_create_hmmwv()
    tv, ts = create_hmmwv(device="cpu")
    return jv, js, tv, ts


def test_hmmwv_converts():
    """The builder's vehicle equals the converted JAX one (the full model
    comparison of every deck is tests/test_torch_models.py's)."""
    jv, _ = j_create_hmmwv()
    tv, _ = create_hmmwv(device="cpu")
    cv = convert.wheeled_vehicle_from_numpy(leaves(jv), device="cpu")
    assert (cv.wheels, cv.knuckles, cv.chassis) == (tv.wheels, tv.knuckles,
                                                    tv.chassis)
    close(cv.tire.fxm_2, tv.tire.fxm_2)
    close(cv.powertrain.map_torque, tv.powertrain.map_torque)


@pytest.fixture(scope="module")
def j_vehicle_step(hmmwv):
    jv = hmmwv[0]
    return jax.jit(lambda s, i, t: jw.vehicle_step(jv, s, i,
                                                   jt.flat_terrain(0.0), t,
                                                   H), compiler_options=O0)


@pytest.mark.parametrize("inputs", [(0.0, 0.0, 0.0), (0.6, 0.4, 0.0),
                                    (-0.8, 0.0, 0.7)],
                         ids=["at_rest", "steer_throttle", "steer_brake"])
def test_vehicle_step(inputs, hmmwv, j_vehicle_step):
    """One step from rest, and from a moving, spinning, perturbed state
    while steering and braking."""
    jv, js, tv, ts = hmmwv
    st = {f: np.array(getattr(js, f)) for f in "xqvw"}
    if inputs != (0.0, 0.0, 0.0):
        rng = np.random.default_rng(9)
        st["v"] += (rng.normal(0, 0.3, st["v"].shape)
                    + [6.0, 0.0, 0.0]).astype(np.float32)
        st["w"] += rng.normal(0, 0.3, st["w"].shape).astype(np.float32)
        st["w"][list(jv.wheels), 1] += 13.0
        st["x"][:, 2] -= 0.012
    jst = js.replace(**{f: jnp.asarray(a) for f, a in st.items()})
    tst = convert.body_state_from_numpy(st, device="cpu")
    ref = j_vehicle_step(jst, jd.DriverInputs(*map(j32, inputs)), j32(0.0))
    got = tw.vehicle_step(tv, tst, td.DriverInputs(*map(t32, inputs)),
                          tt.flat_terrain(0.0), t32(0.0), H)
    for f in "xqvw":
        close(getattr(got.state, f), getattr(ref.state, f), what=f)
    close(got.tire_fz, ref.tire_fz, what="fz")
    close(got.engine_speed, ref.engine_speed, what="engine speed")
    assert int(got.gear) == int(ref.gear)


def dlc_jax(jv, js, n, step):
    """The loop body of demos/demo_vehicle_dlc.py's scan, step by step: the
    controllers jitted apart from ``vehicle_step`` (``step``, jitted once
    for this file), ``t`` carried in float32 as the scan carries it."""
    @functools.partial(jax.jit, compiler_options=O0)
    def drivers(st, sc, pc):
        speed = jnp.linalg.norm(st.v[jv.chassis, :2])
        throttle, braking, sc = sc(TARGET, speed, H)
        fwd = JQ.qrotate(st.q[jv.chassis], jnp.asarray([1.0, 0, 0]))
        heading = jnp.arctan2(fwd[1], fwd[0])
        steer, pc = pc(st.x[jv.chassis, :2], heading, H)
        return jd.DriverInputs(steer, throttle, braking), sc, pc

    sc = jd.SpeedController(kp=jnp.asarray(0.6), ki=jnp.asarray(0.2))
    pc = jd.PathFollower(path_xy=jd.double_lane_change_path(),
                         look_ahead=jnp.asarray(8.0), kp=jnp.asarray(0.25),
                         kd=jnp.asarray(0.15))
    st, t, xs = js, jnp.asarray(0.0), []
    for _ in range(n):
        xs.append(st.x[jv.chassis])
        inputs, sc, pc = drivers(st, sc, pc)
        st = step(st, inputs, t).state
        t = t + H
    return st, jnp.stack(xs)


def dlc_port(dtype, n):
    tv, ts = create_hmmwv(dtype=dtype, device="cpu")
    return run_closed_loop(
        tv, ts, td.SpeedController(kp=0.6, ki=0.2),
        td.PathFollower(path_xy=td.double_lane_change_path(dtype=dtype,
                                                           device="cpu"),
                        look_ahead=8.0, kp=0.25, kd=0.15),
        tt.flat_terrain(0.0), TARGET, H, n)


@pytest.fixture(scope="module")
def dlc_runs(hmmwv, j_vehicle_step):
    jv, js = hmmwv[:2]
    jst, jxs = dlc_jax(jv, js, DLC_STEPS, j_vehicle_step)
    return (np.asarray(jxs), jst, dlc_port(torch.float32, DLC_STEPS),
            dlc_port(torch.float64, DLC_STEPS))


def test_dlc_200_steps(dlc_runs):
    """The closed loop of demos/demo_vehicle_dlc.py, 200 steps: the chassis
    track held to JAX at DLC_X_ATOL; the first 40 steps, before the
    loop's gain has multiplied the rounding, at float32 precision."""
    jxs, jst, out32, _ = dlc_runs
    xs = out32.chassis_x.numpy()
    assert xs.shape == (DLC_STEPS, 3) and np.isfinite(xs).all()
    np.testing.assert_allclose(xs[:40], jxs[:40], rtol=0, atol=1e-6)
    np.testing.assert_allclose(xs, jxs, rtol=0, atol=DLC_X_ATOL)
    np.testing.assert_allclose(out32.state.x.numpy(), np.asarray(jst.x),
                               rtol=0, atol=DLC_X_ATOL)
    assert xs[-1, 0] > 0.05          # it has started to drive off


def test_dlc_float32_floor(dlc_runs):
    """The float32 floor of the 200-step loop: each float32 run (JAX's and
    the port's) against the port in float64.  Both lie between 1e-4 and
    2.5e-3 m, and DLC_X_ATOL is 2x the bound."""
    jxs, _, out32, out64 = dlc_runs
    x64 = out64.chassis_x.numpy()
    gap_port = float(np.abs(out32.chassis_x.numpy() - x64).max())
    gap_jax = float(np.abs(jxs - x64).max())
    assert 1e-4 < gap_port < DLC_X_ATOL / 2
    assert 1e-4 < gap_jax < DLC_X_ATOL / 2
