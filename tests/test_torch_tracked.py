"""PyTorch port (chrono_tpu_torch) vs the JAX package: tracked vehicles.

- ``tracked_step`` on ``build_tracked_vehicle()`` and ``build_m113()``: 200
  steps of symmetric and of differential sprocket torque, the North star's
  state tolerances (x rtol 1e-4 / atol 1e-5, v and ω rtol 1e-3 / atol
  1e-4) and the per-side loads;
- ``build_marder`` against the JAX builder field for field (integer leaves
  and static indices to the bit, floats within 1e-7 relative), then
  tests/test_model_decks.py's acceleration (600 steps at 16,000 N·m a
  sprocket) on both sides with that test's checks;
- ``m113_acceleration_run`` shortened to 300 steps against the JAX run's
  (times, speeds);
- the segmented-track rigs of tests/test_tracked.py: the single-pin loop
  on friction drive, the pitch-matched single-pin loop with and without
  the sprocket gear, and the double-pin loop (its connectors seated by the
  gear), each at its test's settings.  The JAX step is scanned for a few
  steps in float64 and each of its states is stepped once by the port
  (float64 too).  The solve stops at ``max_iter`` with an APGD residual
  of ~0.5, far from converged: the JAX step's own output moves by up to
  5.6 rad/s when its float64 input moves by 1e-12, so a free-running
  comparison parts within steps.  Each port step is held within twice
  that response, measured in the test at each state.  The gear's rows and
  the detected rows are held on every state.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chrono_tpu.collision import pipeline as jpipe
from chrono_tpu.core import functions as JF
from chrono_tpu.models import decks as jdecks
from chrono_tpu.models import m113 as jm113
from chrono_tpu.physics.builder import SystemBuilder as JBuilder
from chrono_tpu.physics.system import SolverSettings as JSettings
from chrono_tpu.vehicle import track_shoes as jts
from chrono_tpu.vehicle import tracked as jtr

from chrono_tpu_torch import convert
from chrono_tpu_torch.collision import pipeline as tpipe
from chrono_tpu_torch.models import build_marder, build_m113
from chrono_tpu_torch.models.m113 import m113_acceleration_run
from chrono_tpu_torch.physics.body import BodyState
from chrono_tpu_torch.physics.builder import SystemBuilder as TBuilder
from chrono_tpu_torch.physics.system import SolverSettings as TSettings
from chrono_tpu_torch.vehicle import track_shoes as tts
from chrono_tpu_torch.vehicle import tracked as ttr
from chrono_tpu_torch.vehicle.terrain import flat_terrain

O0 = {"xla_backend_optimization_level": 0}
X_TOL = dict(rtol=1e-4, atol=1e-5)
V_TOL = dict(rtol=1e-3, atol=1e-4)
# the gear's rows on the same state: closed forms, float64
ROW_TOL = dict(rtol=1e-9, atol=1e-9)
# the detected rows on the same state: MPR's tolerance (tests/
# test_torch_mpr.py: gap atol 1e-5, normal and point atol 1e-4 for
# unit-size shapes)
MPR_TOL = {"gap": 1e-5, "normal": 1e-4, "point": 1e-4}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jit(fn):
    return jax.jit(fn, compiler_options=O0)


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


def j64(tree):
    """A JAX pytree with its float leaves in float64 (inside
    ``jax.enable_x64``)."""
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a), jnp.float64)
        if np.asarray(a).dtype.kind == "f" else a, tree)


def t64(obj):
    """The port's carriers with their float tensors in float64."""
    if isinstance(obj, torch.Tensor):
        return obj.double() if obj.is_floating_point() else obj
    if isinstance(obj, dict):
        return {k: t64(v) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*[t64(v) for v in obj])
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: t64(getattr(obj, f.name))
            for f in dataclasses.fields(obj) if f.init})
    return obj


def assert_same_vehicle(tv, jv):
    """The port's vehicle equals the JAX one carried across by
    ``convert``: integers and static indices to the bit, floats within
    1e-7 relative."""
    ref = convert.tracked_vehicle_from_numpy(leaves(jv), device="cpu")
    assert (tv.chassis, tv.sprockets) == (ref.chassis, ref.sprockets)
    assert tv.track.n_patches == ref.track.n_patches

    def walk(a, b, path):
        if dataclasses.is_dataclass(a):
            for f in dataclasses.fields(a):
                walk(getattr(a, f.name), getattr(b, f.name),
                     f"{path}.{f.name}")
        elif isinstance(a, dict):
            assert a.keys() == b.keys(), path
            for k in a:
                walk(a[k], b[k], f"{path}[{k}]")
        elif isinstance(a, torch.Tensor):
            if a.is_floating_point():
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-7,
                                           atol=0, err_msg=path)
            else:
                assert torch.equal(a, b), path
        else:
            assert a == b, path

    walk(tv, ref, "vehicle")


def drive_both(jv, js, tv, ts, torques, n, h=2e-3):
    """``n`` steps of ``tracked_step`` on both sides from the same state."""
    flat_j = lambda xy: jnp.zeros(xy.shape[:-1], xy.dtype)
    step = jit(lambda s, tq: jtr.tracked_step(jv, s, tq, flat_j, h))
    jq = jnp.asarray(torques, js.x.dtype)
    tq = torch.tensor(torques, dtype=ts.x.dtype)
    flat_t = flat_terrain(0.0)
    jout = tout = None
    for _ in range(n):
        jout = step(js, jq)
        js = jout.state
        tout = ttr.tracked_step(tv, ts, tq, flat_t, h)
        ts = tout.state
    return jout, tout


def assert_state_close(got, ref, what, chassis=0):
    """The North star's tolerances.  A sprocket shaft's orientation is not
    compared: it is the integral of the shaft's spin (held with the other
    spins), nothing in the band track reads it, and after 200 steps of a
    spin held at rtol 1e-3 it has turned tens of radians."""
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x),
                               err_msg=f"{what} x", **X_TOL)
    np.testing.assert_allclose(got.q.numpy()[chassis],
                               np.asarray(ref.q)[chassis],
                               err_msg=f"{what} q", **X_TOL)
    for f in "vw":
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)),
                                   err_msg=f"{what} {f}", **V_TOL)


# -------------------------------------------------------- the band track

@pytest.mark.parametrize("deck", ["default", "m113"])
@pytest.mark.parametrize("torques", [(4000.0, 4000.0), (3000.0, -3000.0)])
def test_tracked_step(deck, torques):
    """Symmetric torque in float32; the pivot turn (differential torque)
    in float64 on both sides: its forward speed is the balance of two
    opposite track forces, zero in exact arithmetic, and float32 rounding
    of that balance alone moves it by 6e-3 m/s in 200 steps (the JAX step
    jitted at XLA's O0 against its default level)."""
    build_j, build_t = ((jm113.build_m113, build_m113) if deck == "m113"
                        else (jtr.build_tracked_vehicle,
                              ttr.build_tracked_vehicle))
    jv, js = build_j()
    tv, ts = build_t(device="cpu")
    assert_same_vehicle(tv, jv)
    x64 = torques[0] != torques[1]
    with jax.enable_x64(x64):
        if x64:
            jv, js = j64(jv), j64(js)
            tv, ts = t64(tv), t64(ts)
        jout, tout = drive_both(jv, js, tv, ts, torques, 200)
    assert_state_close(tout.state, jout.state, f"{deck} {torques}")
    np.testing.assert_allclose(tout.fz.numpy(), np.asarray(jout.fz),
                               rtol=1e-3, atol=1.0)
    np.testing.assert_allclose(tout.sprocket_w.numpy(),
                               np.asarray(jout.sprocket_w), **V_TOL)
    # the port's loads carry the vehicle's weight once it has settled
    assert np.isfinite(tout.state.x.numpy()).all()


def test_marder_builds_and_accelerates():
    """tests/test_model_decks.py's Marder check on both sides."""
    jv, js = jdecks.build_marder()
    tv, ts = build_marder(device="cpu")
    assert_same_vehicle(tv, jv)
    jout, tout = drive_both(jv, js, tv, ts, (16000.0, 16000.0), 600)
    for out in (tout, jout):
        vx = float(out.state.v[tv.chassis, 0])
        assert 0.5 < vx < 15.0, vx
        assert np.isfinite(np.asarray(out.state.x)).all()
    assert_state_close(tout.state, jout.state, "marder")


def test_m113_acceleration_run_short():
    """``m113_acceleration_run`` (eager on the CPU) against the JAX run,
    both cut to 300 steps: the same sample times, speeds within the North
    star's velocity tolerance."""
    jt, jspeed = jm113.m113_acceleration_run(n_steps=300)
    tt, tspeed = m113_acceleration_run(n_steps=300, device="cpu")
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(tspeed, jspeed, **V_TOL)
    assert tspeed[-1] > tspeed[1] > 0.0


def test_tracked_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default builds there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_m113()


# ------------------------------------------------ the segmented tracks

SHOE = dict(wheel_r=0.2, shoe_h=0.05, shoe_w=0.2)
NO_SPHERES = {"spheres": {"body": np.zeros((0,), np.int32),
                          "offset": np.zeros((0, 3), np.float32),
                          "radius": np.zeros((0,), np.float32),
                          "mu": np.zeros((0,), np.float32)}}


def rig(kind):
    """The JAX package's rig of tests/test_tracked.py (built by its
    builders): (model, collision model, state, settings, h, gear, track,
    chassis)."""
    wheel_r, shoe_h, shoe_w = SHOE["wheel_r"], SHOE["shoe_h"], SHOE["shoe_w"]
    rp = wheel_r + 0.5 * shoe_h + 2e-3
    zc = rp + 0.5 * shoe_h
    if kind == "friction":
        d, omega, mu_rim = 0.8, 3.0, 1.5
    else:
        d = jts.matched_track_span(wheel_r, shoe_h, 24, 16)
        omega, mu_rim = 6.0, 0.1
    c_rear, c_front = (0.0, 0.0, zc), (d, 0.0, zc)
    bld = JBuilder()
    bld.set_gravity((0, 0, -9.81))
    g = bld.add_ground()
    chassis = bld.add_body(mass=20.0, inertia=(2.0, 4.0, 5.0),
                           pos=((0.4 if kind == "friction" else d / 2),
                                0.0, zc))
    if kind != "friction":
        bld.add_joint("prismatic", g, chassis, world_pos=(d / 2, 0.0, zc),
                      world_axis=(1, 0, 0))
    if kind == "double_pin":
        track = jts.add_segmented_track_double_pin(
            bld, chassis, c_rear, c_front, wheel_r, n_shoes=24,
            shoe_h=shoe_h, shoe_w=shoe_w, shoe_mass=1.5)
    else:
        track = jts.add_segmented_track(bld, chassis, c_rear, c_front,
                                        wheel_r, n_shoes=24, shoe_h=shoe_h,
                                        shoe_w=shoe_w, shoe_mass=0.5)
    bld.add_motor_rotation_speed(chassis, track.sprocket, world_pos=c_front,
                                 world_axis=(0, 1, 0), profile=omega,
                                 add_joint=False)
    model, state = bld.finalize()
    gear = None
    if kind == "gear":
        gear = jts.make_sprocket_gear(track, state)
    elif kind == "double_pin":
        gear = jts.make_sprocket_gear_double_pin(track, state)
    convex = jts.track_collision_shapes(track, mu_rim=mu_rim,
                                        extra=jts.ground_shape(g))
    coll = jpipe.CollisionModel(
        spheres=jpipe.SphereShapes(**{k: jnp.asarray(v) for k, v in
                                      NO_SPHERES["spheres"].items()}),
        boxes=None, convex=convex,
        grid=jpipe.GridSpec(origin=(-5, -5, -2), cell_size=1.0,
                            dims=(12, 12, 4)),
        max_per_cell=8, max_contacts=96)
    settings = dict(
        friction=dict(solver="apgd", max_iter=300, stab_factor=0.2,
                      max_recovery_speed=0.5),
        gear=dict(solver="apgd", max_iter=300, stab_factor=0.05,
                  max_recovery_speed=0.5),
        no_gear=dict(solver="apgd", max_iter=300, stab_factor=0.05,
                     max_recovery_speed=0.5),
        double_pin=dict(solver="apgd", max_iter=150, stab_factor=0.05,
                        max_recovery_speed=0.5))[kind]
    h = 2.5e-4 if kind == "double_pin" else 1e-3
    return model, coll, state, settings, h, gear, track, chassis


def port_rig(kind):
    """The same rig built by the port's builders on the CPU."""
    wheel_r, shoe_h, shoe_w = SHOE["wheel_r"], SHOE["shoe_h"], SHOE["shoe_w"]
    rp = wheel_r + 0.5 * shoe_h + 2e-3
    zc = rp + 0.5 * shoe_h
    if kind == "friction":
        d, omega, mu_rim = 0.8, 3.0, 1.5
    else:
        d = tts.matched_track_span(wheel_r, shoe_h, 24, 16)
        omega, mu_rim = 6.0, 0.1
    c_rear, c_front = (0.0, 0.0, zc), (d, 0.0, zc)
    bld = TBuilder(device="cpu")
    bld.set_gravity((0, 0, -9.81))
    g = bld.add_ground()
    chassis = bld.add_body(mass=20.0, inertia=(2.0, 4.0, 5.0),
                           pos=((0.4 if kind == "friction" else d / 2),
                                0.0, zc))
    if kind != "friction":
        bld.add_joint("prismatic", g, chassis, world_pos=(d / 2, 0.0, zc),
                      world_axis=(1, 0, 0))
    if kind == "double_pin":
        track = tts.add_segmented_track_double_pin(
            bld, chassis, c_rear, c_front, wheel_r, n_shoes=24,
            shoe_h=shoe_h, shoe_w=shoe_w, shoe_mass=1.5)
    else:
        track = tts.add_segmented_track(bld, chassis, c_rear, c_front,
                                        wheel_r, n_shoes=24, shoe_h=shoe_h,
                                        shoe_w=shoe_w, shoe_mass=0.5)
    bld.add_motor_rotation_speed(chassis, track.sprocket, world_pos=c_front,
                                 world_axis=(0, 1, 0), profile=omega,
                                 add_joint=False)
    model, state = bld.finalize()
    gear = None
    if kind == "gear":
        gear = tts.make_sprocket_gear(track, state)
    elif kind == "double_pin":
        gear = tts.make_sprocket_gear_double_pin(track, state)
    convex = tts.track_collision_shapes(
        track, mu_rim=mu_rim, extra=tts.ground_shape(g, device="cpu"))
    return model, convex, state, gear, track


def assert_points_on_patch(got, ref, normal, what):
    """Contact points on the same plane normal to the contact: a shoe's
    flat face lying on a flat face (the ground, a wheel's rim edge) has no
    unique deepest point, and the support function picks a corner of the
    face by the sign of a direction component that is zero up to
    rounding, so the point may move within the patch (MPR's witness
    point, as in the JAX package)."""
    dn = np.sum((got - ref) * normal, axis=-1)
    np.testing.assert_allclose(dn, 0.0, atol=MPR_TOL["point"], err_msg=what)
    # the in-plane moves are within the shoe (|Δ| ≤ its diagonal)
    assert np.all(np.linalg.norm(got - ref, axis=-1) <= 2 * np.linalg.norm(
        [0.5 * 0.154, 0.5 * SHOE["shoe_w"], 0.5 * SHOE["shoe_h"]])), what


# kind → JAX steps taken (each state also stepped by the port)
RIG_STEPS = {"friction": 3, "gear": 4, "no_gear": 3, "double_pin": 3}
# perturbed JAX steps a state: the JAX step's own response to rounding
N_PERTURB = 2


@pytest.fixture(scope="module", params=sorted(RIG_STEPS))
def rig_run(request):
    """The JAX rig's float64 trajectory through one compiled step, and at
    each state the step's response to ``N_PERTURB`` perturbations of its
    input by ~1e-12 (the largest change of each output field)."""
    kind = request.param
    jmodel, jcoll, jstate, kw, h, jgear, jtrack, chassis = rig(kind)
    n = RIG_STEPS[kind]
    rng = np.random.default_rng(0)
    with jax.enable_x64(True):
        jm, jc, js = j64(jmodel), j64(jcoll), j64(jstate)
        xcf = (None if jgear is None
               else lambda s: jts.sprocket_gear_contacts(jgear, s))

        def one(s, t):
            s, con, info = jpipe.nsc_step(jm, jc, s, t, h, JSettings(**kw),
                                          extra_contacts_fn=xcf)
            return s, con, info.iterations

        one = jit(one)
        np_tree = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
        states, times, cons, iters, resp = [np_tree(js)], [0.0], [], [], []
        gear_rows = []
        for k in range(n):
            cur = jax.tree_util.tree_map(jnp.asarray, states[-1])
            s, con, it = np_tree(one(cur, jnp.asarray(times[-1])))
            r = {f: 0.0 for f in ("x", "q", "v", "w", "gap", "normal")}
            for _ in range(N_PERTURB):
                pert = jax.tree_util.tree_map(
                    lambda a: jnp.asarray(a + 1e-12 * rng.normal(
                        size=a.shape)), states[-1])
                sp, cp, _ = np_tree(one(pert, jnp.asarray(times[-1])))
                for f in "xqvw":
                    r[f] = max(r[f], float(np.abs(getattr(sp, f)
                                                  - getattr(s, f)).max()))
                both = cp.active & con.active
                for f in ("gap", "normal"):
                    r[f] = max(r[f], float(np.abs(
                        getattr(cp, f)[both] - getattr(con, f)[both]).max(
                            initial=0.0)))
            if jgear is not None and k < 2:
                gear_rows.append(np_tree(jts.sprocket_gear_contacts(
                    jgear, cur)))
            states.append(s)
            times.append(times[-1] + h)
            cons.append(con)
            iters.append(int(it))
            resp.append(r)
    return dict(kind=kind, kw=kw, h=h, n=n, jgear=jgear, jtrack=jtrack,
                jcoll=jcoll, states=states, times=times, cons=cons,
                iters=iters, resp=resp, gear_rows=gear_rows or None,
                chassis=chassis, port=port_rig(kind))


def test_rig_builders(rig_run):
    """The port's builders make the JAX package's rig: the model, the
    convex shapes, the track's layout and the gear."""
    from test_torch_mbs import assert_same_leaves

    tmodel, tconvex, tstate, tgear, ttrack = rig_run["port"]
    jmodel, jcoll, jstate, *_ = rig(rig_run["kind"])
    assert_same_leaves(tmodel, convert.mbs_model_from_numpy(
        leaves(jmodel), device="cpu"))
    ref = convert.convex_shapes_from_numpy(leaves(jcoll.convex),
                                           device="cpu")
    for f in dataclasses.fields(ref):
        a, b = getattr(tconvex, f.name), getattr(ref, f.name)
        assert torch.equal(a, b), f.name
    for f in "xqvw":
        np.testing.assert_array_equal(getattr(tstate, f).numpy(),
                                      np.asarray(getattr(jstate, f)))
    jt = rig_run["jtrack"]
    conv = (convert.double_pin_track_from_numpy
            if rig_run["kind"] == "double_pin"
            else convert.segmented_track_from_numpy)
    assert ttrack == conv(jt._asdict())
    if rig_run["jgear"] is not None:
        assert tgear == convert.sprocket_gear_from_numpy(
            rig_run["jgear"]._asdict())


def test_rig_steps(rig_run):
    """Each float64 JAX state stepped once by the port against the JAX
    package's next state, within twice the JAX step's own response to
    ~1e-12 perturbations of that state (+1e-9); the same iteration counts;
    the detected rows (MPR_TOL plus twice their own response) and the
    gear's rows (ROW_TOL) on the same state."""
    tmodel, _, _, tgear, _ = rig_run["port"]
    kind, h, n = rig_run["kind"], rig_run["h"], rig_run["n"]
    tcoll = t64(convert.collision_model_from_numpy(leaves(rig_run["jcoll"]),
                                                   device="cpu"))
    tm = t64(tmodel)
    settings = TSettings(**rig_run["kw"])
    xcf = (None if tgear is None
           else lambda s: tts.sprocket_gear_contacts(tgear, s))
    for k in range(n):
        src, ref, jcon = (rig_run["states"][k], rig_run["states"][k + 1],
                          rig_run["cons"][k])
        st = BodyState(*[torch.tensor(np.asarray(getattr(src, f)))
                         for f in "xqvw"])
        t = torch.tensor(rig_run["times"][k], dtype=torch.float64)
        out, con, info = tpipe.nsc_step(tm, tcoll, st, t, h, settings,
                                        extra_contacts_fn=xcf)
        assert int(info.iterations) == rig_run["iters"][k]
        for f in "xqvw":
            tol = 2.0 * rig_run["resp"][k][f] + 1e-9
            np.testing.assert_allclose(
                getattr(out, f).numpy(), getattr(ref, f), rtol=0, atol=tol,
                err_msg=f"{kind} step {k} {f} (JAX's own response "
                        f"{rig_run['resp'][k][f]:.2e})")
        # the rows that the step solved: the same active set and order
        jact = jcon.active
        np.testing.assert_array_equal(con.active.numpy(), jact)
        for f in ("body_a", "body_b"):
            np.testing.assert_array_equal(getattr(con, f).numpy()[jact],
                                          getattr(jcon, f)[jact])
        for f in ("gap", "normal"):
            np.testing.assert_allclose(
                getattr(con, f).numpy()[jact], getattr(jcon, f)[jact],
                rtol=0, atol=MPR_TOL[f] + 2.0 * rig_run["resp"][k][f],
                err_msg=f"{kind} step {k} {f}")
        assert_points_on_patch(con.point.numpy()[jact], jcon.point[jact],
                               jcon.normal[jact], f"{kind} step {k}")
        if rig_run["gear_rows"] is not None and k < 2:
            got = tts.sprocket_gear_contacts(tgear, st)
            ref_rows = rig_run["gear_rows"][k]
            np.testing.assert_array_equal(got.active.numpy(),
                                          ref_rows.active)
            for f in ("gap", "normal", "point"):
                np.testing.assert_allclose(getattr(got, f).numpy(),
                                           getattr(ref_rows, f), **ROW_TOL)
