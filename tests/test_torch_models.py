"""PyTorch port (chrono_tpu_torch) vs the JAX package: the model decks, the
rovers on SCM soil and the drawbar-pull rig.

Every wheeled deck (``create_hmmwv``, ``create_sedan`` and
``create_polaris`` in both suspensions, each ``create_<name>`` of
``models.decks``), ``build_wheeled_vehicle`` in both suspensions, both
rovers and the tracked ``build_marder`` are built by both packages; the
port's vehicle must equal the JAX one carried across by ``convert``:
integer leaves and the static body indices to the bit, float leaves within
1e-7 relative.  Then Curiosity on
SCM (the scene of tests/test_models_modal.py:110-140, its shaft
differential included) for 50 steps, a short drawbar-pull rig (the rig of
tests/test_dbp.py, 50 settling and 50 pulling steps at two slips) and one
step of the Polaris wishbone build steered through its rack, each held to
the JAX package.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from chrono_tpu import models as jm
from chrono_tpu.core import functions as JF
from chrono_tpu.vehicle import dbp as jdbp
from chrono_tpu.vehicle import driver as jd
from chrono_tpu.vehicle import terrain as jt
from chrono_tpu.vehicle import wheeled as jw

from chrono_tpu_torch import convert
from chrono_tpu_torch import models as tm
from chrono_tpu_torch.physics.joints import joint_violation
from chrono_tpu_torch.vehicle import dbp as tdbp
from chrono_tpu_torch.vehicle.driver import DriverInputs
from chrono_tpu_torch.vehicle import terrain as tt
from chrono_tpu_torch.vehicle import wheeled as tw

O0 = {"xla_backend_optimization_level": 0}
ROVER_H = 2e-3
ROVER_STEPS = 50
# 50 steps of the stiff SCM contact (elastic_K 4e7 Pa/m): positions to
# float32 rounding, speeds where one node entering or leaving contact moves
# a wheel's load (the port against JAX after 50 steps: x 1.2e-7 m, v
# 1.1e-4 m/s, ω 2.2e-4 rad/s)
ROVER_X_TOL = dict(rtol=1e-5, atol=1e-6)
ROVER_V_ATOL = 1e-3
# the rig's pull and torque: sums over the footprint's nodes in another
# order, 100 steps
DBP_TOL = dict(rtol=1e-3, atol=1e-2)


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
        out = {f.name: leaves(getattr(obj, f.name))
               for f in dataclasses.fields(obj)}
        if isinstance(obj, JF.MotionFunction):
            out["class"] = type(obj).__name__
        return out
    return np.asarray(obj)


def assert_same_leaves(got, ref, path="vehicle"):
    """Leaf by leaf: integers and static fields to the bit, floats within
    1e-7 of the larger of 1 and the leaf's magnitude."""
    if dataclasses.is_dataclass(ref):
        assert type(got) is type(ref), path
        for f in dataclasses.fields(ref):
            assert_same_leaves(getattr(got, f.name), getattr(ref, f.name),
                               f"{path}.{f.name}")
    elif isinstance(ref, dict):
        assert list(got) == list(ref), path
        for k in ref:
            assert_same_leaves(got[k], ref[k], f"{path}[{k}]")
    elif isinstance(ref, (tuple, list)):
        assert len(got) == len(ref), path
        for i, (g, r) in enumerate(zip(got, ref)):
            assert_same_leaves(g, r, f"{path}[{i}]")
    elif isinstance(ref, torch.Tensor):
        assert got.dtype == ref.dtype and got.shape == ref.shape, path
        if ref.dtype.is_floating_point:
            scale = max(1.0, float(ref.abs().max())) if ref.numel() else 1.0
            np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                                       atol=1e-7 * scale, err_msg=path)
        else:
            np.testing.assert_array_equal(got.numpy(), ref.numpy(),
                                          err_msg=path)
    else:
        assert got == ref, path


DECK_NAMES = sorted(jm.DECKS)
BUILDS = {
    "hmmwv": (jm.create_hmmwv, tm.create_hmmwv, {}),
    "hmmwv_rwd": (jm.create_hmmwv, tm.create_hmmwv, dict(driven="RWD")),
    "sedan": (jm.create_sedan, tm.create_sedan, {}),
    "sedan_wishbone": (jm.create_sedan, tm.create_sedan,
                       dict(suspension="wishbone")),
    "polaris": (jm.create_polaris, tm.create_polaris, {}),
    "polaris_wishbone": (jm.create_polaris, tm.create_polaris,
                         dict(suspension="wishbone")),
    "generic_reduced": (jw.build_wheeled_vehicle, tw.build_wheeled_vehicle,
                        dict(driven="FWD")),
    "generic_wishbone": (jw.build_wheeled_vehicle, tw.build_wheeled_vehicle,
                         dict(suspension="wishbone", driven="RWD")),
    **{f"deck_{name}": (getattr(jm, f"create_{name}"),
                        getattr(tm, f"create_{name}"), {})
       for name in DECK_NAMES},
}


@pytest.mark.parametrize("name", list(BUILDS))
def test_vehicle_equals_converted_jax_vehicle(name):
    jfn, tfn, kw = BUILDS[name]
    jv, js = jfn(**kw)
    tv, ts = tfn(**kw, device="cpu")
    conv = convert.wheeled_vehicle_from_numpy(leaves(jv), device="cpu")
    assert_same_leaves(tv, conv)
    assert_same_leaves(ts, convert.body_state_from_numpy(
        {f: np.asarray(getattr(js, f)) for f in "xqvw"}, device="cpu"),
        "state")


def test_every_deck_is_built():
    """The port builds every deck the JAX package has, by name and through
    its ``create_<name>``."""
    assert sorted(tm.DECKS) == DECK_NAMES
    assert {f"deck_{n}" for n in DECK_NAMES} <= set(BUILDS)
    for name in DECK_NAMES:
        assert hasattr(tm, f"create_{name}")


@pytest.mark.parametrize("name,build", [
    ("rover", "create_rover"), ("curiosity", "create_curiosity")])
def test_rover_equals_converted_jax_rover(name, build):
    jr, js = getattr(jm, build)()
    tr, ts = getattr(tm, build)(device="cpu")
    jr = jm.set_wheel_speeds(jr, [1.5 + 0.25 * i for i in range(
        len(jr.wheels))])
    tr = tm.set_wheel_speeds(tr, [1.5 + 0.25 * i for i in range(
        len(tr.wheels))])
    assert_same_leaves(tr, convert.rover_from_numpy(leaves(jr),
                                                    device="cpu"))
    if name == "curiosity":
        # the differential: three shaft-body rows, one planetary row
        assert list(tr.model.shaft_constraints) == ["shaft_body",
                                                    "planetary"]
        assert float(tr.model.props.inv_mass[-3:].abs().max()) == 0.0


def test_wishbone_step_steers_through_the_rack():
    """One ``vehicle_step`` of the Polaris wishbone build, moving, while
    steering and under throttle: the steering goes through ``_set_rack``
    (the rack's position motor), and the step equals the JAX one (float32
    on both sides: rtol 1e-5, atol 1e-5 of the largest magnitude)."""
    jv, js = jm.create_polaris(suspension="wishbone")
    tv, _ = tm.create_polaris(suspension="wishbone", device="cpu")
    rng = np.random.default_rng(11)
    st = {f: np.array(getattr(js, f)) for f in "xqvw"}
    st["v"] += (rng.normal(0, 0.2, st["v"].shape) + [4.0, 0, 0]).astype(
        np.float32)
    st["w"][list(jv.wheels), 1] += 12.0
    inputs = np.float32([0.5, 0.3, 0.0])
    ref = jax.jit(lambda s, i: jw.vehicle_step(jv, s, i, jt.flat_terrain(0.0),
                                               0.0, 1e-3),
                  compiler_options=O0)(
        js.replace(**{f: jnp.asarray(a) for f, a in st.items()}),
        jd.DriverInputs(*map(jnp.asarray, inputs)))
    got = tw.vehicle_step(tv, convert.body_state_from_numpy(st, device="cpu"),
                          DriverInputs(*map(torch.as_tensor, inputs)),
                          tt.flat_terrain(0.0), torch.tensor(0.0), 1e-3)
    assert "lin_pos" in tv.model.motors and float(tv.steer_rack_gain) > 0
    for f in "xqvw":
        r = np.asarray(getattr(ref.state, f))
        np.testing.assert_allclose(getattr(got.state, f).numpy(), r,
                                   rtol=1e-5, atol=1e-5 * np.abs(r).max(),
                                   err_msg=f)


def test_tracked_deck_is_refused():
    """The tracked deck, once refused, builds: ``build_marder`` equals the
    JAX builder's vehicle carried across by ``convert`` (integers and
    static indices to the bit, floats within 1e-7 relative) and its state
    the JAX one.  tests/test_torch_tracked.py drives it."""
    jv, js = jm.build_marder()
    tv, ts = tm.build_marder(device="cpu")
    assert_same_leaves(tv, convert.tracked_vehicle_from_numpy(
        leaves(jv), device="cpu"))
    assert_same_leaves(ts, convert.body_state_from_numpy(
        {f: np.asarray(getattr(js, f)) for f in "xqvw"}, device="cpu"))


def test_decks_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default builds there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tm.create_hmmwv()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tt.make_scm_state((0, 0), (1, 1), 0.1)


# ------------------------------------------------------- Curiosity on SCM

def curiosity_scene(package):
    """tests/test_models_modal.py:110-140: wheel speeds of 3 rad/s, an
    8.5 × 5 m patch at 0.06 m (143 × 84 nodes)."""
    if package == "jax":
        rover, state = jm.create_curiosity()
        rover = jm.set_wheel_speeds(rover, [3.0] * 6)
        params = jt.SCMParams(Kphi=jnp.asarray(2e6), n_exp=jnp.asarray(1.0),
                              friction_angle=jnp.asarray(0.8),
                              janosi_k=jnp.asarray(0.01))
        return rover, state, params, jt.make_scm_state((-2.5, -2.5),
                                                       (6, 2.5), 0.06)
    rover, state = tm.create_curiosity(device="cpu")
    rover = tm.set_wheel_speeds(rover, [3.0] * 6)
    params = tt.SCMParams(Kphi=torch.tensor(2e6), n_exp=torch.tensor(1.0),
                          friction_angle=torch.tensor(0.8),
                          janosi_k=torch.tensor(0.01))
    return rover, state, params, tt.make_scm_state((-2.5, -2.5), (6, 2.5),
                                                   0.06, device="cpu")


@pytest.fixture(scope="module")
def curiosity_runs():
    rover, state, params, scm = curiosity_scene("jax")

    @functools.partial(jax.jit, compiler_options=O0)
    def run(state, scm):
        def body(carry, k):
            st, sc = carry
            st, sc, _ = jm.rover_step_scm(rover, st, params, sc,
                                          k * ROVER_H, ROVER_H)
            return (st, sc), None
        return jax.lax.scan(body, (state, scm),
                            jnp.arange(ROVER_STEPS, dtype=jnp.float32))[0]

    jst, jscm = run(state, scm)
    rover, state, params, scm = curiosity_scene("port")
    t = torch.zeros(())
    for _ in range(ROVER_STEPS):
        state, scm, _ = tm.rover_step_scm(rover, state, params, scm, t,
                                          ROVER_H)
        t = t + ROVER_H
    return jst, jscm, rover, state, scm


def test_curiosity_on_scm_follows_jax(curiosity_runs):
    jst, jscm, _, state, scm = curiosity_runs
    for f in "xq":
        np.testing.assert_allclose(getattr(state, f).numpy(),
                                   np.asarray(getattr(jst, f)),
                                   **ROVER_X_TOL, err_msg=f)
    for f in "vw":
        np.testing.assert_allclose(getattr(state, f).numpy(),
                                   np.asarray(getattr(jst, f)), rtol=0,
                                   atol=ROVER_V_ATOL, err_msg=f)
    np.testing.assert_allclose(scm.sinkage.numpy(), np.asarray(jscm.sinkage),
                               rtol=1e-5, atol=1e-6)


def test_curiosity_differential_and_joints(curiosity_runs):
    """The planetary row holds 2 ω_c = ω_L + ω_R on the three shafts, the
    shafts keep still in translation, the joints stay closed, the wheels
    load the soil."""
    *_, rover, state, scm = curiosity_runs
    w = state.w[-3:, 2]
    assert abs(float(2 * w[0] - w[1] - w[2])) < 1e-4
    assert float(state.v[-3:].abs().max()) == 0.0
    viol = max(float(joint_violation(k, d, state.x, state.q).abs().max())
               for k, d in rover.model.joints.items())
    assert viol < 1e-3
    assert float(scm.sinkage.max()) > 0.0


# ------------------------------------------------------- drawbar-pull rig

DBP_PARAMS = dict(Kphi=6e5, Kc=0.0, n_exp=1.0)
DBP_RIG = dict(wheel_radius=0.3, wheel_width=0.2, mass=60.0, load=1200.0,
               v=0.5, h=1e-3, n_steps=50, settle_steps=50,
               start_xy=(0.6, 0.75))


@pytest.mark.parametrize("slip", [0.05, 0.4])
def test_dbp_rig_follows_jax(slip):
    """tests/test_dbp.py's rig on its 3.0 × 1.5 m patch at 0.025 m, cut to
    50 settling and 50 pulling steps."""
    jp = jt.SCMParams(**{k: jnp.asarray(v) for k, v in DBP_PARAMS.items()})
    ref = jdbp.run_dbp_rig(jp, jt.make_scm_state((0, 0), (3.0, 1.5), 0.025),
                           slip=slip, **DBP_RIG)
    got = tdbp.run_dbp_rig(
        convert.scm_params_from_numpy(leaves(jp), device="cpu"),
        tt.make_scm_state((0, 0), (3.0, 1.5), 0.025, device="cpu"),
        slip=slip, **DBP_RIG)
    assert got.pull.shape == (50,) and np.isfinite(got.pull.numpy()).all()
    np.testing.assert_allclose(got.pull.numpy(), np.asarray(ref.pull),
                               **DBP_TOL)
    np.testing.assert_allclose(got.torque.numpy(), np.asarray(ref.torque),
                               **DBP_TOL)
    np.testing.assert_allclose(got.sinkage.numpy(), np.asarray(ref.sinkage),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got.scm.sinkage.numpy(),
                               np.asarray(ref.scm.sinkage), rtol=1e-4,
                               atol=1e-6)
    assert float(got.sinkage[-1]) > 0.0
