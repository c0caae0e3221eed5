"""PyTorch port (chrono_tpu_torch) vs the JAX package: granular (DEM)
terrain coupled to a wheel (``vehicle/granular_terrain.py``).

tests/test_granular_terrain.py's rig (a 3 kg wheel pre-sunk into a carved
0.5 × 0.14 × 0.06 m bed of r = 1 cm spheres, a drive torque after 0.06 s
and a lateral damper; chip_smoke.py's ``granular_rig`` on the port) is
built by both packages: the beds, walls and grids must be equal.  With
the wheel started 5 mm lower, into the crater's wall (``drop``, so that
it is pushed back up from the first substep), after 4 outer steps of 20
substeps (``granular_step`` with its wheel reactions moved to the centre,
then the implicit multibody step) the bed and the wheel agree at the
North-star tolerances (positions rtol 1e-4 / atol 1e-5 m, velocities
rtol 1e-3 / atol 1e-4 m/s, spins atol 2e-3 rad/s).  The JAX outer steps
are its ``make_granular_advance_fn``'s program (a scan of
``granular_step``) jitted at XLA's O0.
"""

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
import pytest
import torch

from chrono_tpu.dem.params import DEMMaterial, DEMParams
from chrono_tpu.physics import SystemBuilder
from chrono_tpu.vehicle import granular_terrain as jgt

from chrono_tpu_torch import convert
from chrono_tpu_torch.vehicle import granular_terrain as tgt

from chip_smoke import (
    DEM_V_TOL, DEM_W_TOL, DEM_X_TOL, GRANULAR_DROP as DROP,
    granular_params, granular_rig,
)
from test_torch_dem_system import (  # noqa: F401 (a fixture)
    assert_states_close, leaves, one_thread,
)

O0 = {"xla_backend_optimization_level": 0}
N_OUTER = 4


def jax_rig(drop=0.0):
    """tests/test_granular_terrain.py::test_wheel_settles_and_drives's
    scene, as that test builds it, the wheel started ``drop`` lower."""
    r = 0.01
    mass = 2500.0 * 4 / 3 * np.pi * r ** 3
    mat = DEMMaterial(youngs=2e6, poisson=0.3, restitution=0.4, mu_s=0.6,
                      mu_r=0.1)
    params = DEMParams(
        radius=jnp.asarray(r), mass=jnp.asarray(mass), material=mat,
        wall_material=mat, gravity=jnp.asarray([0.0, 0.0, -9.81]),
        dt=jnp.asarray(2e-5), max_neighbors=16, max_per_cell=8,
        rebuild_every=20, friction_mode="single_step",
        rolling_mode="schwartz", integrator="centered_difference")
    R_w, W_w, bed, depth, x0 = 0.08, 0.05, (0.5, 0.14), 0.06, 0.14
    z0 = depth + R_w - 0.005

    def carve(pts):
        dxz = pts[:, [0, 2]] - np.array([x0, z0])
        in_r = np.linalg.norm(dxz, axis=1) < (R_w + r)
        in_y = np.abs(pts[:, 1] - bed[1] / 2) < (W_w / 2 + r)
        return ~(in_r & in_y)

    terrain, grid, bcs = jgt.make_granular_terrain_state(
        params, bed, depth, R_w, W_w, n_wheels=1, carve_fn=carve)
    bld = SystemBuilder()
    bld.set_gravity((0, 0, -9.81))
    wheel = bld.add_body(mass=3.0, inertia=(0.01, 0.015, 0.01),
                         pos=(x0, bed[1] / 2, z0 - drop))
    model, bodies = bld.finalize()

    def drive(t, b):
        f = jnp.zeros((model.n_bodies, 3))
        tau = jnp.zeros((model.n_bodies, 3))
        tau = tau.at[wheel, 1].add(jnp.where(t > 0.06, 0.35, 0.0))
        f = f.at[wheel, 1].add(-20.0 * b.v[wheel, 1])
        return f, tau

    state = jgt.GranularFSIState(bodies=bodies, terrain=terrain,
                                 time=jnp.zeros(()))
    return dict(params=params, grid=grid, bcs=bcs, model=model,
                state=state, wheel=wheel, drive=drive)


def jax_outer(rig, state, n_outer):
    """The JAX ``make_granular_advance_fn``'s program at O0: ``(state,
    overflow)``."""
    p = rig["params"]

    def outer(carry, _):
        st, ovf = carry
        st, o, _ = jgt.granular_step(rig["model"], p, rig["bcs"],
                                     rig["grid"], st, p.rebuild_every,
                                     [rig["wheel"]], f_ext_fn=rig["drive"])
        return (st, jnp.maximum(ovf, o)), None

    run = jax.jit(lambda st: lax.scan(
        outer, (st, jnp.zeros((), jnp.int32)), None, length=n_outer)[0],
        compiler_options=O0)
    return run(state)


@pytest.fixture(scope="module")
def rigs():
    jr = jax_rig(DROP)
    ref, ovf = jax_outer(jr, jr["state"], N_OUTER)
    assert int(ovf) == 0
    return jr, (ref, ovf)


def test_bed_and_walls_match_jax(rigs):
    """The carved HCP bed, the open box (top plane dropped), the parked
    wheel slot and the grid: equal; the parameters as the JAX arrays hold
    them."""
    jr, _ = rigs
    tr = granular_rig("cpu", drop=DROP)
    assert tr["params"] == convert.params_from_numpy(leaves(jr["params"]))
    assert tr["grid"] == convert.grid_from_numpy(leaves(jr["grid"]))
    st = convert.granular_state_from_numpy(leaves(jr["state"]),
                                           device="cpu")
    n = st.terrain.n
    assert n > 400
    for k in ("pos", "vel", "omega", "tan_disp", "bc_tan_disp"):
        assert torch.equal(getattr(tr["state"].terrain, k),
                           getattr(st.terrain, k)), k
    for k in "xqvw":
        assert torch.equal(getattr(tr["state"].bodies, k),
                           getattr(st.bodies, k)), k
    walls = convert.dem_boundaries_from_numpy(
        {k: leaves(getattr(jr["bcs"], k)) for k in ("planes", "wheels")})
    for kind in ("planes", "wheels"):
        a, b = getattr(tr["bcs"], kind), getattr(walls, kind)
        for f in a.__dataclass_fields__:
            assert torch.equal(getattr(a, f), getattr(b, f)), (kind, f)
    assert tr["bcs"].planes.normal.shape[0] == 5
    assert float(tr["bcs"].planes.normal[:, 2].min()) >= 0   # no lid


def test_granular_step_matches_jax(rigs):
    """``N_OUTER`` outer steps: the bed, its histories and the list, and
    the wheel's pose and velocities."""
    jr, (ref, _) = rigs
    tr = granular_rig("cpu", drop=DROP)
    got, ovf = tr["adv"](tr["state"], N_OUTER)
    assert int(ovf) == 0
    assert float(got.time) == float(ref.time)
    assert_states_close(got.terrain, ref.terrain, "granular bed")
    for k, tol in (("x", DEM_X_TOL), ("v", DEM_V_TOL), ("w", DEM_W_TOL)):
        np.testing.assert_allclose(getattr(got.bodies, k).numpy(),
                                   np.asarray(getattr(ref.bodies, k)), **tol,
                                   err_msg=f"wheel {k}")
    np.testing.assert_allclose(got.bodies.q.numpy(),
                               np.asarray(ref.bodies.q), rtol=1e-4,
                               atol=1e-6)
    w = tr["wheel"]
    # the bed pushed the wheel up, through the last wall slot
    assert float(got.bodies.v[w, 2]) > 0.005
    assert int((got.terrain.bc_tan_disp[:, -1].abs().sum(-1) > 0).sum()) > 3


def test_step_by_step_equals_advance():
    """``granular_step`` called eagerly (no ``MBSStep``) gives the advance's
    state bit for bit on the CPU; the advance refuses a body with two
    wheel slots."""
    tr = granular_rig("cpu", drop=DROP)
    p = tr["params"]
    st = tr["state"]
    for _ in range(2):
        st, ovf, info = tgt.granular_step(
            tr["model"], p, tr["bcs"], tr["grid"], st, p.rebuild_every,
            [tr["wheel"]], f_ext_fn=tr["drive"])
        assert int(ovf) == 0 and info is not None
    adv, _ = tr["adv"](tr["state"], 2)
    for k in ("pos", "vel", "omega"):
        assert torch.equal(getattr(st.terrain, k), getattr(adv.terrain, k))
    for k in "xqvw":
        assert torch.equal(getattr(st.bodies, k), getattr(adv.bodies, k))
    with pytest.raises(ValueError, match="body of its own"):
        tgt.make_granular_advance_fn(tr["model"], p, tr["bcs"], tr["grid"],
                                     20, [0, 0], device="cpu")
    assert granular_params().rolling_mode == "schwartz"
