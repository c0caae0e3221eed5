"""PyTorch port (chrono_tpu_torch) vs the JAX package: the DEM system on
the neighbour list.

The same scenes (chip_smoke.py's ``dem_box_setup``, ``dem_wall_setup``:
made from numpy seeds) go through the JAX ``DEMSystem`` /
``make_advance_fn`` and the port's.  Each case runs 3 cycles and is held
at the North-star tolerances: positions rtol 1e-4 / atol 1e-5 m,
velocities rtol 1e-3 / atol 1e-4 m/s, spins rtol 1e-3 / atol 2e-3 rad/s
(1e-4 m/s at the surface of an r = 5 cm sphere); the friction and rolling
histories and Chung's accelerations at rtol 1e-3 and 1e-3 of their
largest entry.  The neighbour
lists must be equal entry for entry.  The JAX reference of the advance
cases is its ``make_advance_fn``'s program (``rebuild_neighbors`` and a
scan of ``dem_substep`` in a scan of cycles) jitted at XLA's O0, one
compile of ~1.7 s on one core; ``DEMSystem.advance`` runs the JAX
package's own jitted advance.  The port runs eagerly on the CPU.

The JAX ``cone_contacts`` handles one particle at a time, so the JAX side
of a scene with a cone maps it over the particles (as
tests/test_torch_dem_walls.py does); the JAX package is not changed.
"""

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
import pytest
import torch

from chrono_tpu.dem import forces as jforces
from chrono_tpu.dem import system as jsys
from chrono_tpu.dem.neighbors import NeighborList as JNeighborList
from chrono_tpu.utils import samplers as jsamplers

from chrono_tpu_torch import convert
from chrono_tpu_torch.dem import system as tsys
from chrono_tpu_torch.dem.neighbors import NeighborList, migrate_history
from chrono_tpu_torch.utils import samplers as tsamplers

from chip_smoke import (
    DEM_CYCLES, DEM_FRICTION, DEM_INTEGRATORS, DEM_ROLLING, DEM_V_TOL,
    DEM_W_TOL, DEM_X_TOL, dem_box_setup, dem_system_of, dem_wall_run,
    dem_wall_setup,
)
from test_torch_dem_walls import _cone_contacts_per_particle, _jax_bcs

O0 = {"xla_backend_optimization_level": 0}
HIST_RTOL = 1e-3
HIST_ATOL_REL = 1e-3
RADIUS = 0.05


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread: at a few hundred particles a thread pool costs
    more than it gives, and the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def leaves(obj):
    """A JAX pytree dataclass → mapping of numpy arrays / Python scalars
    (None stays None)."""
    if dataclasses.is_dataclass(obj):
        return {f.name: leaves(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if obj is None or isinstance(obj, (str, int, float, bool, tuple)):
        return obj
    return np.asarray(obj)


def jax_system(setup):
    sys_ = jsys.DEMSystem(**setup["system"])
    sys_.set_material(**setup["material"])
    sys_.set_wall_material(**setup["wall_material"])
    pts, vel, omega = setup["arrays"]
    sys_.create_particles(pts, vel=vel)
    sys_.state = sys_.state.replace(omega=jnp.asarray(omega))
    return sys_


def assert_states_close(got, ref, what):
    """Positions, velocities, spins and the histories of a port
    ``DEMState`` against a JAX one; the lists equal."""
    for k, tol in (("pos", DEM_X_TOL), ("vel", DEM_V_TOL),
                   ("omega", DEM_W_TOL)):
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(ref, k)), **tol,
                                   err_msg=f"{what} {k}")
    np.testing.assert_array_equal(got.nbr.idx.numpy(),
                                  np.asarray(ref.nbr.idx))
    np.testing.assert_array_equal(got.nbr.valid.numpy(),
                                  np.asarray(ref.nbr.valid))
    for k in ("tan_disp", "bc_tan_disp", "roll_disp", "bc_roll_disp",
              "acc_old", "alpha_old"):
        a, b = getattr(got, k), getattr(ref, k)
        assert (a is None) == (b is None), k
        if a is None:
            continue
        b = np.asarray(b)
        scale = float(np.abs(b).max())
        if k == "alpha_old":
            # without friction the spins' acceleration is rounding noise:
            # held at the linear one's scale over the radius
            scale = max(scale, float(np.abs(np.asarray(ref.acc_old)).max())
                        / RADIUS)
        np.testing.assert_allclose(a.numpy(), b, rtol=HIST_RTOL,
                                   atol=HIST_ATOL_REL * max(scale, 1e-30),
                                   err_msg=f"{what} {k}")
    np.testing.assert_allclose(float(got.time), float(ref.time), rtol=1e-6)


def jax_advance(params, bcs, grid, state, n_cycles=DEM_CYCLES):
    """The JAX ``make_advance_fn``'s program, jitted at O0."""
    def cycle(st, _):
        st = jsys.rebuild_neighbors(params, grid, st)
        st, _ = lax.scan(lambda s, __: (jsys.dem_substep(params, bcs, s),
                                        None), st, None,
                         length=params.rebuild_every)
        return st, st.nbr.overflow

    def run(st):
        st, ovf = lax.scan(cycle, st, None, length=n_cycles)
        return st, ovf.max()

    return jax.jit(run, compiler_options=O0)(state)


@functools.cache
def _jax_box_run(integrator, friction_mode, rolling_mode="none",
                 force_model="mat_based"):
    setup = dem_box_setup(integrator=integrator, friction_mode=friction_mode,
                          rolling_mode=rolling_mode, force_model=force_model)
    js = jax_system(setup)
    state, ovf = jax_advance(js.params, js.bcs, js.grid, js.state)
    assert int(ovf) == 0
    return setup, js, state


@pytest.mark.parametrize("friction_mode", DEM_FRICTION)
@pytest.mark.parametrize("integrator", DEM_INTEGRATORS)
def test_advance_matches_jax(integrator, friction_mode):
    """3 cycles of 8 substeps of the 256-particle 1 m box (pairs and the
    floor in contact) through ``make_advance_fn``, from the port's
    ``DEMSystem`` and from the JAX one's state converted."""
    setup, js, ref = _jax_box_run(integrator, friction_mode)
    ts = dem_system_of(setup, "cpu")
    assert ts.dt == js.dt
    got, ovf = ts._advance(ts.state, DEM_CYCLES)
    assert int(ovf) == 0
    assert int(got.nbr.valid.sum()) > 100            # pairs in contact
    if friction_mode != "frictionless":
        assert float(got.bc_tan_disp.abs().max()) > 0    # the floor
    assert_states_close(got, ref, f"{integrator}/{friction_mode}")
    # the same from the JAX state and parameters carried across
    p = convert.params_from_numpy(leaves(js.params))
    bcs = convert.dem_boundaries_from_numpy({"planes": leaves(js.bcs.planes)})
    adv = tsys.make_advance_fn(p, bcs, convert.grid_from_numpy(
        leaves(js.grid)), device="cpu")
    got2, _ = adv(convert.dem_state_from_numpy(leaves(js.state),
                                               device="cpu"), DEM_CYCLES)
    assert tsys.DEMState is type(got2)
    assert all(torch.equal(getattr(got, k), getattr(got2, k))
               for k in ("pos", "vel", "omega", "tan_disp"))


@pytest.mark.parametrize("wheel", [False, True], ids=["four", "five"])
@pytest.mark.parametrize("rolling_mode", DEM_ROLLING)
def test_rolling_and_wall_history_match_jax(rolling_mode, wheel):
    """Multi-step friction with a conveyor floor, a cylinder, a sphere, a
    cone (and a spinning wheel): the (N, B, 3) wall history and both
    rolling modes, 3 cycles of 4 substeps."""
    setup = dem_wall_setup(rolling_mode, wheel=wheel)
    js = jsys.DEMSystem(**setup["system"])
    js.set_material(**setup["material"])
    js.set_wall_material(**setup["wall_material"])
    js._build()
    jb = _jax_bcs(setup["walls"])
    pts, vel, omega = setup["arrays"]
    jstate = jsys.make_dem_state(js.params, jb, pts, vel, omega)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jforces, "cone_contacts", _cone_contacts_per_particle)
        ref, ovf = jax_advance(js.params, jb, js.grid, jstate)
    assert int(ovf) == 0
    got, ovf = dem_wall_run(setup, "cpu")
    assert int(ovf) == 0
    n_walls = 5 if wheel else 4
    assert got.bc_tan_disp.shape[1] == n_walls
    touched = (got.bc_tan_disp.abs().sum(-1) > 0).sum(0)
    assert (touched > 0).all(), touched          # every wall has history
    assert float(got.omega.abs().max()) > 1.0
    if rolling_mode == "elastic_plastic":
        assert float(got.roll_disp.abs().max()) > 0
        assert float(got.bc_roll_disp.abs().max()) > 0
    assert_states_close(got, ref, f"{rolling_mode} walls")


def test_user_force_model_matches_jax():
    """The user-stiffness model (δ^½ damping, raw K and Γ) on the box."""
    setup, js, ref = _jax_box_run("centered_difference", "multi_step",
                                  force_model="user")
    ts = dem_system_of(setup, "cpu")
    assert ts.params.force_model == "user" and ts.dt == js.dt
    got, ovf = ts._advance(ts.state, DEM_CYCLES)
    assert int(ovf) == 0
    assert_states_close(got, ref, "user model")


def test_substep_reactions_match_jax():
    """``dem_substep(return_reactions=True)``: the per-wall force and
    torque about the origin of the five wall kinds (every one touched from
    the start), after a rebuild and one substep."""
    setup = dem_wall_setup("schwartz")
    js = jsys.DEMSystem(**setup["system"])
    js.set_material(**setup["material"])
    js.set_wall_material(**setup["wall_material"])
    js._build()
    jb = _jax_bcs(setup["walls"])
    pts, vel, omega = setup["arrays"]
    jst = jsys.make_dem_state(js.params, jb, pts, vel, omega)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jforces, "cone_contacts", _cone_contacts_per_particle)
        jnew, (jf, jt) = jax.jit(lambda st: jsys.dem_substep(
            js.params, jb, jsys.rebuild_neighbors(js.params, js.grid, st),
            return_reactions=True), compiler_options=O0)(jst)
    ts = dem_system_of(setup, "cpu")
    bcs = convert.dem_boundaries_from_numpy(setup["walls"])
    tst = tsys.rebuild_neighbors(ts.params, ts.grid, tsys.make_dem_state(
        ts.params, bcs, pts, vel, omega, device="cpu"))
    tnew, (tf, tt) = tsys.dem_substep(ts.params, bcs, tst,
                                      return_reactions=True)
    assert tf.shape == (5, 3) and bool((tf.abs().sum(1) > 0).all())
    scale = float(np.abs(np.asarray(jf)).max())
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-4,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-4,
                               atol=1e-5 * scale)
    assert_states_close(tnew, jnew, "one substep")


def test_history_migrates_across_rebuild():
    """tests/test_dem.py::TestNeighborMigration's lists: partners kept
    carry their history to their new slots, new partners start at zero;
    ``rebuild_neighbors`` carries the rolling displacement the same way."""
    old = NeighborList(
        idx=torch.tensor([[3, 7, -1, -1], [0, -1, -1, -1]], dtype=torch.int32),
        valid=torch.tensor([[True, True, False, False],
                            [True, False, False, False]]),
        overflow=torch.zeros((), dtype=torch.int32))
    hist = torch.zeros((2, 4, 3))
    hist[0, 0] = torch.tensor([1., 2., 3.])
    hist[0, 1] = torch.tensor([4., 5., 6.])
    hist[1, 0] = torch.tensor([7., 8., 9.])
    new = NeighborList(
        idx=torch.tensor([[7, 2, 3, -1], [1, 0, -1, -1]], dtype=torch.int32),
        valid=torch.tensor([[True, True, True, False],
                            [True, True, False, False]]),
        overflow=torch.zeros((), dtype=torch.int32))
    out = migrate_history(old, hist, new).numpy()
    ref = np.asarray(jsys.migrate_history(
        JNeighborList(idx=jnp.asarray(old.idx.numpy()),
                      valid=jnp.asarray(old.valid.numpy()),
                      overflow=jnp.zeros((), jnp.int32)),
        jnp.asarray(hist.numpy()),
        JNeighborList(idx=jnp.asarray(new.idx.numpy()),
                      valid=jnp.asarray(new.valid.numpy()),
                      overflow=jnp.zeros((), jnp.int32))))
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out[0, 0], [4, 5, 6])
    np.testing.assert_array_equal(out[0, 2], [1, 2, 3])
    np.testing.assert_array_equal(out[1, 1], [7, 8, 9])
    assert not out[0, 1].any() and not out[1, 0].any()
    # through rebuild_neighbors, after a cycle that wound both histories
    setup = dem_wall_setup("elastic_plastic", wheel=False)
    st, _ = dem_wall_run(setup, "cpu", n_cycles=1)
    sys_ = dem_system_of(setup, "cpu")
    moved = st.replace(pos=st.pos + 0.3 * sys_.params.radius)
    re = tsys.rebuild_neighbors(sys_.params, sys_.grid, moved)
    for h in ("tan_disp", "roll_disp"):
        np.testing.assert_array_equal(
            getattr(re, h).numpy(),
            migrate_history(st.nbr, getattr(st, h), re.nbr).numpy())
    assert float(re.roll_disp.abs().max()) > 0


def test_dem_system_advance_and_energy_match_jax():
    """``DEMSystem.advance`` (rounded to whole cycles), ``time`` in float32,
    ``positions``, ``velocities`` and ``kinetic_energy`` against JAX's."""
    setup = dem_box_setup()
    js, ts = jax_system(setup), dem_system_of(setup, "cpu")
    assert ts.dt == js.dt and ts.params.dt == float(np.float32(ts.dt))
    js.advance(0.02)
    ts.advance(0.02)
    assert float(ts.state.time) == float(js.state.time)
    np.testing.assert_allclose(ts.positions, js.positions, **DEM_X_TOL)
    np.testing.assert_allclose(ts.velocities, js.velocities, **DEM_V_TOL)
    np.testing.assert_allclose(ts.kinetic_energy(), js.kinetic_energy(),
                               rtol=1e-3)
    jp = convert.params_from_numpy(leaves(js.params))
    assert jp == ts.params


def test_retune_resizes_histories_like_jax():
    """``retune``: a new wall set zeroes the wall history at its new width;
    switching to elastic–plastic rolling adds zero rolling states; the
    friction history of the pairs survives; the advance still matches."""
    setup = dem_box_setup()
    js, ts = jax_system(setup), dem_system_of(setup, "cpu")
    js.advance(0.01)
    ts.advance(0.01)
    from chrono_tpu.dem.bc import PlaneBCs as JPlanes
    from chrono_tpu_torch.dem.bc import PlaneBCs
    plane = dict(point=np.array([[0.0, 0.0, 0.2]], np.float32),
                 normal=np.array([[0.0, 0.6, 0.8]], np.float32),
                 vel=np.zeros((1, 3), np.float32))
    js.set_boundaries(planes=JPlanes(**{k: jnp.asarray(v)
                                        for k, v in plane.items()}))
    ts.set_boundaries(planes=PlaneBCs(**{k: torch.from_numpy(v)
                                         for k, v in plane.items()}))
    before = ts.state.tan_disp.clone()
    for s in (js, ts):
        s.retune(material={"mu_r": 0.1}, rolling_mode="elastic_plastic")
    assert ts.state.bc_tan_disp.shape == js.state.bc_tan_disp.shape \
        == (len(setup["arrays"][0]), 7, 3)
    assert not ts.state.bc_tan_disp.any()
    assert ts.state.roll_disp.shape == js.state.roll_disp.shape
    assert ts.state.bc_roll_disp.shape == js.state.bc_roll_disp.shape
    assert torch.equal(ts.state.tan_disp, before)
    assert ts.params == convert.params_from_numpy(leaves(js.params))
    js.advance(0.01)
    ts.advance(0.01)
    np.testing.assert_allclose(ts.positions, js.positions, **DEM_X_TOL)
    np.testing.assert_allclose(ts.velocities, js.velocities, **DEM_V_TOL)
    for s in (js, ts):
        s.retune(rolling_mode="none")
    assert ts.state.bc_roll_disp is not None      # same width: kept, as JAX
    assert js.state.bc_roll_disp is not None


def test_overflow_raises_with_occupancy():
    """Too few neighbour slots: ``advance`` raises with the count dropped
    and the fullest cell, the JAX message word for word."""
    setup = dem_box_setup(max_neighbors=2)
    js, ts = jax_system(setup), dem_system_of(setup, "cpu")
    msgs = []
    for s in (js, ts):
        with pytest.raises(RuntimeError, match="neighbor-list overflow") as e:
            s.advance(0.01)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_make_dem_state_fields_and_device():
    """Chung's and the elastic–plastic fields exist only when used, with
    the JAX shapes; the default device is the card (refused here)."""
    for integ, roll in (("chung", "elastic_plastic"),
                        ("forward_euler", "none")):
        setup = dem_box_setup(integrator=integ, rolling_mode=roll, n=20)
        js, ts = jax_system(setup), dem_system_of(setup, "cpu")
        for f in dataclasses.fields(ts.state):
            a, b = getattr(ts.state, f.name), getattr(js.state, f.name)
            assert (a is None) == (b is None), f.name
            if f.name != "nbr" and a is not None:
                assert tuple(a.shape) == tuple(np.shape(b)), f.name
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA card"):
            tsys.DEMSystem(radius=0.05)


def test_samplers_bit_identical():
    """HCP and Poisson-disk points, the emitter's draws and ``emit_into``,
    and mixtures: the same numbers as JAX's samplers, bit for bit."""
    args = ((0.005, 0.01, 0.0), (0.3, 0.2, 0.25), 0.0101)
    np.testing.assert_array_equal(tsamplers.hcp_sample_box(*args),
                                  jsamplers.hcp_sample_box(*args))
    np.testing.assert_array_equal(
        tsamplers.poisson_disk_sample_box((0, 0, 0), (0.4, 0.3, 0.3), 0.07,
                                          seed=4),
        jsamplers.poisson_disk_sample_box((0, 0, 0), (0.4, 0.3, 0.3), 0.07,
                                          seed=4))
    kw = dict(box_lo=(0, 0, 1), box_hi=(1, 0.5, 1.2), rate=3000.0,
              vel_mean=(0, 0, -1), vel_sigma=0.2, seed=7)
    te, je = tsamplers.ParticleEmitter(**kw), jsamplers.ParticleEmitter(**kw)
    for dt in (1e-3, 2.5e-3, 4e-4):
        for a, b in zip(te.emit(dt), je.emit(dt)):
            np.testing.assert_array_equal(a, b)

    @dataclasses.dataclass
    class Padded:
        pos: object
        vel: object
        active: object

    n = 16
    active = np.zeros(n, bool)
    active[:5] = True
    tst = Padded(torch.zeros((n, 3), dtype=torch.float64),
                 torch.zeros((n, 3), dtype=torch.float64),
                 torch.from_numpy(active))
    # writable numpy arrays: the JAX emit_into writes into np.asarray of
    # the state's arrays, which is read-only for a JAX array
    jst = Padded(np.zeros((n, 3)), np.zeros((n, 3)), active.copy())
    tout, jout = te.emit_into(tst, 3e-3), je.emit_into(jst, 3e-3)
    assert tout[3] == jout[3] == 9
    for a, b in zip(tout[:3], jout[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    ings = [dict(ratio=2.0, radius=(0.01, 0.002), density=2500.0),
            dict(ratio=1.0, radius=0.02, mu=(0.4, 0.05))]
    pts = tsamplers.grid_sample_box((0, 0, 0), (0.3, 0.3, 0.3), 0.03)
    t = tsamplers.generate_mixture(
        pts, [tsamplers.MixtureIngredient(**i) for i in ings], seed=3)
    j = jsamplers.generate_mixture(
        pts, [jsamplers.MixtureIngredient(**i) for i in ings], seed=3)
    assert t.keys() == j.keys()
    for k in t:
        np.testing.assert_array_equal(t[k], j[k])


def test_params_convert_every_field():
    """``params_from_numpy`` takes rolling and the user model (it refused
    both) and every other field of the JAX ``DEMParams``."""
    setup = dem_box_setup(rolling_mode="elastic_plastic",
                          force_model="user", integrator="chung",
                          max_neighbors=12, max_per_cell=6, skin=0.3)
    js = jax_system(setup)
    p = convert.params_from_numpy(leaves(js.params))
    for name in ("max_neighbors", "max_per_cell", "rebuild_every", "skin",
                 "integrator", "friction_mode", "rolling_mode",
                 "force_model"):
        assert getattr(p, name) == getattr(js.params, name), name
    for m in ("material", "wall_material"):
        for f in dataclasses.fields(getattr(p, m)):
            assert getattr(getattr(p, m), f.name) == float(
                getattr(getattr(js.params, m), f.name)), (m, f.name)
    assert p == dem_system_of(setup, "cpu").params
