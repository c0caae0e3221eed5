"""PyTorch port (chrono_tpu_torch) vs the JAX package: the gather
backend's WCSPH passes and its substep.

Each function of ``fsi/sph/wcsph.py`` (``adami_bc`` with both boundary
models and with and without a wall acceleration, ``continuity_rhs``,
``wcsph_rhs`` with both viscosity models, ``xsph_velocity``,
``ppst_shift``, ``summation_density``) on a mini dam with a rigid box of
BCE markers in it (tests/test_sph_pencil.py's dam, seeded velocities and
densities), ``sph_substep`` for each integrator × shifting and
``make_sph_advance_fn`` with and without ``adaptive_dt`` on
tests/test_sph.py's periodic water column, cut to 8 × 8 × 10 markers.
The same numpy arrays go through both packages; the JAX functions run
eagerly (one call each costs less than a compile), its advance jitted.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from chrono_tpu.fsi import bce as j_bce
from chrono_tpu.fsi.sph import system as j_sys
from chrono_tpu.fsi.sph import wcsph as j_w

from chrono_tpu_torch import convert
from chrono_tpu_torch.fsi.sph import system as t_sys
from chrono_tpu_torch.fsi.sph import wcsph as t_w

from test_sph import hydrostatic_setup
from test_sph_pencil import _mini_dam

# the tolerances tests/test_sph_pencil.py holds the JAX backends to
RHO_TOL = dict(rtol=2e-5, atol=1e-3)
POS_TOL = dict(rtol=1e-6, atol=1e-7)
V_RTOL, V_ATOL = 1e-4, 2e-5
# markers after several substeps: the North-star tolerances
X_TOL = dict(rtol=1e-4, atol=1e-5)
V_TOL = dict(rtol=1e-3, atol=1e-4)


def _leaves(obj, skip=()):
    return {f.name: np.asarray(getattr(obj, f.name))
            if not isinstance(getattr(obj, f.name), (str, int))
            else getattr(obj, f.name)
            for f in dataclasses.fields(obj) if f.name not in skip}


def port_grid(grid):
    return convert.grid_from_numpy({"origin": grid.origin,
                                    "cell_size": grid.cell_size,
                                    "dims": grid.dims,
                                    "periodic": grid.periodic})


def port_state(state):
    """A JAX SPHState (with its list) as the port's, on the CPU."""
    leaves = _leaves(state, ("nbr",))
    leaves["nbr"] = _leaves(state.nbr)
    return convert.sph_state_from_numpy(leaves, device="cpu")


def assert_same_list(got, ref):
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(ref.idx))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    assert int(got.overflow) == int(ref.overflow) == 0


def close(got, ref, rtol=1e-4, atol_rel=2e-5, what=""):
    """``got`` within rtol and atol_rel · max|ref| of ``ref``."""
    ref = np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1e-12)
    np.testing.assert_allclose(got.numpy(), ref, rtol=rtol,
                               atol=atol_rel * scale, err_msg=what)
    return scale


@functools.cache
def dam_with_a_body():
    """The mini dam of tests/test_sph_pencil.py with a 0.06 m box of two
    BCE layers (two bodies, one a half) in the water, seeded velocities
    (0.3 m/s) and densities (±1 %), and both lists built: ``(jp, jg,
    js, tp, tg, ts, body_acc)``."""
    jp, jg, js0 = _mini_dam("laminar")
    d0 = float(jp.d0)
    shell = j_bce.box_body_markers((0.03, 0.03, 0.03), d0, layers=2)
    centre = np.array([0.09, 0.06, 0.05])
    bodies = (shell[:, 0] > 0).astype(int)
    fluid = np.asarray(js0.pos)[np.asarray(js0.kind) == 0]
    fluid = fluid[np.any(np.abs(fluid - centre) > 0.03 + 0.5 * d0, axis=1)]
    walls = np.asarray(js0.pos)[np.asarray(js0.kind) == 1]
    js = j_sys.make_sph_state(jp, fluid, boundary_pts=walls,
                              rigid_pts=shell + centre,
                              rigid_body_ids=bodies, rigid_local=shell)
    rng = np.random.default_rng(11)
    n = js.n
    vel = rng.normal(0.0, 0.3, (n, 3)).astype(np.float32)
    rho = (1000.0 * (1.0 + rng.uniform(-0.01, 0.01, n))).astype(np.float32)
    js = js.replace(vel=jnp.asarray(vel), rho=jnp.asarray(rho))
    js = jit_rebuild(jp, jg, js)
    tp = convert.sph_params_from_numpy(_leaves(jp))
    tg = port_grid(jg)
    ts = t_sys.rebuild_sph_neighbors(tp, tg, port_state(js).replace(nbr=None))
    assert_same_list(ts.nbr, js.nbr)
    acc = rng.normal(0.0, 2.0, (n, 3)).astype(np.float32)
    return jp, jg, js, tp, tg, ts, acc


def jit_rebuild(jp, jg, js):
    """The JAX list, jitted (eagerly its first build costs ~7 s of
    per-op compiles on one core, jitted under 1 s)."""
    return jax.jit(lambda s: j_sys.rebuild_sph_neighbors(jp, jg, s))(js)


def _args(js, ts):
    j = (js.pos, js.vel, js.rho, js.kind, js.nbr.idx, js.nbr.valid)
    t = (ts.pos, ts.vel, ts.rho, ts.kind, ts.nbr.idx, ts.nbr.valid)
    return j, t


def test_scene_has_every_kind_of_pair():
    jp, jg, js, tp, tg, ts, _ = dam_with_a_body()
    kind = ts.kind
    assert {0, 1, 2} == set(kind.unique().tolist())
    j = ts.nbr.idx.long().clamp(min=0)
    for a, b in ((0, 1), (0, 2), (2, 0), (1, 0)):
        pairs = ts.nbr.valid & (kind[:, None] == a) & (kind[j] == b)
        assert int(pairs.sum()) > 100, (a, b)
    assert tp.max_neighbors == 96 and tp.max_per_cell == 64


@pytest.mark.parametrize("boundary_model", ["adami", "holmes"])
@pytest.mark.parametrize("with_acc", [False, True])
def test_adami_bc_matches_jax(boundary_model, with_acc):
    jp, jg, js, tp, tg, ts, acc = dam_with_a_body()
    jp = jp.replace(boundary_model=boundary_model)
    tp = tp.replace(boundary_model=boundary_model)
    ja, ta = _args(js, ts)
    ref = j_w.adami_bc(jp, jg, *ja, jnp.asarray(acc) if with_acc else None)
    got = t_w.adami_bc(tp, tg, *ta, torch.from_numpy(acc) if with_acc
                       else None)
    solid = (ts.kind != 0).numpy()
    p_scale = close(got[0], ref[0], rtol=1e-4, atol_rel=1e-5, what="p")
    assert float(np.abs(np.asarray(ref[0])[solid]).max()) > 0.1 * p_scale
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]),
                               **RHO_TOL)
    close(got[2], ref[2], V_RTOL, V_ATOL, "v_bc")


@pytest.mark.parametrize("viscosity", ["laminar", "artificial"])
@pytest.mark.parametrize("with_acc", [False, True])
def test_wcsph_rhs_matches_jax(viscosity, with_acc):
    jp, jg, js, tp, tg, ts, acc = dam_with_a_body()
    jp = jp.replace(viscosity_model=viscosity)
    tp = tp.replace(viscosity_model=viscosity)
    ja, ta = _args(js, ts)
    ref = j_w.wcsph_rhs(jp, jg, *ja, jnp.asarray(acc) if with_acc else None)
    got = t_w.wcsph_rhs(tp, tg, *ta, torch.from_numpy(acc) if with_acc
                        else None)
    close(got[0], ref[0], 1e-4, 1e-5, "drho")
    close(got[1], ref[1], 1e-4, 1e-5, "dv")
    # the solid markers carry the reaction, not gravity
    rigid = (ts.kind == 2).numpy()
    assert float(np.abs(np.asarray(ref[1])[rigid]).max()) > 1.0


def test_continuity_xsph_ppst_and_summation_match_jax():
    jp, jg, js, tp, tg, ts, _ = dam_with_a_body()
    ja, ta = _args(js, ts)
    close(t_w.continuity_rhs(tp, tg, *ta), j_w.continuity_rhs(jp, jg, *ja),
          1e-4, 1e-5, "continuity")
    close(t_w.xsph_velocity(tp, tg, *ta), j_w.xsph_velocity(jp, jg, *ja),
          V_RTOL, V_ATOL, "xsph")
    ref = j_w.ppst_shift(jp, jg, *ja)
    assert float(jnp.abs(ref).max()) > 0.0
    close(t_w.ppst_shift(tp, tg, *ta), ref, 1e-4, 1e-5, "ppst")
    j_sum = (js.pos, js.kind, js.nbr.idx, js.nbr.valid)
    t_sum = (ts.pos, ts.kind, ts.nbr.idx, ts.nbr.valid)
    np.testing.assert_allclose(
        t_w.summation_density(tp, tg, *t_sum).numpy(),
        np.asarray(j_w.summation_density(jp, jg, *j_sum)), **RHO_TOL)
    assert t_w.particle_mass(tp) == pytest.approx(
        float(j_w.particle_mass(jp)), rel=1e-6)


def small_column():
    """tests/test_sph.py's periodic column at 8 × 8 × 10 markers, its
    cells holding 48 slots (the test's 80 cost two thirds more candidates
    a marker on one core; no cell holds more than 24)."""
    jp, jg, js, _ = hydrostatic_setup(nx=8, nz=10)
    return jp.replace(max_per_cell=48), jg, js


@functools.cache
def periodic_column():
    """tests/test_sph.py's periodic water column at 8 × 8 × 10 markers,
    velocities seeded at 0.05 m/s so the shifting and viscous terms
    act, the lists built by both packages."""
    jp, jg, js = small_column()
    assert jg.periodic == (True, True, False) and min(jg.dims[:2]) >= 3
    rng = np.random.default_rng(12)
    vel = np.where(np.asarray(js.kind)[:, None] == 0,
                   rng.normal(0.0, 0.05, (js.n, 3)), 0.0).astype(np.float32)
    js = js.replace(vel=jnp.asarray(vel))
    js = jit_rebuild(jp, jg, js)
    tp = convert.sph_params_from_numpy(_leaves(jp))
    tg = port_grid(jg)
    ts = t_sys.rebuild_sph_neighbors(tp, tg, port_state(js).replace(nbr=None))
    assert_same_list(ts.nbr, js.nbr)
    return jp, jg, js, tp, tg, ts


def assert_state_close(got, ref, pos_tol=POS_TOL):
    np.testing.assert_allclose(got.rho.numpy(), np.asarray(ref.rho),
                               **RHO_TOL)
    close(got.vel, ref.vel, V_RTOL, V_ATOL, "v")
    np.testing.assert_allclose(got.pos.numpy(), np.asarray(ref.pos),
                               **pos_tol)


def fluid_close(got, ref):
    np.testing.assert_allclose(got.pos.numpy(), np.asarray(ref.pos),
                               **X_TOL)
    v_scale = float(np.abs(np.asarray(ref.vel)).max())
    np.testing.assert_allclose(got.vel.numpy(), np.asarray(ref.vel),
                               rtol=V_TOL["rtol"],
                               atol=V_TOL["atol"] * max(v_scale, 1.0))
    np.testing.assert_allclose(got.rho.numpy(), np.asarray(ref.rho),
                               **RHO_TOL)


@pytest.mark.parametrize("integrator", ["euler", "symplectic", "rk2"])
@pytest.mark.parametrize("shifting", ["xsph", "ppst", "none"])
def test_sph_substep_matches_jax(integrator, shifting):
    """One substep of each scheme on the periodic column (markers that
    cross the period are wrapped alike; ρ clipped alike)."""
    jp, jg, js, tp, tg, ts = periodic_column()
    change = dict(integrator=integrator, shifting=shifting)
    ref = j_sys.sph_substep(jp.replace(**change), jg, js)
    got = t_sys.sph_substep(tp.replace(**change), tg, ts)
    assert_state_close(got, ref)
    assert float(got.time) == pytest.approx(float(ref.time), rel=1e-6)
    fluid = ts.kind == 0
    assert torch.equal(got.pos[~fluid], ts.pos[~fluid])


@pytest.mark.parametrize("adaptive", [False, True])
def test_sph_advance_matches_jax(adaptive):
    """``make_sph_advance_fn`` on the periodic column (8 × 8 × 10), 2
    cycles of 4 substeps, with and without the adaptive step."""
    jp, jg, js = small_column()
    rng = np.random.default_rng(13)
    vel = np.where(np.asarray(js.kind)[:, None] == 0,
                   rng.normal(0.0, 0.05, (js.n, 3)), 0.0).astype(np.float32)
    js = js.replace(vel=jnp.asarray(vel))
    tp, tg = convert.sph_params_from_numpy(_leaves(jp)), port_grid(jg)
    ts = port_state(jit_rebuild(jp, jg, js))
    ref, ovf = j_sys.make_sph_advance_fn(jp, jg, adaptive_dt=adaptive)(js, 2)
    got, t_ovf = t_sys.make_sph_advance_fn(tp, tg, adaptive_dt=adaptive,
                                           device="cpu")(ts, 2)
    assert int(ovf) == int(t_ovf) == 0
    fluid_close(got, ref)
    assert float(got.time) == pytest.approx(float(ref.time), rel=1e-6)
    if adaptive:
        assert float(got.time) < 8 * tp.dt
