"""PyTorch port (chrono_tpu_torch) vs the JAX package: CRM's gather
engine, the JAX package's default.

``velocity_gradient``, ``crm_forces``, ``crm_step`` and
``make_crm_advance_fn`` on tests/test_crm.py's squat cohesive column
(periodic in y, seeded velocities), and ``crm_fsi_step`` without
``substeps_fn`` and ``make_crm_fsi_advance_fn(engine="gather")`` (the
default) on the single-wheel mini bed of tests/test_crm_terrain.py
(4,636 markers), each held to JAX's gather backend on the same inputs.
The wheel bed's JAX references come from tests/test_torch_crm_fsi.py's
module (one jitted step, cached).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from chrono_tpu.fsi.sph import crm as j_crm
from chrono_tpu.dem.neighbors import build_neighbor_list as j_build

from chrono_tpu_torch import convert
from chrono_tpu_torch.fsi import crm_terrain as t_ct
from chrono_tpu_torch.fsi.sph import crm as t_crm

from test_crm import column_setup
from test_torch_crm_fsi import (
    N_SUB, _bodies_close, _jax_fsi_step, _jax_wheel_scene,
    _port_wheel_scene, _terrain_close, _to_port,
)
from test_torch_wcsph import _leaves, assert_same_list, port_grid

# tests/test_crm.py:176-199, the tolerances the JAX package holds its TPU
# engines to against the gather backend after one substep (scales: max
# |ref| of the field)
POS_TOL = dict(rtol=1e-6, atol=1e-7)
RHO_TOL = dict(rtol=2e-5, atol=1e-2)
VEL_RTOL, VEL_ATOL = 1e-4, 3e-5
TAU_RTOL, TAU_ATOL = 1e-4, 2e-4
DV_RTOL, DV_ATOL = 1e-4, 5e-5


@pytest.fixture(scope="module", autouse=True)
def threads():
    """The multibody step's tiny LAPACK calls would pay for a larger
    pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def scaled(got, ref, rtol, atol_rel, what):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=rtol,
                               atol=atol_rel * max(float(np.abs(ref).max()),
                                                   1e-6), err_msg=what)


@functools.cache
def column():
    """tests/test_crm.py's squat cohesive column (aspect 0.5, c = 800 Pa)
    with seeded velocities (0.05 m/s) and its lists built by both
    packages, 32 markers a cell (the test's 80 slots triple the
    candidates on one core; no cell holds more than 20)."""
    jp, jc, jg, js, H, width = column_setup(aspect=0.5, cohesion=800.0)
    jp = jp.replace(max_per_cell=32)
    rng = np.random.default_rng(17)
    vel = np.where(np.asarray(js.kind)[:, None] == 0,
                   rng.normal(0.0, 0.05, (js.n, 3)), 0.0).astype(np.float32)
    js = js.replace(vel=jnp.asarray(vel))
    support = 2.0 * float(jp.h)
    js = js.replace(nbr=jax.jit(j_build, static_argnums=(0, 3, 4))(
        jg, js.pos, support, jp.max_per_cell, jp.max_neighbors))
    tp = convert.sph_params_from_numpy(_leaves(jp))
    tc = convert.crm_params_from_numpy(_leaves(jc))
    tg = port_grid(jg)
    ts = convert.crm_state_from_numpy(_leaves(js, ("nbr",)), device="cpu")
    ts = t_crm.rebuild_crm_neighbors(tp, tg, ts)
    assert_same_list(ts.nbr, js.nbr)
    assert jg.periodic == (False, True, False)
    return jp, jc, jg, js, tp, tc, tg, ts


def test_velocity_gradient_and_forces_match_jax():
    jp, jc, jg, js, tp, tc, tg, ts = column()
    ref = j_crm.velocity_gradient(jp, jg, js.pos, js.vel, js.rho,
                                  js.nbr.idx, js.nbr.valid)
    got = t_crm.velocity_gradient(tp, tg, ts.pos, ts.vel, ts.rho,
                                  ts.nbr.idx, ts.nbr.valid)
    scaled(got, ref, 1e-4, 1e-5, "grad v")
    ref = j_crm.crm_forces(jp, jc, jg, js)
    got = t_crm.crm_forces(tp, tc, tg, ts)
    scaled(got, ref, DV_RTOL, DV_ATOL, "dv")
    wall = (ts.kind == 1).numpy()
    assert float(np.abs(np.asarray(ref)[wall]).max()) > 1.0


def test_crm_step_matches_jax():
    """One elastoplastic step: every field at tests/test_crm.py's
    one-substep tolerances, walls not integrated."""
    jp, jc, jg, js, tp, tc, tg, ts = column()
    ref = j_crm.crm_step(jp, jc, jg, js)
    got = t_crm.crm_step(tp, tc, tg, ts)
    np.testing.assert_allclose(got.pos.numpy(), np.asarray(ref.pos),
                               **POS_TOL)
    scaled(got.vel, ref.vel, VEL_RTOL, VEL_ATOL, "v")
    np.testing.assert_allclose(got.rho.numpy(), np.asarray(ref.rho),
                               **RHO_TOL)
    for f in ("tau_d", "tau_o"):
        scaled(getattr(got, f), getattr(ref, f), TAU_RTOL, TAU_ATOL, f)
    wall = ts.kind == 1
    assert torch.equal(got.pos[wall], ts.pos[wall])
    assert float(got.time) == pytest.approx(float(ref.time), rel=1e-6)


def test_crm_advance_matches_jax():
    """``make_crm_advance_fn``: 2 cycles of 4 steps, held as
    tests/test_torch_crm.py holds 3 cycles of the cell-sorted engine to
    the gather backend (x atol 1e-6 m, v 1e-3·max|v|, ρ 0.05, σ
    1e-3·max|σ|)."""
    jp, jc, jg, js, tp, tc, tg, ts = column()
    ref, ovf = j_crm.make_crm_advance_fn(jp, jc, jg)(js, 2)
    got, t_ovf = t_crm.make_crm_advance_fn(tp, tc, tg, device="cpu")(ts, 2)
    assert int(ovf) == int(t_ovf) == 0
    _terrain_close(got, ref)
    assert_same_list(got.nbr, ref.nbr)


@functools.cache
def jax_outer_steps():
    """The JAX wheel bed after 1 and 2 outer steps of 2 substeps (its
    gather backend, one jitted step)."""
    state = _jax_wheel_scene()[4]
    step = _jax_fsi_step()
    out = []
    for _ in range(2):
        state, ovf = step(state)
        assert int(ovf) == 0
        out.append(state)
    return out


def test_crm_fsi_step_gather_matches_jax():
    """One outer step of ``crm_fsi_step`` without ``substeps_fn`` (the
    gather backend) on the wheel bed, from the JAX scene's own state."""
    params, crm, grid, model, state = _jax_wheel_scene()[:5]
    ref = jax_outer_steps()[0]
    sc = _port_wheel_scene()
    assert sc["params"].max_neighbors == params.max_neighbors
    assert sc["params"].max_per_cell == params.max_per_cell
    got, t_ovf, info = t_ct.crm_fsi_step(
        sc["model"], sc["params"], sc["soil"], sc["grid"],
        _to_port(state), N_SUB, sc["wheels"], f_ext_fn=sc["drive"])
    assert int(t_ovf) == 0
    assert info is not None
    _terrain_close(got.terrain, ref.terrain)
    _bodies_close(got.bodies, ref.bodies)
    assert_same_list(got.terrain.nbr, ref.terrain.nbr)


def test_crm_fsi_advance_gather_matches_jax():
    """``make_crm_fsi_advance_fn`` with its default engine (the gather
    backend, as in JAX), 2 outer steps of 2 substeps on the port's own
    wheel bed: the terrain and the wheel at tests/test_torch_crm_fsi.py's
    tolerances, the wheel pushed and the time advanced alike."""
    ref = jax_outer_steps()[1]
    sc = _port_wheel_scene()
    got, ovf = t_ct.make_crm_fsi_advance_fn(
        sc["model"], sc["params"], sc["soil"], sc["grid"], N_SUB,
        sc["wheels"], f_ext_fn=sc["drive"], device="cpu")(sc["state"], 2)
    assert int(ovf) == 0
    _terrain_close(got.terrain, ref.terrain)
    _bodies_close(got.bodies, ref.bodies)
    assert float(np.abs(np.asarray(ref.bodies.v)).max()) > 1e-3
    assert float(got.time) == pytest.approx(float(ref.time), rel=1e-6)
