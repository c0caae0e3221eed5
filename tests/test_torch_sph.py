"""PyTorch port (chrono_tpu_torch) vs the JAX package: the WCSPH dam break.

The oracle is the JAX gather backend (``rebuild_sph_neighbors`` +
``sph_substep``, ``make_sph_advance_fn``), the JAX package's own plain
reference for its SPH TPU kernels, on the mini dam of
tests/test_sph_pencil.py (756 markers).  The interpret-mode TPU kernels are
not run here: one of their substeps costs over a minute on one CPU core.
On the CPU the port's kernels run their plain twins.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from chrono_tpu.fsi.sph import kernels as j_kernels
from chrono_tpu.fsi.sph import state as j_state
from chrono_tpu.fsi.sph.system import (
    make_sph_advance_fn, make_sph_state, rebuild_sph_neighbors, sph_substep,
    suggest_sph_dt,
)

from chrono_tpu_torch.collision.cell_list import GridSpec
from chrono_tpu_torch.convert import sph_params_from_numpy, sph_state_from_numpy
from chrono_tpu_torch.fsi.sph import kernels as t_kernels
from chrono_tpu_torch.fsi.sph import state as t_state
from chrono_tpu_torch.fsi.sph import system as t_system
from chrono_tpu_torch.fsi.sph.pencil import (
    bin_to_cells, make_sph_advance_pencil,
)

from test_sph_pencil import _mini_dam

# the tolerances tests/test_sph_pencil.py holds the JAX backends to
RHO_TOL = dict(rtol=2e-5, atol=1e-3)
POS_TOL = dict(rtol=1e-6, atol=1e-7)


def _leaves(obj, skip=()):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)
            if f.name not in skip}


def _port(params, grid, state):
    return (sph_params_from_numpy(_leaves(params)),
            GridSpec(origin=tuple(grid.origin), cell_size=grid.cell_size,
                     dims=tuple(grid.dims)),
            sph_state_from_numpy(_leaves(state, ("nbr",)), device="cpu"))


def _assert_state_close(got, ref, v_tol_rel=1e-4, v_tol_abs=2e-5,
                        pos_tol=POS_TOL, rho_tol=RHO_TOL):
    np.testing.assert_allclose(got.rho.numpy(), np.asarray(ref.rho),
                               **rho_tol)
    v_scale = max(float(jnp.abs(ref.vel).max()), 1e-6)
    np.testing.assert_allclose(got.vel.numpy(), np.asarray(ref.vel),
                               rtol=v_tol_rel, atol=v_tol_abs * v_scale)
    np.testing.assert_allclose(got.pos.numpy(), np.asarray(ref.pos),
                               **pos_tol)


@pytest.mark.parametrize("name", ["cubic", "wendland", "quintic"])
def test_smoothing_kernels_match_jax(name):
    h = 0.024
    r = np.random.default_rng(5).uniform(0.0, 3.5 * h, 4096) \
        .astype(np.float32)
    r[:4] = [0.0, h, 2 * h, 3 * h]
    jw, jdw, jsupp = j_kernels.KERNELS[name]
    tw, tdw, tsupp = t_kernels.KERNELS[name]
    assert tsupp == jsupp
    rt = torch.from_numpy(r)
    for tf, jf in ((tw, jw), (tdw, jdw)):
        ref = np.asarray(jf(jnp.asarray(r), jnp.float32(h)))
        got = tf(rt, h).numpy()
        # the absolute floor covers values that cancel to near zero: the
        # quintic's three-term sum loses ~20 ulp of its largest term where
        # XLA contracts it into FMAs
        np.testing.assert_allclose(got, ref, rtol=1e-6,
                                   atol=2e-6 * np.abs(ref).max())
    d = np.random.default_rng(6).normal(0.0, h, (512, 3)).astype(np.float32)
    rd = np.sqrt((d * d).sum(-1) + 1e-12).astype(np.float32)
    ref = np.asarray(j_kernels.grad_w(jdw, jnp.asarray(d), jnp.asarray(rd),
                                      jnp.float32(h)))
    got = t_kernels.grad_w(tdw, torch.from_numpy(d), torch.from_numpy(rd),
                           h).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6,
                               atol=1e-6 * np.abs(ref).max())


def test_tait_eos_matches_jax():
    jp, _, _ = _mini_dam()
    tp = sph_params_from_numpy(_leaves(jp))
    rho = np.random.default_rng(8).uniform(650.0, 1550.0, 2048) \
        .astype(np.float32)
    p_ref = np.asarray(j_state.tait_pressure(jp, jnp.asarray(rho)))
    p_got = t_state.tait_pressure(tp, torch.from_numpy(rho)).numpy()
    np.testing.assert_allclose(p_got, p_ref, rtol=1e-5,
                               atol=1e-6 * np.abs(p_ref).max())
    # down to p/B = −1.2, past the 1e-3 clamp of the inverse
    B = tp.c_s ** 2 * tp.rho0 / tp.eos_gamma
    p = np.random.default_rng(9).uniform(-1.2 * B, 2.0 * B, 2048) \
        .astype(np.float32)
    np.testing.assert_allclose(
        t_state.tait_density(tp, torch.from_numpy(p)).numpy(),
        np.asarray(j_state.tait_density(jp, jnp.asarray(p))), rtol=1e-6)


def test_make_state_and_dt_match_jax():
    jp, _, js = _mini_dam("laminar")
    tp = sph_params_from_numpy(_leaves(jp))
    assert t_system.suggest_sph_dt(tp) == pytest.approx(
        suggest_sph_dt(jp), rel=1e-6)
    rng = np.random.default_rng(4)
    fluid = rng.uniform(0.0, 0.1, (50, 3))
    wall = rng.uniform(-0.1, 0.0, (20, 3))
    fvel = rng.normal(0.0, 0.3, (50, 3))
    ref = make_sph_state(jp, fluid, boundary_pts=wall, fluid_vel=fvel)
    got = t_system.make_sph_state(tp, fluid, boundary_pts=wall,
                                  fluid_vel=fvel, device="cpu")
    for f in ("pos", "vel", "rho", "kind", "body_id", "bce_local", "time"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)))
    assert got.kind.dtype == torch.int32 and got.pos.dtype == torch.float32
    # rigid-body BCE markers after the walls, with their bodies and local
    # offsets; flexible ones wait for FEA and are refused
    rigid = dict(rigid_pts=wall[:6] + 1.0, rigid_body_ids=[0, 0, 1, 1, 1, 2],
                 rigid_local=wall[:6])
    ref = make_sph_state(jp, fluid, boundary_pts=wall, **rigid)
    got = t_system.make_sph_state(tp, fluid, boundary_pts=wall,
                                  device="cpu", **rigid)
    for f in ("pos", "kind", "body_id", "bce_local"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)))
    assert got.kind[-6:].tolist() == [2] * 6
    with pytest.raises(NotImplementedError, match="item 8"):
        t_system.make_sph_state(tp, fluid, flex_pts=wall, device="cpu")


def test_runtime_dt_matches_jax():
    from chrono_tpu.fsi.sph.system import runtime_dt
    jp, _, js = _mini_dam()
    vel = np.random.default_rng(2).normal(0.0, 2.0, js.vel.shape) \
        .astype(np.float32)
    js = js.replace(vel=jnp.asarray(vel))
    _, _, ts = _port(jp, _mini_dam()[1], js)
    tp = sph_params_from_numpy(_leaves(jp))
    assert float(t_system.runtime_dt(tp, ts)) == pytest.approx(
        float(runtime_dt(jp, js)), rel=1e-6)


def test_binning_counts_and_order():
    """The cell table covers every marker once, in stable cell order, and
    overflow is the largest excess over the capacity."""
    jp, jg, js = _mini_dam()
    _, grid, ts = _port(jp, jg, js)
    order, cells, ovf = bin_to_cells(grid, 32, ts.pos)
    assert int(ovf) == 0 and int(cells.count.sum()) == ts.n
    assert torch.equal(torch.sort(order).values, torch.arange(ts.n))
    cid = cells.cell.long()
    assert bool((cid[1:] >= cid[:-1]).all())
    same = cid[1:] == cid[:-1]
    assert bool((order[1:][same] > order[:-1][same]).all())
    top = int(cells.count.max())
    assert 20 <= top <= 32
    assert int(bin_to_cells(grid, top - 3, ts.pos)[2]) == 3


def _stirred(state, seed=17):
    """The mini dam with random fluid velocities (σ = 0.1 m/s) and densities
    (±1 %): at rest every viscosity and δ-SPH term is exactly zero."""
    rng = np.random.default_rng(seed)
    fluid = np.asarray(state.kind) == j_state.FLUID
    vel = np.array(state.vel)
    rho = np.array(state.rho)
    vel[fluid] = rng.normal(0.0, 0.1, (int(fluid.sum()), 3))
    rho[fluid] *= 1.0 + rng.uniform(-0.01, 0.01, int(fluid.sum()))
    return state.replace(vel=jnp.asarray(vel, jnp.float32),
                         rho=jnp.asarray(rho, jnp.float32))


@functools.cache
def _jax_one_substep(viscosity):
    """The gather backend's substep of the stirred dam.  The laminar case
    takes a glycerol-like μ = 1 Pa·s: water's 1e-3 changes v by ~1e-6 m/s
    in one substep, below the velocity tolerance."""
    params, grid, state = _mini_dam(viscosity)
    if viscosity == "laminar":
        params = params.replace(mu=jnp.asarray(1.0, jnp.float32))
    state = _stirred(state)
    ref = sph_substep(params, grid, rebuild_sph_neighbors(params, grid,
                                                          state))
    return params, grid, state, ref


@pytest.mark.parametrize("viscosity", ["artificial", "laminar"])
def test_one_substep_matches_gather_backend(viscosity):
    """One symplectic substep of the port's advance == the JAX gather
    backend, at the tolerances test_sph_pencil.py holds its TPU kernels to,
    from a stirred dam, so that pressure, the Adami walls, the viscosity
    (fluid–fluid and fluid–solid), δ-SPH and XSPH all act."""
    params, grid, state, ref = _jax_one_substep(viscosity)
    tp, tg, ts = _port(params.replace(rebuild_every=1), grid, state)
    got, ovf = make_sph_advance_pencil(tp, tg, capacity=32,
                                       device="cpu")(ts, 1)
    assert int(ovf) == 0
    _assert_state_close(got, ref)
    assert float(got.time) == pytest.approx(float(ref.time), rel=1e-6)


@pytest.mark.parametrize("viscosity,term,field", [
    ("artificial", "alpha_visc", "vel"), ("laminar", "mu", "vel"),
    ("artificial", "delta_sph", "rho")])
def test_one_substep_parity_sees_each_term(viscosity, term, field):
    """The one-substep parity above would catch a wrong viscosity or δ-SPH
    term: with the term switched off, the port's substep leaves that
    test's tolerance on the field the term acts on, by a factor ≥ 10."""
    params, grid, state, ref = _jax_one_substep(viscosity)
    tp, tg, ts = _port(params.replace(rebuild_every=1), grid, state)
    got, _ = make_sph_advance_pencil(tp.replace(**{term: 0.0}), tg,
                                     capacity=32, device="cpu")(ts, 1)
    ref = np.asarray(getattr(ref, field))
    if field == "vel":
        rtol, atol = 1e-4, 2e-5 * np.abs(ref).max()
    else:
        rtol, atol = RHO_TOL["rtol"], RHO_TOL["atol"]
    off = np.abs(getattr(got, field).numpy() - ref) / (atol
                                                      + rtol * np.abs(ref))
    assert off.max() > 10.0


@functools.cache
def _jax_three_cycles():
    params, grid, state = _mini_dam()
    params = params.replace(rebuild_every=2)
    out, ovf = make_sph_advance_fn(params, grid)(state, 3)
    assert int(ovf) == 0
    return out


def test_three_cycles_match_gather_backend_and_stay_physical():
    """3 cycles × 2 substeps against ``make_sph_advance_fn``.  The pair
    sums run in another order, and those fp32 differences grow over the
    substeps: velocities are held at an absolute 1e-4·max|v| (the
    one-substep test holds 2e-5·max|v|; this run differs by ~2.5e-5·max|v|
    on one CPU core), ρ and x at the one-substep tolerances.  The same run
    must show the multi-cycle properties of
    test_pencil_multi_cycle_stays_physical."""
    params, grid, state = _mini_dam()
    ref = _jax_three_cycles()
    tp, tg, ts = _port(params.replace(rebuild_every=2), grid, state)
    got, ovf = make_sph_advance_pencil(tp, tg, capacity=32,
                                       device="cpu")(ts, 3)
    assert int(ovf) == 0
    _assert_state_close(got, ref, v_tol_abs=1e-4)
    fluid = ts.kind == j_state.FLUID
    assert bool(torch.isfinite(got.pos).all() and torch.isfinite(
        got.vel).all() and torch.isfinite(got.rho).all())
    rho = got.rho[fluid]
    assert float(rho.min()) > 700.0 and float(rho.max()) < 1500.0
    # the front moves as t²: test_pencil_multi_cycle_stays_physical asks
    # 1e-5 after 10 substeps, this run makes 6
    assert float(got.pos[fluid, 0].max()) > float(ts.pos[fluid, 0].max()) \
        + 3e-6
    assert torch.equal(got.pos[~fluid], ts.pos[~fluid])


def test_advance_rejects_what_the_kernels_do_not_implement():
    params, grid, state = _mini_dam()
    tp, tg, _ = _port(params, grid, state)
    small = dataclasses.replace(tg, cell_size=1.9 * tp.h)
    with pytest.raises(ValueError):
        make_sph_advance_pencil(tp, small, device="cpu")
    for change in (dict(kernel="wendland"), dict(shifting="ppst"),
                   dict(integrator="rk2"), dict(boundary_model="holmes")):
        with pytest.raises(ValueError):
            make_sph_advance_pencil(tp.replace(**change), tg, device="cpu")


def test_density_reinit_every_is_carried_unread():
    """``density_reinit_every`` is read by nothing in either package: a
    non-zero value converts and is carried, and a cycle on either engine
    gives the same state, bit for bit, as with zero."""
    params, grid, state = _mini_dam()
    tp, tg, ts = _port(params, grid, state)
    tr = sph_params_from_numpy(_leaves(params.replace(
        density_reinit_every=20)))
    assert tr.density_reinit_every == 20 and tp.density_reinit_every == 0
    assert tr.replace(density_reinit_every=0) == tp
    for advance in (t_system.make_sph_advance_fn, make_sph_advance_pencil):
        a, b = (advance(p.replace(rebuild_every=1), tg, device="cpu")(ts, 1)
                [0] for p in (tp, tr))
        for f in ("pos", "vel", "rho"):
            assert torch.equal(getattr(a, f), getattr(b, f))
        assert not torch.equal(a.pos, ts.pos)


def test_markers_past_the_capacity_are_carried_through():
    """A cell with more markers than ``capacity`` keeps its first ones in
    the sweeps; the rest keep their state, and overflow counts them."""
    params, grid, state = _mini_dam()
    tp, tg, ts = _port(params.replace(rebuild_every=1), grid, state)
    order, cells, _ = bin_to_cells(tg, 32, ts.pos)
    cap = int(cells.count.max()) - 2
    start = cells.start.long()[cells.cell.long()]
    skipped = order[torch.arange(ts.n) - start >= cap]
    assert len(skipped) > 0
    got, ovf = make_sph_advance_pencil(tp, tg, capacity=cap,
                                       device="cpu")(ts, 1)
    assert int(ovf) == 2
    for f in ("pos", "vel", "rho"):
        assert torch.equal(getattr(got, f)[skipped],
                           getattr(ts, f)[skipped])
    fluid = ts.kind == j_state.FLUID
    assert bool((got.vel[fluid] != 0).any())
