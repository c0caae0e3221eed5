"""PyTorch port (chrono_tpu_torch) vs the JAX package: CRM terrain alone.

The oracle is the JAX gather backend (``crm_step``, ``crm_forces``,
``make_crm_advance_fn``), the JAX package's own plain reference for its CRM
TPU kernels, jitted.  The interpret-mode TPU kernels are not run here: their
tests take minutes on one CPU core.  The bed is 0.4 × 0.2 × 0.1 m at
d0 = 0.02 with the firm cohesive loam of demos/demo_vehicle_crm.py: 1,000
granular markers and 4,017 wall markers.  On the CPU the port's kernels run
their plain twins.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from chrono_tpu.dem.neighbors import build_neighbor_list
from chrono_tpu.fsi.crm_terrain import (
    make_crm_terrain_state as j_make_crm_terrain_state,
)
from chrono_tpu.fsi.sph import crm as j_crm
from chrono_tpu.fsi.sph.state import SPHParams as JSPHParams

from chrono_tpu_torch.collision.cell_list import GridSpec
from chrono_tpu_torch.convert import (
    crm_params_from_numpy, crm_state_from_numpy, sph_params_from_numpy,
)
from chrono_tpu_torch.fsi.crm_terrain import make_crm_terrain_state
from chrono_tpu_torch.fsi.sph import crm as t_crm
from chrono_tpu_torch.fsi.sph.crm_pencil import (
    cells_to_crm_state, cells_to_markers, crm_state_to_cells,
    make_crm_advance_pencil,
    make_crm_engine, make_crm_substeps_pencil,
)
from chrono_tpu_torch.ops.cuda import crm_substep as k

# the tolerances tests/test_crm.py holds the JAX TPU engines to, against
# the gather backend, after one substep (scales: max |ref| of the field)
POS_TOL = dict(rtol=1e-6, atol=1e-7)
RHO_TOL = dict(rtol=2e-5, atol=1e-2)
VEL_RTOL, VEL_ATOL = 1e-4, 3e-5
TAU_RTOL, TAU_ATOL = 1e-4, 2e-4
DV_RTOL, DV_ATOL = 1e-4, 5e-5
D0 = 0.02


def _leaves(obj, skip=()):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)
            if f.name not in skip}


def _jax_soil():
    """demos/demo_vehicle_crm.py:70-81 at d0 = 0.02."""
    params = JSPHParams(
        d0=jnp.asarray(D0), h=jnp.asarray(1.2 * D0),
        rho0=jnp.asarray(1700.0), mu=jnp.asarray(0.0),
        c_s=jnp.asarray(40.0), gravity=jnp.asarray([0.0, 0.0, -9.81]),
        dt=jnp.asarray(1e-4), alpha_visc=jnp.asarray(0.3), kernel="cubic",
        max_neighbors=128, max_per_cell=64, rebuild_every=4)
    crm = j_crm.CRMParams(youngs=jnp.asarray(4e6), poisson=jnp.asarray(0.3),
                          friction_angle=jnp.asarray(0.9),
                          cohesion=jnp.asarray(2000.0))
    return params, crm


def _port(params, crm, grid=None, state=None):
    out = [sph_params_from_numpy(_leaves(params)),
           crm_params_from_numpy(_leaves(crm))]
    if grid is not None:
        out.append(GridSpec(origin=tuple(grid.origin),
                            cell_size=grid.cell_size, dims=tuple(grid.dims)))
    if state is not None:
        out.append(crm_state_from_numpy(_leaves(state, ("nbr",)),
                                        device="cpu"))
    return out


@functools.cache
def _jax_fns():
    """The jitted gather backend: one cycle of ``make_crm_advance_fn``,
    ``crm_step`` and ``crm_forces`` (each compiled once for the file)."""
    params, crm = _jax_soil()
    _, _, grid, _ = _jax_bed()
    adv = j_crm.make_crm_advance_fn(params, crm, grid)
    return (lambda s: adv(s, 1),
            jax.jit(lambda s: j_crm.crm_step(params, crm, grid, s)),
            jax.jit(lambda s: j_crm.crm_forces(params, crm, grid, s)))


def _jax_cycles(state, n):
    cycle = _jax_fns()[0]
    for _ in range(n):
        state, ovf = cycle(state)
        assert int(ovf) == 0
    return state


@functools.cache
def _jax_bed():
    params, crm = _jax_soil()
    state, grid = j_make_crm_terrain_state(params, crm, (0.4, 0.2), 0.1,
                                           air=12.0, margin=6.0)
    return params, crm, grid, state


def _nbr(params, grid, pos):
    nbr = build_neighbor_list(grid, pos, 2.0 * float(params.h),
                              params.max_per_cell, params.max_neighbors)
    assert int(nbr.overflow) == 0
    return nbr


@functools.cache
def _jax_stirred():
    """2 gather cycles from the lithostatic bed, then granular velocities
    perturbed by N(0, 0.05 m/s) and stresses by ±5 % (seeded): at rest the
    viscosity and spin terms are zero and nothing yields."""
    state = _jax_cycles(_jax_bed()[3], 2)
    rng = np.random.default_rng(23)
    gran = np.asarray(state.kind) == 0
    n_g = int(gran.sum())
    vel, tau_d, tau_o = (np.array(a) for a in
                         (state.vel, state.tau_d, state.tau_o))
    vel[gran] += rng.normal(0.0, 0.05, (n_g, 3))
    tau_d[gran] *= 1.0 + rng.uniform(-0.05, 0.05, (n_g, 3))
    tau_o[gran] *= 1.0 + rng.uniform(-0.05, 0.05, (n_g, 3))
    return state.replace(vel=jnp.asarray(vel, jnp.float32),
                         tau_d=jnp.asarray(tau_d, jnp.float32),
                         tau_o=jnp.asarray(tau_o, jnp.float32))


@functools.cache
def _jax_one_substep():
    """One gather substep of the stirred bed, and ``crm_forces`` at the
    stepped state with a rebuilt list (tests/test_crm.py:162-201)."""
    params, _, grid, _ = _jax_bed()
    _, step, forces = _jax_fns()
    state = _jax_stirred().replace(nbr=_nbr(params, grid,
                                            _jax_stirred().pos))
    ref = step(state)
    dv = forces(ref.replace(nbr=_nbr(params, grid, ref.pos)))
    return state, ref, dv


def _ratio(got, ref, rtol, atol):
    """max |got − ref| / (atol + rtol·|ref|): ≤ 1 passes."""
    ref = np.asarray(ref)
    return float((np.abs(np.asarray(got) - ref)
                  / (atol + rtol * np.abs(ref))).max())


def _ratios(got, ref, dv=None, dv_ref=None):
    """Each field's ratio to the one-substep tolerance of tests/test_crm.py,
    except that σ_o is scaled by its own max |σ_o|, not by max |σ_d| as
    there: ten times tighter on this bed, where the edge markers' kicks
    make max |σ_d| ~ 6e5 Pa, and tight enough to see the Jaumann spin."""
    v_scale = max(float(jnp.abs(ref.vel).max()), 1e-6)
    d_scale = max(float(jnp.abs(ref.tau_d).max()), 1.0)
    o_scale = max(float(jnp.abs(ref.tau_o).max()), 1.0)
    out = {"pos": _ratio(got.pos, ref.pos, **POS_TOL),
           "vel": _ratio(got.vel, ref.vel, VEL_RTOL, VEL_ATOL * v_scale),
           "rho": _ratio(got.rho, ref.rho, **RHO_TOL),
           "tau": max(_ratio(got.tau_d, ref.tau_d, TAU_RTOL,
                             TAU_ATOL * d_scale),
                      _ratio(got.tau_o, ref.tau_o, TAU_RTOL,
                             TAU_ATOL * o_scale))}
    if dv is not None:
        a_scale = max(float(jnp.abs(dv_ref).max()), 1e-6)
        out["dv"] = _ratio(dv, dv_ref, DV_RTOL, DV_ATOL * a_scale)
    return out


# ------------------------------------------------------------ (a), (b)


@pytest.mark.parametrize("cohesion", [0.0, 2000.0])
def test_drucker_prager_return_matches_jax(cohesion):
    """Seeded stresses inside the cone, outside it and in tension beyond
    the apex: the port's return (the channel form its twins use) equals
    the JAX one."""
    rng = np.random.default_rng(31)
    n = 3000
    p = rng.uniform(-2e4, 4e4, n)                  # compression positive
    dev = rng.normal(0.0, 1.0, (n, 3, 3))
    dev = 0.5 * (dev + dev.transpose(0, 2, 1))
    dev -= np.trace(dev, axis1=1, axis2=2)[:, None, None] / 3 * np.eye(3)
    dev *= rng.uniform(0.0, 1e4, n)[:, None, None] / np.sqrt(
        0.5 * (dev * dev).sum((1, 2)))[:, None, None]
    s = (dev - p[:, None, None] * np.eye(3)).astype(np.float32)
    jp = j_crm.CRMParams(friction_angle=jnp.asarray(0.9),
                         cohesion=jnp.asarray(cohesion))
    tp = crm_params_from_numpy(_leaves(jp))
    ref = np.asarray(j_crm.drucker_prager_return(jnp.asarray(s), jp))
    got = t_crm.drucker_prager_return(torch.from_numpy(s), tp).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())
    den = np.sqrt(9 + 3 * 0.9 ** 2)
    alpha, k_c = 0.9 / den, 3.0 * cohesion / den
    p_mean = -np.trace(s, axis1=1, axis2=2) / 3
    dev = s + p_mean[:, None, None] * np.eye(3)
    inside = (np.sqrt(0.5 * (dev * dev).sum((1, 2)))
              < alpha * p_mean + k_c)
    tension = p_mean < -k_c / alpha
    assert inside.mean() > 0.15 and (~inside & ~tension).mean() > 0.15
    assert tension.mean() > 0.05
    np.testing.assert_allclose(got[inside], s[inside], rtol=1e-5,
                               atol=1e-5 * np.abs(s).max())


def test_lithostatic_init_matches_jax():
    params, crm, _, state = _jax_bed()
    tp, tc, ts = _port(params, crm, state=state)
    rng = np.random.default_rng(3)
    surf = rng.uniform(0.05, 0.12, state.n).astype(np.float32)
    for z, tz in ((0.1, 0.1), (jnp.asarray(surf), torch.from_numpy(surf))):
        ref = j_crm.lithostatic_init(state, params, crm, z)
        got = t_crm.lithostatic_init(ts, tp, tc, tz)
        np.testing.assert_allclose(got.tau_d.numpy(), np.asarray(ref.tau_d),
                                   rtol=1e-6, atol=1e-3)
        assert float(got.tau_d.abs().max()) > 1e3


@pytest.mark.parametrize("shape", ["flat", "heightmap_carved"])
def test_terrain_state_matches_jax(shape):
    """Same markers, kinds, stresses and grid as the JAX terrain state."""
    params, crm = _jax_soil()
    tp, tc = _port(params, crm)
    kw = dict(air=12.0, margin=6.0)
    if shape == "heightmap_carved":
        kw.update(surface_fn=lambda x, y: 0.07 + 0.03 * np.sin(8 * x),
                  carve_fn=lambda p: np.hypot(p[:, 0] - 0.2,
                                              p[:, 2] - 0.1) > 0.05)
    ref, grid = j_make_crm_terrain_state(params, crm, (0.4, 0.2), 0.1, **kw)
    got, tgrid = make_crm_terrain_state(tp, tc, (0.4, 0.2), 0.1,
                                        device="cpu", **kw)
    for f in ("pos", "vel", "rho", "kind", "body_id", "bce_local", "tau_o",
              "time"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), f)
    np.testing.assert_allclose(got.tau_d.numpy(), np.asarray(ref.tau_d),
                               rtol=1e-6, atol=1e-3)
    assert tgrid == GridSpec(origin=tuple(grid.origin),
                             cell_size=grid.cell_size, dims=tuple(grid.dims))
    # rigid-body BCE markers follow the walls, with their bodies and local
    # offsets, as in the JAX state
    rigid = dict(rigid_pts=np.full((4, 3), 0.05), rigid_body_ids=[0] * 4,
                 rigid_local=np.eye(4, 3))
    ref, _ = j_make_crm_terrain_state(params, crm, (0.4, 0.2), 0.1, **kw,
                                      **rigid)
    got, _ = make_crm_terrain_state(tp, tc, (0.4, 0.2), 0.1, device="cpu",
                                    **kw, **rigid)
    for f in ("pos", "kind", "body_id", "bce_local"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), f)
    assert got.kind[-4:].tolist() == [2] * 4


# ---------------------------------------------------------------- (c)


def _port_one_substep(consts_change=None):
    """The port's substep of the stirred bed (the twins, through the
    engine's binning), and ``dv`` at the stepped state."""
    params, crm, grid, _ = _jax_bed()
    tp, tc, tg, ts = _port(params, crm, grid, _jax_stirred())
    if consts_change is None:
        got, dv, ovf = make_crm_substeps_pencil(tp, tc, tg, 32,
                                                device="cpu")(ts, 1)
        assert int(ovf) == 0
        return got, dv
    eng = make_crm_engine(tp, tc, tg, 32, device="cpu")
    feat, order, cells, _ = eng["bin"](ts)
    out, _ = k.crm_substep_plain(feat, cells,
                                 eng["consts"].replace(**consts_change))
    return cells_to_crm_state(out, order, ts), None


@functools.cache
def _port_one_substep_cached():
    return _port_one_substep()


def test_one_substep_matches_gather_backend():
    """One substep of the port == ``crm_step``, and its forces-only sweep
    at the stepped state == ``crm_forces`` with a rebuilt list, at the
    tolerances of tests/test_crm.py, from a stirred bed on which the
    viscosity and the penalty act and the spin and the return matter."""
    state, ref, dv_ref = _jax_one_substep()
    got, dv = _port_one_substep_cached()
    ratios = _ratios(got, ref, dv, dv_ref)
    assert all(r <= 1.0 for r in ratios.values()), ratios
    # what makes it bite: approaching pairs (artificial viscosity) and
    # mixed pairs inside d0 (the penalty) in the gather list
    params, _, _, _ = _jax_bed()
    idx, valid = np.asarray(state.nbr.idx), np.asarray(state.nbr.valid)
    j = np.maximum(idx, 0)
    pos, vel = np.asarray(state.pos), np.asarray(state.vel)
    gran = np.asarray(state.kind) == 0
    d = pos[:, None] - pos[j]
    approach = valid & (((vel[:, None] - vel[j]) * d).sum(-1) < 0)
    close = valid & (gran[:, None] != gran[j]) & (
        np.sqrt((d * d).sum(-1)) < float(params.d0))
    assert approach[gran].sum() > 1000 and close[gran].sum() > 100


@pytest.mark.parametrize("term,field", [
    ("penalty", "vel"), ("viscosity", "vel"), ("spin", "tau"),
    ("return", "tau")])
def test_one_substep_parity_sees_each_term(term, field, monkeypatch):
    """The one-substep parity above would catch a wrong term: with the
    mixed-pair penalty, the artificial viscosity, the Jaumann spin or the
    Drucker–Prager return switched off, the port's substep leaves that
    test's tolerance on the field the term acts on, by a factor ≥ 10."""
    base, _ = _port_one_substep_cached()      # before any term is patched
    change = None
    if term == "penalty":
        change = dict(k_bc=0.0, c_bc=0.0)
    elif term == "viscosity":
        change = dict(alpha_visc=0.0)
    elif term == "spin":
        orig = k.strain_and_spin
        monkeypatch.setattr(k, "strain_and_spin", lambda g: (
            orig(g)[0], torch.zeros_like(orig(g)[1])))
    else:
        monkeypatch.setattr(k, "drucker_prager_channels",
                            lambda s, fa, coh: s)
    got, _ = _port_one_substep(change or {})
    assert _ratios(got, _jax_one_substep()[1])[field] > 10.0
    if term == "return":
        # the share of granular markers that yield in this substep (68 %
        # on this bed: the edge kicks and the ±5 % stir push most of them
        # onto the cone)
        gran = base.kind == 0
        moved = (got.tau_d != base.tau_d).any(1) | (
            got.tau_o != base.tau_o).any(1)
        assert float(moved[gran].float().mean()) > 0.5


# ---------------------------------------------------------------- (d)


def test_outer_twin_matches_three_gather_steps():
    """The whole-outer twin (n = 3 substeps on one binning) == 3
    ``crm_step``s on one gather list, and its acceleration == ``crm_forces``
    at the state before the last substep on that list.  After the first
    substep the two differ at second order, because the gather list is
    fixed for the cycle while the sweeps see every pair inside 2h (cells
    have no skin): the velocity is held at 3× the one-substep atol, the
    rest at the one-substep tolerances."""
    params, crm, grid, _ = _jax_bed()
    _, step, forces = _jax_fns()
    state = _jax_stirred()
    ref = state.replace(nbr=_nbr(params, grid, state.pos))
    for _ in range(2):
        ref = step(ref)
    dv_ref = forces(ref)
    ref = step(ref)
    tp, tc, tg, ts = _port(params, crm, grid, state)
    eng = make_crm_engine(tp, tc, tg, 32, device="cpu")
    feat, order, cells, ovf = eng["bin"](ts)
    assert int(ovf) == 0
    out, acc, list_ovf = eng["outer"](feat, cells, 3)
    assert int(list_ovf) == 0
    got = cells_to_crm_state(out, order, ts)
    ratios = _ratios(got, ref, cells_to_markers(acc, order), dv_ref)
    ratios["vel"] /= 3.0
    assert all(r <= 1.0 for r in ratios.values()), ratios
    assert float(got.time) == float(ts.time)


# ---------------------------------------------------------------- (e)


def test_three_cycles_match_gather_backend():
    """3 cycles × 4 substeps of ``make_crm_advance_pencil`` against
    ``make_crm_advance_fn`` from the lithostatic bed.  The edge markers
    start inside the wall penalty range and are kicked to ~3 m/s, and the
    gather list misses pairs that enter 2h within a cycle (cells have no
    skin), so the fields are held looser than one substep: x at atol 1e-6
    m, v at 1e-3·max|v|, ρ at 0.05 kg/m³, σ at 1e-3·max|σ|."""
    params, crm, grid, state = _jax_bed()
    ref = _jax_cycles(state, 3)
    tp, tc, tg, ts = _port(params, crm, grid, state)
    got, ovf = make_crm_advance_pencil(tp, tc, tg, 32, device="cpu")(ts, 3)
    assert int(ovf) == 0
    v_scale = float(jnp.abs(ref.vel).max())
    s_scale = float(jnp.abs(ref.tau_d).max())
    assert v_scale > 1.0
    np.testing.assert_allclose(got.pos.numpy(), np.asarray(ref.pos),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.vel.numpy(), np.asarray(ref.vel),
                               rtol=1e-4, atol=1e-3 * v_scale)
    np.testing.assert_allclose(got.rho.numpy(), np.asarray(ref.rho),
                               rtol=2e-5, atol=0.05)
    for f in ("tau_d", "tau_o"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)),
                                   rtol=1e-4, atol=1e-3 * s_scale)
    assert float(got.time) == pytest.approx(float(ref.time), rel=1e-6)
    walls = ts.kind != 0
    assert torch.equal(got.pos[walls], ts.pos[walls])
    assert torch.equal(got.vel[walls], ts.vel[walls])


# ------------------------------------------------------- port mechanics


def test_markers_past_the_capacity_are_carried_through():
    """A cell with more markers than ``capacity`` keeps its first ones in
    the sweeps; the rest keep their state bit for bit, and overflow counts
    them."""
    params, crm, grid, state = _jax_bed()
    tp, tc, tg, ts = _port(params, crm, grid, state)
    feat, order, cells, _ = crm_state_to_cells(tg, 32, ts)
    cap = int(cells.count.max()) - 3
    feat, order, cells, ovf = crm_state_to_cells(tg, cap, ts)
    assert int(ovf) == 3
    past = feat[k.VAL] < 0.5
    assert bool(past.any())
    out, _ = k.crm_substep_plain(feat, cells, k.crm_static_params(tp, tc))
    assert torch.equal(out[:, past], feat[:, past])
    assert bool((out[k.VX:k.VZ + 1, ~past] != feat[k.VX:k.VZ + 1, ~past])
                .any())


def test_engine_rejects_what_the_kernels_do_not_implement():
    params, crm, grid, _ = _jax_bed()
    tp, tc, tg = _port(params, crm, grid)
    small = dataclasses.replace(tg, cell_size=1.9 * tp.h)
    with pytest.raises(ValueError):
        make_crm_engine(tp, tc, small, device="cpu")
    with pytest.raises(ValueError):
        make_crm_engine(tp.replace(kernel="wendland"), tc, tg, device="cpu")
    with pytest.raises(ValueError):
        make_crm_engine(tp, tc, tg, capacity=0, device="cpu")


def test_conversion_refuses_dilatancy():
    """Nothing reads tan ψ, in either package (the return is
    non-associated): a non-zero dilatancy converts and is carried, and a
    substep on either engine gives the same state, bit for bit, as with
    zero."""
    _, crm = _jax_soil()
    tc = crm_params_from_numpy(_leaves(crm))
    assert tc.cohesion == 2000.0 and tc.dilatancy == 0.0
    td = crm_params_from_numpy(_leaves(dataclasses.replace(
        crm, dilatancy=jnp.asarray(0.1))))
    assert td.dilatancy == pytest.approx(0.1)
    assert td.replace(dilatancy=0.0) == tc
    params, _, grid, state = _jax_bed()
    tp, _, tg, ts = _port(params, crm, grid, state)
    tp = tp.replace(rebuild_every=1)
    for advance in (t_crm.make_crm_advance_fn, make_crm_advance_pencil):
        a, b = (advance(tp, soil, tg, device="cpu")(ts, 1)[0]
                for soil in (tc, td))
        for f in ("pos", "vel", "rho", "tau_d", "tau_o"):
            assert torch.equal(getattr(a, f), getattr(b, f))
        assert not torch.equal(a.vel, ts.vel)
