"""PyTorch port (chrono_tpu_torch) vs the JAX package: every DEM boundary
kind, the general wall pass and the cell-dense forces path.

Same inputs, made from a numpy seed, go through the JAX functions and their
port counterparts on the CPU.  The contact geometry is held within 1e-6; the
wall pass and the three-cycle advances at the tolerances that
tests/test_pallas_kernel.py holds the JAX backends to.

The pair pass of the forces path, ``dem_forces``, is held here to one
interpret-mode call of the TPU kernel of the ``pallas`` backend,
``dem_cell_forces_pallas`` (with friction; tests/test_torch_dem_backends.py
holds it to ``dem_pencil_forces_pallas`` without).

The JAX ``cone_contacts`` handles one particle at a time: for N > 1 it
concatenates an (N, B, 2) with a (1, B, 1) array and raises.  So the JAX
side of every cone comparison maps that function over the particles with
``jax.vmap``; the JAX package itself is not changed.
"""

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from chrono_tpu.dem import bc as jbc
from chrono_tpu.dem import forces as jforces
from chrono_tpu.dem.cell_dense import (
    make_cell_dense_advance, pallas_cell_forces, to_cells,
)
from chrono_tpu.dem.params import DEMMaterial, DEMParams
from chrono_tpu.dem.system import _n_walls
from chrono_tpu.ops.pallas.dem_cell_kernel import edge_ok_table

from chrono_tpu_torch import convert
from chrono_tpu_torch.dem import bc as t_bc
from chrono_tpu_torch.dem import cell_dense as t_cd
from chrono_tpu_torch.dem.forces import wall_forces

from chip_smoke import five_kind_scene, five_kind_walls
from test_torch_cell_dense import leaves
from test_torch_dem_backends import assert_slot_forces, kernel_scene

R = 0.05
GEOM_TOL = dict(rtol=1e-6, atol=1e-6)
POS_TOL = dict(rtol=1e-4, atol=1e-5)
VEL_TOL = dict(rtol=1e-3, atol=1e-4)
JAX_KINDS = {"planes": jbc.PlaneBCs, "cylinders": jbc.CylinderBCs,
             "spheres": jbc.SphereBCs, "cones": jbc.ConeBCs,
             "wheels": jbc.WheelBCs}


def _cone_contacts_per_particle(bc, pos, radius):
    """The JAX cone contact, one particle at a time."""
    one = jax.vmap(lambda p: jbc.cone_contacts(bc, p[None], radius))(pos)
    return jbc.BCContact(*(a[:, 0] for a in one))


@pytest.fixture
def jax_cones(monkeypatch):
    monkeypatch.setattr(jforces, "cone_contacts",
                        _cone_contacts_per_particle)


def _jax_bcs(walls):
    return jbc.DEMBoundaries(**{
        k: JAX_KINDS[k](**{f: jnp.asarray(v) for f, v in walls[k].items()})
        for k in walls})


def _unit(rng, n):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def _walls(rng):
    """Two walls of each kind: planes with moving surfaces, cylinders,
    spheres, a cone opening +z and one opening −z, two spinning wheels."""
    f32 = np.float32
    return {
        "planes": {"point": rng.uniform(-0.2, 0.2, (2, 3)).astype(f32),
                   "normal": _unit(rng, 2),
                   "vel": rng.normal(0, 0.3, (2, 3)).astype(f32)},
        "cylinders": {"center": np.array([[0.0, 0.0], [0.1, -0.05]], f32),
                      "radius": np.array([0.4, 0.25], f32),
                      "vel": rng.normal(0, 0.3, (2, 3)).astype(f32)},
        "spheres": {"center": np.array([[0.0, 0.1, 0.0], [-0.1, 0, 0.2]],
                                       f32),
                    "radius": np.array([0.15, 0.3], f32),
                    "vel": rng.normal(0, 0.3, (2, 3)).astype(f32)},
        "cones": {"apex": np.array([[0.0, 0.0, -0.4], [0.05, 0.0, 0.4]],
                                   f32),
                  "slope": np.array([1.2, -0.7], f32),
                  "vel": rng.normal(0, 0.3, (2, 3)).astype(f32)},
        "wheels": {"center": np.array([[0.0, 0.0, 0.0], [0.1, 0.1, -0.1]],
                                      f32),
                   "axis": _unit(rng, 2),
                   "radius": np.array([0.2, 0.12], f32),
                   "half_width": np.array([0.1, 0.15], f32),
                   "vel": rng.normal(0, 0.3, (2, 3)).astype(f32),
                   "omega": rng.normal(0, 8.0, (2, 3)).astype(f32)}}


def _points(rng, n=600):
    return rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)


def _jax_contact(kind, bc, pos):
    if kind == "cones":
        return _cone_contacts_per_particle(bc, pos, R)
    return {"planes": jbc.plane_contacts, "cylinders": jbc.cylinder_contacts,
            "spheres": jbc.sphere_bc_contacts,
            "wheels": jbc.wheel_contacts}[kind](bc, pos, R)


@pytest.mark.parametrize("kind", list(JAX_KINDS))
def test_contacts_match_jax(kind):
    """Gap, normal and surface velocity of 600 points against two walls of
    each kind, within 1e-6; the points fall inside, outside and across the
    surfaces (and on both sides of each branch of the wheel's distance)."""
    rng = np.random.default_rng(11)
    walls = _walls(rng)
    pos = _points(rng)
    ref = _jax_contact(kind, _jax_bcs(walls).__getattribute__(kind),
                       jnp.asarray(pos))
    bcs = convert.dem_boundaries_from_numpy(walls)
    got = t_bc.CONTACTS[kind](getattr(bcs, kind), torch.from_numpy(pos), R)
    for name, g, r in zip(("gap", "normal", "vel"), got, ref):
        assert tuple(g.shape) == r.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **GEOM_TOL,
                                   err_msg=f"{kind} {name}")
    gap = got.gap.numpy()
    assert (gap < -R).any() and (gap > R).any()      # inside and outside
    assert (np.abs(gap) < 0.5 * R).any()             # at the surface
    if kind == "wheels":
        # the rim: outside both the tread and the caps at once
        w = getattr(bcs, "wheels")
        d = torch.from_numpy(pos)[:, None] - w.center[None]
        ax = (d * w.axis[None]).sum(-1)
        rho = torch.linalg.norm(d - ax[..., None] * w.axis[None], dim=-1)
        rim = (rho > w.radius) & (ax.abs() > w.half_width)
        assert bool(rim.any()) and bool((~rim & (got.gap < 0)).any())
        assert float(got.vel.abs().max()) > 1.0       # the spin is in v


def test_cone_signs_and_reference_shape_fault():
    """A cone opening +z and one opening −z keep an axis point inside and
    push a point beyond the rim back; the JAX function raises for more
    than one particle (the reason the JAX side is mapped)."""
    walls = _walls(np.random.default_rng(11))
    cones = convert.dem_boundaries_from_numpy(walls).cones
    pts = torch.tensor([[0.0, 0.0, 0.0], [0.05, 0.0, 0.0], [0.9, 0.0, 0.0]])
    c = t_bc.cone_contacts(cones, pts, R)
    assert float(c.gap[0, 0]) > 0 and float(c.gap[1, 1]) > 0
    assert float(c.gap[2, 0]) < 0 and float(c.gap[2, 1]) < 0
    assert float(c.normal[2, 0, 2]) > 0 > float(c.normal[2, 1, 2])
    jcones = _jax_bcs(walls).cones
    with pytest.raises(TypeError):
        jbc.cone_contacts(jcones, jnp.asarray(pts.numpy()), R)


def test_boundaries_convert_and_count():
    walls = _walls(np.random.default_rng(11))
    bcs = convert.dem_boundaries_from_numpy(walls)
    assert t_bc.n_walls(bcs) == _n_walls(_jax_bcs(walls)) == 10
    assert bcs.kinds() == list(JAX_KINDS)
    for kind, leaf in walls.items():
        for f, v in leaf.items():
            np.testing.assert_array_equal(getattr(getattr(bcs, kind),
                                                  f).numpy(), v)
    part = convert.dem_boundaries_from_numpy({"spheres": walls["spheres"]})
    assert part.kinds() == ["spheres"] and t_bc.n_walls(part) == 2
    assert t_bc.n_walls(t_bc.DEMBoundaries()) == 0
    ref = leaves(jbc.conveyor_plane((0, 0, 0.1), (0, 0, 1), (0.5, 0, 0)))
    got = t_bc.conveyor_plane((0, 0, 0.1), (0, 0, 1), (0.5, 0, 0))
    for k in ("point", "normal", "vel"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), ref[k])


def _params(friction_mode, rolling_mode="none"):
    """Unequal μ: the walls' own material says 0.15, the particles' 0.6."""
    return DEMParams(
        radius=jnp.asarray(R), mass=jnp.asarray(0.8),
        material=DEMMaterial(youngs=jnp.asarray(2e7), mu_s=jnp.asarray(0.6)),
        wall_material=DEMMaterial(youngs=jnp.asarray(5e6),
                                  restitution=jnp.asarray(0.3),
                                  mu_s=jnp.asarray(0.15)),
        gravity=jnp.asarray([0.0, 0.0, -9.81]), dt=jnp.asarray(2e-5),
        friction_mode=friction_mode, rolling_mode=rolling_mode)


@pytest.mark.parametrize("friction_mode", ["frictionless", "single_step"])
def test_wall_forces_match_jax(jax_cones, friction_mode):
    """Force, torque and per-wall reactions of 600 particles against ten
    walls of five kinds.  Friction is capped at the particles' μ (0.6), as
    the JAX wall pass caps it; with the walls' μ (0.15) the answer moves."""
    rng = np.random.default_rng(12)
    walls = _walls(rng)
    pos = _points(rng)
    vel = rng.normal(0, 2.0, pos.shape).astype(np.float32)
    omega = rng.normal(0, 40.0, pos.shape).astype(np.float32)
    p = _params(friction_mode)
    jb = _jax_bcs(walls)
    f_ref, t_ref, _, (rf_ref, rt_ref) = jforces.wall_forces(
        p, jb, *(jnp.asarray(a) for a in (pos, vel, omega)),
        jnp.zeros((len(pos), 10, 3)))
    tp = convert.params_from_numpy(leaves(p))
    bcs = convert.dem_boundaries_from_numpy(walls)
    args = [torch.from_numpy(a) for a in (pos, vel, omega)]
    f, t, _, (rf, rt) = wall_forces(tp, bcs, *args)
    f_scale = float(jnp.abs(f_ref).max())
    assert f_scale > 0 and tuple(rf.shape) == (10, 3)
    t_atol = 1e-5 * max(float(jnp.abs(t_ref).max()), R * f_scale)
    np.testing.assert_allclose(f.numpy(), f_ref, rtol=1e-4,
                               atol=1e-5 * f_scale)
    np.testing.assert_allclose(t.numpy(), t_ref, rtol=1e-4, atol=t_atol)
    r_scale = float(jnp.abs(rf_ref).max())
    np.testing.assert_allclose(rf.numpy(), rf_ref, rtol=1e-4,
                               atol=1e-5 * r_scale)
    np.testing.assert_allclose(rt.numpy(), rt_ref, rtol=1e-4,
                               atol=1e-5 * max(float(jnp.abs(rt_ref).max()),
                                               r_scale))
    # every kind is touched
    n_b = [len(walls[k]["vel"]) for k in JAX_KINDS]
    touched = np.add.reduceat(np.abs(rf.numpy()).sum(1), np.cumsum(
        [0] + n_b[:-1]))
    assert (touched > 0).all()
    if friction_mode == "single_step":
        wall_mu = dataclasses.replace(tp.material,
                                      mu_s=tp.wall_material.mu_s)
        f2 = wall_forces(dataclasses.replace(tp, material=wall_mu), bcs,
                         *args)[0]
        assert not np.allclose(f2.numpy(), f_ref, rtol=1e-4,
                               atol=1e-5 * f_scale)
    else:
        assert float(t.abs().max()) <= t_atol      # no tangential force


def _wall_case(friction_mode, rolling_mode, force_model, seed):
    """600 particles against the ten walls of ``_walls`` with a random
    wall history (N, 10, 3) and rolling displacement: the JAX
    ``wall_forces`` and the port's outputs, the same inputs."""
    rng = np.random.default_rng(seed)
    walls = _walls(rng)
    pos = _points(rng)
    vel = rng.normal(0, 2.0, pos.shape).astype(np.float32)
    omega = rng.normal(0, 40.0, pos.shape).astype(np.float32)
    hist = rng.normal(0, 1e-4, (len(pos), 10, 3)).astype(np.float32)
    roll = rng.normal(0, 1e-3, (len(pos), 10, 3)).astype(np.float32)
    p = _params(friction_mode, rolling_mode).replace(
        force_model=force_model,
        material=DEMMaterial(youngs=jnp.asarray(2e7), mu_s=jnp.asarray(0.6),
                             mu_r=jnp.asarray(0.3), kn=jnp.asarray(3e5),
                             gn=jnp.asarray(30.0), kt=jnp.asarray(2e5),
                             gt=jnp.asarray(10.0)),
        wall_material=DEMMaterial(youngs=jnp.asarray(5e6),
                                  restitution=jnp.asarray(0.3),
                                  mu_s=jnp.asarray(0.15),
                                  mu_r=jnp.asarray(0.1), kn=jnp.asarray(4e5),
                                  gn=jnp.asarray(20.0), kt=jnp.asarray(3e5),
                                  gt=jnp.asarray(15.0)))
    ep = rolling_mode == "elastic_plastic"
    ref = jforces.wall_forces(
        p, _jax_bcs(walls), *(jnp.asarray(a) for a in (pos, vel, omega)),
        jnp.asarray(hist), jnp.asarray(roll) if ep else None)
    got = wall_forces(convert.params_from_numpy(leaves(p)),
                      convert.dem_boundaries_from_numpy(walls),
                      *(torch.from_numpy(a) for a in (pos, vel, omega)),
                      torch.from_numpy(hist),
                      torch.from_numpy(roll) if ep else None)
    return ref, got


def test_wall_forces_refuse_history_and_rolling(jax_cones):
    """What the wall pass refused (multi-step history, rolling, the user
    model) now runs and matches JAX, the JAX 4-tuple without and the
    5-tuple with an elastic–plastic rolling state; with no walls the pass
    gives zeros, empty reactions and the history as it came."""
    ref, got = _wall_case("multi_step", "elastic_plastic", "user", 6)
    assert len(ref) == len(got) == 5
    f_scale = float(jnp.abs(ref[0]).max())
    np.testing.assert_allclose(got[0].numpy(), ref[0], rtol=1e-4,
                               atol=1e-5 * f_scale)
    np.testing.assert_allclose(got[4].numpy(), ref[4], rtol=1e-4,
                               atol=1e-5 * float(jnp.abs(ref[4]).max()))
    tp = convert.params_from_numpy(leaves(_params("single_step",
                                                  "schwartz")))
    assert tp.rolling_mode == "schwartz"
    z = torch.zeros((4, 3))
    h = torch.ones((4, 0, 3))
    f, t, xi, (rf, _) = wall_forces(tp, t_bc.DEMBoundaries(), z, z, z, h)
    assert f.abs().max() == 0 and tuple(rf.shape) == (0, 3) and xi is h


@pytest.mark.parametrize("friction_mode,rolling_mode,force_model", [
    ("multi_step", "none", "mat_based"),
    ("multi_step", "schwartz", "mat_based"),
    ("single_step", "elastic_plastic", "mat_based"),
    ("frictionless", "schwartz", "user"),
    ("multi_step", "elastic_plastic", "user")])
def test_wall_history_and_rolling_match_jax(jax_cones, friction_mode,
                                            rolling_mode, force_model):
    """Force, torque, new wall history, reactions (and the new wall
    rolling displacement) of ``_wall_case`` at the wall pass's
    tolerances; the history and the displacement at rtol 1e-4 and 1e-5 of
    their largest entry."""
    ref, got = _wall_case(friction_mode, rolling_mode, force_model, 7)
    assert len(got) == len(ref)
    f_scale = float(jnp.abs(ref[0]).max())
    assert f_scale > 0
    np.testing.assert_allclose(got[0].numpy(), ref[0], rtol=1e-4,
                               atol=1e-5 * f_scale)
    t_atol = 1e-5 * max(float(jnp.abs(ref[1]).max()), R * f_scale)
    np.testing.assert_allclose(got[1].numpy(), ref[1], rtol=1e-4,
                               atol=t_atol)
    rows = [(got[2], ref[2])] + ([(got[4], ref[4])] if len(ref) == 5
                                 else [])
    for g, r in rows:
        scale = max(float(jnp.abs(r).max()), 1e-30)
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-4,
                                   atol=1e-5 * scale)
    for g, r in zip(got[3], ref[3]):
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-4,
                                   atol=1e-5 * max(float(jnp.abs(r).max()),
                                                   f_scale))
    if friction_mode == "frictionless":
        assert not got[2].any()


@functools.cache
def _jax_five_kind_advance():
    params, _, _, pos, C = five_kind_scene()
    jp = DEMParams(
        radius=jnp.asarray(params.radius), mass=jnp.asarray(params.mass),
        material=DEMMaterial(mu_s=jnp.asarray(params.material.mu_s)),
        wall_material=DEMMaterial(
            mu_s=jnp.asarray(params.wall_material.mu_s)),
        gravity=jnp.asarray(params.gravity), dt=jnp.asarray(params.dt),
        friction_mode=params.friction_mode,
        rebuild_every=params.rebuild_every)
    from chrono_tpu.collision.cell_list import GridSpec
    grid = GridSpec(origin=(0.0, 0.0, 0.0), cell_size=0.13, dims=(4, 4, 4))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jforces, "cone_contacts", _cone_contacts_per_particle)
        adv = make_cell_dense_advance(jp, _jax_bcs(five_kind_walls()), grid,
                                      capacity=C, backend="xla")
        z = jnp.zeros(pos.shape)
        out = adv(jnp.asarray(pos), z, z, 3)
    assert int(out[3]) == 0
    return jp, tuple(np.asarray(a) for a in out[:3])


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_forces_path_five_kinds_matches_jax(backend):
    """3 cycles × 4 substeps with a conveyor floor, a cylinder, a cone, a
    sphere and a sinking spinning wheel, single-step friction with unequal
    μ: the port's forces path tracks the JAX ``xla`` backend."""
    _, bcs, grid, pos, C = five_kind_scene()
    jp, (px, vx, ox) = _jax_five_kind_advance()
    params = convert.params_from_numpy(leaves(jp))
    adv = t_cd.make_cell_dense_advance(params, bcs, grid, capacity=C,
                                       backend=backend, device="cpu")
    z = np.zeros_like(pos)
    p, v, o, ovf = adv(pos, z, z, 3)
    assert int(ovf) == 0
    assert np.abs(vx).max() > 0.1 and np.abs(ox).max() > 1.0
    np.testing.assert_allclose(p.numpy(), px, **POS_TOL)
    np.testing.assert_allclose(v.numpy(), vx, **VEL_TOL)
    np.testing.assert_allclose(o.numpy(), ox, **VEL_TOL)


def test_forces_match_cell_forces_kernel():
    """``dem_forces``'s twin, per slot, against one interpret-mode call of
    ``dem_cell_forces_pallas`` (B = 16) with single-step friction on the
    scene of tests/test_pallas_kernel.py ``_scene``."""
    params, bcs, grid, pos, vel, omega = kernel_scene("single_step")
    field = to_cells(grid, 8, *(jnp.asarray(a) for a in (pos, vel, omega)))
    assert int(field.overflow) == 0
    f_ref, t_ref = pallas_cell_forces(params, grid, field,
                                      edge_ok_table(grid.dims), B=16,
                                      interpret=True)
    assert_slot_forces(t_cd.cell_dense_forces, params, bcs, grid,
                       (pos, vel, omega), f_ref, t_ref)
