"""PyTorch port (chrono_tpu_torch) vs the JAX package: the cell-dense DEM
backends ``sym``, ``pencil``, ``pallas`` and ``xla``.

The port runs kernel ``dem_forces`` (TPU rows ``dem_pencil_forces_pallas``
and ``dem_cell_forces_pallas``) and kernel K1 (TPU rows
``dem_sym_substep_pallas`` and ``dem_pencil_substep_pallas``); on the CPU
their plain twins.  Each TPU kernel is called once, in interpret mode, on
the scenes of tests/test_pallas_kernel.py and ``__graft_entry__.entry()``:
one interpret-mode compile costs 25–36 s on one CPU core, so the four calls
are spread over this file, tests/test_torch_dem_walls.py,
tests/test_torch_dem_sym.py and tests/test_torch_dem_pencil.py, which share
this file's helpers.  The three-cycle runs are held to the jitted JAX
``xla`` backend.  Tolerances are those of tests/test_pallas_kernel.py.
"""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from chrono_tpu.collision.cell_list import GridSpec
from chrono_tpu.dem.bc import DEMBoundaries, box_boundaries
from chrono_tpu.dem.cell_dense import (
    make_cell_dense_advance, pallas_pencil_forces, to_cells,
    wall_static_coefs,
)
from chrono_tpu.dem.params import DEMMaterial, DEMParams
from chrono_tpu.ops.pallas.dem_pencil_kernel import edge_ok_xy

from chrono_tpu_torch import convert
from chrono_tpu_torch.dem import bc as t_bc
from chrono_tpu_torch.dem import cell_dense as t_cd
from chrono_tpu_torch.ops.cuda.dem_substep import dem_substep_plain

from chip_smoke import five_kind_walls
from test_torch_cell_dense import leaves

POS_TOL = dict(rtol=1e-4, atol=1e-5)
VEL_TOL = dict(rtol=1e-3, atol=1e-4)
BOX = 0.52


def kernel_scene(friction_mode):
    """The 120-particle scene of tests/test_pallas_kernel.py ``_scene``
    (seed 5, 4 × 4 × 4 cells of 0.13 m, C = 8, no gravity), with box walls
    around it."""
    rng = np.random.default_rng(5)
    pos = rng.uniform(0.05, 0.47, (120, 3)).astype(np.float32)
    vel = rng.normal(0, 0.1, (120, 3)).astype(np.float32)
    omega = rng.normal(0, 0.5, (120, 3)).astype(np.float32)
    params = DEMParams(
        radius=jnp.asarray(0.05), mass=jnp.asarray(1.0),
        material=DEMMaterial(), wall_material=DEMMaterial(),
        gravity=jnp.zeros(3), dt=jnp.asarray(1e-5),
        friction_mode=friction_mode)
    grid = GridSpec(origin=(0.0, 0.0, 0.0), cell_size=0.13, dims=(4, 4, 4))
    bcs = DEMBoundaries(planes=box_boundaries((0, 0, 0), (BOX,) * 3))
    return params, bcs, grid, pos, vel, omega


def port(params, bcs, grid):
    walls = {k: leaves(getattr(bcs, k)) for k in t_bc.KINDS
             if getattr(bcs, k) is not None}
    return (convert.params_from_numpy(leaves(params)),
            convert.dem_boundaries_from_numpy(walls),
            convert.grid_from_numpy(leaves(grid)))


def fused_kw(params, bcs):
    """The static wall, gravity and mass arguments of the fused TPU
    substeps, built as ``make_cell_dense_advance`` builds them."""
    wc = wall_static_coefs(params)
    pn = np.asarray(bcs.planes.normal, float)
    pp = np.asarray(bcs.planes.point, float)
    pv = np.asarray(bcs.planes.vel, float)
    return dict(
        walls=tuple((tuple(pn[b]), float(pn[b] @ pp[b]), tuple(pv[b]))
                    for b in range(pn.shape[0])),
        wall_coefs=(wc["knw"], wc["gnw"], wc["ktw"], wc["gtw"], wc["muw"]),
        gravity=tuple(float(g) for g in np.asarray(params.gravity)),
        inv_m=1.0 / float(params.mass), inv_I=1.0 / float(params.inertia))


def assert_slot_forces(port_fn, params, bcs, grid, state, f_ref, t_ref):
    """The port's forces per slot against the JAX (nx, ny, nz, C, 3) ones,
    at test_pallas_kernel's bounds: rtol 1e-4, atol 1e-5 of the largest
    force, and for torques of the larger of the largest torque and r·F;
    empty slots must be exactly zero."""
    tparams, _, tgrid = port(params, bcs, grid)
    tfield = t_cd.to_cells(tgrid, 8, *(torch.from_numpy(a) for a in state))
    f, t = port_fn(tparams, tgrid, tfield.feat)

    def slots(a):        # (3, n_cells, C) → (n_cells, C, 3)
        return a.permute(1, 2, 0).numpy()

    f_ref = np.asarray(f_ref).reshape(grid.n_cells, 8, 3)
    t_ref = np.asarray(t_ref).reshape(grid.n_cells, 8, 3)
    f_scale = float(np.abs(f_ref).max())
    assert f_scale > 0
    np.testing.assert_allclose(slots(f), f_ref, rtol=1e-4,
                               atol=1e-5 * f_scale)
    t_atol = 1e-5 * max(float(np.abs(t_ref).max()),
                        tparams.radius * f_scale)
    np.testing.assert_allclose(slots(t), t_ref, rtol=1e-4, atol=t_atol)
    empty = tfield.feat[9].numpy() < 0.5
    assert empty.any() and not slots(f)[empty].any()


def test_forces_match_pencil_forces_kernel():
    """``dem_forces``'s twin, per slot, against one interpret-mode call of
    ``dem_pencil_forces_pallas`` (NZp = 128, Bxy = 4), frictionless; empty
    slots are zero on both sides.  (``dem_cell_forces_pallas`` with
    friction: tests/test_torch_dem_walls.py.)"""
    params, bcs, grid, pos, vel, omega = kernel_scene("frictionless")
    field = to_cells(grid, 8, *(jnp.asarray(a) for a in (pos, vel, omega)))
    assert int(field.overflow) == 0
    f_ref, t_ref = pallas_pencil_forces(params, grid, field,
                                        edge_ok_xy(grid.dims), nzp=128,
                                        Bxy=4, interpret=True)
    assert_slot_forces(t_cd.cell_dense_forces, params, bcs, grid,
                       (pos, vel, omega), f_ref, t_ref)


def per_particle_close(got, ref):
    np.testing.assert_allclose(got[0], ref[0], **POS_TOL)
    np.testing.assert_allclose(got[1], ref[1], **VEL_TOL)
    np.testing.assert_allclose(got[2], ref[2], **VEL_TOL)


def k1_substep(params, bcs, grid, pos, vel, omega):
    """One substep of K1's twin, per particle."""
    tparams, tbcs, tgrid = port(params, bcs, grid)
    tfield = t_cd.to_cells(tgrid, 8, *(torch.tensor(np.asarray(a))
                                       for a in (pos, vel, omega)))
    nxt = dem_substep_plain(tfield.feat,
                            t_cd.substep_coefs(tparams, tbcs, tgrid, 8))
    return [a.numpy() for a in
            t_cd.from_cells(tfield, nxt[0:3], nxt[3:6], nxt[6:9])]


def _advance_scene(friction_mode):
    """test_pallas_kernel's advance scene: 100 particles (seed 3) in a
    0.52 m box of 4³ cells, gravity, 4 substeps of 2e-5 s per cycle."""
    rng = np.random.default_rng(3)
    pos = rng.uniform(0.07, 0.45, (100, 3)).astype(np.float32)
    params = DEMParams(
        radius=jnp.asarray(0.05), mass=jnp.asarray(1.0),
        material=DEMMaterial(), wall_material=DEMMaterial(),
        gravity=jnp.asarray([0.0, 0.0, -9.81]), dt=jnp.asarray(2e-5),
        friction_mode=friction_mode, rebuild_every=4)
    bcs = DEMBoundaries(planes=box_boundaries((0, 0, 0), (BOX,) * 3))
    grid = GridSpec(origin=(0.0, 0.0, 0.0), cell_size=0.13, dims=(4, 4, 4))
    return params, bcs, grid, pos


@functools.cache
def _jax_xla(friction_mode):
    params, bcs, grid, pos = _advance_scene(friction_mode)
    adv = make_cell_dense_advance(params, bcs, grid, backend="xla")
    z = jnp.zeros(pos.shape)
    out = adv(jnp.asarray(pos), z, z, 3)
    assert int(out[3]) == 0
    return tuple(np.asarray(a) for a in out[:3])


@pytest.mark.parametrize("backend", ["sym", "pencil", "pallas", "xla"])
def test_advance_backends_match_jax_xla(backend):
    """3 cycles × 4 substeps with single-step friction through
    ``make_cell_dense_advance`` with each backend name (sym / pencil: K1
    with a sort rebin; pallas / xla: the forces path) against the JAX
    ``xla`` backend, at the tolerances of test_pencil_advance_backend_parity
    and test_sym_advance_parity.  (Frictionless: the K1 path in
    tests/test_torch_advance.py, the pair pass of the forces path in
    test_forces_match_pencil_forces_kernel.)"""
    friction_mode = "single_step"
    params, bcs, grid, pos = _advance_scene(friction_mode)
    adv = t_cd.make_cell_dense_advance(*port(params, bcs, grid),
                                       capacity=8, backend=backend,
                                       migrate=True, device="cpu")
    z = np.zeros_like(pos)
    p, v, o, ovf = adv(pos, z, z, 3)
    assert int(ovf) == 0
    px, vx, ox = _jax_xla(friction_mode)
    assert np.abs(vx).max() > 0.05
    per_particle_close([a.numpy() for a in (p, v, o)], (px, vx, ox))


@pytest.mark.parametrize("backend", ["flat", "sym", "pencil"])
@pytest.mark.parametrize("kind", ["cylinders", "spheres", "cones", "wheels"])
def test_fused_backends_refuse_other_walls(backend, kind):
    """The fused substep takes planes only: every other kind raises, wheels
    included (the JAX fused backends ignore wheels without a word)."""
    params, bcs, grid, _ = _advance_scene("single_step")
    tparams, tbcs, tgrid = port(params, bcs, grid)
    walls = {"planes": leaves(bcs.planes), kind: five_kind_walls()[kind]}
    with pytest.raises(ValueError, match=kind):
        t_cd.make_cell_dense_advance(
            tparams, convert.dem_boundaries_from_numpy(walls), tgrid,
            backend=backend, device="cpu")
    t_cd.make_cell_dense_advance(tparams, tbcs, tgrid, backend=backend,
                                 device="cpu")


def test_unknown_backend_and_forces_path_without_walls():
    params, bcs, grid, pos = _advance_scene("frictionless")
    tparams, _, tgrid = port(params, bcs, grid)
    with pytest.raises(ValueError, match="backend"):
        t_cd.make_cell_dense_advance(tparams, t_bc.DEMBoundaries(), tgrid,
                                     backend="gather", device="cpu")
    # no walls: free fall plus pair forces, which cancel pairwise
    adv = t_cd.make_cell_dense_advance(tparams, t_bc.DEMBoundaries(), tgrid,
                                       backend="pallas", device="cpu")
    z = np.zeros_like(pos)
    _, v, _, ovf = adv(pos, z, z, 1)
    t_sim = 4 * float(params.dt)
    np.testing.assert_allclose(v.double().mean(0).numpy(),
                               [0.0, 0.0, -9.81 * t_sim], rtol=1e-4,
                               atol=1e-7)
