"""PyTorch port (chrono_tpu_torch) vs the JAX package: cell binning and
the fused DEM substep on identical inputs, and the port's overflow and
particle-loss reports.

On the CPU the port's kernels run their plain twins; the JAX side runs its
TPU substep kernel in interpret mode.  Tolerances are the ones the JAX
package holds its own backends to (tests/test_pallas_kernel.py): fp32 pair
sums are taken in another order.  The scene helpers here are shared with
test_torch_advance.py.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from chrono_tpu.collision.cell_list import GridSpec
from chrono_tpu.dem.bc import DEMBoundaries, box_boundaries
from chrono_tpu.dem.cell_dense import (
    field_to_flat, flat_to_particles, pallas_static_coefs, to_cells,
    wall_static_coefs,
)
from chrono_tpu.dem.params import DEMMaterial, DEMParams
from chrono_tpu.ops.pallas.dem_flat_kernel import dem_flat_substep_pallas

from chrono_tpu_torch import convert
from chrono_tpu_torch.collision.cell_list import GridSpec as TGridSpec
from chrono_tpu_torch.dem import bc as t_bc
from chrono_tpu_torch.dem import cell_dense as t_cd
from chrono_tpu_torch.dem.params import DEMParams as TDEMParams
from chrono_tpu_torch.ops.cuda.dem_substep import dem_substep_plain

CELL = 0.13


def leaves(obj):
    """A JAX pytree dataclass → mapping of numpy arrays / Python scalars."""
    if dataclasses.is_dataclass(obj):
        return {f.name: leaves(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, (str, int, float, bool, tuple)):
        return obj
    return np.asarray(obj)


def _scene(seed, friction_mode="single_step"):
    """The 120-particle box of test_flat_advance_parity (seed 7) and
    test_flat_migrate_parity (seed 11): grid (5, 4, 3), 4 substeps/cycle."""
    rng = np.random.default_rng(seed)
    dims = (5, 4, 3)
    n = 120
    pos = np.stack([rng.uniform(0.07, d * CELL - 0.07, n) for d in dims],
                   axis=1).astype(np.float32)
    params = DEMParams(
        radius=jnp.asarray(0.05), mass=jnp.asarray(1.0),
        material=DEMMaterial(), wall_material=DEMMaterial(),
        gravity=jnp.asarray([0.0, 0.0, -9.81]), dt=jnp.asarray(2e-5),
        friction_mode=friction_mode, rebuild_every=4)
    bcs = DEMBoundaries(planes=box_boundaries(
        (0, 0, 0), tuple(d * CELL for d in dims)))
    grid = GridSpec(origin=(0.0, 0.0, 0.0), cell_size=CELL, dims=dims)
    return pos, params, bcs, grid


def _port(params, bcs, grid):
    return (convert.params_from_numpy(leaves(params)),
            t_bc.DEMBoundaries(planes=convert.planes_from_numpy(
                leaves(bcs.planes))),
            convert.grid_from_numpy(leaves(grid)))


def _slot_rows(feat, f0, n_cells, C):
    return feat[f0:f0 + 3].permute(1, 2, 0).reshape(n_cells, C, 3).numpy()


@pytest.mark.parametrize("C", [16, 3])
def test_to_cells_matches_jax_and_round_trips(C):
    """Same per-cell occupancy, overflow and slot order as JAX (C = 16
    fits, C = 3 overflows), and an exact from_cells round trip."""
    pos, params, bcs, grid = _scene(7)
    rng = np.random.default_rng(1)
    vel = rng.normal(0, 0.1, pos.shape).astype(np.float32)
    tgrid = _port(params, bcs, grid)[2]
    n_cells = grid.n_cells
    ref = to_cells(grid, C, jnp.asarray(pos), jnp.asarray(vel),
                   jnp.zeros_like(jnp.asarray(vel)))
    got = t_cd.to_cells(tgrid, C, torch.from_numpy(pos),
                        torch.from_numpy(vel), torch.zeros(pos.shape))
    count = np.bincount(np.asarray(ref.perm) // C, minlength=n_cells)
    occ = got.feat[9].reshape(n_cells, C).sum(-1).numpy()
    np.testing.assert_array_equal(occ, np.minimum(count, C))
    assert int(got.overflow) == int(ref.overflow) == max(count.max() - C, 0)
    np.testing.assert_array_equal(got.perm.numpy(), np.asarray(ref.perm))
    if C == 3:
        # JAX leaves the overflowing cells' last slot unspecified
        assert int(got.overflow) > 0
        return
    np.testing.assert_array_equal(
        np.asarray(ref.mask).reshape(n_cells, C).sum(-1), occ)
    # the same stable order inside each cell → identical slots
    np.testing.assert_array_equal(_slot_rows(got.feat, 0, n_cells, C),
                                  np.asarray(ref.pos).reshape(n_cells, C, 3))
    p2, v2 = t_cd.from_cells(got, got.feat[0:3], got.feat[3:6])
    np.testing.assert_array_equal(p2.numpy(), pos)
    np.testing.assert_array_equal(v2.numpy(), vel)
    ids = got.ids.reshape(-1).numpy()
    assert sorted(ids[ids >= 0]) == list(range(len(pos)))


def test_plain_substep_matches_tpu_kernel():
    """One substep of the port's plain twin vs the TPU kernel itself
    (dem_flat_substep_pallas in interpret mode), per particle, with
    single-step friction.  C = 8 (no cell of the scene holds more than 6)
    and one row block keep the interpret-mode compile short; the
    frictionless form is held against JAX in test_torch_advance.py."""
    pos, params, bcs, grid = _scene(7, "single_step")
    rng = np.random.default_rng(3)
    vel = rng.normal(0, 0.1, pos.shape).astype(np.float32)
    omega = rng.normal(0, 0.5, pos.shape).astype(np.float32)
    C = 8
    nx, ny, nz = grid.dims

    field = to_cells(grid, C, jnp.asarray(pos), jnp.asarray(vel),
                     jnp.asarray(omega))
    SZ = nz + 1
    NL = ((ny * SZ + SZ + 1 + 127) // 128) * 128
    wc = wall_static_coefs(params)
    pn = np.asarray(bcs.planes.normal, float)
    pp = np.asarray(bcs.planes.point, float)
    walls = tuple((tuple(pn[b]), float(pn[b] @ pp[b]), (0.0, 0.0, 0.0))
                  for b in range(6))
    out = dem_flat_substep_pallas(
        field_to_flat(field, SZ, NL), grid_dims=grid.dims, SZ=SZ, C=C,
        Bxy=8, interpret=True, **pallas_static_coefs(params), walls=walls,
        wall_coefs=(wc["knw"], wc["gnw"], wc["ktw"], wc["gtw"], wc["muw"]),
        gravity=(0.0, 0.0, -9.81), inv_m=1.0,
        inv_I=1.0 / float(params.inertia))
    ref = [np.asarray(a) for a in
           flat_to_particles(out, field, grid.dims, C, SZ)]

    tparams, tbcs, tgrid = _port(params, bcs, grid)
    tfield = t_cd.to_cells(tgrid, C, *(torch.from_numpy(a)
                                       for a in (pos, vel, omega)))
    nxt = dem_substep_plain(tfield.feat,
                            t_cd.substep_coefs(tparams, tbcs, tgrid, C))
    got = [a.numpy() for a in
           t_cd.from_cells(tfield, nxt[0:3], nxt[3:6], nxt[6:9])]
    assert np.abs(ref[1] - vel).max() > 1e-2       # contacts were resolved
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got[2], ref[2], rtol=1e-3, atol=1e-4)


def _line(dims, pos, vel, capacity, migrate, n_cycles=1):
    """Contact-free particles (tiny radius, no walls, no gravity) on a line
    of cells, 4 substeps of 1 ms per cycle."""
    params = TDEMParams(radius=1e-3, mass=1.0, gravity=(0.0, 0.0, 0.0),
                        dt=1e-3, rebuild_every=4,
                        friction_mode="single_step")
    grid = TGridSpec(origin=(0.0, 0.0, 0.0), cell_size=CELL, dims=dims)
    adv = t_cd.make_cell_dense_advance(params, t_bc.DEMBoundaries(), grid,
                                       capacity=capacity, migrate=migrate,
                                       device="cpu")
    pos = np.asarray(pos, np.float32)
    vel = np.asarray(vel, np.float32)
    return adv(pos, vel, np.zeros_like(pos), n_cycles)


@pytest.mark.parametrize("migrate", [False, True])
def test_overflow_reported(migrate):
    """Two particles per cell fit C = 2; after one cycle four land in the
    middle cell."""
    y, z = 0.05, 0.05
    pos = [(0.10, y, z), (0.17, y, z), (0.22, y, z), (0.30, y, z)]
    # outer two move into the middle cell (x ∈ [0.13, 0.26)) in 4 ms
    vel = [(12.0, 0, 0), (0, 0, 0), (0, 0, 0), (-12.0, 0, 0)]
    *_, ovf = _line((3, 1, 1), pos, vel, capacity=2, migrate=migrate,
                    n_cycles=1 if migrate else 2)
    assert int(ovf) == 2


def test_two_cell_jump_reported():
    """A particle that crosses two cells in one cycle is lost to the
    migration (ovf > 0); the sort rebin carries it."""
    pos = [(0.05, 0.05, 0.05), (0.45, 0.05, 0.05)]
    vel = [(70.0, 0, 0), (0, 0, 0)]         # 0.28 m = 2.15 cells in 4 ms
    *_, ovf = _line((5, 1, 1), pos, vel, capacity=8, migrate=True)
    assert int(ovf) == 1
    p, *_, ovf = _line((5, 1, 1), pos, vel, capacity=8, migrate=False)
    assert int(ovf) == 0
    np.testing.assert_allclose(p[0, 0].item(), 0.05 + 0.28, rtol=1e-5)
