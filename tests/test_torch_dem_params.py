"""PyTorch port (chrono_tpu_torch) vs the JAX package: DEM parameters,
coefficients, sampler, grid binning and box walls on identical inputs."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from chrono_tpu.collision.cell_list import GridSpec, cell_ijk
from chrono_tpu.dem.bc import box_boundaries
from chrono_tpu.dem.cell_dense import pallas_static_coefs, wall_static_coefs
from chrono_tpu.dem.params import DEMMaterial, DEMParams, hertz_coefficients
from chrono_tpu.utils.samplers import grid_sample_box

from chrono_tpu_torch import convert
from chrono_tpu_torch.collision import cell_list as t_cell_list
from chrono_tpu_torch.dem import bc as t_bc
from chrono_tpu_torch.dem import cell_dense as t_cell_dense
from chrono_tpu_torch.dem import params as t_params
from chrono_tpu_torch.utils import samplers as t_samplers


def leaves(obj):
    """A JAX pytree dataclass → mapping of numpy arrays / Python scalars."""
    if dataclasses.is_dataclass(obj):
        return {f.name: leaves(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, (str, int, float, bool, tuple)):
        return obj
    return np.asarray(obj)


def _params(friction_mode):
    mat = DEMMaterial(youngs=jnp.asarray(2e7), poisson=jnp.asarray(0.25),
                      restitution=jnp.asarray(0.4), mu_s=jnp.asarray(0.3))
    wall = DEMMaterial(youngs=jnp.asarray(5e6), poisson=jnp.asarray(0.3),
                       restitution=jnp.asarray(0.6), mu_s=jnp.asarray(0.5))
    return DEMParams(
        radius=jnp.asarray(0.005), mass=jnp.asarray(1.3e-3), material=mat,
        wall_material=wall, gravity=jnp.asarray([0.0, 0.0, -9.81]),
        dt=jnp.asarray(2e-6), friction_mode=friction_mode, rebuild_every=7)


def test_hertz_coefficients_match():
    p = _params("single_step")
    tp = convert.params_from_numpy(leaves(p))
    for m_eff, r_eff in ((0.5 * p.mass, 0.5 * p.radius), (p.mass, p.radius)):
        ref = hertz_coefficients(p.material, m_eff, r_eff)
        got = t_params.hertz_coefficients(tp.material, float(m_eff),
                                          float(r_eff))
        np.testing.assert_allclose(got, np.asarray(ref, np.float64),
                                   rtol=1e-6)


@pytest.mark.parametrize("friction_mode", ["frictionless", "single_step"])
def test_static_coefs_match(friction_mode):
    p = _params(friction_mode)
    tp = convert.params_from_numpy(leaves(p))
    for ref, got in ((pallas_static_coefs(p),
                      t_cell_dense.pallas_static_coefs(tp)),
                     (wall_static_coefs(p),
                      t_cell_dense.wall_static_coefs(tp))):
        assert ref.keys() == got.keys()
        for k in ref:
            if isinstance(ref[k], bool):
                assert got[k] == ref[k]
            else:
                np.testing.assert_allclose(got[k], ref[k], rtol=1e-6,
                                           err_msg=k)
    assert tp.rebuild_every == 7
    np.testing.assert_allclose(tp.inertia, float(p.inertia), rtol=1e-6)


def test_grid_sample_box_bit_identical():
    args = ((0.005, 0.005, 0.005), (0.3, 0.2, 0.5), 0.0105)
    for kw in ({}, {"jitter": 0.03, "seed": 0}, {"jitter": 0.1, "seed": 9}):
        ref = grid_sample_box(*args, **kw)
        got = t_samplers.grid_sample_box(*args, **kw)
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)


def test_cell_ijk_and_index_match():
    rng = np.random.default_rng(2)
    grid = GridSpec(origin=(0.005, -0.01, 0.02), cell_size=0.021,
                    dims=(7, 5, 9))
    # inside, outside (clamped) and exactly on cell faces
    pos = rng.uniform(-0.05, 0.25, (4000, 3)).astype(np.float32)
    faces = (np.asarray(grid.origin)
             + grid.cell_size * rng.integers(0, 6, (500, 3)))
    pos = np.concatenate([pos, faces.astype(np.float32)])
    tgrid = convert.grid_from_numpy(leaves(grid))
    ref = np.asarray(cell_ijk(grid, jnp.asarray(pos)))
    got = t_cell_list.cell_ijk(tgrid, torch.from_numpy(pos)).numpy()
    np.testing.assert_array_equal(got, ref)
    lin = t_cell_list.cell_index(tgrid, torch.from_numpy(pos)).numpy()
    np.testing.assert_array_equal(
        lin, (ref[:, 0] * 5 + ref[:, 1]) * 9 + ref[:, 2])


def test_periodic_grid_raises():
    """A periodic grid is a grid (the neighbour lists wrap it); the DEM
    cell-slot and row paths run non-periodic boxes only and refuse it."""
    grid = t_cell_list.GridSpec(periodic=(True, False, False))
    pos = torch.zeros((4, 3))
    with pytest.raises(NotImplementedError, match="periodic grids"):
        t_cell_dense.to_cells(grid, 8, pos, pos, pos)


def test_box_boundaries_match():
    lo, hi = (0.0, -0.1, 0.2), (1.071, 0.9, 1.7136)
    ref = leaves(box_boundaries(lo, hi))
    got = t_bc.box_boundaries(lo, hi)
    conv = convert.planes_from_numpy(ref)
    for k in ("point", "normal", "vel"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), ref[k])
        np.testing.assert_array_equal(getattr(conv, k).numpy(), ref[k])
