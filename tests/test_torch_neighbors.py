"""PyTorch port (chrono_tpu_torch) vs the JAX package: periodic grids and
the neighbour lists of the gather backend.

``build_neighbor_list`` and ``migrate_history`` on seeded random positions,
non-periodic and periodic in x and y, with a cell over ``max_per_cell``
and a row over ``k_max``: the lists are held to JAX entry for entry
(``idx``, ``valid`` and both ``overflow`` terms).  Also the grid's own
helpers (``wrap_positions``, ``min_image``, ``compact_rows``), the
refusal of a periodic axis with fewer than 3 cells, and the refusals of a
periodic grid at the port's entry points that run non-periodic boxes
only.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from chrono_tpu.collision import cell_list as j_cl
from chrono_tpu.dem import neighbors as j_nb

from chrono_tpu_torch import convert
from chrono_tpu_torch.collision import cell_list as t_cl
from chrono_tpu_torch.collision import (
    CollisionModel, SphereShapes,
)
from chrono_tpu_torch.dem import neighbors as t_nb
from chrono_tpu_torch.dem.cell_dense import (
    make_cell_dense_advance, to_cells, to_rows,
)
from chrono_tpu_torch.dem.bc import box_boundaries
from chrono_tpu_torch.fsi.sph.crm import CRMParams
from chrono_tpu_torch.fsi.sph.crm_pencil import make_crm_engine
from chrono_tpu_torch.fsi.sph.pencil import make_sph_advance_pencil
from chrono_tpu_torch.fsi.sph.state import SPHParams
from chrono_tpu_torch.solver.nsc_pencil import (
    NSCPencilParams, make_nsc_pencil_advance,
)

GRIDS = {
    "box": dict(origin=(-0.1, 0.0, 0.05), cell_size=0.1, dims=(6, 5, 4),
                periodic=(False, False, False)),
    "periodic_xy": dict(origin=(0.0, -0.2, 0.0), cell_size=0.1,
                        dims=(5, 4, 6), periodic=(True, True, False)),
    "periodic_xyz": dict(origin=(0.0, 0.0, 0.0), cell_size=0.1,
                         dims=(3, 4, 3), periodic=(True, True, True)),
}

# about 20 neighbours a marker within one cell's length
N_MARKERS = {"box": 600, "periodic_xy": 600, "periodic_xyz": 180}


def _grids(name):
    g = GRIDS[name]
    return j_cl.GridSpec(**g), t_cl.GridSpec(**g)


def _positions(grid_kw, n, seed, clump=0):
    """Seeded positions over the grid's box and past it by a cell (the
    clamped edge cells fill up), with ``clump`` markers in one cell."""
    rng = np.random.default_rng(seed)
    lo = np.asarray(grid_kw["origin"])
    L = np.asarray(grid_kw["dims"]) * grid_kw["cell_size"]
    pos = rng.uniform(lo - 0.3 * grid_kw["cell_size"],
                      lo + L + 0.3 * grid_kw["cell_size"], (n, 3))
    if clump:
        c = lo + grid_kw["cell_size"] * np.array([1.5, 1.5, 1.5])
        pos[:clump] = c + rng.uniform(-0.04, 0.04, (clump, 3))
    # inside the period on periodic axes, as the solvers wrap them
    per = np.asarray(grid_kw["periodic"])
    pos = np.where(per, lo + np.mod(pos - lo, L), pos)
    return pos.astype(np.float32)


# one jitted JAX build: calls with the same grid and capacities share its
# compile
J_BUILD = jax.jit(j_nb.build_neighbor_list, static_argnums=(0, 3, 4))


@functools.cache
def _jax_list(name, n, seed, clump, cutoff, max_per_cell, k_max):
    pos = _positions(GRIDS[name], n, seed, clump)
    return J_BUILD(_grids(name)[0], jnp.asarray(pos), cutoff, max_per_cell,
                   k_max), pos


def _lists(name, n=600, seed=1, clump=0, cutoff=0.1, max_per_cell=24,
           k_max=40, chunk=None):
    ref, pos = _jax_list(name, n, seed, clump, cutoff, max_per_cell, k_max)
    got = t_nb.build_neighbor_list(_grids(name)[1], torch.from_numpy(pos),
                                   cutoff, max_per_cell, k_max, chunk=chunk)
    return ref, got, pos


def _assert_same_list(got, ref):
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(ref.idx))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    assert int(got.overflow) == int(ref.overflow)
    assert got.idx.dtype == torch.int32
    assert got.overflow.dtype == torch.int32


@pytest.mark.parametrize("name", list(GRIDS))
@pytest.mark.parametrize("chunk", [None, 97])
def test_neighbor_list_matches_jax(name, chunk):
    """No capacity overflows: the same list, in chunks of 97 markers or in
    one, and every pair within the cutoff (minimum image) is in it."""
    ref, got, pos = _lists(name, n=N_MARKERS[name], chunk=chunk)
    assert int(ref.overflow) == 0
    _assert_same_list(got, ref)
    # against all pairs, in the same float32 arithmetic
    tg = _grids(name)[1]
    p = torch.from_numpy(pos)
    d = t_cl.min_image(tg, p[:, None, :] - p[None, :, :])
    near = (torch.sum(d * d, dim=-1) < 0.1 ** 2) & ~torch.eye(len(pos),
                                                             dtype=bool)
    counts = got.valid.sum(1)
    assert torch.equal(counts, near.sum(1))
    assert int(counts.max()) > 5


@pytest.mark.parametrize("name", ["box", "periodic_xy"])
def test_overflow_terms_match_jax(name):
    """A 60-marker clump overflows a cell (``max_per_cell`` 24) and its
    rows overflow ``k_max`` 40: both overflow terms, and the truncated
    rows, as the JAX package has them."""
    for k_max, clump in ((40, 0), (40, 60), (200, 60)):
        ref, got, _ = _lists(name, clump=clump, k_max=k_max, seed=3)
        _assert_same_list(got, ref)
    assert int(ref.overflow) >= 60 - 24             # the cell term
    ref, got, _ = _lists(name, clump=20, k_max=12, seed=3)
    assert int(ref.overflow) > 0
    _assert_same_list(got, ref)


def test_migrate_history_matches_jax():
    """History carried from a list to the next one (the markers moved),
    with a slot count that changes between them."""
    jg, tg = _grids("periodic_xy")
    rng = np.random.default_rng(7)
    pos0 = _positions(GRIDS["periodic_xy"], 500, 7)
    pos1 = (pos0 + rng.normal(0, 0.01, pos0.shape)).astype(np.float32)
    j_old = J_BUILD(jg, jnp.asarray(pos0), 0.1, 24, 40)
    j_new = J_BUILD(jg, jnp.asarray(pos1), 0.1, 24, 48)
    hist = rng.normal(size=(500, 40, 3)).astype(np.float32)
    ref = jax.jit(j_nb.migrate_history)(j_old, jnp.asarray(hist), j_new)
    t_old = t_nb.build_neighbor_list(tg, torch.from_numpy(pos0), 0.1, 24, 40)
    t_new = t_nb.build_neighbor_list(tg, torch.from_numpy(pos1), 0.1, 24, 48)
    _assert_same_list(t_new, j_new)
    got = t_nb.migrate_history(t_old, torch.from_numpy(hist), t_new)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert float(got.abs().sum()) > 0.0
    conv = convert.neighbor_list_from_numpy(
        {f.name: np.asarray(getattr(j_new, f.name))
         for f in dataclasses.fields(j_new)}, device="cpu")
    _assert_same_list(conv, j_new)


def test_grid_helpers_match_jax():
    """``wrap_positions``, ``min_image`` (half-way displacements round to
    even, as ``jnp.round``), ``compact_rows`` and the neighbour cells."""
    jg, tg = _grids("periodic_xy")
    rng = np.random.default_rng(2)
    pos = rng.uniform(-1.0, 1.5, (300, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        t_cl.wrap_positions(tg, torch.from_numpy(pos)).numpy(),
        np.asarray(j_cl.wrap_positions(jg, jnp.asarray(pos))))
    d = np.concatenate([rng.uniform(-1.0, 1.0, (300, 3)),
                        [[0.25, 0.2, 0.3], [-0.25, -0.2, 0.0]]]
                       ).astype(np.float32)
    np.testing.assert_array_equal(
        t_cl.min_image(tg, torch.from_numpy(d)).numpy(),
        np.asarray(j_cl.min_image(jg, jnp.asarray(d))))
    box = t_cl.GridSpec(**GRIDS["box"])
    assert torch.equal(t_cl.min_image(box, torch.from_numpy(d)),
                       torch.from_numpy(d))
    assert tg.lengths == jg.lengths
    cand = rng.integers(0, 50, (40, 30)).astype(np.int32)
    valid = rng.uniform(size=(40, 30)) < 0.4
    for k in (5, 30):
        ri, rv = j_cl.compact_rows(jnp.asarray(cand), jnp.asarray(valid), k)
        gi, gv = t_cl.compact_rows(torch.from_numpy(cand),
                                   torch.from_numpy(valid), k)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(rv))


def test_periodic_axis_with_fewer_than_3_cells_raises():
    g = dict(GRIDS["periodic_xy"], dims=(2, 4, 6))
    pos = torch.from_numpy(_positions(g, 50, 4))
    with pytest.raises(ValueError, match="needs >=3 cells"):
        t_nb.build_neighbor_list(t_cl.GridSpec(**g), pos, 0.1, 8, 16)
    with pytest.raises(ValueError, match="needs >=3 cells"):
        j_nb.build_neighbor_list(j_cl.GridSpec(**g), jnp.asarray(pos.numpy()),
                                 0.1, 8, 16)


def test_non_periodic_paths_refuse_a_periodic_grid():
    """The cell-sorted SPH and CRM engines (the JAX package refuses
    them too), the DEM cell-slot and row paths, the NSC pencil and the
    contact pipeline run non-periodic boxes only."""
    tg = t_cl.GridSpec(**GRIDS["periodic_xy"])
    sph = SPHParams(d0=0.02, h=0.024, rho0=1000.0, mu=1e-3, c_s=10.0,
                    gravity=(0.0, 0.0, -9.81), dt=1e-4)
    pos = torch.zeros((4, 3))
    calls = [
        lambda: make_sph_advance_pencil(sph, tg, device="cpu"),
        lambda: make_crm_engine(sph, CRMParams(), tg, device="cpu"),
        lambda: to_cells(tg, 8, pos, pos, pos),
        lambda: to_rows(tg, 8, pos, pos, pos),
        lambda: make_nsc_pencil_advance(
            NSCPencilParams(radius=0.01, mass=1e-3, mu=0.5, dt=1e-3,
                            gravity=(0.0, 0.0, -9.81)),
            tg, (), device="cpu"),
        lambda: CollisionModel(
            spheres=SphereShapes(body=torch.zeros(1, dtype=torch.int32),
                                 offset=torch.zeros((1, 3)),
                                 radius=torch.ones(1),
                                 mu=torch.ones(1)),
            boxes=None, grid=tg),
    ]
    for call in calls:
        with pytest.raises(NotImplementedError, match="periodic grids"):
            call()
    from chrono_tpu_torch.dem.params import DEMMaterial, DEMParams
    mat = DEMMaterial(youngs=1e7, poisson=0.3, restitution=0.5, mu_s=0.5)
    dem = DEMParams(radius=0.01, mass=1e-3, material=mat,
                    wall_material=mat, gravity=(0.0, 0.0, -9.81), dt=1e-5,
                    rebuild_every=4, friction_mode="single_step")
    with pytest.raises(NotImplementedError, match="periodic grids"):
        make_cell_dense_advance(dem, box_boundaries((0, 0, 0), (1, 1, 1)),
                                tg, device="cpu")
