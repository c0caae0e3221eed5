"""PyTorch port (chrono_tpu_torch): the cell-sorted rows that kernels K1 and
``dem_forces`` walk, on the CPU.

* The rows and their (start, count) table, from ``to_rows`` and from K2's
  twin, against a numpy reference built from the slot semantics: empty
  cells, edge and corner cells, and a cell past its capacity.
* A pure-Python mirror of the kernels' nine-run index arithmetic
  (``csrc/dem_pairs.cuh`` ``neighbour_run``) against a
  brute-force walk of the 27 neighbour cells in (dx, dy, dz, slot) order,
  at every face, edge and corner of a small grid; and the vectorised runs
  the twins use against the mirror.
* The row twins against the slot-plane twins and the JAX package's
  ``cell_dense_forces`` (no TPU kernel), at the tolerances of
  tests/test_pallas_kernel.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from chrono_tpu.dem.cell_dense import cell_dense_forces
from chrono_tpu.dem.cell_dense import to_cells as jax_to_cells

from chrono_tpu_torch.collision.cell_list import GridSpec
from chrono_tpu_torch.dem import cell_dense as t_cd
from chrono_tpu_torch.dem.rows import (
    neighbour_runs, rows_from_prefix_slots, rows_from_slots, rows_to_planes,
)
from chrono_tpu_torch.ops.cuda.dem_forces import (
    dem_forces, dem_forces_plain, dem_forces_rows_plain,
)
from chrono_tpu_torch.ops.cuda.dem_substep import (
    dem_substep, dem_substep_plain, dem_substep_rows_plain,
)
from chrono_tpu_torch.ops.cuda.migrate import dem_migrate_plain

from test_torch_dem_backends import kernel_scene, port

DIMS = (3, 4, 5)
CELL = 0.1
C = 4


def _cell_of(pos):
    ijk = np.clip(np.floor(pos / CELL).astype(int), 0, np.array(DIMS) - 1)
    return (ijk[:, 0] * DIMS[1] + ijk[:, 1]) * DIMS[2] + ijk[:, 2]


def _reference_rows(pos, n_cells, capacity):
    """Numpy rows of the slot semantics: per cell in id order its first
    ``capacity`` particles in input order; (kept ids, start, count, row of
    every particle)."""
    cell = _cell_of(pos)
    kept, start, count = [], np.zeros(n_cells, int), np.zeros(n_cells, int)
    prow = np.zeros(len(pos), int)
    for c in range(n_cells):
        members = np.flatnonzero(cell == c)
        start[c] = len(kept)
        count[c] = min(len(members), capacity)
        for rank, p in enumerate(members):
            prow[p] = start[c] + min(rank, capacity - 1)
        kept.extend(members[:capacity])
    return np.array(kept), start, count, prow


def _edge_scene(seed=0):
    """Particles in a (3, 4, 5) grid of 0.1 m cells: both corner cells and
    an edge cell filled, one cell holding C + 2, many cells empty."""
    rng = np.random.default_rng(seed)
    lo = np.array([[0.01, 0.01, 0.01], [0.21, 0.31, 0.41],
                   [0.01, 0.31, 0.21]])
    pts = [rng.uniform(0, np.array(DIMS) * CELL, (20, 3))]
    pts += [base + rng.uniform(0, 0.08, (2, 3)) for base in lo]
    pts.append(np.array([0.11, 0.21, 0.31]) + rng.uniform(0, 0.08,
                                                          (C + 2, 3)))
    pos = rng.permutation(np.concatenate(pts)).astype(np.float32)
    vel = rng.normal(0, 1, pos.shape).astype(np.float32)
    omega = rng.normal(0, 1, pos.shape).astype(np.float32)
    return pos, vel, omega


def _check_rows(rows, kept, start, count, pos, vel, omega):
    m = len(kept)
    np.testing.assert_array_equal(rows.table[:, 0].numpy(), start)
    np.testing.assert_array_equal(rows.table[:, 1].numpy(), count)
    for k, a in enumerate((pos, vel, omega)):
        np.testing.assert_array_equal(rows.state[k, :m, :3].numpy(),
                                      a[kept])
    np.testing.assert_array_equal(rows.cell[:m].numpy(),
                                  _cell_of(pos[kept]))
    assert (rows.cell[m:] == -1).all()
    assert not rows.state[:, m:].any() and not rows.state[..., 3].any()


def test_rows_from_to_rows_match_numpy():
    """``to_rows``: the table, the rows, each particle's row and the
    overflow, against the numpy reference; and the same bits as compacting
    ``to_cells``'s slot planes."""
    pos, vel, omega = _edge_scene()
    grid = GridSpec(cell_size=CELL, dims=DIMS)
    kept, start, count, prow = _reference_rows(pos, grid.n_cells, C)
    assert (count == 0).any() and count[0] > 0 and count[-1] > 0
    rows, got_prow, ovf = t_cd.to_rows(grid, C, *(torch.from_numpy(a) for a
                                                  in (pos, vel, omega)))
    assert rows.n_rows == len(pos) + 1
    assert int(ovf) == 2
    _check_rows(rows, kept, start, count, pos, vel, omega)
    np.testing.assert_array_equal(got_prow.numpy(), prow)
    field = t_cd.to_cells(grid, C, *(torch.from_numpy(a) for a in
                                     (pos, vel, omega)))
    slot_rows, sel = rows_from_slots(field.feat)
    m = len(kept)
    assert torch.equal(slot_rows.state[:, :m], rows.state[:, :m])
    assert torch.equal(slot_rows.table, rows.table)
    assert torch.equal(slot_rows.cell[:m], rows.cell[:m])
    # the row of each slot is the slot's own particle
    assert torch.equal(field.ids.reshape(-1)[sel].long(),
                       torch.from_numpy(kept))


def test_rows_from_migrate_twin_match_numpy():
    """Rows of K2's output by its landing counts, with no host sync: the
    same particles in slot order, the table clamped at C where a cell
    overflows, and every slot mapped to its row (empty ones to the dead
    last row, which is zero)."""
    pos, vel, omega = _edge_scene(1)
    # C more particles in cell (0, 2, 3), beside the full cell (1, 2, 3)
    rng = np.random.default_rng(2)
    side = (np.array([0.01, 0.21, 0.31])
            + rng.uniform(0, 0.08, (C, 3))).astype(np.float32)
    pos = np.concatenate([pos, side])
    vel, omega = (np.concatenate([a, a[:C]]) for a in (vel, omega))
    grid = GridSpec(cell_size=CELL, dims=DIMS)
    field = t_cd.to_cells(grid, C, *(torch.from_numpy(a) for a in
                                     (pos, vel, omega)))
    # they move one cell along x, into the full cell
    feat = field.feat.clone()
    src = (0 * DIMS[1] + 2) * DIMS[2] + 3
    assert int(feat[9, src].sum()) == C
    feat[0, src] += CELL
    moved, ids, landed = dem_migrate_plain(feat, field.ids, grid)
    assert int(landed.max()) > C
    n = len(pos)
    rows, row_of_slot = rows_from_prefix_slots(moved, landed, n + 1)
    valid = (moved[9] > 0.5).reshape(-1).numpy()
    planes = moved.reshape(10, -1).numpy()
    m = int(valid.sum())
    count = np.minimum(landed.numpy(), C)
    assert m == count.sum()
    np.testing.assert_array_equal(rows.table[:, 1].numpy(), count)
    np.testing.assert_array_equal(rows.table[:, 0].numpy(),
                                  np.cumsum(count) - count)
    for k in range(3):
        np.testing.assert_array_equal(rows.state[k, :m, :3].numpy(),
                                      planes[3 * k:3 * k + 3, valid].T)
    assert (rows.cell[m:] == -1).all() and not rows.state[:, m:].any()
    np.testing.assert_array_equal(row_of_slot.numpy()[valid], np.arange(m))
    assert (row_of_slot.numpy()[~valid] == n).all()
    back = rows_to_planes(rows.state, row_of_slot).reshape(9, -1)
    assert torch.equal(back, moved.reshape(10, -1)[0:9])


# ---------------------------------------------------------- nine runs


def kernel_runs(row, cell, dims, start, count):
    """Line by line the kernels' walk (``add_pair_forces`` with
    ``neighbour_run``): the candidate rows of ``row`` in visiting order."""
    nx, ny, nz = dims
    k = cell % nz
    j = (cell // nz) % ny
    i = cell // (nz * ny)
    k0, k1 = max(k - 1, 0), min(k + 1, nz - 1)
    out = []
    for o in range(9):
        ii, jj = i + o // 3 - 1, j + o % 3 - 1
        if ii < 0 or ii >= nx or jj < 0 or jj >= ny:
            lo = hi = 0
        else:
            base = (ii * ny + jj) * nz
            lo = start[base + k0]
            hi = start[base + k1] + count[base + k1]
        out.extend(t for t in range(lo, hi) if t != row)
    return out


def brute_runs(row, cell, dims, start, count):
    """The 27 neighbour cells in (dx, dy, dz) order, each cell's rows in
    slot order, the row itself skipped."""
    nx, ny, nz = dims
    i, j, k = cell // (nz * ny), (cell // nz) % ny, cell % nz
    out = []
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                ii, jj, kk = i + dx, j + dy, k + dz
                if not (0 <= ii < nx and 0 <= jj < ny and 0 <= kk < nz):
                    continue
                c = (ii * ny + jj) * nz + kk
                out.extend(t for t in range(start[c], start[c] + count[c])
                           if t != row)
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_nine_runs_match_27_cells(seed):
    """Every row and every cell (faces, edges and corners) of a (3, 4, 5)
    grid with random counts, empty cells included, sees the brute-force
    candidates in the same order, and the vectorised runs of the twins
    agree with the mirror."""
    rng = np.random.default_rng(seed)
    n_cells = int(np.prod(DIMS))
    count = rng.integers(0, C + 1, n_cells)
    count[rng.choice(n_cells, 12, replace=False)] = 0
    start = np.cumsum(count) - count
    m = int(count.sum())
    cell = np.repeat(np.arange(n_cells), count)
    for row in range(m):
        c = int(cell[row])
        assert kernel_runs(row, c, DIMS, start, count) == \
            brute_runs(row, c, DIMS, start, count)
    # every cell, so every face, edge and corner (no row of its own)
    for c in range(n_cells):
        assert kernel_runs(-1, c, DIMS, start, count) == \
            brute_runs(-1, c, DIMS, start, count)

    table = torch.from_numpy(np.stack([start, count], 1).astype(np.int32))
    cells = torch.from_numpy(np.concatenate([cell, [-1, -1]])
                             .astype(np.int32))
    runs = neighbour_runs(cells, table, DIMS)
    for row in range(m):
        got = [t for lo, hi in runs
               for t in range(int(lo[row]), int(hi[row])) if t != row]
        assert got == kernel_runs(row, int(cell[row]), DIMS, start, count)
    assert all(int(hi[m]) == int(lo[m]) for lo, hi in runs)   # dead row


# ---------------------------------------------------------- twins


def _scene_rows(friction_mode):
    params, bcs, grid, pos, vel, omega = kernel_scene(friction_mode)
    tparams, tbcs, tgrid = port(params, bcs, grid)
    field = t_cd.to_cells(tgrid, 8, *(torch.from_numpy(a)
                                      for a in (pos, vel, omega)))
    rows, sel = rows_from_slots(field.feat)
    return (params, grid, (pos, vel, omega)), (tparams, tbcs, tgrid), \
        field, rows, sel


def _forces_close(got, ref, radius):
    """test_pallas_kernel's bounds: rtol 1e-4, atol 1e-5 of the largest
    force, and for torques of the larger of the largest torque and r·F."""
    f_scale = float(ref[0:3].abs().max())
    assert f_scale > 0
    t_atol = 1e-5 * max(float(ref[3:6].abs().max()), radius * f_scale)
    np.testing.assert_allclose(got[0:3].numpy(), ref[0:3].numpy(),
                               rtol=1e-4, atol=1e-5 * f_scale)
    np.testing.assert_allclose(got[3:6].numpy(), ref[3:6].numpy(),
                               rtol=1e-4, atol=t_atol)


@pytest.mark.parametrize("friction_mode", ["frictionless", "single_step"])
def test_row_twins_match_slot_twins(friction_mode):
    """On the 120-particle scene of tests/test_pallas_kernel.py: the row
    twins of ``dem_forces`` and of K1 against the slot twins, particle by
    particle; the slot wrappers, which compact, run the row twin and
    scatter back, give the row twin's values, zeros (forces) or the input
    (K1) on empty slots."""
    _, (tparams, tbcs, tgrid), field, rows, sel = _scene_rows(friction_mode)
    m = sel.numel()
    pair = t_cd.pair_coefs(tparams, tgrid, 8)
    got = rows_to_planes(dem_forces_rows_plain(rows, pair)[:, :m])
    _forces_close(got, dem_forces_plain(field.feat, pair)
                  .reshape(6, -1)[:, sel], tparams.radius)
    wrapped = torch.empty((6,) + tuple(field.feat.shape[1:]))
    dem_forces(field.feat, wrapped, pair)
    assert torch.equal(wrapped.reshape(6, -1)[:, sel], got)
    assert not wrapped.reshape(6, -1)[:, field.feat[9].reshape(-1) < 0.5] \
        .any()

    coefs = t_cd.substep_coefs(tparams, tbcs, tgrid, 8)
    nxt = rows_to_planes(dem_substep_rows_plain(rows, coefs)[:, :m])
    ref = dem_substep_plain(field.feat, coefs).reshape(10, -1)[0:9, sel]
    np.testing.assert_allclose(nxt[0:3].numpy(), ref[0:3].numpy(),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(nxt[3:9].numpy(), ref[3:9].numpy(),
                               rtol=1e-3, atol=1e-4)
    assert float((nxt[3:6] - rows_to_planes(rows.state[1:2, :m])).abs()
                 .max()) > 1e-3                     # contacts were resolved
    wrapped = torch.empty_like(field.feat)
    dem_substep(field.feat, wrapped, coefs)
    assert torch.equal(wrapped.reshape(10, -1)[0:9, sel], nxt)
    empty = field.feat[9] < 0.5
    assert torch.equal(wrapped[:, empty], field.feat[:, empty])


def test_row_forces_twin_matches_jax():
    """The row twin of ``dem_forces`` with single-step friction against the
    JAX ``cell_dense_forces`` (jitted) at the occupied slots."""
    (params, grid, state), (tparams, _, tgrid), _, rows, sel = \
        _scene_rows("single_step")
    jfield = jax_to_cells(grid, 8, *(jnp.asarray(a) for a in state))
    jf, jt = jax.jit(cell_dense_forces, static_argnums=1)(params, grid,
                                                          jfield)
    # JAX (nx, ny, nz, C, 3) → (6, n_slots) at the occupied slots
    ref = torch.from_numpy(np.concatenate(
        [np.asarray(a).reshape(-1, 3).T for a in (jf, jt)]))[:, sel]
    pair = t_cd.pair_coefs(tparams, tgrid, 8)
    got = rows_to_planes(dem_forces_rows_plain(rows, pair)[:, :sel.numel()])
    _forces_close(got, ref, tparams.radius)
