"""PyTorch port (chrono_tpu_torch): K2 on cell-sorted rows, on the CPU.

``dem_migrate_rows_plain`` (a stable sort of the rows by new cell) against
the slot path it replaced on the main path: the rows scattered into slot
planes, the slot twin ``dem_migrate_plain`` (a 27-source gather), and
``rows_from_prefix_slots`` of its output.  The two are independent, and
must agree exactly: state, cell, table, carried ids and landing counts.
The checks are phase 1's of ``chip_smoke.py`` on the CPU, where both
wrappers run their twins: the 120-particle box of
tests/test_pallas_kernel.py (seed 11, the scene of test_torch_advance.py's
``test_migrate_matches_sort_rebin``) over 6 cycles of K1's twin, the same
box stirred by up to 0.45 cell a cycle, at C = 16 and at C = 3, which
overflows; and a planted two-cell jump, which both count as a loss.  The
whole path against the JAX package is in test_torch_advance.py.
"""

import pytest
import torch

import chip_smoke as cs
from chrono_tpu_torch.dem.rows import CellRows
from chrono_tpu_torch.ops.cuda.migrate import (
    dem_migrate_rows, dem_migrate_rows_plain,
)


@pytest.mark.parametrize("capacity,stir", [(16, False), (16, True),
                                           (3, True)])
def test_rows_twin_matches_slot_path_over_six_cycles(capacity, stir):
    """Particles change cell in every variant; at C = 3 cells overflow at
    the binning and in the migrations, with the same landers kept."""
    changed, most = cs.k2_rows_cycles(capacity, stir, device="cpu")
    assert changed > 0
    assert (most > capacity) == (capacity == 3)


def test_two_cell_jump_is_a_loss():
    """A particle moved two cells along x lands in no cell's walk: the row
    twin drops it as the slot twin does, and the live rows fall by one."""
    assert cs.k2_rows_jump(device="cpu") == 1


def test_wrapper_runs_the_twin_on_the_cpu_and_refuses_other_devices():
    _, _, grid, rows, ids, _, _ = cs.k2_rows_binned(11, 16, device="cpu")
    launches = dem_migrate_rows.launches
    got = cs.k2_rows_run(rows, ids, grid, 16)
    assert dem_migrate_rows.launches == launches
    assert not cs.k2_rows_differ(
        got, dem_migrate_rows_plain(rows, ids, grid, 16))
    meta = CellRows(*(t.to("meta") for t in (rows.state, rows.cell,
                                               rows.table)))
    landed = torch.empty(grid.n_cells, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        dem_migrate_rows(meta, ids.to("meta"), meta, ids.to("meta"), landed,
                         grid, 16)
