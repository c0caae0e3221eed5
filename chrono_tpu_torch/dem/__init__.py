"""Granular DEM (counterpart of ``chrono_tpu.dem``): the cell-slot
settling path (``cell_dense``) and the neighbour-list system
(``system``)."""

from chrono_tpu_torch.dem.params import (
    DEMMaterial, DEMParams, suggest_step_size,
)
from chrono_tpu_torch.dem.bc import (
    ConeBCs, CylinderBCs, DEMBoundaries, PlaneBCs, SphereBCs,
    box_boundaries,
)
from chrono_tpu_torch.dem.system import (
    DEMState, DEMSystem, make_advance_fn, make_dem_state,
)
