"""Vehicles (counterpart of ``chrono_tpu.vehicle``).

Ported: the suspension templates (``suspension``), the tire models
(``tire``: TMeasy, Fiala, Pacejka 89 and 2002, TMsimple), rigid and SCM
terrain (``terrain``), the powertrain, the drivers, the wheeled vehicle
and its step (``wheeled``), the closed path-following loop
(``closed_loop``), the drawbar-pull rig (``dbp``), granular (DEM)
terrain (``granular_terrain``), tracked vehicles (``tracked``: the band
track; ``track_shoes``: single- and double-pin shoe chains and the
sprocket gear) and OpenCRG roads (``crg``).  The FEA tire waits for a
later slice.
"""

from chrono_tpu_torch.vehicle.tire import (
    FialaParams, Pac02Params, Pac89Params, TMeasyParams, TMsimpleParams,
    fiala_forces, pac02_forces, pac89_forces, tmeasy_forces,
    tmsimple_forces,
)
from chrono_tpu_torch.vehicle.terrain import (
    Heightmap, SCMParams, SCMState, flat_terrain, make_scm_state,
    scm_erosion_step, scm_relocate, scm_wheel_forces,
)
from chrono_tpu_torch.vehicle.powertrain import (
    PowertrainParams, brake_torques, driveline_torques,
)
from chrono_tpu_torch.vehicle.driver import (
    DataDriver, DriverInputs, HumanDriver, PathFollower, SpeedController,
    acc_speed_command, double_lane_change_path, straight_path,
)
from chrono_tpu_torch.vehicle.wheeled import (
    WheeledVehicle, ackermann_angles, build_wheeled_vehicle, vehicle_step,
)
from chrono_tpu_torch.vehicle.closed_loop import (
    closed_loop_step, run_closed_loop,
)
from chrono_tpu_torch.vehicle.dbp import dbp_curve, run_dbp_rig
from chrono_tpu_torch.vehicle.granular_terrain import (
    GranularFSIState, granular_step, make_granular_advance_fn,
    make_granular_terrain_state,
)
from chrono_tpu_torch.vehicle.tracked import (
    TrackedVehicle, TrackParams, build_tracked_vehicle, tracked_step,
)
from chrono_tpu_torch.vehicle.crg import (
    CRGRoad, crg_height, crg_path, crg_to_heightmap, load_crg,
)
