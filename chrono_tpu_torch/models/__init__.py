"""Ready-made models (counterpart of ``chrono_tpu.models``), all of them
ported: the HMMWV, sedan and Polaris decks, the other wheeled decks of
``models.decks``, the rovers, the tracked M113 and Marder, the industrial
arms (``models.industrial``: 6R and SCARA kinematics, Newton IK,
trajectories, the driven 6-dof arm), the RoboSimian limbed robot
(``models.robosimian``) and the copter and Turtlebot (``models.robots``)."""

from chrono_tpu_torch.models.hmmwv import HMMWV_SPEC, create_hmmwv
from chrono_tpu_torch.models.m113 import (
    M113_SPEC, build_m113, m113_acceleration_run,
)
from chrono_tpu_torch.models.rover import (
    Rover, create_curiosity, create_rover, rover_step_scm, set_wheel_speeds,
)
from chrono_tpu_torch.models.sedan import create_sedan
from chrono_tpu_torch.models.polaris import POLARIS_SPEC, create_polaris
from chrono_tpu_torch.models.decks import (
    DECKS, build_marder, create_bmw, create_citybus, create_duro,
    create_feda, create_gator, create_gclass, create_jeep, create_kraz,
    create_man, create_mrole, create_mtv, create_uaz, create_unimog,
    create_vehicle, tmeasy_for_load,
)
from chrono_tpu_torch.models.industrial import (
    Arm6R, ArmSCARA, Trajectory, create_arm_6dof, fk_6r, fk_scara, ik_6r,
    ik_newton, ik_scara, joint_programs_from_trajectory, make_trajectory,
    traj_eval,
)
from chrono_tpu_torch.models.robosimian import (
    WHEEL_RADIUS, create_robosimian, gait_programs, limb_fk, load_actuation,
)
from chrono_tpu_torch.models.robots import (
    Copter, Turtlebot, copter_forces, copter_hover_omega, copter_step,
    create_copter, create_turtlebot, set_turtlebot_speeds, turtlebot_step,
)
