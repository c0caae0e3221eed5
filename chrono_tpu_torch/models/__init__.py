"""Ready-made models (counterpart of ``chrono_tpu.models``): the HMMWV,
sedan and Polaris decks, the other wheeled decks of ``models.decks``, the
rovers, and the tracked M113 and Marder.  Ported so far: these; the
robots and the industrial arms wait for later slices."""

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
