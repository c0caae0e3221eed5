"""The multibody core: bodies, joints, motors, force elements, shafts, the
system model and its stepper, the scene builder, and SMC penalty contact."""

from chrono_tpu_torch.physics.body import (
    BodyProps, BodyState, kinetic_energy, make_body_state,
)
from chrono_tpu_torch.physics.builder import SystemBuilder
from chrono_tpu_torch.physics.system import (
    Model, SolverSettings, StepInfo, make_step_fn, simulate,
    step_euler_implicit_linearized,
)
from chrono_tpu_torch.physics.smc import SMCParams, smc_step, smc_contact_forces
