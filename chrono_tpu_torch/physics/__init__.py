"""The multibody core: bodies, joints, motors, force elements, shafts, the
system model and its steppers (the DVI stepper, the explicit integrators,
HHT and Newmark in ``physics.implicit``, ODE blocks in
``physics.external``), the scene builder, and SMC penalty contact."""

from chrono_tpu_torch.physics.body import (
    BodyProps, BodyState, kinetic_energy, make_body_state,
)
from chrono_tpu_torch.physics.builder import SystemBuilder
from chrono_tpu_torch.physics.system import (
    Model, SolverSettings, StepInfo, make_step_fn, simulate,
    step_euler_implicit_linearized,
)
from chrono_tpu_torch.physics.explicit import (
    EXPLICIT_STEPPERS, step_euler_explicit, step_heun, step_leapfrog,
    step_rk4,
)
from chrono_tpu_torch.physics.smc import SMCParams, smc_step, smc_contact_forces
