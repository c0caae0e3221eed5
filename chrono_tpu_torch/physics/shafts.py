"""1-D drivetrain (shaft) elements inside the multibody solve.

Counterpart of ``chrono_tpu/physics/shafts.py`` (the reference's ChShaft
family: ChShaftsGear, ChShaftsPlanetary, ChShaftsClutch, ChShaftsBody,
ChShaftsTorsionSpring, applied shaft torques).  A shaft IS a rigid body
whose mass properties disable every degree of freedom but the spin about
its local z (inv_mass = 0, inv_inertia = (0, 0, 1/J)), so the descriptor
and the solvers take drivetrains with no special case.  The shaft angle is
the body quaternion (a pure z rotation); the shaft speed is w_z.

Couplings are velocity-level constraint rows (gear; planetary, a genuine
three-variable row in the rows' third slot; shaft–body) or applied-torque
pairs (clutch, torsion spring, constant torque) summed with no atomics.
"""

from __future__ import annotations

import math

import torch
from torch import Tensor

from chrono_tpu_torch.physics.constraints import ConstraintRows
from chrono_tpu_torch.utils.segment import segment_sum
from chrono_tpu_torch.utils.tree import tensor_dataclass


# ---------------------------------------------------------------------------
# constraint-type couplings
# ---------------------------------------------------------------------------

@tensor_dataclass
class ShaftGearData:
    """ω_a = ratio · ω_b  (ChShaftsGear; ratio < 0 = reversing mesh)."""

    shaft_a: Tensor   # (G,) int32 body index of shaft a
    shaft_b: Tensor
    ratio: Tensor     # (G,)


@tensor_dataclass
class ShaftPlanetaryData:
    """c_c ω_c + c_s ω_s + c_r ω_r = 0 (the carrier/sun/ring Willis
    equation, ChShaftsPlanetary), coefficients per constraint."""

    carrier: Tensor   # (P,) int32
    sun: Tensor
    ring: Tensor
    c_carrier: Tensor  # (P,)
    c_sun: Tensor
    c_ring: Tensor


@tensor_dataclass
class ShaftBodyData:
    """A shaft's spin locked to a body's angular velocity about a body-local
    axis (ChShaftsBody): ω_shaft − a·w_body = 0."""

    shaft: Tensor       # (S,) int32
    body: Tensor        # (S,) int32
    axis_local: Tensor  # (S, 3)


def _ez(n, like: Tensor) -> Tensor:
    """(n, 3) rows of the unit z, built on the device (no host copy)."""
    return torch.eye(3, dtype=like.dtype, device=like.device)[2].expand(n, 3)


def _zcol(c: Tensor) -> Tensor:
    """(n, 3) rows (0, 0, c)."""
    return torch.nn.functional.pad(c[:, None], (2, 0))


def shaft_gear_rows(data: ShaftGearData, dtype=torch.float32
                    ) -> ConstraintRows:
    n = data.shaft_a.shape[0]
    z = data.ratio.new_zeros((n, 3), dtype=dtype)
    return ConstraintRows.two_body(
        body_a=data.shaft_a, body_b=data.shaft_b,
        Ja_v=z, Ja_w=_ez(n, z).contiguous(), Jb_v=z,
        Jb_w=_zcol(-data.ratio.to(dtype)),
        rhs=z.new_zeros((n,)),
        active=torch.ones((n,), dtype=torch.bool, device=z.device))


def shaft_planetary_rows(data: ShaftPlanetaryData, dtype=torch.float32
                         ) -> ConstraintRows:
    n = data.carrier.shape[0]
    z = data.c_carrier.new_zeros((n, 3), dtype=dtype)
    return ConstraintRows(
        body_a=data.carrier, body_b=data.sun, body_c=data.ring,
        Ja_v=z, Ja_w=_zcol(data.c_carrier.to(dtype)),
        Jb_v=z, Jb_w=_zcol(data.c_sun.to(dtype)),
        Jc_w=_zcol(data.c_ring.to(dtype)),
        rhs=z.new_zeros((n,)),
        active=torch.ones((n,), dtype=torch.bool, device=z.device))


def shaft_body_rows(data: ShaftBodyData, dtype=torch.float32
                    ) -> ConstraintRows:
    n = data.shaft.shape[0]
    z = data.axis_local.new_zeros((n, 3), dtype=dtype)
    return ConstraintRows.two_body(
        body_a=data.shaft, body_b=data.body,
        Ja_v=z, Ja_w=_ez(n, z).contiguous(), Jb_v=z,
        Jb_w=-data.axis_local.to(dtype),
        rhs=z.new_zeros((n,)),
        active=torch.ones((n,), dtype=torch.bool, device=z.device))


SHAFT_ROW_GENERATORS = {
    "gear": shaft_gear_rows,
    "planetary": shaft_planetary_rows,
    "shaft_body": shaft_body_rows,
}


# ---------------------------------------------------------------------------
# torque-type couplings (smooth loads)
# ---------------------------------------------------------------------------

@tensor_dataclass
class ShaftTorqueElements:
    """Batched clutch + torsion-spring + constant-torque elements.

    clutch:  τ = clip(c_slip · (ω_b − ω_a), ±τ_max · engagement)
             (a viscous-locking approximation of ChShaftsClutch)
    spring:  τ = k (θ_b − θ_a − rest) + c (ω_b − ω_a)   (ChShaftsTorsionSpring)
    torque:  a constant applied pair (ChShaftsAppliedTorque)
    """

    shaft_a: Tensor        # (T,) int32
    shaft_b: Tensor
    kind: Tensor           # (T,) 0 = clutch, 1 = spring, 2 = torque
    k: Tensor              # spring k | clutch c_slip | torque value
    c: Tensor              # spring c | clutch τ_max  | unused
    rest: Tensor           # spring rest angle | clutch engagement (0..1)


def shaft_angle(q: Tensor) -> Tensor:
    """Rotation angle about local z of a pure-z-rotation quaternion.

    Continuous only modulo 2π: torsion springs wind correctly because the
    integrator keeps q on the unit circle, but rest angles beyond ±π must
    be tracked by the caller.
    """
    return 2.0 * torch.atan2(q[..., 3], q[..., 0])


def shaft_torques(data: ShaftTorqueElements, state_q, state_w, n_bodies):
    """The shaft elements' torque pairs → (N, 3) body-local torques, summed
    per body in a fixed order (``utils.segment``: no atomics)."""
    a, b = data.shaft_a, data.shaft_b
    w_a = state_w[a][:, 2]
    w_b = state_w[b][:, 2]
    dw = w_b - w_a
    dth = shaft_angle(state_q[b]) - shaft_angle(state_q[a])
    # wrap the angle difference to (−π, π] so springs don't jump at ±π
    dth = dth - 2.0 * math.pi * torch.round(dth / (2.0 * math.pi))

    lim = data.c * data.rest
    tau_clutch = torch.clamp(data.k * dw, -lim, lim)
    tau_spring = data.k * (dth - data.rest) + data.c * dw
    tau = torch.where(data.kind == 0, tau_clutch,
                      torch.where(data.kind == 1, tau_spring, data.k))
    t3 = _zcol(tau)
    return (segment_sum(t3, a.long(), n_bodies)
            + segment_sum(-t3, b.long(), n_bodies))
