"""Rigid-body population state and properties (struct of arrays).

Counterpart of ``chrono_tpu/physics/body.py``: batched tensors over the
whole body population instead of one object per body.

Conventions:
  * linear state in world frame; angular velocity ``w`` in BODY-LOCAL frame,
    inertia diagonal in the body principal frame.
  * fixed bodies are encoded with ``inv_mass == 0`` and ``inv_inertia == 0``,
    so nothing special-cases them.
"""

from __future__ import annotations

import torch
from torch import Tensor

from chrono_tpu_torch.core import quaternion as Q
from chrono_tpu_torch.utils.device import resolve_device
from chrono_tpu_torch.utils.tree import tensor_dataclass


@tensor_dataclass
class BodyState:
    """Dynamic state of N rigid bodies."""

    x: Tensor  # (N, 3) position of COM, world
    q: Tensor  # (N, 4) orientation, scalar-first unit quaternion
    v: Tensor  # (N, 3) linear velocity of COM, world
    w: Tensor  # (N, 3) angular velocity, body-local

    @property
    def n(self) -> int:
        return self.x.shape[0]


@tensor_dataclass
class BodyProps:
    """Constant mass properties of N bodies."""

    inv_mass: Tensor     # (N,)  1/m, 0 if fixed
    inertia: Tensor      # (N, 3) principal inertia diagonal (body frame)
    inv_inertia: Tensor  # (N, 3) reciprocal, 0 if fixed


def make_body_state(x, q=None, v=None, w=None, dtype=torch.float32,
                    device=None) -> BodyState:
    """A ``BodyState`` on ``device``: the CUDA card unless the caller
    passes another (``device="cpu"``); without a card the default raises,
    as ``SystemBuilder`` does, and never falls back to the CPU."""
    device = resolve_device(device, "make_body_state")
    x = torch.as_tensor(x, dtype=dtype, device=device)
    n = x.shape[0]

    def vec(a, width):
        if a is None:
            return torch.zeros((n, width), dtype=dtype, device=device)
        return torch.as_tensor(a, dtype=dtype, device=device)

    q = Q.qidentity((n,), dtype, device) if q is None else vec(q, 4)
    return BodyState(x=x, q=q, v=vec(v, 3), w=vec(w, 3))


def gyroscopic_torque(props: BodyProps, state: BodyState) -> Tensor:
    """Euler term ``-ω × (I ω)`` in the body-local frame (N, 3)."""
    Iw = props.inertia * state.w
    return -torch.linalg.cross(state.w, Iw, dim=-1)


def kinetic_energy(props: BodyProps, state: BodyState) -> Tensor:
    """Total kinetic energy (scalar). Fixed bodies contribute zero."""
    live = props.inv_mass > 0
    m = torch.where(live, 1.0 / torch.clamp_min(props.inv_mass, 1e-30),
                    torch.zeros_like(props.inv_mass))
    lin = 0.5 * torch.sum(m * torch.sum(state.v**2, dim=-1))
    rot = 0.5 * torch.sum(
        torch.where(live[:, None], props.inertia,
                    torch.zeros_like(props.inertia)) * state.w**2)
    return lin + rot


def integrate_positions(state: BodyState, h) -> BodyState:
    """Semi-implicit position update: x += h v, q ← q ⊗ exp(h ω_l / 2)."""
    return state.replace(
        x=state.x + h * state.v,
        q=Q.integrate_quat(state.q, state.w, h),
    )


def integrate_positions_compensated(state: BodyState, h, cx, cq):
    """Kahan-compensated position update for long fp32 runs.

    fp32 ``x += h v`` drops the increment's low bits every step; two-sum
    compensation carries the dropped bits in ``cx``/``cq`` (x_true = x + cx),
    restoring O(eps) accumulation.  The quaternion update is compensated in
    additive form (dq = q⊗exp(½hω) − q) with the normalisation factor folded
    into the carry.

    The two-sums are exact only if each sum and difference rounds on its
    own: eager PyTorch ops do, but ``torch.compile`` or a fused kernel may
    reassociate ``(t - x) - y`` and lose the carry.  Do not compile this
    function.

    Returns (new_state, new_cx, new_cq).
    """
    y = h * state.v - cx
    t = state.x + y
    cx2 = (t - state.x) - y
    q1 = Q.qmul(state.q, Q.qexp_half(state.w * h))
    dq = q1 - state.q
    yq = dq - cq
    tq = state.q + yq
    cq2 = (tq - state.q) - yq
    inv_n = 1.0 / torch.sqrt(torch.sum(tq * tq, dim=-1, keepdim=True))
    # the carry tracks dropped ADDITION bits only; rescale it through the
    # (intentional) normalisation so the convention q_true = q − cq holds
    return state.replace(x=t, q=tq * inv_n), cx2, cq2 * inv_n
