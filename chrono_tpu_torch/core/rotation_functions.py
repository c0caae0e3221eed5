"""Rotation-valued motion functions: q(t) on SO(3).

Counterpart of ``chrono_tpu/core/rotation_functions.py`` (the reference's
ChFunctionRotation family: ABC functions, axis, spline/SQUAD, setpoint):
time-parameterised orientation programs for imposed-motion links.  Each
has ``value(t) -> quaternion (w, x, y, z)`` and ``omega(t) -> (3,)`` world
angular velocity, exact by forward-mode autodiff of the quaternion path
(ω = 2 (q̇ ⊗ q*)_vec, ``torch.func.jvp``).
"""

from __future__ import annotations

import torch
from torch import Tensor

from chrono_tpu_torch.core import quaternion as Q
from chrono_tpu_torch.core.functions import MotionFunction, _time
from chrono_tpu_torch.utils.tree import tensor_dataclass


class RotationFunction:
    """Base: quaternion-valued function of time."""

    def value(self, t):  # pragma: no cover - abstract
        raise NotImplementedError

    def omega(self, t):
        """World angular velocity, exact: ω = 2 (q̇ ⊗ q⁻¹)_vec."""
        t = _time(t)
        q, qdot = torch.func.jvp(self.value, (t,), (torch.ones_like(t),))
        return 2.0 * Q.qmul(qdot, Q.qconj(q))[..., 1:4]

    def __call__(self, t):
        return self.value(t)


def _unit(like: Tensor, i: int) -> Tensor:
    """The i-th unit axis of ``like``'s type, built on its device."""
    return torch.eye(3, dtype=like.dtype, device=like.device)[i]


@tensor_dataclass
class RotConst(RotationFunction):
    """Fixed orientation."""

    q: Tensor

    def value(self, t):
        return self.q + 0.0 * _time(t)


@tensor_dataclass
class RotAxisAngle(RotationFunction):
    """Rotation about a fixed axis by a scalar angle program:
    q(t) = exp(axis · f(t))."""

    axis: Tensor                      # (3,) unit
    angle: MotionFunction

    def value(self, t):
        a = self.angle.value(t)
        return Q.qexp_half(self.axis * a)


@tensor_dataclass
class RotSlerp(RotationFunction):
    """Piecewise spherical-linear interpolation through key orientations at
    key times (C0 chart).  The keys are indexed through a 1-D index, so a
    captured step may call it."""

    ts: Tensor                        # (K,) ascending
    qs: Tensor                        # (K, 4) unit quaternions

    def value(self, t):
        t = _time(t).to(self.ts.dtype)
        shape = t.shape
        t = t.reshape(-1)
        K = self.ts.shape[0]
        i = torch.clamp(torch.searchsorted(self.ts, t.detach()) - 1,
                        0, K - 2)
        t0, t1 = self.ts[i], self.ts[i + 1]
        # clip as minimum(maximum(·)): at a key the two one-sided rates
        # are averaged, as jnp.clip's derivative does there
        u = (t - t0) / (t1 - t0)
        u = torch.minimum(torch.maximum(u, torch.zeros_like(u)),
                          torch.ones_like(u))
        q0, q1 = self.qs[i], self.qs[i + 1]
        # shortest-path slerp via the relative rotation's log map
        rel = Q.qmul(q1, Q.qconj(q0))
        rel = torch.where(rel[..., 0:1] < 0, -rel, rel)
        w = Q.qlog2(rel)
        out = Q.qmul(Q.qexp_half(u[:, None] * w), q0)
        return out.reshape(shape + (4,))


@tensor_dataclass
class RotABC(RotationFunction):
    """Three independent Euler-angle programs (Z-Y-X convention)."""

    fa: MotionFunction                # yaw   about z
    fb: MotionFunction                # pitch about y
    fc: MotionFunction                # roll  about x

    def value(self, t):
        a, b, c = self.fa.value(t), self.fb.value(t), self.fc.value(t)
        return Q.qmul(Q.qexp_half(_unit(a, 2) * a[..., None]),
                      Q.qmul(Q.qexp_half(_unit(b, 1) * b[..., None]),
                             Q.qexp_half(_unit(c, 0) * c[..., None])))
