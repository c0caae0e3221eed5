"""Rigid frames (position + orientation), batched.

Counterpart of ``chrono_tpu/core/frame.py``: composition, inversion and
point/direction transforms, all broadcasting over leading batch axes.
"""

from __future__ import annotations

import torch
from torch import Tensor

from chrono_tpu_torch.core import quaternion as Q
from chrono_tpu_torch.utils.tree import tensor_dataclass


@tensor_dataclass
class Frame:
    """A rigid transform: ``p_world = pos + R(rot) · p_local``."""

    pos: Tensor  # (..., 3)
    rot: Tensor  # (..., 4) unit quaternion, scalar-first

    @staticmethod
    def identity(shape=(), dtype=torch.float32, device=None) -> "Frame":
        return Frame(
            pos=torch.zeros(tuple(shape) + (3,), dtype=dtype, device=device),
            rot=Q.qidentity(shape, dtype=dtype, device=device),
        )

    def transform_point(self, p: Tensor) -> Tensor:
        """Local point → world."""
        return self.pos + Q.qrotate(self.rot, p)

    def transform_dir(self, d: Tensor) -> Tensor:
        """Local direction → world (rotation only)."""
        return Q.qrotate(self.rot, d)

    def inv_transform_point(self, p: Tensor) -> Tensor:
        """World point → local."""
        return Q.qrotate_inv(self.rot, p - self.pos)

    def inv_transform_dir(self, d: Tensor) -> Tensor:
        return Q.qrotate_inv(self.rot, d)

    def compose(self, other: "Frame") -> "Frame":
        """``self ∘ other``: apply ``other`` in self's local space."""
        return Frame(
            pos=self.transform_point(other.pos),
            rot=Q.qmul(self.rot, other.rot),
        )

    def inverse(self) -> "Frame":
        rinv = Q.qconj(self.rot)
        return Frame(pos=-Q.qrotate(rinv, self.pos), rot=rinv)


def skew(v: Tensor) -> Tensor:
    """Cross-product (hat) matrix: ``skew(v) @ u == cross(v, u)``; batched."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))
