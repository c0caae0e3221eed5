"""SPH smoothing kernels (W and dW/dr), batched and branch-free.

Counterpart of ``chrono_tpu/fsi/sph/kernels.py``: each function returns
W(q) or dW/dr for q = r/h, zero outside the compact support, broadcast over
any batch shape, with 3-D normalisation constants.  ``h`` is a Python float
or a tensor.
"""

from __future__ import annotations

import math

import torch


def cubic_spline_w(r: torch.Tensor, h) -> torch.Tensor:
    """Monaghan cubic spline, support radius 2h. σ = 1/(π h³)."""
    sigma = 1.0 / (math.pi * h**3)
    q = r / h
    w1 = 1.0 - 1.5 * q * q + 0.75 * q**3          # 0 ≤ q < 1
    w2 = 0.25 * (2.0 - q) ** 3                     # 1 ≤ q < 2
    zero = torch.zeros_like(q)
    return sigma * torch.where(q < 1.0, w1, torch.where(q < 2.0, w2, zero))


def cubic_spline_dwdr(r: torch.Tensor, h) -> torch.Tensor:
    """dW/dr for the cubic spline."""
    sigma = 1.0 / (math.pi * h**3)
    q = r / h
    d1 = -3.0 * q + 2.25 * q * q
    d2 = -0.75 * (2.0 - q) ** 2
    zero = torch.zeros_like(q)
    return sigma / h * torch.where(q < 1.0, d1,
                                   torch.where(q < 2.0, d2, zero))


def wendland_c2_w(r: torch.Tensor, h) -> torch.Tensor:
    """Wendland C2 quintic, support radius 2h. σ = 21/(16 π h³)."""
    sigma = 21.0 / (16.0 * math.pi * h**3)
    q = r / h
    t = torch.where(q < 2.0, 1.0 - 0.5 * q, torch.zeros_like(q))
    return sigma * t**4 * (2.0 * q + 1.0)


def wendland_c2_dwdr(r: torch.Tensor, h) -> torch.Tensor:
    sigma = 21.0 / (16.0 * math.pi * h**3)
    q = r / h
    t = torch.where(q < 2.0, 1.0 - 0.5 * q, torch.zeros_like(q))
    return sigma / h * (-5.0 * q) * t**3


def quintic_spline_w(r: torch.Tensor, h) -> torch.Tensor:
    """Quintic spline, support radius 3h. σ = 1/(120 π h³)."""
    sigma = 1.0 / (120.0 * math.pi * h**3)
    q = r / h
    t3 = torch.clamp(3.0 - q, min=0.0) ** 5
    t2 = torch.clamp(2.0 - q, min=0.0) ** 5
    t1 = torch.clamp(1.0 - q, min=0.0) ** 5
    return sigma * (t3 - 6.0 * t2 + 15.0 * t1)


def quintic_spline_dwdr(r: torch.Tensor, h) -> torch.Tensor:
    sigma = 1.0 / (120.0 * math.pi * h**3)
    q = r / h
    t3 = torch.clamp(3.0 - q, min=0.0) ** 4
    t2 = torch.clamp(2.0 - q, min=0.0) ** 4
    t1 = torch.clamp(1.0 - q, min=0.0) ** 4
    return sigma / h * (-5.0) * (t3 - 6.0 * t2 + 15.0 * t1)


KERNELS = {
    "cubic": (cubic_spline_w, cubic_spline_dwdr, 2.0),
    "wendland": (wendland_c2_w, wendland_c2_dwdr, 2.0),
    "quintic": (quintic_spline_w, quintic_spline_dwdr, 3.0),
}


def grad_w(dwdr_fn, d: torch.Tensor, r: torch.Tensor, h,
           eps: float = 1e-12) -> torch.Tensor:
    """∇W_ij = (dW/dr) · d/|d| for separation d = x_i − x_j (points toward
    i); ``d`` is (…, 3), ``r`` is (…)."""
    return (dwdr_fn(r, h) / torch.clamp(r, min=eps))[..., None] * d
