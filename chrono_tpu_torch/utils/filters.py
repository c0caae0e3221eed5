"""Signal filters and running statistics.

Counterpart of ``chrono_tpu/utils/filters.py`` (the reference's running
average, Butterworth low/high-pass and PID controller): each filter is a
small carrier whose ``step`` returns the output and the carrier with its
new state, plus whole-signal helpers.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import Tensor

from chrono_tpu_torch.utils.device import resolve_device
from chrono_tpu_torch.utils.tree import tensor_dataclass


@tensor_dataclass
class Biquad:
    """Second-order IIR section (direct form II transposed).  ``s`` starts
    at zeros on ``b``'s device."""

    b: Tensor  # (3,)
    a: Tensor  # (3,) a[0] == 1
    s: Tensor = None

    def __post_init__(self):
        if self.s is None:
            object.__setattr__(self, "s", torch.zeros_like(self.b[:2]))

    def step(self, x):
        y = self.b[0] * x + self.s[0]
        s0 = self.b[1] * x - self.a[1] * y + self.s[1]
        s1 = self.b[2] * x - self.a[2] * y
        return y, self.replace(s=torch.stack([s0, s1]))

    def filter(self, xs: Tensor) -> Tensor:
        """Filter a whole signal from this state, sample by sample."""
        f, ys = self, []
        for x in xs:
            y, f = f.step(x)
            ys.append(y)
        return torch.stack(ys) if ys else xs.new_zeros((0,))


def _biquad(b, a, device) -> Biquad:
    device = resolve_device(device, "Biquad")
    return Biquad(b=torch.as_tensor(np.asarray(b, np.float32), device=device),
                  a=torch.as_tensor(np.asarray(a, np.float32), device=device))


def butterworth_lowpass(cutoff_hz: float, fs_hz: float, *,
                        device=None) -> Biquad:
    """2nd-order Butterworth low-pass (bilinear transform), on the card
    unless ``device`` names another."""
    w = np.tan(np.pi * cutoff_hz / fs_hz)
    k = 1.0 / (1.0 + np.sqrt(2.0) * w + w * w)
    b0 = w * w * k
    return _biquad([b0, 2 * b0, b0],
                   [1.0, 2 * (w * w - 1) * k,
                    (1 - np.sqrt(2.0) * w + w * w) * k], device)


def butterworth_highpass(cutoff_hz: float, fs_hz: float, *,
                         device=None) -> Biquad:
    """2nd-order Butterworth high-pass (bilinear transform)."""
    w = np.tan(np.pi * cutoff_hz / fs_hz)
    k = 1.0 / (1.0 + np.sqrt(2.0) * w + w * w)
    return _biquad([k, -2 * k, k],
                   [1.0, 2 * (w * w - 1) * k,
                    (1 - np.sqrt(2.0) * w + w * w) * k], device)


def running_average(xs: Tensor, window: int) -> Tensor:
    """Simple moving average over full windows (ChRunningAverage)."""
    kernel = torch.full((1, 1, window), 1.0 / window, dtype=xs.dtype,
                        device=xs.device)
    return torch.nn.functional.conv1d(xs[None, None], kernel)[0, 0]


@tensor_dataclass
class PID:
    """General PID controller (reference ChControllerPID)."""

    kp: Tensor
    ki: Tensor = 0.0
    kd: Tensor = 0.0
    integral: Tensor = 0.0
    prev: Tensor = 0.0

    def step(self, err, h):
        integral = self.integral + err * h
        deriv = (err - self.prev) / h
        out = self.kp * err + self.ki * integral + self.kd * deriv
        return out, self.replace(integral=integral, prev=err)
