"""1-D motion functions used by motors and actuators.

Counterpart of ``chrono_tpu/core/functions.py``: each function is a small
dataclass whose parameters are tensors (or Python numbers), so a motor
profile lives on the device beside the model and can be stacked across the
motors of one kind.

Every function has ``value(t)``, ``deriv(t)`` and ``deriv2(t)``; ``deriv``
defaults to forward-mode autodiff of ``value`` (``torch.func.jacfwd``), which
is exact for every function here.  ``t`` may be a Python number or a 0-dim
tensor; on the card it is the device scalar that a captured step advances,
and nothing here reads it back to the host.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import Tensor

from chrono_tpu_torch.utils.tree import static_field, tensor_dataclass


def _time(t) -> Tensor:
    """``t`` as a floating tensor (the default float type for numbers)."""
    if isinstance(t, Tensor):
        return t if t.is_floating_point() else t.to(torch.get_default_dtype())
    return torch.tensor(t, dtype=torch.get_default_dtype())


def _dtype(x) -> torch.dtype:
    return x.dtype if isinstance(x, Tensor) else torch.get_default_dtype()


def _polyval(p: Tensor, x) -> Tensor:
    """Horner's rule over the leading axis of ``p`` (``jnp.polyval``)."""
    x = _time(x)
    y = torch.zeros(torch.broadcast_shapes(p.shape[1:], x.shape),
                    dtype=x.dtype, device=p.device)
    for k in range(p.shape[0]):
        y = y * x + p[k]
    return y


def linspace(start: float, stop: float, num: int, endpoint: bool = True,
             dtype=torch.float32, device=None) -> Tensor:
    """``num`` evenly spaced samples, computed as ``start·(1 − s) +
    stop·s`` with ``s = k / div`` in ``dtype`` (the ends exact), the
    arithmetic of ``jnp.linspace``, so sampled knots and ray fans match the
    JAX package's to the bit."""
    div = num - 1 if endpoint else num
    if num <= 1:
        return torch.full((num,), start, dtype=dtype, device=device)
    s = torch.arange(div, dtype=dtype, device=device) / div
    out = (torch.tensor(start, dtype=dtype, device=device) * (1 - s)
           + torch.tensor(stop, dtype=dtype, device=device) * s)
    if endpoint:
        out = torch.cat([out, torch.full((1,), stop, dtype=dtype,
                                         device=device)])
    return out


def interp(x, xp: Tensor, fp: Tensor) -> Tensor:
    """Piecewise-linear interpolation of 1-D knots (``jnp.interp``), held at
    the end values outside them.  The knots are indexed through a 1-D index
    even for a 0-d ``x`` (indexing by a 0-d tensor may read it on the host,
    which a CUDA graph cannot hold)."""
    x = _time(x)
    shape = x.shape
    x = x.reshape(-1)
    i = torch.clamp(torch.searchsorted(xp, x.detach(), right=True),
                    1, xp.shape[0] - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    epsilon = float(np.spacing(np.finfo(
        np.float32 if xp.dtype == torch.float32 else np.float64).eps))
    dx0 = torch.abs(dx) <= epsilon
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(dx0, torch.ones_like(dx),
                                                     dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f).reshape(shape)


class MotionFunction:
    """Base: scalar function of time, differentiable with ``torch.func``."""

    def value(self, t):  # pragma: no cover - abstract
        raise NotImplementedError

    # a tangent can come back in float64 (pow's forward rule promotes a
    # Python exponent): the derivative keeps t's type, as in the JAX package
    def deriv(self, t):
        t = _time(t)
        return torch.func.jacfwd(self.value)(t).to(t.dtype)

    def deriv2(self, t):
        t = _time(t)
        return torch.func.jacfwd(self.deriv)(t).to(t.dtype)

    def __call__(self, t):
        return self.value(t)


@tensor_dataclass
class FConst(MotionFunction):
    """f(t) = c   (reference: ChFunctionConst)."""

    c: Tensor

    def value(self, t):
        return self.c + 0.0 * _time(t)

    def deriv(self, t):
        return torch.zeros_like(torch.as_tensor(t, dtype=_dtype(self.c)))


@tensor_dataclass
class FRamp(MotionFunction):
    """f(t) = y0 + slope·t   (reference: ChFunctionRamp)."""

    y0: Tensor
    slope: Tensor

    def value(self, t):
        return self.y0 + self.slope * _time(t)

    def deriv(self, t):
        return self.slope + 0.0 * _time(t)


@tensor_dataclass
class FSine(MotionFunction):
    """f(t) = amp · sin(2π·freq·t + phase)   (reference: ChFunctionSine)."""

    amp: Tensor
    freq: Tensor
    phase: Tensor = 0.0

    def value(self, t):
        w = 2.0 * math.pi * self.freq
        return self.amp * torch.sin(w * _time(t) + self.phase)

    def deriv(self, t):
        w = 2.0 * math.pi * self.freq
        return self.amp * w * torch.cos(w * _time(t) + self.phase)


@tensor_dataclass
class FPoly(MotionFunction):
    """f(t) = Σ coeffs[k]·t^k   (reference: ChFunctionPoly)."""

    coeffs: Tensor  # (K,) low-order first

    def value(self, t):
        return _polyval(self.coeffs.flip(0), t)


@tensor_dataclass
class FInterp(MotionFunction):
    """Piecewise-linear interpolation of samples (reference:
    ChFunctionInterp).  Knot tables may carry leading batch axes (``(…, K)``,
    a stack of per-motor profiles); ``value``/``deriv`` then broadcast a
    scalar ``t`` over the batch."""

    ts: Tensor  # (…, K) ascending along the last axis
    ys: Tensor  # (…, K)

    def _seg(self, t):
        K = self.ts.shape[-1]
        i = torch.clamp(torch.sum(self.ts <= t.detach(), dim=-1) - 1,
                        0, K - 2)

        def take(a, idx):
            return torch.gather(a, -1, idx[..., None])[..., 0]

        return (take(self.ts, i), take(self.ts, i + 1),
                take(self.ys, i), take(self.ys, i + 1))

    def value(self, t):
        t = _time(t)
        if self.ts.ndim == 1:
            return interp(t, self.ts, self.ys)
        t0, t1, y0, y1 = self._seg(t)
        s = torch.clamp((t - t0) / torch.clamp_min(t1 - t0, 1e-12), 0.0, 1.0)
        return y0 + s * (y1 - y0)

    def deriv(self, t):
        # slope of the active segment (zero outside the knot range)
        t = _time(t)
        t0, t1, y0, y1 = self._seg(t)
        inside = torch.logical_and(t >= self.ts[..., 0], t <= self.ts[..., -1])
        slope = (y1 - y0) / torch.clamp_min(t1 - t0, 1e-12)
        return torch.where(inside, slope, torch.zeros_like(slope))


@tensor_dataclass
class FConstAcc(MotionFunction):
    """Trapezoidal speed profile reaching ``end`` displacement over
    ``duration`` with acceleration ramps of fractional lengths aw1/aw2
    (reference: ChFunctionConstAcc)."""

    end: Tensor
    duration: Tensor
    aw1: float = static_field(default=0.3)
    aw2: float = static_field(default=0.7)

    def value(self, t):
        T = torch.as_tensor(self.duration)
        t = torch.minimum(torch.clamp_min(_time(t), 0.0), T)
        t1, t2 = self.aw1 * T, self.aw2 * T
        # peak velocity such that total displacement == end
        vmax = self.end / (T - 0.5 * t1 - 0.5 * (T - t2))
        return torch.where(
            t < t1,
            0.5 * vmax / t1 * t * t,
            torch.where(
                t < t2,
                0.5 * vmax * t1 + vmax * (t - t1),
                0.5 * vmax * t1 + vmax * (t2 - t1)
                + vmax * (t - t2) - 0.5 * vmax / (T - t2) * (t - t2) ** 2,
            ),
        )


@tensor_dataclass
class FCycloidal(MotionFunction):
    """Cycloidal rise: f(t) = h·(x − sin(2πx)/2π), x = t/T clipped to [0,1]
    (reference: ChFunctionCycloidal)."""

    height: Tensor
    width: Tensor

    def value(self, t):
        x = torch.clamp(_time(t) / self.width, 0.0, 1.0)
        return self.height * (x - torch.sin(2.0 * math.pi * x)
                              / (2.0 * math.pi))


@tensor_dataclass
class FPoly345(MotionFunction):
    """Quintic rise 10x³−15x⁴+6x⁵ (reference: ChFunctionPoly345)."""

    height: Tensor
    width: Tensor

    def value(self, t):
        x = torch.clamp(_time(t) / self.width, 0.0, 1.0)
        return self.height * (10.0 * x**3 - 15.0 * x**4 + 6.0 * x**5)


@tensor_dataclass
class FPoly23(MotionFunction):
    """Cubic rise 3x²−2x³ (reference: ChFunctionPoly23)."""

    height: Tensor
    width: Tensor

    def value(self, t):
        x = torch.clamp(_time(t) / self.width, 0.0, 1.0)
        return self.height * (3.0 * x**2 - 2.0 * x**3)


@tensor_dataclass
class FSineStep(MotionFunction):
    """Smooth step from (t1,y1) to (t2,y2) via a half-cosine
    (reference: ChFunctionSineStep)."""

    t1: Tensor
    y1: Tensor
    t2: Tensor
    y2: Tensor

    def value(self, t):
        x = torch.clamp((_time(t) - self.t1) / (self.t2 - self.t1), 0.0, 1.0)
        return self.y1 + (self.y2 - self.y1) * 0.5 * (
            1.0 - torch.cos(math.pi * x))


@tensor_dataclass
class FBSpline(MotionFunction):
    """Uniform cubic B-spline through control points on [t0, t0+(K−3)·dt]
    (reference: ChFunctionBSpline role, uniform knots), evaluated with the
    standard cubic basis on the active span.  The span index is clipped and
    the four control points gathered by it (``lax.dynamic_slice`` in the JAX
    package), so no branch depends on ``t``."""

    ctrl: Tensor            # (K,) control points, K >= 4
    t0: Tensor = 0.0
    dt: Tensor = 1.0

    def value(self, t):
        K = self.ctrl.shape[0]
        u = (_time(t) - self.t0) / self.dt
        span = torch.clamp(torch.floor(u).to(torch.int32), 0, K - 4)
        x = u - span
        # clamp x only outside the domain (hold end values)
        if K == 4:
            x = torch.clamp(x, 0.0, 1.0)
        else:
            x = torch.where(u < 0, torch.zeros_like(x),
                            torch.where(u > K - 3, torch.ones_like(x), x))
        b0 = (1 - x) ** 3 / 6.0
        b1 = (3 * x**3 - 6 * x**2 + 4) / 6.0
        b2 = (-3 * x**3 + 3 * x**2 + 3 * x + 1) / 6.0
        b3 = x**3 / 6.0
        c = self.ctrl.index_select(
            0, span.long() + torch.arange(4, device=self.ctrl.device))
        return b0 * c[0] + b1 * c[1] + b2 * c[2] + b3 * c[3]


@tensor_dataclass
class FMirror(MotionFunction):
    """f(t) = inner(2·t_mirror − t) for t > t_mirror, inner(t) otherwise
    (reference: ChFunctionMirror)."""

    inner: MotionFunction
    t_mirror: Tensor = 0.0

    def value(self, t):
        t = _time(t)
        return self.inner.value(
            torch.where(t > self.t_mirror, 2.0 * self.t_mirror - t, t))


@tensor_dataclass
class FDerivative(MotionFunction):
    """f(t) = d/dt inner(t), exact via autodiff
    (reference: ChFunctionDerivative)."""

    inner: MotionFunction

    def value(self, t):
        return self.inner.deriv(t)


@tensor_dataclass
class FIntegral(MotionFunction):
    """f(t) = c0 + ∫₀ᵗ inner(s) ds by fixed-resolution trapezoid on [0, tmax]
    (reference: ChFunctionIntegral; the reference also pre-tabulates)."""

    inner: MotionFunction
    tmax: Tensor = 1.0
    c0: Tensor = 0.0
    samples: int = static_field(default=256)

    def value(self, t):
        t = _time(t)
        ts = torch.linspace(0.0, 1.0, self.samples, dtype=t.dtype,
                            device=t.device) * self.tmax
        ys = torch.func.vmap(self.inner.value)(ts)
        cum = torch.cat([
            torch.zeros((1,), dtype=ys.dtype, device=ys.device),
            torch.cumsum(0.5 * (ys[1:] + ys[:-1]) * torch.diff(ts), dim=0)])
        return self.c0 + interp(t, ts, cum)


@tensor_dataclass
class FRepeat(MotionFunction):
    """Periodic repetition of an inner function over window width ``width``."""

    inner: MotionFunction
    width: Tensor

    def value(self, t):
        return self.inner.value(torch.remainder(_time(t), self.width))


@tensor_dataclass
class FSequence(MotionFunction):
    """Sum of scaled functions: f = Σ w_k f_k (reference: ChFunctionOperator
    add)."""

    fns: tuple = ()
    weights: Tensor = 1.0

    def value(self, t):
        w = torch.broadcast_to(torch.as_tensor(self.weights), (len(self.fns),))
        total = 0.0
        for k, f in enumerate(self.fns):
            total = total + w[k] * f.value(t)
        return total


#: class name → class, for carrying a JAX profile across (``convert.py``)
FUNCTIONS = {cls.__name__: cls for cls in (
    FConst, FRamp, FSine, FPoly, FInterp, FConstAcc, FCycloidal, FPoly345,
    FPoly23, FSineStep, FBSpline, FMirror, FDerivative, FIntegral, FRepeat,
    FSequence)}
