"""Forward-mode dual numbers with K tangents, for the joint lowering.

A :class:`Dual` is a value ``p`` and its directional derivatives ``t``
along K directions (``t`` has a leading axis of K, then ``p``'s axes,
possibly of size 1 where they broadcast).  It takes part in the arithmetic
and in the handful of torch functions that the gap functions of
``physics.joints`` and the quaternion helpers call, through
``__torch_function__``, so one evaluation of a gap function gives the gap
and its Jacobian along all K directions at once.

Why not ``torch.autograd.forward_ad`` or ``torch.func.jacfwd``: both give
every operand without a tangent (a constant, a Python number) a zero
tangent whose arithmetic runs through Python reference decompositions;
``torch.func.vmap(torch.func.jacfwd(...))`` lowers ``bench_mbs``'s six
joints in ~12× the host time of this pass (``mbs_host_cost.py``).  Here a
missing tangent is simply skipped.  Everything is plain tensor arithmetic,
with no host sync, so a CUDA graph captures it.
"""

from __future__ import annotations

import torch
from torch import Tensor


def _aligned(t: Tensor, ndim: int) -> Tensor:
    """Tangent ``t`` (K leading) with axes inserted after K so that it
    broadcasts against a value of rank ``ndim``."""
    while t.dim() < ndim + 1:
        t = t.unsqueeze(1)
    return t


def _split(x):
    return (x.p, x.t) if isinstance(x, Dual) else (x, None)


def _rank(x) -> int:
    return x.dim() if isinstance(x, Tensor) else 0


def _lin(p, parts):
    """Dual of value ``p`` whose tangent is Σ tangent·factor over ``parts``
    (pairs; a None tangent contributes nothing)."""
    r = _rank(p)
    t = None
    for tan, factor in parts:
        if tan is None:
            continue
        term = _aligned(tan, r) if factor is None else \
            _aligned(tan, r) * factor
        t = term if t is None else t + term
    return Dual(p, t) if t is not None else p


def _add(a, b):
    (ap, at), (bp, bt) = _split(a), _split(b)
    return _lin(ap + bp, [(at, None), (bt, None)])


def _sub(a, b):
    (ap, at), (bp, bt) = _split(a), _split(b)
    return _lin(ap - bp, [(at, None), (None if bt is None else -bt, None)])


def _mul(a, b):
    (ap, at), (bp, bt) = _split(a), _split(b)
    return _lin(ap * bp, [(at, bp), (bt, ap)])


def _full(x, shape):
    """Tangent of ``x`` expanded to ``(K,) + shape`` (zeros if none)."""
    p, t = _split(x)
    if t is None:
        return None
    return _aligned(t, len(shape)).expand((t.shape[0],) + tuple(shape))


def _shift(dim: int) -> int:
    return dim + 1 if dim >= 0 else dim


def _join(fn, xs, dim):
    """stack / cat of values some of which are duals."""
    ps = [_split(x)[0] for x in xs]
    p = fn(ps, dim=dim)
    tans = [_full(x, pp.shape) for x, pp in zip(xs, ps)]
    k = next(t.shape[0] for t in tans if t is not None)
    ts = [t if t is not None else
          pp.new_zeros((k,) + tuple(pp.shape)) for t, pp in zip(tans, ps)]
    return Dual(p, fn(ts, dim=_shift(dim)))


def _sum(x, dim, keepdim=False):
    p, t = _split(x)
    dims = [dim] if isinstance(dim, int) else list(dim)
    full = _full(x, p.shape)
    return Dual(torch.sum(p, dim=dim, keepdim=keepdim),
                torch.sum(full, dim=[_shift(d) for d in dims],
                          keepdim=keepdim))


def _sqrt(x):
    p, t = _split(x)
    r = torch.sqrt(p)
    return _lin(r, [(t, 0.5 / r)])


def _clamp_min(x, lo):
    # at a tie the derivative is split evenly, as jax.numpy.maximum's is
    p, t = _split(x)
    gate = torch.where(p > lo, torch.ones_like(p),
                       torch.where(p == lo, torch.full_like(p, 0.5),
                                   torch.zeros_like(p)))
    return _lin(torch.clamp_min(p, lo), [(t, gate)])


def _cross(a, b, dim=-1):
    (ap, at), (bp, bt) = _split(a), _split(b)
    ap, bp = torch.broadcast_tensors(ap, bp)
    r = ap.dim()
    parts = []
    if at is not None:
        parts.append(torch.linalg.cross(
            *torch.broadcast_tensors(_aligned(at, r), bp), dim=-1))
    if bt is not None:
        parts.append(torch.linalg.cross(
            *torch.broadcast_tensors(ap, _aligned(bt, r)), dim=-1))
    return _lin(torch.linalg.cross(ap, bp, dim=-1),
                [(t, None) for t in parts])


def _broadcast(*xs):
    shape = torch.broadcast_shapes(*(_split(x)[0].shape for x in xs))
    out = []
    for x in xs:
        p, t = _split(x)
        p = p.expand(shape)
        out.append(p if t is None else Dual(p, _full(x, shape)))
    return out


# torch hands over tensor ⊕ dual as the tensor's method (``add``,
# ``__mul__``, …, the reflected ``__r*__`` with the operands swapped)
_BINARY = {
    "add": _add, "__add__": _add, "__radd__": lambda a, b: _add(b, a),
    "sub": _sub, "__sub__": _sub, "__rsub__": lambda a, b: _sub(b, a),
    "mul": _mul, "__mul__": _mul, "__rmul__": lambda a, b: _mul(b, a),
}


class Dual:
    """A value ``p`` and its tangents ``t`` ((K,) + p's axes)."""

    __slots__ = ("p", "t")

    def __init__(self, p: Tensor, t: Tensor):
        self.p = p
        self.t = t

    @property
    def shape(self):
        return self.p.shape

    def __getitem__(self, key):
        key = key if isinstance(key, tuple) else (key,)
        return Dual(self.p[key],
                    _full(self, self.p.shape)[(slice(None),) + key])

    def reshape(self, *shape):
        shape = shape[0] if len(shape) == 1 and not isinstance(
            shape[0], int) else shape
        return Dual(self.p.reshape(shape),
                    _full(self, self.p.shape).reshape(
                        (self.t.shape[0],) + tuple(shape)))

    def __neg__(self):
        return Dual(-self.p, -self.t)

    def __add__(self, o):
        return _add(self, o)

    def __radd__(self, o):
        return _add(o, self)

    def __sub__(self, o):
        return _sub(self, o)

    def __rsub__(self, o):
        return _sub(o, self)

    def __mul__(self, o):
        return _mul(self, o)

    def __rmul__(self, o):
        return _mul(o, self)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        if name in _BINARY and len(args) == 2 and not kwargs:
            return _BINARY[name](*args)
        if func is torch.stack or func is torch.cat:
            return _join(func, args[0], kwargs.get("dim", args[1]
                                                   if len(args) > 1 else 0))
        if func is torch.sum:
            return _sum(args[0], *args[1:], **kwargs)
        if func is torch.sqrt:
            return _sqrt(args[0])
        if func is torch.clamp_min:
            return _clamp_min(*args)
        if func is torch.linalg.cross:
            return _cross(*args, **kwargs)
        if func is torch.broadcast_tensors:
            return _broadcast(*args)
        raise NotImplementedError(f"Dual does not support {func}")
