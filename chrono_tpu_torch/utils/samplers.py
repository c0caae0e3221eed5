"""Particle samplers: grid, HCP and Poisson-disk points, a streaming
emitter and granular mixtures (host-side numpy, runs once at scene build).

Counterpart of ``chrono_tpu/utils/samplers.py``.  Copied rather than
imported, because importing ``chrono_tpu.utils`` imports JAX; the code is
the same, and every random draw comes from a ``numpy`` generator seeded as
the JAX package's is, so both packages give the same points, bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch


def grid_sample_box(lo, hi, spacing, jitter=0.0, seed=0) -> np.ndarray:
    """Regular grid with optional random jitter, points at cell centers."""
    lo = np.asarray(lo, float)
    hi = np.asarray(hi, float)
    counts = np.maximum(((hi - lo) / spacing).astype(int), 1)
    axes = [lo[i] + spacing * (np.arange(counts[i]) + 0.5) for i in range(3)]
    pts = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).reshape(-1, 3)
    if jitter > 0:
        rng = np.random.default_rng(seed)
        pts = pts + rng.uniform(-jitter, jitter, pts.shape) * spacing
    return pts


def hcp_sample_box(lo, hi, radius) -> np.ndarray:
    """Hexagonal-close-packed sphere centers filling an axis-aligned box."""
    lo = np.asarray(lo, float)
    hi = np.asarray(hi, float)
    d = 2.0 * radius
    dx = d
    dy = d * np.sqrt(3.0) / 2.0
    dz = d * np.sqrt(6.0) / 3.0
    pts = []
    k = 0
    z = lo[2] + radius
    while z <= hi[2] - radius + 1e-12:
        j = 0
        y = lo[1] + radius + (dy / 3.0 if k % 2 else 0.0)
        while y <= hi[1] - radius + 1e-12:
            x0 = lo[0] + radius + (radius if (j + k) % 2 else 0.0)
            xs = np.arange(x0, hi[0] - radius + 1e-12, dx)
            row = np.stack([xs, np.full_like(xs, y), np.full_like(xs, z)],
                           axis=-1)
            pts.append(row)
            y += dy
            j += 1
        z += dz
        k += 1
    return (np.concatenate(pts, axis=0) if pts
            else np.zeros((0, 3)))


def poisson_disk_sample_box(lo, hi, min_dist, seed=0,
                            k_tries=30) -> np.ndarray:
    """Bridson-style Poisson-disk sampling inside a box."""
    rng = np.random.default_rng(seed)
    lo = np.asarray(lo, float)
    hi = np.asarray(hi, float)
    cell = min_dist / np.sqrt(3.0)
    dims = np.maximum(((hi - lo) / cell).astype(int) + 1, 1)
    grid = -np.ones(dims, dtype=int)
    pts = []
    active = []

    def gidx(p):
        return tuple(((p - lo) / cell).astype(int).clip(0, dims - 1))

    def ok(p):
        if np.any(p < lo) or np.any(p > hi):
            return False
        gi = np.array(gidx(p))
        sl = tuple(slice(max(0, gi[i] - 2), min(dims[i], gi[i] + 3))
                   for i in range(3))
        for idx in grid[sl].ravel():
            if idx >= 0 and np.linalg.norm(pts[idx] - p) < min_dist:
                return False
        return True

    p0 = rng.uniform(lo, hi)
    pts.append(p0)
    grid[gidx(p0)] = 0
    active.append(0)
    while active:
        i = active[rng.integers(len(active))]
        found = False
        for _ in range(k_tries):
            dir_ = rng.normal(size=3)
            dir_ /= np.linalg.norm(dir_)
            p = pts[i] + dir_ * rng.uniform(min_dist, 2 * min_dist)
            if ok(p):
                pts.append(p)
                grid[gidx(p)] = len(pts) - 1
                active.append(len(pts) - 1)
                found = True
                break
        if not found:
            active.remove(i)
    return np.asarray(pts)


class ParticleEmitter:
    """Streaming particle source: emits
    particles-per-second from a box region with randomized positions and
    velocities, activating pre-allocated slots of a fixed-capacity DEM state
    (TPU shapes stay static — emission flips validity, it never reallocates).
    """

    def __init__(self, box_lo, box_hi, rate, vel_mean=(0, 0, 0),
                 vel_sigma=0.0, seed=0):
        self.lo = np.asarray(box_lo, float)
        self.hi = np.asarray(box_hi, float)
        self.rate = float(rate)
        self.vel_mean = np.asarray(vel_mean, float)
        self.vel_sigma = float(vel_sigma)
        self.rng = np.random.default_rng(seed)
        self._carry = 0.0

    def emit(self, dt):
        """Positions/velocities of particles born in this interval.

        Returns (pos (k,3), vel (k,3)) with k = floor(rate·dt + carry).
        """
        self._carry += self.rate * dt
        k = int(self._carry)
        self._carry -= k
        pos = self.rng.uniform(self.lo, self.hi, (k, 3))
        vel = self.vel_mean + self.vel_sigma * self.rng.standard_normal((k, 3))
        return pos, vel

    def emit_into(self, state, dt):
        """Activate up to k inactive slots of a padded DEM-style state.

        ``state`` needs ``pos``/``vel`` tensors and a boolean ``active``
        mask; returns (new_pos, new_vel, new_active, n_emitted), tensors
        on the state's device.
        """
        pos, vel = self.emit(dt)
        if len(pos) == 0:
            return state.pos, state.vel, state.active, 0
        active = state.active.cpu().numpy().copy()
        free = np.where(~active)[0][: len(pos)]
        p = state.pos.cpu().numpy().copy()
        v = state.vel.cpu().numpy().copy()
        p[free] = pos[: len(free)]
        v[free] = vel[: len(free)]
        active[free] = True
        return (torch.as_tensor(p, device=state.pos.device),
                torch.as_tensor(v, device=state.vel.device),
                torch.as_tensor(active, device=state.active.device),
                len(free))


class MixtureIngredient:
    """One ingredient of a granular mixture: a relative ratio plus
    per-particle property
    distributions (constant or (mean, stddev) truncated normal)."""

    def __init__(self, ratio=1.0, radius=0.01, density=2500.0, mu=0.5,
                 restitution=0.5, youngs=1e7):
        self.ratio = float(ratio)
        self.props = dict(radius=radius, density=density, mu=mu,
                          restitution=restitution, youngs=youngs)

    def _draw(self, key, n, rng):
        spec = self.props[key]
        if isinstance(spec, (tuple, list)) and len(spec) == 2:
            mean, sd = spec
            v = rng.normal(mean, sd, n)
            return np.clip(v, mean - 2 * sd, mean + 2 * sd)
        return np.full(n, float(spec))


def generate_mixture(points, ingredients, seed=0):
    """Assign mixture ingredients to sampled ``points`` (N,3) by ratio.

    Returns a dict of per-particle arrays: ``which`` (ingredient index),
    ``radius``, ``density``, ``mass``, ``mu``, ``restitution``, ``youngs`` —
    ready to feed SphereShapes / body builders."""
    rng = np.random.default_rng(seed)
    n = len(points)
    ratios = np.asarray([ing.ratio for ing in ingredients], float)
    ratios = ratios / ratios.sum()
    which = rng.choice(len(ingredients), size=n, p=ratios)
    out = {"which": which}
    for key in ("radius", "density", "mu", "restitution", "youngs"):
        vals = np.empty(n)
        for i, ing in enumerate(ingredients):
            m = which == i
            vals[m] = ing._draw(key, int(m.sum()), rng)
        out[key] = vals
    out["mass"] = out["density"] * 4.0 / 3.0 * np.pi * out["radius"] ** 3
    return out
