"""Deterministic scatter-add of per-row values into per-body sums.

The JAX package accumulates with ``.at[idx].add``.  Its direct counterpart,
``index_add_``, adds with atomics on CUDA, so the order of a body's terms
(and the rounding of its sum) changes from run to run, and a CUDA-graph
replay could not be held bit for bit to the eager loop.  The port's rule is
no atomics and a fixed sum order: :func:`segment_sum` multiplies by the
(bodies × rows) incidence matrix, a product whose sum order is fixed by
its shapes.
Its cost is bodies × rows, which suits the multibody scenes (tens of bodies
and rows); a contact-sized solve needs a gather plan instead.
"""

from __future__ import annotations

import torch
from torch import Tensor


def segment_sum(values: Tensor, idx: Tensor, n: int) -> Tensor:
    """``out[i] = Σ_{k: idx[k] == i} values[k]`` (shape ``(n,) +
    values.shape[1:]``), in the same order on every call."""
    k = values.shape[0]
    onehot = (idx[None, :] == torch.arange(n, device=idx.device)[:, None])
    out = onehot.to(values.dtype) @ values.reshape(k, -1)
    return out.reshape((n,) + values.shape[1:])


def scatter_add(acc: Tensor, idx: Tensor, values: Tensor) -> Tensor:
    """``acc.at[idx].add(values)`` without atomics."""
    return acc + segment_sum(values, idx, acc.shape[0])
