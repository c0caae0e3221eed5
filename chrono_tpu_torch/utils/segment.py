"""Deterministic scatter-add of per-row values into per-body sums.

The JAX package accumulates with ``.at[idx].add``.  Its direct counterpart,
``index_add_``, adds with atomics on CUDA, so the order of a body's terms
(and the rounding of its sum) changes from run to run, and a CUDA-graph
replay could not be held bit for bit to the eager loop.  The port's rule is
no atomics and a fixed sum order, in one of two forms:

- :func:`segment_sum` multiplies by the (bodies × rows) incidence matrix, a
  product whose sum order is fixed by its shapes.  Its cost is bodies ×
  rows, which suits the multibody scenes (tens of bodies and rows).
- :func:`sorted_segments` + :func:`segment_sum_sorted` sort the rows by
  body once (a stable sort, so a body's rows keep their order) and sum each
  body's run with ``torch.segment_reduce``, which adds a segment's entries
  one after the other, in the sorted order, with no cap on a segment's
  length.  Its cost is rows, which suits contact-sized sums (360,000 rows
  on 10,000 bodies), and the order is the one a sequential
  ``.at[idx].add`` takes: each body's rows in row order.
"""

from __future__ import annotations

import torch
from torch import Tensor

from chrono_tpu_torch.utils.tree import tensor_dataclass


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


@tensor_dataclass
class SortedSegments:
    """Rows sorted by the segment they add into (once; reused by every sum
    over the same rows).

    ``order[j]`` is the row in sorted place j; segment i is sorted places
    ``offsets[i]`` to ``offsets[i + 1]``; the rows left out are sorted past
    ``offsets[n]`` and no sum reads them.
    """

    order: Tensor    # (K,) int64
    offsets: Tensor  # (n + 1,) int64

    @property
    def n(self) -> int:
        return self.offsets.shape[0] - 1


def sorted_segments(idx: Tensor, n: int, keep: Tensor | None = None
                    ) -> SortedSegments:
    """Sort rows by ``idx`` (a stable sort: each segment's rows stay in row
    order); rows where ``keep`` is False sort last and are left out of every
    sum.  No host sync: the offsets come from ``searchsorted`` on the sorted
    keys."""
    key = idx.long()
    if keep is not None:
        key = torch.where(keep, key, torch.full_like(key, n))
    key_sorted, order = torch.sort(key, stable=True)
    return SortedSegments(order=order, offsets=torch.searchsorted(
        key_sorted, torch.arange(n + 1, device=idx.device)))


def segment_reduce_sum(values: Tensor, offsets: Tensor) -> Tensor:
    """``torch.segment_reduce`` of the sorted ``values`` by ``offsets``:
    each segment's entries added in their order; the entries past the last
    offset are not read, so rows left out cost nothing however many they
    are."""
    return torch.segment_reduce(values, "sum", offsets=offsets, unsafe=True)


def segment_sum_sorted(seg: SortedSegments, values: Tensor) -> Tensor:
    """``out[i] = Σ values[k]`` over the kept rows k of segment i, added in
    row order (shape ``(n,) + values.shape[1:]``; empty segments are 0)."""
    return segment_reduce_sum(values[seg.order], seg.offsets)


def rank_in_run(key_sorted: Tensor) -> Tensor:
    """Place of each sorted entry in its run of equal keys (0 for the
    first)."""
    n = key_sorted.shape[0]
    arange = torch.arange(n, device=key_sorted.device)
    boundary = torch.ones((n,), dtype=torch.bool, device=key_sorted.device)
    boundary[1:] = key_sorted[1:] != key_sorted[:-1]
    first = torch.cummax(torch.where(boundary, arange,
                                     torch.zeros_like(arange)), 0).values
    return arange - first


def take(a: Tensor, i: Tensor) -> Tensor:
    """``a[i]`` for a 0-d integer device tensor ``i``, as a gather (Python
    indexing with a 0-d tensor may read it on the host, which a CUDA graph
    cannot hold), with ``i`` clamped into range as JAX's gather clamps it
    (a speed past the last shift speed selects the last gear)."""
    i = torch.clamp(i.reshape(1).long(), 0, a.shape[0] - 1)
    return a.index_select(0, i).squeeze(0)
