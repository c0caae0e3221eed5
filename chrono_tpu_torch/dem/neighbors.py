"""Persistent fixed-capacity neighbour lists with friction-history
migration.

Counterpart of ``chrono_tpu/dem/neighbors.py``: each marker owns K
neighbour slots rebuilt from the sorted cell list (both directions of every
pair are stored, so a force pass is a masked row reduction with no
scatter), and per-slot history is carried between rebuilds by a per-row
sorted join on the partner index.

The list is the JAX package's entry for entry: the candidates come in the
same order (the 27 neighbour cells in ``_OFFSETS_27`` order, each cell's
markers in stable sort order, at most ``max_per_cell`` of them), each row
keeps its first ``k_max`` neighbours in that order, and ``overflow`` holds
both of its capacity terms.  The candidates are built in chunks of
markers, so a million-marker build never holds the whole (N, 27·C, 3)
displacement tensor.  No atomics: the cell counts are integer
``bincount``s.
"""

from __future__ import annotations

import torch

from chrono_tpu_torch.collision.cell_list import (
    GridSpec, build_cell_list, cell_ijk, compact_rows, min_image,
    neighbor_candidates,
)
from chrono_tpu_torch.utils.tree import tensor_dataclass

# candidate entries a chunk of markers holds at once: 2^25 of them are a
# 400 MB displacement tensor in float32
CHUNK_CANDIDATES = 2 ** 25


@tensor_dataclass
class NeighborList:
    """(N, K) padded neighbour table; ``idx == -1`` marks empty slots."""

    idx: torch.Tensor       # (N, K) int32
    valid: torch.Tensor     # (N, K) bool
    overflow: torch.Tensor  # () int32: neighbours dropped by a capacity

    @staticmethod
    def empty(n: int, k: int, device) -> "NeighborList":
        """The list ``make_sph_state`` starts a state with: every slot
        empty."""
        return NeighborList(
            idx=torch.full((n, k), -1, dtype=torch.int32, device=device),
            valid=torch.zeros((n, k), dtype=torch.bool, device=device),
            overflow=torch.zeros((), dtype=torch.int32, device=device))

    def to(self, device) -> "NeighborList":
        return NeighborList(idx=self.idx.to(device),
                            valid=self.valid.to(device),
                            overflow=self.overflow.to(device))


def build_neighbor_list(grid: GridSpec, pos: torch.Tensor, cutoff,
                        max_per_cell: int, k_max: int,
                        chunk: int | None = None) -> NeighborList:
    """Every j ≠ i with |x_j − x_i| < cutoff (minimum image on periodic
    axes), up to ``k_max`` a marker.  ``chunk`` markers are built at a
    time (default: ``CHUNK_CANDIDATES`` candidates' worth)."""
    n = pos.shape[0]
    dev = pos.device
    cl = build_cell_list(grid, pos)
    qijk = cell_ijk(grid, pos)
    if chunk is None:
        chunk = max(1, CHUNK_CANDIDATES // (27 * max_per_cell))
    cut2 = float(cutoff) ** 2
    idx_parts, valid_parts = [], []
    most = torch.zeros((), dtype=torch.int64, device=dev)
    for lo in range(0, n, chunk):
        hi = min(n, lo + chunk)
        cand, cvalid = neighbor_candidates(grid, cl, qijk[lo:hi],
                                           max_per_cell)
        me = torch.arange(lo, hi, dtype=torch.int32, device=dev)[:, None]
        d = min_image(grid, pos[lo:hi, None, :] - pos[cand])
        ok = cvalid & (cand != me) & (torch.sum(d * d, dim=-1) < cut2)
        idx, valid = compact_rows(cand, ok, k_max)
        idx_parts.append(idx)
        valid_parts.append(valid)
        most = torch.maximum(most, ok.sum(dim=1).max())
    overflow = torch.clamp(most - k_max, min=0)
    cell_over = torch.clamp(cl.count.max() - max_per_cell, min=0)
    return NeighborList(
        idx=torch.cat(idx_parts), valid=torch.cat(valid_parts),
        overflow=torch.maximum(overflow, cell_over).to(torch.int32))


def migrate_history(old: NeighborList, old_hist: torch.Tensor,
                    new: NeighborList) -> torch.Tensor:
    """Carry per-slot history (N, K, H) from the old list to the new one:
    each row's old slots sorted by partner (a stable sort), each new
    partner looked up by ``searchsorted`` and the hit checked.  New pairs
    start with zero history."""
    big = torch.iinfo(torch.int32).max
    keys = torch.where(old.valid, old.idx, big)
    keys_sorted, order = torch.sort(keys, dim=1, stable=True)
    hist_sorted = torch.gather(
        old_hist, 1, order[..., None].expand(-1, -1, old_hist.shape[-1]))
    at = torch.searchsorted(keys_sorted.contiguous(),
                            new.idx.contiguous())
    at = torch.clamp(at, max=keys_sorted.shape[1] - 1)
    hit = torch.gather(keys_sorted, 1, at) == new.idx
    found = torch.gather(hist_sorted, 1,
                         at[..., None].expand(-1, -1, old_hist.shape[-1]))
    return torch.where(hit[..., None], found, 0.0)
