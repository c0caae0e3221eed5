// In-place-style rebin of cell slots after a substep cycle, one thread per
// destination cell.
//
// Replaces the TPU kernel chrono_tpu/ops/pallas/migrate_kernel.py
// migrate_flat_pallas (caller chrono_tpu/dem/cell_dense.py migrate_flat).
// Same contract: every particle has moved at most one cell per axis since
// the last binning, so a cell's new occupants all come from its 27-cell
// neighbourhood.  Not the TPU kernel's three axis passes: one gather.
//
// Each thread walks the 27 source cells (edge cells skipped) and their C
// slots in the fixed order (dx, dy, dz, slot), recomputes each valid
// particle's cell from its position exactly as the sort rebin does --
// floor((p - origin) / cell_size) with a true division, clipped to the grid
// -- and copies the first C particles that land in its own cell, with their
// ids, into slots 0..C-1.  The remaining slots are zeroed with mask 0 and id
// -1; count[cell] receives the number of particles that landed, so that
// max(count) - C reports overflow.  A particle that moved two or more cells
// on an axis is found by no cell, which the caller's conservation check
// counts.  No atomics, no scan: the result is deterministic.
//
// What bounds it: at the bench scene 216 k cells x 216 candidate tests,
// each a mask load and three position loads from L1/L2, plus one 10-plane
// copy per particle (70 MB read, 70 MB written).  It runs once per
// rebuild_every substeps, so it is a small share of a cycle.

// The row migration at the end of this file (dem_migrate_rows_launch) is
// the main path's K2; this kernel keeps the slot-plane contract.

#include <cuda_runtime.h>

#include "dem_pairs.cuh"

constexpr int kFeat = 10;
constexpr int kMask = 9;

struct MigrateParams {
  int nx, ny, nz, C;
  float origin[3];
  float cell_size;
};

__device__ __forceinline__ int cell_coord(float p, float o, float size,
                                          int n) {
  const int c = static_cast<int>(floorf((p - o) / size));
  return min(max(c, 0), n - 1);
}

__global__ void __launch_bounds__(256)
dem_migrate_kernel(const float* __restrict__ feat_in,
                   const int* __restrict__ ids_in,
                   float* __restrict__ feat_out, int* __restrict__ ids_out,
                   int* __restrict__ count, int n_cells, MigrateParams p) {
  const int cell = blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= n_cells) return;
  const int C = p.C;
  const int n_slots = n_cells * C;
  const int k = cell % p.nz;
  const int j = (cell / p.nz) % p.ny;
  const int i = cell / (p.nz * p.ny);
  int found = 0;

  for (int dx = -1; dx <= 1; ++dx) {
    const int ii = i + dx;
    if (ii < 0 || ii >= p.nx) continue;
    for (int dy = -1; dy <= 1; ++dy) {
      const int jj = j + dy;
      if (jj < 0 || jj >= p.ny) continue;
      for (int dz = -1; dz <= 1; ++dz) {
        const int kk = k + dz;
        if (kk < 0 || kk >= p.nz) continue;
        const int base = ((ii * p.ny + jj) * p.nz + kk) * C;
        for (int c = 0; c < C; ++c) {
          const int t = base + c;
          if (feat_in[kMask * n_slots + t] < 0.5f) continue;
          if (cell_coord(feat_in[t], p.origin[0], p.cell_size, p.nx) != i ||
              cell_coord(feat_in[n_slots + t], p.origin[1], p.cell_size,
                         p.ny) != j ||
              cell_coord(feat_in[2 * n_slots + t], p.origin[2], p.cell_size,
                         p.nz) != k)
            continue;
          if (found < C) {
            const int d = cell * C + found;
            for (int f = 0; f < kFeat; ++f)
              feat_out[f * n_slots + d] = feat_in[f * n_slots + t];
            ids_out[d] = ids_in[t];
          }
          ++found;
        }
      }
    }
  }
  for (int slot = found; slot < C; ++slot) {
    const int d = cell * C + slot;
    for (int f = 0; f < kFeat; ++f) feat_out[f * n_slots + d] = 0.0f;
    ids_out[d] = -1;
  }
  count[cell] = found;
}

// Launch on `stream`; returns cudaGetLastError() (0 on success).  The caller
// checks shapes and types and that outputs do not overlap inputs.
extern "C" int dem_migrate_launch(const float* feat_in, const int* ids_in,
                                  float* feat_out, int* ids_out, int* count,
                                  int n_cells, const MigrateParams* params,
                                  void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = 256;
  const int blocks = (n_cells + threads - 1) / threads;
  dem_migrate_kernel<<<blocks, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      feat_in, ids_in, feat_out, ids_out, count, n_cells, *params);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// K2 on cell-sorted rows (dem/rows.py): from one cycle's rows to the next
// cycle's, with no slot planes between them.
//
// The same contract and the same result as the slot kernel above on the
// slots that rows_to_planes would fill.  A cell's candidates lie in the
// nine contiguous runs of its 27 source cells (dem_pairs.cuh
// neighbour_run), and the runs in (dx, dy) order visit rows in ascending
// order: the slot kernel's order (dx, dy, dz, slot).  So a cell's landers,
// in that order, are simply the rows that land in it, by ascending row.
// The first C of them become the cell's rows; the next cycle's rows are the
// cells' landers in cell order, then the dead rows (zero, cell -1, id -1).
// rows_from_prefix_slots of the slot kernel's output gives the same rows
// bit for bit.
//
// One warp owns a segment of 32 consecutive cells of a column (i, j).
// For each of its nine neighbour columns (i+dx, j+dy), in (dx, dy) order,
// the runs of the segment's cells together are one contiguous range of
// rows (cells k0-1 .. k0+32); the warp sweeps it 32 rows a step, each lane
// loading one key (coalesced, each key once a column), and
// __match_any_sync groups the lanes whose rows land in the same cell: the
// group's size is the step's landers there, and a lane's rank among them
// is the group's lanes below it.  A running count per cell in shared
// memory (one writer a cell a step: the group's highest lane) carries the
// rank from step to step.
//
// Three launches, no atomics, a fixed order:
//   1. one thread per row writes its new cell id (computed as the slot
//      kernel does: floor((p - origin) / cell_size), a true division,
//      clipped), or -1 for a dead row and for a row that moved more than
//      one cell on an axis, which no cell's neighbourhood holds;
//   2. the sweep counts each cell's landers into landed; each block scans
//      min(landed, C) over its cells (exclusive, in cell order) into the
//      new table's starts and writes its total;
//   3. the sweep again: each block adds the totals of the blocks before it
//      to its starts and writes the table; the lane holding a lander of
//      rank below C copies its row (three float4 state rows, id, cell) to
//      start + rank; every thread also zeroes a share of the dead rows
//      [M', R).
//
// What bounds it: its bound is the rows in and out (~56 B a particle each
// way) and 20 B a cell, 0.035 ms at the settling box (1 M particles, 216 k
// cells) on an NVIDIA H100 80GB HBM3 at 700 W, where the three launches
// took 0.013, 0.028 and 0.068 ms (0.108 in all, against the slot kernel's
// 0.430); with every particle moved up to 0.45 cell the copy took 0.178
// (its stores scatter).  Each sweep reads the keys of a segment's nine
// neighbour columns, ~3x the key array, mostly from L1 and L2.  One thread
// a destination cell walking its nine runs alone (the first version) took
// 0.311 ms, 0.257 of it the copy: a lander's lane copied while its warp's
// other lanes waited, and neighbouring lanes' rows lay 4.6 rows apart.

constexpr int kScanThreads = 256;
constexpr int kSegment = 32;   // cells of a column one warp owns

// Exclusive scan of v over the block's threads (blockDim.x == kScanThreads)
// in `s` (kScanThreads ints of shared memory); returns the scan and sets
// `total`.  Every thread of the block must call it.
__device__ __forceinline__ int block_exclusive_scan(int v, int* s,
                                                    int& total) {
  const int t = threadIdx.x;
  s[t] = v;
  __syncthreads();
  for (int off = 1; off < kScanThreads; off <<= 1) {
    const int add = t >= off ? s[t - off] : 0;
    __syncthreads();
    s[t] += add;
    __syncthreads();
  }
  const int inclusive = s[t];
  total = s[kScanThreads - 1];
  __syncthreads();
  return inclusive - v;
}

// The segment of warp `w`: column (i, j), its first cell k0, its width
// (32, or what is left of the column) and the id c0 of its first cell.
struct Segment {
  int i, j, k0, width, c0;
};

__device__ __forceinline__ Segment segment_of(int w, const MigrateParams& p) {
  const int per_column = (p.nz + kSegment - 1) / kSegment;
  const int column = w / per_column;
  Segment s;
  s.i = column / p.ny;
  s.j = column % p.ny;
  s.k0 = (w % per_column) * kSegment;
  s.width = min(kSegment, p.nz - s.k0);
  s.c0 = column * p.nz + s.k0;
  return s;
}

// Sweeps the segment's nine neighbour columns, 32 rows a step, and calls
// f(t, q, same) on every lane at every step: t the lane's row, q the cell
// in the segment (0 .. width-1) that the row lands in, or -1, and `same`
// the lanes whose q equals the lane's.  The whole warp calls it.
template <typename F>
__device__ __forceinline__ void sweep_segment(const int2* table,
                                              const int* key,
                                              const Segment& s,
                                              const MigrateParams& p,
                                              F&& f) {
  const int lane = threadIdx.x & 31;
  const int k_lo = max(s.k0 - 1, 0);
  const int k_hi = min(s.k0 + s.width, p.nz - 1);
  for (int o = 0; o < 9; ++o) {
    int lo, hi;
    neighbour_run(table, s.i + o / 3 - 1, s.j + o % 3 - 1, k_lo, k_hi, p.nx,
                  p.ny, p.nz, lo, hi);
    for (int base = lo; base < hi; base += 32) {
      const int t = base + lane;
      int q = t < hi ? key[t] - s.c0 : -1;
      if (q < 0 || q >= s.width) q = -1;
      const unsigned same = __match_any_sync(0xffffffffu, q);
      f(t, q, same);
      __syncwarp();
    }
  }
}

__global__ void __launch_bounds__(kScanThreads)
migrate_rows_key_kernel(const float4* __restrict__ pos,
                        const int* __restrict__ cell, int* __restrict__ key,
                        int n_rows, MigrateParams p) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rows) return;
  const int old = cell[r];
  if (old < 0) {
    key[r] = -1;
    return;
  }
  const float4 x = pos[r];
  const int i = cell_coord(x.x, p.origin[0], p.cell_size, p.nx);
  const int j = cell_coord(x.y, p.origin[1], p.cell_size, p.ny);
  const int k = cell_coord(x.z, p.origin[2], p.cell_size, p.nz);
  const bool near = abs(i - old / (p.ny * p.nz)) <= 1 &&
                    abs(j - (old / p.nz) % p.ny) <= 1 &&
                    abs(k - old % p.nz) <= 1;
  key[r] = near ? (i * p.ny + j) * p.nz + k : -1;
}

__global__ void __launch_bounds__(kScanThreads)
migrate_rows_count_kernel(const int2* __restrict__ table,
                          const int* __restrict__ key,
                          int* __restrict__ landed,
                          int2* __restrict__ table_out,
                          int* __restrict__ block_total, int n_segments,
                          MigrateParams p) {
  extern __shared__ int smem[];     // the scan, then a count a lane
  int* count = smem + kScanThreads + (threadIdx.x & ~31);
  const int lane = threadIdx.x & 31;
  const int w = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const bool owns = w < n_segments;          // the same for the warp
  Segment s{0, 0, 0, 0, 0};
  count[lane] = 0;
  __syncwarp();
  if (owns) {
    s = segment_of(w, p);
    sweep_segment(table, key, s, p, [&](int, int q, unsigned same) {
      if (q >= 0 && lane == 31 - __clz(same)) count[q] += __popc(same);
    });
  }
  const bool real = owns && lane < s.width;
  const int found = real ? count[lane] : 0;
  int total;
  const int start = block_exclusive_scan(min(found, p.C), smem, total);
  if (real) {
    landed[s.c0 + lane] = found;
    table_out[s.c0 + lane] = make_int2(start, min(found, p.C));
  }
  if (threadIdx.x == 0) block_total[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kScanThreads)
migrate_rows_write_kernel(const float4* __restrict__ state,
                          const int* __restrict__ ids,
                          const int2* __restrict__ table,
                          const int* __restrict__ key,
                          const int* __restrict__ block_total,
                          float4* __restrict__ state_out,
                          int* __restrict__ ids_out,
                          int* __restrict__ cell_out,
                          int2* __restrict__ table_out, int n_rows,
                          int n_segments, MigrateParams p) {
  extern __shared__ int smem[];     // the scan, a first row and a count a lane
  int* first = smem + kScanThreads + (threadIdx.x & ~31);
  int* count = first + kScanThreads;
  // the landers of the blocks before this one, and of all blocks
  int before = 0, all = 0;
  for (int b = threadIdx.x; b < static_cast<int>(gridDim.x);
       b += blockDim.x) {
    const int v = block_total[b];
    all += v;
    if (b < static_cast<int>(blockIdx.x)) before += v;
  }
  int offset, n_live;
  block_exclusive_scan(before, smem, offset);
  block_exclusive_scan(all, smem, n_live);

  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const int w = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (w < n_segments) {                      // the same for the warp
    const Segment s = segment_of(w, p);
    if (lane < s.width) {
      const int2 slot = table_out[s.c0 + lane];   // (start in the block, n)
      first[lane] = offset + slot.x;
      table_out[s.c0 + lane] = make_int2(offset + slot.x, slot.y);
    }
    count[lane] = 0;
    __syncwarp();
    sweep_segment(table, key, s, p, [&](int t, int q, unsigned same) {
      const int rank = q >= 0 ? count[q] + __popc(same & below) : p.C;
      if (rank < p.C) {
        const int d = first[q] + rank;
        for (int f = 0; f < 3; ++f)
          state_out[f * n_rows + d] = state[f * n_rows + t];
        ids_out[d] = ids[t];
        cell_out[d] = s.c0 + q;
      }
      __syncwarp();                 // every rank read before the update
      if (q >= 0 && lane == 31 - __clz(same)) count[q] += __popc(same);
    });
  }
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int r = n_live + blockIdx.x * blockDim.x + threadIdx.x; r < n_rows;
       r += gridDim.x * blockDim.x) {
    for (int f = 0; f < 3; ++f) state_out[f * n_rows + r] = zero;
    ids_out[r] = -1;
    cell_out[r] = -1;
  }
}

// Launch the three passes on `stream`; returns cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue when the grid is not n_cells or
// block_total holds fewer than the launches' blocks: one warp for each
// segment of 32 cells of a column, nx * ny * ceil(nz / 32) warps in blocks
// of 8.  key (n_rows,) and block_total (n_blocks,) are int32 scratch.  The
// caller checks shapes and types and that outputs do not overlap inputs.
extern "C" int dem_migrate_rows_launch(
    const float* state, const int* cell, const int* table, const int* ids,
    float* state_out, int* cell_out, int* table_out, int* ids_out,
    int* landed, int* key, int* block_total, int n_rows, int n_cells,
    int n_blocks, const MigrateParams* params, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const MigrateParams& p = *params;
  const int n_segments =
      p.nx * p.ny * ((p.nz + kSegment - 1) / kSegment);
  const int blocks = (n_segments * 32 + kScanThreads - 1) / kScanThreads;
  if (n_cells != p.nx * p.ny * p.nz || n_blocks < blocks)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int smem = static_cast<int>(sizeof(int)) * 3 * kScanThreads;
  const float4* st = reinterpret_cast<const float4*>(state);
  const int2* tb = reinterpret_cast<const int2*>(table);
  int2* tb_out = reinterpret_cast<int2*>(table_out);
  migrate_rows_key_kernel<<<(n_rows + kScanThreads - 1) / kScanThreads,
                            kScanThreads, 0, s>>>(st, cell, key, n_rows, p);
  migrate_rows_count_kernel<<<blocks, kScanThreads, smem, s>>>(
      tb, key, landed, tb_out, block_total, n_segments, p);
  migrate_rows_write_kernel<<<blocks, kScanThreads, smem, s>>>(
      st, ids, tb, key, block_total, reinterpret_cast<float4*>(state_out),
      ids_out, cell_out, tb_out, n_rows, n_segments, p);
  return static_cast<int>(cudaGetLastError());
}
