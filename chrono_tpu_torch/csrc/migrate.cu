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

#include <cuda_runtime.h>

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
