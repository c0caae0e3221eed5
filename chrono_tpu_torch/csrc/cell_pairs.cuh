// The neighbour loop over cell-sorted markers that the SPH and CRM sweeps
// share: a per-cell (start, count) table, the cubic spline, and a walk over
// the 27 neighbour cells that hands each pair inside the support 2h to a
// per-pair callable.  Nothing here knows a sweep's plane layout: the loop
// reads the three position planes it is given.
//
// Ports the pair loop of chrono_tpu/ops/pallas/sph_sym_kernel.py _sym_sweep
// and flatlane_kernel.py sym_sweep_flat (their pair2 callback contract) in
// the GPU-native form: one thread per marker, every pair summed from the
// thread's own side only, in a fixed order, with no atomics.
#pragma once

#include <cuda_runtime.h>

struct Cells {
  const int* cell;    // (N,) cell id (i*ny + j)*nz + k of each sorted marker
  const int* start;   // (n_cells,) first sorted index in the cell
  const int* count;   // (n_cells,) markers in the cell
  int nx, ny, nz, cap;
};

// Cubic spline W and dW/dr at q = r/h, zero for q >= 2 (fsi/sph/kernels.py);
// sigma = 1/(pi h^3).
__device__ __forceinline__ float cubic_w(float q, float sigma) {
  if (q < 1.0f) return sigma * (1.0f - 1.5f * q * q + 0.75f * q * q * q);
  const float t = 2.0f - q;
  return sigma * (0.25f * t * t * t);
}

__device__ __forceinline__ float cubic_dwdr(float q, float h, float sigma) {
  if (q < 1.0f) return sigma / h * (-3.0f * q + 2.25f * q * q);
  const float t = 2.0f - q;
  return sigma / h * (-0.75f * t * t);
}

// Calls pair(j, d, r2, r, q) for every marker j != i of the 27 neighbour
// cells (edge cells skipped; only the first `cap` markers of a cell) that
// lies inside the support (q < 2), in a fixed order.  d = x_i - x_j and
// r = sqrt(r2 + 1e-12).  The position pointers take no __restrict__: the
// CRM outer kernel reads buffers that it writes in a later sweep.
template <class Pair>
__device__ __forceinline__ void for_pairs(const float* px, const float* py,
                                          const float* pz, const Cells& c,
                                          int i, const float xi[3], float h,
                                          Pair&& pair) {
  const int cell = c.cell[i];
  const int ck = cell % c.nz;
  const int cj = (cell / c.nz) % c.ny;
  const int ci = cell / (c.nz * c.ny);
  // q >= 2 for certain beyond this r^2 (margin over rounding)
  const float r2_cut = 4.0004f * h * h;
  for (int dx = -1; dx <= 1; ++dx) {
    const int ii = ci + dx;
    if (ii < 0 || ii >= c.nx) continue;
    for (int dy = -1; dy <= 1; ++dy) {
      const int jj = cj + dy;
      if (jj < 0 || jj >= c.ny) continue;
      for (int dz = -1; dz <= 1; ++dz) {
        const int kk = ck + dz;
        if (kk < 0 || kk >= c.nz) continue;
        const int nc = (ii * c.ny + jj) * c.nz + kk;
        const int s = c.start[nc];
        const int e = s + min(c.count[nc], c.cap);
        for (int j = s; j < e; ++j) {
          if (j == i) continue;
          const float d[3] = {xi[0] - px[j], xi[1] - py[j], xi[2] - pz[j]};
          const float r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
          if (r2 > r2_cut) continue;
          const float r = sqrtf(r2 + 1e-12f);
          const float q = r / h;
          if (q >= 2.0f) continue;
          pair(j, d, r2, r, q);
        }
      }
    }
  }
}

// Whether sorted marker i is among the first `cap` of its cell (takes part).
__device__ __forceinline__ bool live(const Cells& c, int i) {
  return i - c.start[c.cell[i]] < c.cap;
}
