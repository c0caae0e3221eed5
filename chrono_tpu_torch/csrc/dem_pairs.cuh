// The DEM pair physics shared by the fused substep (dem_substep.cu) and the
// forces-only kernel (dem_forces.cu): the Hertz-Mindlin contact force and
// the walk over a particle's neighbours in cell-sorted rows.
//
// Layout (chrono_tpu_torch/dem/rows.py): the occupied particles of a cycle
// are rows in cell order (cell id (i*ny + j)*nz + k, then slot).  state is
// (3, R, 4) float32 -- position, velocity and spin rows as float4 (w = 0)
// -- cell (R,) int32 gives each row's cell (-1 on a dead row; the dead
// rows are the last ones), and table (n_cells,) int2 each cell's first row
// and row count.  One thread owns one row.
//
// The walk: for fixed (dx, dy) the cells (i+dx, j+dy, k-1..k+1) are
// consecutive ids, so their particles are one contiguous run of rows, from
// the first row of cell max(k-1, 0) to the end of cell min(k+1, nz-1).
// A particle's 27 neighbour cells are nine runs (columns off the grid
// skipped), walked in (dx, dy) order and each in row order: the order
// (dx, dy, dz, slot) of the slot walk this replaces, so every particle sums
// its pairs in the same order.  Only occupied candidates are tested; the
// row itself is skipped by index.  Every pair is evaluated from both of its
// sides and summed onto the owner only (swapping the sides flips the force
// and keeps the torque exactly): no atomics, a fixed sum order.
//
// Each candidate costs one 16-byte load of its position (velocities and
// spins are read only for the rare overlapping pair) and a distance-squared
// test that skips the rsqrt of the candidates out of reach.  What bounds
// the walk on an H100 is that load's trip through L1 and the latency of
// the loop, so the kernels cap their registers at 40 a thread for six
// blocks of 256 on an SM (kMinBlocks).  A version that staged each
// (dx, dy) range of a block's positions in shared memory with cp.async was
// 18-43 % slower at every full-width scene (the same bits): shared-memory
// loads of 16 bytes cost the load unit as much as L1 hits, and the copies
// and barriers came on top.

#pragma once

#include <cuda_runtime.h>

constexpr int kThreads = 256;
// blocks of kThreads an SM should hold: caps the registers at 40 a thread
constexpr int kMinBlocks = 6;

struct Rows {
  const float4* pos;    // (R,) rows of the input state
  const float4* vel;
  const float4* omg;
  const int* cell;      // (R,) cell of each row, -1 when dead
  const int2* table;    // (n_cells,) (start, count)
  int n_rows;
};

// Hertz normal plus single-step Coulomb-capped tangential force, on the
// particle whose contact normal (toward the other surface) is nh, given the
// relative surface velocity vr; writes the force into pf.
template <bool kFriction>
__device__ __forceinline__ void contact_force(
    const float nh[3], float delta, const float vr[3], float kn, float gn,
    float kt, float gt, float mu, float dt, float pf[3]) {
  const float sq = sqrtf(delta);
  const float q4 = sqrtf(sq);
  const float vn = vr[0] * nh[0] + vr[1] * nh[1] + vr[2] * nh[2];
  const float fn = fmaxf(kn * sq * delta - gn * q4 * vn, 0.0f);
  float ft[3] = {0.0f, 0.0f, 0.0f};
  if (kFriction) {
    const float coef = kt * sq * dt + gt * q4;
    for (int a = 0; a < 3; ++a) ft[a] = coef * (vr[a] - vn * nh[a]);
    const float ft2 = ft[0] * ft[0] + ft[1] * ft[1] + ft[2] * ft[2] + 1e-18f;
    const float scale = fminf(1.0f, mu * fn * rsqrtf(ft2));
    for (int a = 0; a < 3; ++a) ft[a] *= scale;
  }
  for (int a = 0; a < 3; ++a) pf[a] = -fn * nh[a] + ft[a];
}

// Rows [lo, hi) of the cells (ii, jj, k0..k1); an empty run off the grid.
__device__ __forceinline__ void neighbour_run(const int2* table, int ii,
                                              int jj, int k0, int k1, int nx,
                                              int ny, int nz, int& lo,
                                              int& hi) {
  if (ii < 0 || ii >= nx || jj < 0 || jj >= ny) {
    lo = hi = 0;
    return;
  }
  const int base = (ii * ny + jj) * nz;
  const int2 first = table[base + k0];
  const int2 last = table[base + k1];
  lo = first.x;
  hi = last.x + last.y;
}

// Adds to F and T the pair forces and torques on the live row `row` (in
// cell `cell`, position x, velocity v, spin w) from its nine neighbour
// runs.  P holds the grid (nx, ny, nz) and the pair constants (radius, kn,
// gn, kt, gt, mu, dt: m* = m/2, r* = r/2).
template <bool kFriction, typename P>
__device__ __forceinline__ void add_pair_forces(
    const Rows& rw, const P& p, int row, int cell, const float x[3],
    const float v[3], const float w[3], float F[3], float T[3]) {
  const int k = cell % p.nz;
  const int j = (cell / p.nz) % p.ny;
  const int i = cell / (p.nz * p.ny);
  const int k0 = max(k - 1, 0);
  const int k1 = min(k + 1, p.nz - 1);
  const float r = p.radius;
  // no overlap for certain beyond this |d|^2 (a margin over the rounding of
  // the exact test below), so most candidates skip the rsqrt
  const float cut2 = 4.0004f * r * r;
  for (int o = 0; o < 9; ++o) {
    int lo, hi;
    neighbour_run(rw.table, i + o / 3 - 1, j + o % 3 - 1, k0, k1, p.nx,
                  p.ny, p.nz, lo, hi);
    for (int t = lo; t < hi; ++t) {
      if (t == row) continue;
      const float4 q = rw.pos[t];
      const float d[3] = {q.x - x[0], q.y - x[1], q.z - x[2]};
      const float dist2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
      if (dist2 >= cut2) continue;
      const float inv = rsqrtf(dist2 + 1e-18f);
      const float overlap = 2.0f * r - dist2 * inv;
      if (overlap <= 0.0f) continue;
      const float nh[3] = {d[0] * inv, d[1] * inv, d[2] * inv};
      const float arm = r - 0.5f * overlap;
      const float4 wt = rw.omg[t];
      const float4 vt = rw.vel[t];
      const float ws[3] = {wt.x + w[0], wt.y + w[1], wt.z + w[2]};
      const float cr[3] = {ws[1] * nh[2] - ws[2] * nh[1],
                           ws[2] * nh[0] - ws[0] * nh[2],
                           ws[0] * nh[1] - ws[1] * nh[0]};
      const float vr[3] = {vt.x - v[0] - arm * cr[0],
                           vt.y - v[1] - arm * cr[1],
                           vt.z - v[2] - arm * cr[2]};
      float pf[3];
      contact_force<kFriction>(nh, overlap, vr, p.kn, p.gn, p.kt, p.gt, p.mu,
                               p.dt, pf);
      for (int a = 0; a < 3; ++a) F[a] += pf[a];
      T[0] += arm * (nh[1] * pf[2] - nh[2] * pf[1]);
      T[1] += arm * (nh[2] * pf[0] - nh[0] * pf[2]);
      T[2] += arm * (nh[0] * pf[1] - nh[1] * pf[0]);
    }
  }
}
