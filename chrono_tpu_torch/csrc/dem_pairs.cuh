// The DEM pair physics shared by the fused substep (dem_substep.cu) and the
// forces-only kernel (dem_forces.cu): the Hertz-Mindlin contact force and
// the 27-cell pair loop over (10, n_cells, C) slot planes.
//
// Layout: planes pos xyz, vel xyz, omega xyz, mask, with cell id
// (i*ny + j)*nz + k and slot s = cell*C + slot.  The owner of slot s walks
// the 27 neighbour cells (edge cells skipped) and their C slots in a fixed
// order and sums each pair's force onto itself only: every pair is
// evaluated from both of its sides, and swapping the two sides flips the
// force and keeps the torque exactly.  So there are no atomics, and the sum
// order is deterministic.

#pragma once

#include <cuda_runtime.h>

constexpr int kFeat = 10;
constexpr int kMask = 9;

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

// Adds to F and T the pair forces and torques on the valid slot s, whose
// ten values are x.  P holds the grid (nx, ny, nz, C) and the pair
// constants (radius, kn, gn, kt, gt, mu, dt: m* = m/2, r* = r/2).
template <bool kFriction, typename P>
__device__ __forceinline__ void add_pair_forces(
    const float* __restrict__ in, int n_slots, int s, const float x[kFeat],
    const P& p, float F[3], float T[3]) {
  const int C = p.C;
  const int cell = s / C;
  const int k = cell % p.nz;
  const int j = (cell / p.nz) % p.ny;
  const int i = cell / (p.nz * p.ny);
  const float r = p.radius;
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
          if (t == s || in[kMask * n_slots + t] < 0.5f) continue;
          const float d[3] = {in[t] - x[0], in[n_slots + t] - x[1],
                              in[2 * n_slots + t] - x[2]};
          const float dist2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
          const float inv = rsqrtf(dist2 + 1e-18f);
          const float overlap = 2.0f * r - dist2 * inv;
          if (overlap <= 0.0f) continue;
          const float nh[3] = {d[0] * inv, d[1] * inv, d[2] * inv};
          const float arm = r - 0.5f * overlap;
          float ws[3], vr[3];
          for (int a = 0; a < 3; ++a)
            ws[a] = in[(6 + a) * n_slots + t] + x[6 + a];
          const float cr[3] = {ws[1] * nh[2] - ws[2] * nh[1],
                               ws[2] * nh[0] - ws[0] * nh[2],
                               ws[0] * nh[1] - ws[1] * nh[0]};
          for (int a = 0; a < 3; ++a)
            vr[a] = in[(3 + a) * n_slots + t] - x[3 + a] - arm * cr[a];
          float pf[3];
          contact_force<kFriction>(nh, overlap, vr, p.kn, p.gn, p.kt, p.gt,
                                   p.mu, p.dt, pf);
          for (int a = 0; a < 3; ++a) F[a] += pf[a];
          T[0] += arm * (nh[1] * pf[2] - nh[2] * pf[1]);
          T[1] += arm * (nh[2] * pf[0] - nh[0] * pf[2]);
          T[2] += arm * (nh[0] * pf[1] - nh[1] * pf[0]);
        }
      }
    }
  }
}
