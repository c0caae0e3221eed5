// The two sweeps of one CRM (elastoplastic granular SPH) substep, as
// per-marker device functions on cell-sorted markers.  csrc/crm_substep.cu
// launches each as its own kernel; csrc/crm_outer.cu runs them in turn in
// one cooperative launch.
//
// Physics: chrono_tpu/ops/pallas/crm_sym_kernel.py _crm_phys (pairM, postM,
// pairG, postG), which chrono_tpu/fsi/sph/crm.py crm_step / crm_forces
// define term by term:
//
//   M  momentum: stress divergence (a wall neighbour mirrors the granular
//      marker's own stress), artificial viscosity, and the short-range
//      penalty of mixed granular-solid pairs with approach damping; then the
//      kick v + dt (a + g) of integrated markers.  Optionally the raw
//      acceleration a of every marker that takes part (the BCE reduction's
//      input).
//   G  velocity gradient (9 channels) and continuity at the kicked
//      velocities; then, per marker, the Jaumann stress rate, the
//      Drucker-Prager radial return with tension cut-off, the density update
//      with the [0.5, 2] rho0 clip, and the drift x + dt v.
//
// Planes (N floats each, markers sorted by cell id): the TPU kernel's 16
// (pos xyz, vel xyz, rho, sigma xx yy zz xy xz yz, granular flag, integrate
// flag, valid) and one derived plane, 1/max(rho^2, 1e-9), that M reads and
// G's epilogue writes for the next substep.  "valid" marks a marker among
// the first C of its cell: the others are carried through unchanged.  M
// writes, for G, the kicked velocity and 1/max(rho, 1e-9) of every marker.
// Each derived term is computed once per marker, never per pair.  The
// functions take no __restrict__: in the cooperative kernel a buffer one
// sweep reads is written by a later one, so its loads must not go through
// the non-coherent read-only cache.
//
// Each thread sums the pairs of its own marker only (for_pairs in the
// per-sweep kernels; in the whole-outer kernel for_pairs_compact in M and
// M's list in G, which hand over the same pairs in the same order;
// cell_pairs.cuh): no atomics, a fixed order.  A pair beyond 2h is skipped,
// an exact no-op: the cubic dW/dr is 0 there and the penalty needs
// r < d0 < 2h.  The pair loop runs only where its result is used: M on
// integrated markers (on every valid marker when the acceleration is asked
// for), G on integrated markers.
#pragma once

#include <cuda_runtime.h>

#include "cell_pairs.cuh"

struct CrmConsts {
  float h, sigma, m, d0, c_s, alpha_visc, dt, rho0;
  float g[3];
  float G2, K;                  // 2 x shear modulus, bulk modulus
  float alpha_dp, k_c, p_apex;  // Drucker-Prager cone and its apex
  float k_bc, c_bc;             // penalty stiffness c_s^2/d0, damping rate
};

namespace crm {

enum {
  PX, PY, PZ, VX, VY, VZ, RHO, SXX, SYY, SZZ, SXY, SXZ, SYZ, GRN, INT, VAL,
  DER, kPlanes
};
enum { MV_VX, MV_VY, MV_VZ, MV_IRHO, kMv };

// Each sweep is a per-pair body and a per-marker epilogue, so that the
// per-sweep kernels (momentum, gradv_stress: for_pairs) and the whole-outer
// kernel (momentum_listing, gradv_stress_listed: the compacted walk and its
// list) run the same arithmetic.

// Marker i's terms that sweep M's pair body reads.
struct MomentumSelf {
  float v[3];
  float rho, ir2;   // rho and 1/max(rho^2, 1e-9)
  float s[6];       // sigma
  bool gran;
};

__device__ __forceinline__ void momentum_self(const float* st, int n, int i,
                                              MomentumSelf& me) {
  me.rho = st[RHO * n + i];
  me.ir2 = st[DER * n + i];
  me.gran = st[GRN * n + i] > 0.5f;
  for (int a = 0; a < 6; ++a) me.s[a] = st[(SXX + a) * n + i];
}

// Adds pair (i, j) to sweep M's raw acceleration of i.
__device__ __forceinline__ void momentum_pair(const float* st, int n,
                                              const CrmConsts& k,
                                              const MomentumSelf& me, int j,
                                              const float* d, float r2,
                                              float r, float q,
                                              float acc[3]) {
  const float eps_h2 = 0.01f * k.h * k.h;
  const float gf = cubic_dwdr(q, k.h, k.sigma) / fmaxf(r, 1e-12f);
  const float gw[3] = {k.m * gf * d[0], k.m * gf * d[1], k.m * gf * d[2]};
  const bool gj = st[GRN * n + j] > 0.5f;
  const float ir2_j = st[DER * n + j];
  // sigma_i/rho_i^2 + sigma_j/rho_j^2; a wall neighbour carries no evolved
  // stress and mirrors the granular marker's own
  float T[6];
  for (int a = 0; a < 6; ++a)
    T[a] = me.s[a] * me.ir2 + (gj ? st[(SXX + a) * n + j] : me.s[a]) * ir2_j;
  acc[0] += T[0] * gw[0] + T[3] * gw[1] + T[4] * gw[2];
  acc[1] += T[3] * gw[0] + T[1] * gw[1] + T[5] * gw[2];
  acc[2] += T[4] * gw[0] + T[5] * gw[1] + T[2] * gw[2];
  const float vij[3] = {me.v[0] - st[VX * n + j], me.v[1] - st[VY * n + j],
                        me.v[2] - st[VZ * n + j]};
  const float vr = vij[0] * d[0] + vij[1] * d[1] + vij[2] * d[2];
  if (vr < 0.0f) {     // artificial viscosity, approaching pairs
    const float mu_ij = k.h * vr / (r2 + eps_h2);
    const float pi = -k.alpha_visc * k.c_s * mu_ij /
                     (0.5f * (me.rho + st[RHO * n + j]));
    for (int a = 0; a < 3; ++a) acc[a] -= pi * gw[a];
  }
  if (me.gran != gj && r < k.d0) {   // mixed-pair boundary penalty
    const float nh[3] = {d[0] / r, d[1] / r, d[2] / r};
    const float vn = vij[0] * nh[0] + vij[1] * nh[1] + vij[2] * nh[2];
    const float pen = k.k_bc * ((k.d0 - r) / k.d0) -
                      k.c_bc * vn * (vn < 0.0f ? 1.0f : 0.3f);
    for (int a = 0; a < 3; ++a) acc[a] += pen * nh[a];
  }
}

// Sweep M's epilogue: mv (4, N) gets the kicked velocity and 1/rho when
// given; acc_out (3, N) the raw acceleration when given.
__device__ __forceinline__ void momentum_finish(const float* st, int n, int i,
                                                const CrmConsts& k, bool kick,
                                                const float v[3],
                                                const float acc[3],
                                                float* mv, float* acc_out) {
  if (mv != nullptr) {
    for (int a = 0; a < 3; ++a)
      mv[(MV_VX + a) * n + i] =
          kick ? v[a] + k.dt * (acc[a] + k.g[a]) : v[a];
    mv[MV_IRHO * n + i] = 1.0f / fmaxf(st[RHO * n + i], 1e-9f);
  }
  if (acc_out != nullptr)
    for (int a = 0; a < 3; ++a) acc_out[a * n + i] = acc[a];
}

// Sweep M for marker i.  mv (4, N) gets the kicked velocity and 1/rho when
// given; acc (3, N) the raw acceleration when given.
__device__ __forceinline__ void momentum(const float* st, const Cells& c,
                                         int n, int i, const CrmConsts& k,
                                         float* mv, float* acc_out) {
  MomentumSelf me;
  for (int a = 0; a < 3; ++a) me.v[a] = st[(VX + a) * n + i];
  const bool valid = st[VAL * n + i] > 0.5f;
  const bool kick = valid && st[INT * n + i] > 0.5f;
  float acc[3] = {0.0f, 0.0f, 0.0f};
  if (valid && (acc_out != nullptr || (kick && mv != nullptr))) {
    const float xi[3] = {st[PX * n + i], st[PY * n + i], st[PZ * n + i]};
    momentum_self(st, n, i, me);
    for_pairs(st + PX * n, st + PY * n, st + PZ * n, c, i, xi, k.h,
              [&](int j, const float* d, float r2, float r, float q) {
                momentum_pair(st, n, k, me, j, d, r2, r, q, acc);
              });
  }
  momentum_finish(st, n, i, k, kick, me.v, acc, mv, acc_out);
}

// Sweep M of the whole-outer kernel, for marker i (i < 0: a lane past the
// markers, which only votes in the walk), on the compacted walk, with mv
// given.  An integrated marker also lists its in-support neighbours, in walk
// order, for sweep G: the first K in list (K, N), entry t at list[t * n + i]
// (slot-major, so that the lanes of a warp read one slot of consecutive
// markers at once; marker-major was 22 % slower: PERF.md); their number, which
// may pass K, in n_listed[i]; and the largest number seen in most[i].  Every
// lane of a warp calls it together; kDepth and kUnroll are the walk's
// (for_pairs_compact).
template <int kDepth, int kUnroll>
__device__ __forceinline__ void momentum_listing(
    const float* st, const Cells& c, int n, int i, const CrmConsts& k,
    float* mv, float* acc_out, int* list, int K, int* n_listed, int* most,
    int* hits) {
  const bool in = i >= 0;
  const int m = in ? i : 0;
  MomentumSelf me;
  for (int a = 0; a < 3; ++a) me.v[a] = st[(VX + a) * n + m];
  const bool valid = in && st[VAL * n + m] > 0.5f;
  const bool kick = valid && st[INT * n + m] > 0.5f;
  const bool walk = valid && (acc_out != nullptr || kick);
  const float xi[3] = {st[PX * n + m], st[PY * n + m], st[PZ * n + m]};
  if (walk) momentum_self(st, n, m, me);
  float acc[3] = {0.0f, 0.0f, 0.0f};
  int listed = 0;
  for_pairs_compact<kDepth, kUnroll>(
      st + PX * n, st + PY * n, st + PZ * n, c, m, xi, k.h, walk, hits,
      [&](int j, const float* d, float r2, float r, float q) {
        if (kick) {
          if (listed < K) list[listed * n + m] = j;
          ++listed;
        }
        momentum_pair(st, n, k, me, j, d, r2, r, q, acc);
      });
  if (!in) return;
  if (kick) {
    n_listed[i] = listed;
    most[i] = max(most[i], listed);
  }
  momentum_finish(st, n, i, k, kick, me.v, acc, mv, acc_out);
}

// Adds pair (i, j) to sweep G's velocity gradient g[3a + b] =
// sum_j (m/rho_j) (v_j - v_i)_a dW/dx_b and continuity term of i.
__device__ __forceinline__ void gradv_pair(const float* mv, int n,
                                           const CrmConsts& k,
                                           const float v1[3], int j,
                                           const float* d, float r, float q,
                                           float g[9], float& drho) {
  const float gf = cubic_dwdr(q, k.h, k.sigma) / fmaxf(r, 1e-12f);
  const float gw[3] = {gf * d[0], gf * d[1], gf * d[2]};
  const float u[3] = {mv[MV_VX * n + j] - v1[0], mv[MV_VY * n + j] - v1[1],
                      mv[MV_VZ * n + j] - v1[2]};
  const float w = k.m * mv[MV_IRHO * n + j];
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 3; ++b) g[3 * a + b] += w * u[a] * gw[b];
  drho -= k.m * (u[0] * gw[0] + u[1] * gw[1] + u[2] * gw[2]);
}

// Sweep G's epilogue for marker i: out (17, N) gets the next state.
__device__ __forceinline__ void gradv_finish(const float* st, int n, int i,
                                             const CrmConsts& k, bool valid,
                                             bool move, float x[3],
                                             const float v1[3], float s[6],
                                             float rho, const float g[9],
                                             float drho, float* out) {
  if (move) {
    // Jaumann: sigma + dt (2G dev D + K tr D I + W sigma - sigma W)
    const float dxy = 0.5f * (g[1] + g[3]);
    const float dxz = 0.5f * (g[2] + g[6]);
    const float dyz = 0.5f * (g[5] + g[7]);
    const float w1 = 0.5f * (g[1] - g[3]);     // W_xy
    const float w2 = 0.5f * (g[2] - g[6]);     // W_xz
    const float w3 = 0.5f * (g[5] - g[7]);     // W_yz
    const float tr = g[0] + g[4] + g[8];
    const float third = tr / 3.0f;
    const float sxx = s[0], syy = s[1], szz = s[2];
    const float sxy = s[3], sxz = s[4], syz = s[5];
    float t[6];
    t[0] = sxx + k.dt * (k.G2 * (g[0] - third) + k.K * tr +
                         2.0f * (w1 * sxy + w2 * sxz));
    t[1] = syy + k.dt * (k.G2 * (g[4] - third) + k.K * tr +
                         2.0f * (-w1 * sxy + w3 * syz));
    t[2] = szz + k.dt * (k.G2 * (g[8] - third) + k.K * tr +
                         2.0f * (-w2 * sxz - w3 * syz));
    t[3] = sxy + k.dt * (k.G2 * dxy + w1 * (syy - sxx) + w2 * syz + w3 * sxz);
    t[4] = sxz + k.dt * (k.G2 * dxz + w1 * syz + w2 * (szz - sxx) - w3 * sxy);
    t[5] = syz + k.dt * (k.G2 * dyz - w1 * sxz - w2 * sxy + w3 * (szz - syy));
    // Drucker-Prager radial return with tension cut-off
    const float p_mean = -(t[0] + t[1] + t[2]) / 3.0f;
    float e[3];
    for (int a = 0; a < 3; ++a) e[a] = t[a] + p_mean;
    const float J2 = 0.5f * (e[0] * e[0] + e[1] * e[1] + e[2] * e[2]) +
                     (t[3] * t[3] + t[4] * t[4] + t[5] * t[5]);
    const float sqrt_J2 = sqrtf(J2 + 1e-20f);
    const float p_new = fmaxf(p_mean, k.p_apex);
    const float scale = fminf((k.alpha_dp * p_new + k.k_c) / sqrt_J2, 1.0f);
    for (int a = 0; a < 3; ++a) s[a] = e[a] * scale - p_new;
    for (int a = 3; a < 6; ++a) s[a] = t[a] * scale;
    rho += k.dt * drho;
    for (int a = 0; a < 3; ++a) x[a] += k.dt * v1[a];
  }
  if (valid) rho = fminf(fmaxf(rho, 0.5f * k.rho0), 2.0f * k.rho0);
  for (int a = 0; a < 3; ++a) {
    out[(PX + a) * n + i] = x[a];
    out[(VX + a) * n + i] = v1[a];
  }
  out[RHO * n + i] = rho;
  for (int a = 0; a < 6; ++a) out[(SXX + a) * n + i] = s[a];
  for (int f = GRN; f <= VAL; ++f) out[f * n + i] = st[f * n + i];
  out[DER * n + i] = 1.0f / fmaxf(rho * rho, 1e-9f);
}

// Sweep G for marker i: out (17, N) gets the next state.
__device__ __forceinline__ void gradv_stress(const float* st,
                                             const float* mv, const Cells& c,
                                             int n, int i, const CrmConsts& k,
                                             float* out) {
  const float v1[3] = {mv[MV_VX * n + i], mv[MV_VY * n + i],
                       mv[MV_VZ * n + i]};
  const bool valid = st[VAL * n + i] > 0.5f;
  const bool move = valid && st[INT * n + i] > 0.5f;
  float x[3] = {st[PX * n + i], st[PY * n + i], st[PZ * n + i]};
  float s[6];
  for (int a = 0; a < 6; ++a) s[a] = st[(SXX + a) * n + i];
  const float rho = st[RHO * n + i];
  float g[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float drho = 0.0f;
  if (move)
    for_pairs(st + PX * n, st + PY * n, st + PZ * n, c, i, x, k.h,
              [&](int j, const float* d, float, float r, float q) {
                gradv_pair(mv, n, k, v1, j, d, r, q, g, drho);
              });
  gradv_finish(st, n, i, k, valid, move, x, v1, s, rho, g, drho, out);
}

// Sweep G of the whole-outer kernel, for marker i (i < 0: a lane past the
// markers): an integrated marker replays the n_listed[i] pairs that
// momentum_listing listed, or, when they passed K, walks again
// (for_pairs_compact); either way the pairs of for_pairs in its order.
// Every lane of a warp calls it together.
template <int kDepth, int kUnroll>
__device__ __forceinline__ void gradv_stress_listed(
    const float* st, const float* mv, const Cells& c, int n, int i,
    const CrmConsts& k, float* out, const int* list, int K,
    const int* n_listed, int* hits) {
  const bool in = i >= 0;
  const int m = in ? i : 0;
  const float v1[3] = {mv[MV_VX * n + m], mv[MV_VY * n + m],
                       mv[MV_VZ * n + m]};
  const bool valid = in && st[VAL * n + m] > 0.5f;
  const bool move = valid && st[INT * n + m] > 0.5f;
  float x[3] = {st[PX * n + m], st[PY * n + m], st[PZ * n + m]};
  float g[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float drho = 0.0f;
  const int listed = move ? n_listed[m] : 0;
  const auto pair = [&](int j, const float* d, float, float r, float q) {
    gradv_pair(mv, n, k, v1, j, d, r, q, g, drho);
  };
  if (listed <= K)
    for_listed_pairs(st + PX * n, st + PY * n, st + PZ * n, list + m, n,
                     listed, x, k.h, pair);
  for_pairs_compact<kDepth, kUnroll>(st + PX * n, st + PY * n, st + PZ * n,
                                     c, m, x, k.h, listed > K, hits, pair);
  if (!in) return;
  float s[6];
  for (int a = 0; a < 6; ++a) s[a] = st[(SXX + a) * n + i];
  gradv_finish(st, n, i, k, valid, move, x, v1, s, st[RHO * n + i], g, drho,
               out);
}

}  // namespace crm
