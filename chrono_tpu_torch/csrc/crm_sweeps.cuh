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
// Each thread sums the pairs of its own marker only, in the walk order
// (cell_pairs.cuh): no atomics in any sum, a fixed order.  Sweep M walks
// for_pairs_compact and lists each integrated marker's neighbours; sweep G
// replays that list.  Both read a neighbour's terms from a packed record
// (RecordNbr, RecordMv) that a pass ahead of the sweep writes.  A pair
// beyond 2h is skipped, an exact no-op: the cubic dW/dr is 0 there and the
// penalty needs r < d0 < 2h.  The pair loop runs only where its result is
// used: M on integrated markers (on every valid marker when the
// acceleration is asked for), G on integrated markers.
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

// Each sweep is a per-pair body and a per-marker epilogue, run by
// momentum_listing and gradv_stress_listed, which the per-sweep kernels
// and the whole-outer kernel both call, so that they run the same
// arithmetic.

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

// Neighbour j's terms that sweep M's pair body reads, from its packed
// record: three float4 of the (N, 12) records that pack_momentum_record
// wrote, three 16-byte loads a pair in place of up to twelve loads from
// twelve planes.
struct RecordNbr {
  // (v, rho), sigma xx yy zz xy, (sigma xz yz, 1/rho^2, granular flag)
  float4 a, b, c;
  __device__ __forceinline__ static RecordNbr at(const float4* rec, int j) {
    return {rec[3 * j], rec[3 * j + 1], rec[3 * j + 2]};
  }
  __device__ __forceinline__ float gran() const { return c.w; }
  __device__ __forceinline__ float ir2() const { return c.z; }
  __device__ __forceinline__ float s(int k) const {
    const float t[6] = {b.x, b.y, b.z, b.w, c.x, c.y};
    return t[k];
  }
  __device__ __forceinline__ float v(int k) const {
    return k == 0 ? a.x : k == 1 ? a.y : a.z;
  }
  __device__ __forceinline__ float rho() const { return a.w; }
};

// Marker i's record for RecordNbr.
__device__ __forceinline__ void pack_momentum_record(const float* st, int n,
                                                     int i, float4* rec) {
  rec[3 * i] = make_float4(st[VX * n + i], st[VY * n + i], st[VZ * n + i],
                           st[RHO * n + i]);
  rec[3 * i + 1] = make_float4(st[SXX * n + i], st[SYY * n + i],
                               st[SZZ * n + i], st[SXY * n + i]);
  rec[3 * i + 2] = make_float4(st[SXZ * n + i], st[SYZ * n + i],
                               st[DER * n + i], st[GRN * n + i]);
}

// Adds pair (i, j) to sweep M's raw acceleration of i; nb is j's record.
__device__ __forceinline__ void momentum_pair(const CrmConsts& k,
                                              const MomentumSelf& me,
                                              const RecordNbr& nb,
                                              const float* d, float r2,
                                              float r, float q,
                                              float acc[3]) {
  const float eps_h2 = 0.01f * k.h * k.h;
  const float gf = cubic_dwdr(q, k.h, k.sigma) / fmaxf(r, 1e-12f);
  const float gw[3] = {k.m * gf * d[0], k.m * gf * d[1], k.m * gf * d[2]};
  const bool gj = nb.gran() > 0.5f;
  const float ir2_j = nb.ir2();
  // sigma_i/rho_i^2 + sigma_j/rho_j^2; a wall neighbour carries no evolved
  // stress and mirrors the granular marker's own
  float T[6];
  for (int a = 0; a < 6; ++a)
    T[a] = me.s[a] * me.ir2 + (gj ? nb.s(a) : me.s[a]) * ir2_j;
  acc[0] += T[0] * gw[0] + T[3] * gw[1] + T[4] * gw[2];
  acc[1] += T[3] * gw[0] + T[1] * gw[1] + T[5] * gw[2];
  acc[2] += T[4] * gw[0] + T[5] * gw[1] + T[2] * gw[2];
  const float vij[3] = {me.v[0] - nb.v(0), me.v[1] - nb.v(1),
                        me.v[2] - nb.v(2)};
  const float vr = vij[0] * d[0] + vij[1] * d[1] + vij[2] * d[2];
  if (vr < 0.0f) {     // artificial viscosity, approaching pairs
    const float mu_ij = k.h * vr / (r2 + eps_h2);
    const float pi = -k.alpha_visc * k.c_s * mu_ij /
                     (0.5f * (me.rho + nb.rho()));
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

// Sweep M for marker i (i < 0: a lane past the markers, which only votes
// in the walk), on for_pairs_compact (every lane of a warp calls it
// together; kDepth and kUnroll are the walk's), with the neighbours' terms
// from the records rec (pack_momentum_record).  mv (4, N) gets the kicked
// velocity and 1/rho when given; acc (3, N) the raw acceleration of every
// valid marker when given.  With list given, a
// kicked marker also lists its in-support neighbours, in walk order, for
// sweep G: the first K in list (K, N), entry t at list[t * n + i]
// (slot-major, so that the lanes of a warp read one slot of consecutive
// markers at once; marker-major was 22 % slower in crm_outer: PERF.md);
// their number, which may pass K, in n_listed[i]; and, with most given,
// the largest number seen in most[i].
template <int kDepth, int kUnroll>
__device__ __forceinline__ void momentum_listing(
    const float* st, const Cells& c, int n, int i, const CrmConsts& k,
    const float4* rec, float* mv, float* acc_out, int* list, int K,
    int* n_listed, int* most, int* hits) {
  const bool in = i >= 0;
  const int m = in ? i : 0;
  MomentumSelf me;
  for (int a = 0; a < 3; ++a) me.v[a] = st[(VX + a) * n + m];
  const bool valid = in && st[VAL * n + m] > 0.5f;
  const bool kick = valid && st[INT * n + m] > 0.5f;
  const bool lists = kick && list != nullptr;
  const bool walking = valid && (acc_out != nullptr ||
                                 (kick && mv != nullptr));
  const float xi[3] = {st[PX * n + m], st[PY * n + m], st[PZ * n + m]};
  if (walking) momentum_self(st, n, m, me);
  float acc[3] = {0.0f, 0.0f, 0.0f};
  int listed = 0;
  for_pairs_compact<kDepth, kUnroll>(
      st + PX * n, st + PY * n, st + PZ * n, c, m, xi, k.h, walking, hits,
      [&](int j, const float* d, float r2, float r, float q) {
        if (lists) {
          if (listed < K) list[listed * n + m] = j;
          ++listed;
        }
        momentum_pair(k, me, RecordNbr::at(rec, j), d, r2, r, q, acc);
      });
  if (!in) return;
  if (lists) {
    n_listed[i] = listed;
    if (most != nullptr) most[i] = max(most[i], listed);
  }
  momentum_finish(st, n, i, k, kick, me.v, acc, mv, acc_out);
}

// Neighbour j's position and M's kicked velocity and 1/rho, as sweep G
// reads them: two float4 of the (N, 8) records that pack_gradv_record
// wrote, (x, 1/rho) and (v1, 0), two 16-byte loads a listed pair in place
// of seven loads from seven planes.
struct RecordMv {
  const float4* rec;
  __device__ __forceinline__ void pos(int j, float xj[3]) const {
    const float4 p = rec[2 * j];
    xj[0] = p.x;
    xj[1] = p.y;
    xj[2] = p.z;
  }
  __device__ __forceinline__ float v(int j, int a) const {
    const float4 w = rec[2 * j + 1];
    return a == 0 ? w.x : a == 1 ? w.y : w.z;
  }
  __device__ __forceinline__ float irho(int j) const { return rec[2 * j].w; }
};

// Marker i's record for RecordMv.
__device__ __forceinline__ void pack_gradv_record(const float* st,
                                                  const float* mv, int n,
                                                  int i, float4* rec) {
  rec[2 * i] = make_float4(st[PX * n + i], st[PY * n + i], st[PZ * n + i],
                           mv[MV_IRHO * n + i]);
  rec[2 * i + 1] = make_float4(mv[MV_VX * n + i], mv[MV_VY * n + i],
                               mv[MV_VZ * n + i], 0.0f);
}

// Adds pair (i, j) to sweep G's velocity gradient g[3a + b] =
// sum_j (m/rho_j) (v_j - v_i)_a dW/dx_b and continuity term of i; src
// holds j's kicked velocity and 1/rho.
__device__ __forceinline__ void gradv_pair(const RecordMv& src,
                                           const CrmConsts& k,
                                           const float v1[3], int j,
                                           const float* d, float r, float q,
                                           float g[9], float& drho) {
  const float gf = cubic_dwdr(q, k.h, k.sigma) / fmaxf(r, 1e-12f);
  const float gw[3] = {gf * d[0], gf * d[1], gf * d[2]};
  const float u[3] = {src.v(j, 0) - v1[0], src.v(j, 1) - v1[1],
                      src.v(j, 2) - v1[2]};
  const float w = k.m * src.irho(j);
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

// Sweep G for marker i (i < 0: a lane past the markers): out (17, N) gets
// the next state.  An integrated marker replays the n_listed[i] pairs that
// momentum_listing listed, or, when they passed K, walks again
// (for_pairs_compact; every lane of a warp calls it together); either way
// the pairs of the walk in its order.  src gives the neighbours'
// positions for the replay and their kicked velocities and 1/rho.
template <int kDepth, int kUnroll>
__device__ __forceinline__ void gradv_stress_listed(
    const float* st, const float* mv, const Cells& c, int n, int i,
    const CrmConsts& k, const RecordMv& src, float* out, const int* list,
    int K, const int* n_listed, int* hits) {
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
    gradv_pair(src, k, v1, j, d, r, q, g, drho);
  };
  if (listed <= K)
    for_listed_pairs(list + m, n, listed, x, k.h,
                     [&](int j, float xj[3]) { src.pos(j, xj); }, pair);
  for_pairs_compact<kDepth, kUnroll>(st + PX * n, st + PY * n, st + PZ * n,
                                     c, m, x, k.h, listed > K, hits, pair);
  if (!in) return;
  float s[6];
  for (int a = 0; a < 6; ++a) s[a] = st[(SXX + a) * n + i];
  gradv_finish(st, n, i, k, valid, move, x, v1, s, st[RHO * n + i], g, drho,
               out);
}

}  // namespace crm
