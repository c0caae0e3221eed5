// The two sweeps of one APGD iteration of the NSC/DVI cone-complementarity
// solve, on cell-sorted bodies with single-sided multipliers, one thread per
// body.
//
// Replaces the TPU kernels chrono_tpu/ops/pallas/nsc_half_kernel.py
// nsc_half_sweep_u_pallas / nsc_half_sweep_g_pallas (on _call_half:401), and
// the layouts before them, nsc_partner_kernel.py _call_sweep:328 and
// nsc_pencil_kernel.py nsc_sweep_u_pallas:544 / nsc_sweep_g_pallas:607.  The
// physics is chrono_tpu/solver/nsc_pencil.py dense_sweep_u / dense_sweep_g's.
//
//   U: u = u_free + M^-1 D^T y,  y = gam + beta (gam - gam_prev)
//   G: gam+ = Proj_cone(y - s (D u - b)),  s = omega / diag(N) per row
//
// Layout (N sorted bodies, P partner slots, W walls): pos (3, N), u_free and
// u (6, N: v then w), the partner table (N, P) int32 packed from slot 0
// (-1 = empty), multipliers gam (3, N, P) and wall multipliers (3, N, W).
// Each contact is stored once, on its owner, in the owner's frame (normal
// owner -> partner).  The partner sees (gn, gu, -gv) in the frame (-n, -t1,
// t2), so its reaction is -force and +torque of the owner's.  U sums, per
// body: its owned contacts in slot order, then the contacts that name it as
// partner (a reverse table sorted by owner and slot), then its walls.  G
// writes each owned contact's and each wall row's new multipliers.  No
// atomics; every sum has a fixed order.  G reads U's output of the same
// iteration and writes fresh buffers: nothing runs in place.
//
// What bounds it: at the bladed mixer (40,000 bodies, ~2.85 contacts owned
// per body, 6 walls) U needs ~7 MB and G ~11 MB of traffic, 2-3 us at HBM
// rate, and ~100-150 flops per contact.  Measured on an NVIDIA H100 80GB HBM3
// at a 700 W limit, U takes ~8 us and G ~20 us per launch, shorter than the
// host's cost to issue a launch from Python (40-85 us): the 101 launches of
// a DVI step set its pace, not the kernels.  At 400,000 bodies G (~0.15 ms,
// one thread walking six slots serially) is the larger.  Kept simple: no
// shared-memory staging, one thread per body.

#include <cuda_runtime.h>

#include "nsc_pair.cuh"

namespace {

__device__ __forceinline__ void load3(const float* __restrict__ p, int n,
                                      int i, float out[3]) {
  out[0] = p[i];
  out[1] = p[n + i];
  out[2] = p[2 * n + i];
}

// y = g + beta (g - gp) of row e of a (3, rows) multiplier array
__device__ __forceinline__ void extrapolate(const float* __restrict__ g,
                                            const float* __restrict__ gp,
                                            int rows, int e, float beta,
                                            float y[3]) {
  for (int c = 0; c < 3; ++c) {
    const float a = g[c * rows + e];
    y[c] = a + beta * (a - gp[c * rows + e]);
  }
}

__global__ void __launch_bounds__(256)
nsc_sweep_u_kernel(const float* __restrict__ pos,
                   const float* __restrict__ ufree,
                   const float* __restrict__ g, const float* __restrict__ gp,
                   const float* __restrict__ wg,
                   const float* __restrict__ wgp,
                   const int* __restrict__ partners,
                   const int* __restrict__ rev_start,
                   const int* __restrict__ rev_count,
                   const int* __restrict__ rev, const float* __restrict__ cs,
                   float* __restrict__ u, int n, int P, float beta,
                   NscParams k) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int np = n * P, nw = n * k.n_walls;
  float xi[3], xj[3], y[3], F[3], T[3];
  load3(pos, n, i, xi);
  float f[3] = {0.0f, 0.0f, 0.0f}, tq[3] = {0.0f, 0.0f, 0.0f};
  for (int p = 0; p < P; ++p) {                        // owned contacts
    const int e = i * P + p;
    const int j = partners[e];
    if (j < 0) break;
    load3(pos, n, j, xj);
    const Frame fr = pair_frame(xi, xj, k.radius);
    extrapolate(g, gp, np, e, beta, y);
    row_impulse(fr, y, F, T);
    for (int a = 0; a < 3; ++a) {
      f[a] -= F[a];
      tq[a] += T[a];
    }
  }
  const int r1 = rev_start[i] + rev_count[i];
  for (int r = rev_start[i]; r < r1; ++r) {          // named as partner
    const int e = rev[r];
    load3(pos, n, e / P, xj);
    const Frame fr = pair_frame(xj, xi, k.radius);
    extrapolate(g, gp, np, e, beta, y);
    row_impulse(fr, y, F, T);
    for (int a = 0; a < 3; ++a) {
      f[a] += F[a];
      tq[a] += T[a];
    }
  }
  for (int w = 0; w < k.n_walls; ++w) {                // walls
    float vs[3];
    const Frame fr = wall_frame(k.walls[w], xi, k.radius, cs, vs);
    if (!(fr.gap < k.envelope)) continue;
    extrapolate(wg, wgp, nw, i * k.n_walls + w, beta, y);
    row_impulse(fr, y, F, T);
    for (int a = 0; a < 3; ++a) {
      f[a] -= F[a];
      tq[a] += T[a];
    }
  }
  for (int a = 0; a < 3; ++a) {
    u[a * n + i] = ufree[a * n + i] + k.inv_m * f[a];
    u[(3 + a) * n + i] = ufree[(3 + a) * n + i] + k.inv_I * tq[a];
  }
}

__global__ void __launch_bounds__(256)
nsc_sweep_g_kernel(const float* __restrict__ pos, const float* __restrict__ u,
                   const float* __restrict__ g, const float* __restrict__ gp,
                   const float* __restrict__ wg,
                   const float* __restrict__ wgp,
                   const int* __restrict__ partners,
                   const float* __restrict__ cs, float* __restrict__ gout,
                   float* __restrict__ wout, int n, int P, float beta,
                   NscParams k) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int np = n * P, nw = n * k.n_walls;
  float xi[3], vi[3], wi[3], y[3], gv[3];
  load3(pos, n, i, xi);
  load3(u, n, i, vi);
  load3(u + 3 * n, n, i, wi);
  for (int p = 0; p < P; ++p) {                        // owned contacts
    const int e = i * P + p;
    const int j = partners[e];
    if (j < 0) {
      for (int c = 0; c < 3; ++c) gout[c * np + e] = 0.0f;
      continue;
    }
    float xj[3], vj[3], wj[3];
    load3(pos, n, j, xj);
    load3(u, n, j, vj);
    load3(u + 3 * n, n, j, wj);
    const Frame fr = pair_frame(xi, xj, k.radius);
    pair_velocity(fr, vi, vj, wi, wj, gv);
    const float bn = contact_rhs(fr.gap, k);
    const float s =
        k.omega / (2.0f * k.inv_m + 2.0f * fr.arm * fr.arm * k.inv_I);
    extrapolate(g, gp, np, e, beta, y);
    float pn = y[0] - s * (gv[0] - bn), pu = y[1] - s * gv[1];
    float pv = y[2] - s * gv[2];
    cone_project(pn, pu, pv, k.mu);
    gout[e] = pn;
    gout[np + e] = pu;
    gout[2 * np + e] = pv;
  }
  const float zero3[3] = {0.0f, 0.0f, 0.0f};
  for (int w = 0; w < k.n_walls; ++w) {                // walls
    const NscWall& wall = k.walls[w];
    const int e = i * k.n_walls + w;
    float vs[3];
    const Frame fr = wall_frame(wall, xi, k.radius, cs, vs);
    if (!(fr.gap < k.envelope)) {
      for (int c = 0; c < 3; ++c) wout[c * nw + e] = 0.0f;
      continue;
    }
    pair_velocity(fr, vi, vs, wi, zero3, gv);
    const float bn = contact_rhs(fr.gap, k);
    float denom = k.inv_m + fr.arm * fr.arm * k.inv_I;
    if (wall.kind == kRotbox && k.inv_Ib > 0.0f) {
      // the dynamic blade's rotational compliance rho^2 / I_b
      const int i1 = (wall.axis + 1) % 3, i2 = (wall.axis + 2) % 3;
      const float d1 = xi[i1] - wall.a[i1], d2 = xi[i2] - wall.a[i2];
      denom += (d1 * d1 + d2 * d2) * k.inv_Ib;
    }
    const float s = k.omega / denom;
    extrapolate(wg, wgp, nw, e, beta, y);
    float pn = y[0] - s * (gv[0] - bn), pu = y[1] - s * gv[1];
    float pv = y[2] - s * gv[2];
    cone_project(pn, pu, pv, wall.mu);
    wout[e] = pn;
    wout[nw + e] = pu;
    wout[2 * nw + e] = pv;
  }
}

int blocks_for(int n) { return (n + 255) / 256; }

}  // namespace

// Launchers: run on `stream` and return cudaGetLastError() (0 on success).
// The caller checks shapes, types, devices and that no output overlaps an
// input.

extern "C" int nsc_sweep_u_launch(const float* pos, const float* ufree,
                                  const float* g, const float* gp,
                                  const float* wg, const float* wgp,
                                  const int* partners, const int* rev_start,
                                  const int* rev_count, const int* rev,
                                  const float* cs, float* u, int n, int P,
                                  float beta, const NscParams* k,
                                  void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  nsc_sweep_u_kernel<<<blocks_for(n), 256, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      pos, ufree, g, gp, wg, wgp, partners, rev_start, rev_count, rev, cs, u,
      n, P, beta, *k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nsc_sweep_g_launch(const float* pos, const float* u,
                                  const float* g, const float* gp,
                                  const float* wg, const float* wgp,
                                  const int* partners, const float* cs,
                                  float* gout, float* wout, int n, int P,
                                  float beta, const NscParams* k,
                                  void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  nsc_sweep_g_kernel<<<blocks_for(n), 256, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      pos, u, g, gp, wg, wgp, partners, cs, gout, wout, n, P, beta, *k);
  return static_cast<int>(cudaGetLastError());
}
