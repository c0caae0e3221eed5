// The two sweeps of one APGD iteration of the NSC/DVI cone-complementarity
// solve, on cell-sorted bodies with single-sided multipliers: U one thread
// per body, G one thread per multiplier row.
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
// writes each owned contact's and each wall row's new multipliers, one row
// per thread.  No atomics; every sum has a fixed order.  G reads U's output
// of the same iteration and writes fresh buffers: nothing runs in place.
//
// What bounds them: at the bladed mixer (40,000 bodies, ~2.85 contacts owned
// per body, 6 walls) U needs ~7 MB and G ~11 MB of traffic, 2-3 us at HBM
// rate, and ~100-150 flops per contact.  At 40,000 bodies both are shorter
// than the host's cost to issue a launch from Python, so the 101 launches
// of a DVI step set its pace; at 400,000 the kernels do (PERF.md gives the
// times).  G has no reduction, so it runs over its N (P + W) rows rather
// than its N bodies: a thread per body walked six slots and six walls in
// series, at a stride of P or W floats between adjacent threads, with too
// few threads resident to hide the chains of dependent loads.  What bounds
// G then is neither its bytes nor its flops: the wall rows (every body
// against every wall, each row's frame computed before its envelope test)
// take more than half of it, the contact rows' gathers of the partner's
// nine planes the rest.  U, a sum per body, keeps one thread per body; no
// shared-memory staging (staging the walls there gained nothing).  It
// visits only the walls of the body's mask, which the step's first U
// writes (see U's modes).

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

// U's two modes.  Within a step the positions and the rotbox poses stay
// fixed, so whether a body lies within a wall's envelope is the step's
// constant: with kWrite, U computes every wall's frame, as the sum needs
// it, and writes the body's wall mask on the way (the step's first
// launch); without, it takes the walls in the mask only (every later
// launch of the step).  The contact frames are built from the positions in
// every launch: kept as per-step records they cost more to read than to
// rebuild (PERF.md).
template <bool kWrite>
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
                   int* __restrict__ wmask, float* __restrict__ u, int n,
                   int P, float beta, NscParams k) {
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
  // walls: bit w of the mask is set where the body lies within the
  // envelope of wall w
  const int mask = kWrite ? 0 : wmask[i];
  int bits = 0;
  for (int w = 0; w < k.n_walls; ++w) {
    if (!kWrite && !((mask >> w) & 1)) continue;
    float vs[3];
    const Frame fr = wall_frame(k.walls[w], xi, k.radius, cs, vs);
    if (kWrite) {
      if (!(fr.gap < k.envelope)) continue;
      bits |= 1 << w;
    }
    extrapolate(wg, wgp, nw, i * k.n_walls + w, beta, y);
    row_impulse(fr, y, F, T);
    for (int a = 0; a < 3; ++a) {
      f[a] -= F[a];
      tq[a] += T[a];
    }
  }
  if (kWrite) wmask[i] = bits;
  for (int a = 0; a < 3; ++a) {
    u[a * n + i] = ufree[a * n + i] + k.inv_m * f[a];
    u[(3 + a) * n + i] = ufree[(3 + a) * n + i] + k.inv_I * tq[a];
  }
}

// G: one thread per row of its output.  Rows [0, N P) are the contact
// rows e = i P + p, in the layout of gout; rows [N P, N (P + W)) the wall
// rows e = i W + w, in the layout of wout.  Each row depends only on its own
// (gam, gprev) and on the x and u of its two bodies, so no thread waits for
// another: adjacent threads read partners, gam and gprev and write gout and
// wout at adjacent addresses, and the threads of one body read its x and u
// as near-broadcast loads.  An empty slot, or a wall row beyond the
// envelope, writes its three zeros and ends.  (The wrapper keeps 3 N max(P,
// W) below 2^31, so the row index N (P + W) fits an int.)  Each row's
// arithmetic is that of the twin, term by term, as in U.  The wall rows
// keep wout's order, so a warp mixes walls (and wall kinds); mapping one
// wall per warp instead was slower at 400,000 bodies, its stores strided
// by W (PERF.md).
__device__ __forceinline__ void g_contact_row(
    const float* __restrict__ pos, const float* __restrict__ u,
    const float* __restrict__ g, const float* __restrict__ gp,
    const int* __restrict__ partners, float* __restrict__ gout, int n,
    int P, int e, float beta, const NscParams& k) {
  const int np = n * P;
  const int j = partners[e];
  if (j < 0) {
    for (int c = 0; c < 3; ++c) gout[c * np + e] = 0.0f;
    return;
  }
  const int i = e / P;
  float xi[3], vi[3], wi[3], xj[3], vj[3], wj[3], y[3], gv[3];
  load3(pos, n, i, xi);
  load3(u, n, i, vi);
  load3(u + 3 * n, n, i, wi);
  load3(pos, n, j, xj);
  load3(u, n, j, vj);
  load3(u + 3 * n, n, j, wj);
  const Frame fr = pair_frame(xi, xj, k.radius);
  pair_velocity(fr, vi, vj, wi, wj, gv);
  const float bn = contact_rhs(fr.gap, k);
  // the diagonal 2 inv_m + 2 arm^2 inv_I with its sum fused explicitly:
  // contraction is otherwise the compiler's choice, which changes with the
  // kernel's shape and moves s by an ulp where arm is below the radius
  // (overlapping pairs); PERF.md
  const float s =
      k.omega / __fmaf_rn(2.0f * fr.arm * fr.arm, k.inv_I, 2.0f * k.inv_m);
  extrapolate(g, gp, np, e, beta, y);
  float pn = y[0] - s * (gv[0] - bn), pu = y[1] - s * gv[1];
  float pv = y[2] - s * gv[2];
  cone_project(pn, pu, pv, k.mu);
  gout[e] = pn;
  gout[np + e] = pu;
  gout[2 * np + e] = pv;
}

__device__ __forceinline__ void g_wall_row(
    const float* __restrict__ pos, const float* __restrict__ u,
    const float* __restrict__ wg, const float* __restrict__ wgp,
    const float* __restrict__ cs, float* __restrict__ wout, int n, int e,
    float beta, const NscParams& k) {
  const int W = k.n_walls, nw = n * W;
  const int i = e / W;
  const NscWall& wall = k.walls[e - i * W];
  float xi[3], vi[3], wi[3], vs[3], y[3], gv[3];
  load3(pos, n, i, xi);
  const Frame fr = wall_frame(wall, xi, k.radius, cs, vs);
  if (!(fr.gap < k.envelope)) {
    for (int c = 0; c < 3; ++c) wout[c * nw + e] = 0.0f;
    return;
  }
  load3(u, n, i, vi);
  load3(u + 3 * n, n, i, wi);
  const float zero3[3] = {0.0f, 0.0f, 0.0f};
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

// The blocks of 256 an SM should hold: 6 caps G at 40 registers (a few
// spilled) and hides more of the gathers' latency than 4 blocks at 64
// registers, 8 blocks spill too much; set by timing on the card (PERF.md).
constexpr int kGMinBlocks = 6;

__global__ void __launch_bounds__(256, kGMinBlocks)
nsc_sweep_g_kernel(const float* __restrict__ pos, const float* __restrict__ u,
                   const float* __restrict__ g, const float* __restrict__ gp,
                   const float* __restrict__ wg,
                   const float* __restrict__ wgp,
                   const int* __restrict__ partners,
                   const float* __restrict__ cs, float* __restrict__ gout,
                   float* __restrict__ wout, int n, int P, float beta,
                   NscParams k) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const int np = n * P;
  if (e < np)
    g_contact_row(pos, u, g, gp, partners, gout, n, P, e, beta, k);
  else if (e < np + n * k.n_walls)
    g_wall_row(pos, u, wg, wgp, cs, wout, n, e - np, beta, k);
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
                                  const float* cs, int* wmask, float* u,
                                  int n, int P, float beta, int write,
                                  const NscParams* k, void* stream,
                                  int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto kernel = write ? nsc_sweep_u_kernel<true>
                            : nsc_sweep_u_kernel<false>;
  kernel<<<blocks_for(n), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      pos, ufree, g, gp, wg, wgp, partners, rev_start, rev_count, rev, cs,
      wmask, u, n, P, beta, *k);
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
  nsc_sweep_g_kernel<<<blocks_for(n * (P + k->n_walls)), 256, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      pos, u, g, gp, wg, wgp, partners, cs, gout, wout, n, P, beta, *k);
  return static_cast<int>(cudaGetLastError());
}
