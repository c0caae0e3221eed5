// One symplectic WCSPH substep as three neighbour sweeps on cell-sorted
// markers, one thread per marker.
//
// Replaces the TPU kernels chrono_tpu/ops/pallas/sph_sym_kernel.py
// sph_substep_sym (sweeps A, B and the fused CD on _sym_sweep) and
// chrono_tpu/ops/pallas/sph_pencil_kernel.py sph_substep_pencil (the same
// physics as four dense sweeps on _pencil_sweep).  The physics is
// chrono_tpu/fsi/sph/wcsph.py's, term by term.
//
// Layout: markers sorted by cell id (i*ny + j)*nz + k, as a structure of
// arrays of N floats per plane.  state: pos xyz, vel xyz, rho, is_fluid,
// p = Tait(rho), 1/max(rho, 1e-9).  adami: p, v_bc xyz, rho (Tait inverse
// for solids), p/rho^2, 1/rho.  A cell table gives each cell's first sorted
// index and count; only the first C markers of a cell take part, the rest
// are copied through.
//
// Each thread walks the 27 neighbour cells (edge cells skipped) in a fixed
// order (for_pairs_compact in A, B and CD: cell_pairs.cuh, which the CRM
// sweeps share) and sums every pair onto its own marker only:
// no atomics, and a deterministic sum.  A pair beyond the kernel support 2h
// adds exact zeros in the plain twin, so it is skipped (first on r^2 with a
// safe margin, then on q = r/h >= 2 exactly as the twin's branches).  A
// sweep's pair loop runs only where its result is used: A on solid markers
// (the Adami values of a fluid marker are its own), B and CD on fluid
// markers (solids are not integrated; their x is written back unchanged, bit
// for bit).  Each sweep reads the previous sweep's output on every
// neighbour, so each is its own launch into a fresh buffer.  Per-marker
// terms (Tait p, its inverse, p/rho^2, 1/rho) are computed once per marker,
// in the epilogue of the sweep before the one that reads them: never per
// pair.
//
// What bounds it: at the 1 M-marker dam break (cells 1.25 x 2h) a fluid
// marker tests ~660 candidates, of which ~8 % lie inside the support.  The
// candidate loop (three position loads, served from L1 because the threads
// of a warp share most neighbour cells, and a distance test) and the ~60
// flops of each interacting pair bound it, not DRAM: each sweep moves ~70 MB.
// Every sweep runs its pair body over compacted hits; A launches its
// walking threads over the solid markers only (see there).
// No shared-memory staging of the neighbourhood, no half stencil.

#include <cuda_runtime.h>

#include "cell_pairs.cuh"

struct SphConsts {
  float h, sigma, m, rho0, c_s, gamma, B, dhc, alpha_visc, mu, xsph_eps, dt;
  float g[3];
  int laminar;
};

namespace {

enum { PX, PY, PZ, VX, VY, VZ, RHO, FLU, PRS, IRHO, kState };
enum { A_P, A_VBX, A_VBY, A_VBZ, A_RHO, A_PR2, A_IRHO, kAdami };

__device__ __forceinline__ float tait_p(float rho, const SphConsts& k) {
  return k.B * (powf(rho / k.rho0, k.gamma) - 1.0f);
}

// Inverse Tait EOS, 1 + p/B clamped at 0.1 as the TPU kernels clamp it
// (sph_pencil_kernel.py _tait_rho); the JAX gather backend clamps at 1e-3,
// which differs only where p/B < -0.9.
__device__ __forceinline__ float tait_rho(float p, const SphConsts& k) {
  return k.rho0 * powf(fmaxf(1.0f + p / k.B, 0.1f), 1.0f / k.gamma);
}

// ---- sweep A: Adami wall BC (sph_pencil_kernel.py:222-258) ----
//
// Thread t takes marker order[t] (ops/cuda/sph_substep.py
// adami_walk_order, once per binning): the live solid markers first, in
// sorted order, then every other marker (fluid, or past its cell's cap), in
// sorted order.  So only the first warps walk, each lane a solid marker
// beside its neighbours in space, and they walk on the compacted walk as B
// and CD do, each solid summing its fluid neighbours in the walk order.
// The later threads only copy their marker's own values through the
// epilogue, in the same launch.  What bounds it then is the length of one
// solid's walk, not the number of walkers: skipping the solids with no
// fluid in their 27 cells (three in four in the dam break) gained nothing
// (PERF.md).  The scan keeps the fluid neighbours only, so the body runs
// over those (testing the kind in the body instead was slower); the hit
// buffer's depth, the scan's stretch and the minimum blocks an SM were set
// by timing on the card (PERF.md).
constexpr int kAHitDepth = 32;
constexpr int kAUnroll = 4;
constexpr int kAMinBlocks = 3;

__global__ void __launch_bounds__(256, kAMinBlocks)
sph_adami_kernel(const float* __restrict__ st, const int* __restrict__ order,
                 Cells c, float* __restrict__ out, int n, SphConsts k) {
  extern __shared__ int hits[];
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const bool mine = t < n;
  const int i = order[mine ? t : n - 1];
  const float flu = st[FLU * n + i];
  const float v[3] = {st[VX * n + i], st[VY * n + i], st[VZ * n + i]};
  float p_all = st[PRS * n + i];
  float vb[3] = {v[0], v[1], v[2]};
  const bool walk = mine && flu < 0.5f && live(c, i);
  float xi[3] = {0.0f, 0.0f, 0.0f};
  if (walk) {
    xi[0] = st[PX * n + i];
    xi[1] = st[PY * n + i];
    xi[2] = st[PZ * n + i];
  }
  float swp = 0.0f, sw = 0.0f, swv[3] = {0.0f, 0.0f, 0.0f};
  for_pairs_compact_kept<kAHitDepth, kAUnroll>(
      st + PX * n, st + PY * n, st + PZ * n, c, i, xi, k.h, walk, hits,
      [&](int j) { return st[FLU * n + j] > 0.5f; },   // fluid neighbours
      [&](int j, const float* d, float, float, float q) {
        const float w = cubic_w(q, k.sigma);
        // hydrostatic term (g . (x_i - x_j)) rho_j for fixed walls
        const float hydro =
            (k.g[0] * d[0] + k.g[1] * d[1] + k.g[2] * d[2]) *
            st[RHO * n + j];
        swp += w * (st[PRS * n + j] + hydro);
        swv[0] += w * st[VX * n + j];
        swv[1] += w * st[VY * n + j];
        swv[2] += w * st[VZ * n + j];
        sw += w;
      });
  if (!mine) return;
  if (walk) {
    const bool has = sw > 1e-12f;
    const float den = fmaxf(sw, 1e-12f);
    p_all = has ? swp / den : 0.0f;
    if (has)
      for (int a = 0; a < 3; ++a) vb[a] = 2.0f * v[a] - swv[a] / den;
  }
  const float rho_all = flu > 0.5f ? st[RHO * n + i] : tait_rho(p_all, k);
  out[A_P * n + i] = p_all;
  for (int a = 0; a < 3; ++a) out[(A_VBX + a) * n + i] = vb[a];
  out[A_RHO * n + i] = rho_all;
  out[A_PR2 * n + i] = p_all / (rho_all * rho_all);
  out[A_IRHO * n + i] = 1.0f / rho_all;
}

// ---- sweep B: momentum + kick (sph_pencil_kernel.py:260-319) ----
//
// On the compacted walk, as CD (see there): the pair body runs over each
// fluid marker's hits only, in the walk order, so each marker sums the
// same pairs in the same order.  The hit buffer's depth, the scan's stretch
// and the minimum blocks an SM were set by timing on the card (PERF.md).
constexpr int kBHitDepth = 40;
constexpr int kBUnroll = 4;
constexpr int kBMinBlocks = 3;

__global__ void __launch_bounds__(256, kBMinBlocks)
sph_momentum_kernel(const float* __restrict__ st,
                    const float* __restrict__ ad, Cells c,
                    float* __restrict__ out, int n, SphConsts k) {
  extern __shared__ int hits[];
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const bool mine = t < n;
  const int i = mine ? t : n - 1;
  const float v[3] = {st[VX * n + i], st[VY * n + i], st[VZ * n + i]};
  const float xi[3] = {st[PX * n + i], st[PY * n + i], st[PZ * n + i]};
  const float pr2_i = ad[A_PR2 * n + i];
  const float rho_i = ad[A_RHO * n + i];
  const float irho_i = ad[A_IRHO * n + i];
  const float eps_h2 = 0.01f * k.h * k.h;
  const bool walk = mine && st[FLU * n + i] > 0.5f && live(c, i);
  float acc[3] = {0.0f, 0.0f, 0.0f};
  for_pairs_compact<kBHitDepth, kBUnroll>(
      st + PX * n, st + PY * n, st + PZ * n, c, i, xi, k.h, walk, hits,
      [&](int j, const float* d, float r2, float r, float q) {
        const float gf = cubic_dwdr(q, k.h, k.sigma) / fmaxf(r, 1e-12f);
        const float gw[3] = {gf * d[0], gf * d[1], gf * d[2]};
        // viscous velocity: the ghost velocity of a solid neighbour
        const float vij[3] = {v[0] - ad[A_VBX * n + j],
                              v[1] - ad[A_VBY * n + j],
                              v[2] - ad[A_VBZ * n + j]};
        const float cp = k.m * (pr2_i + ad[A_PR2 * n + j]);
        for (int a = 0; a < 3; ++a) acc[a] -= cp * gw[a];
        if (k.laminar) {
          const float cl = k.m * 2.0f * k.mu * irho_i * ad[A_IRHO * n + j] *
                           (d[0] * gw[0] + d[1] * gw[1] + d[2] * gw[2]) /
                           (r2 + eps_h2);
          for (int a = 0; a < 3; ++a) acc[a] += cl * vij[a];
        } else {
          const float vr = vij[0] * d[0] + vij[1] * d[1] + vij[2] * d[2];
          if (vr < 0.0f) {
            const float mu_ij = k.h * vr / (r2 + eps_h2);
            const float pi = -k.alpha_visc * k.c_s * mu_ij /
                             (0.5f * (rho_i + ad[A_RHO * n + j]));
            for (int a = 0; a < 3; ++a) acc[a] -= k.m * pi * gw[a];
          }
        }
      });
  if (!mine) return;
  float v1[3] = {v[0], v[1], v[2]};
  if (walk)
    for (int a = 0; a < 3; ++a) v1[a] = v[a] + k.dt * (acc[a] + k.g[a]);
  for (int a = 0; a < 3; ++a) out[a * n + i] = v1[a];
}

// ---- sweep CD: continuity + delta-SPH at the kicked velocities, then XSPH
// drift with the weight at rho^n (sph_sym_kernel.py:495-555) ----
//
// On the compacted walk (for_pairs_compact), as B: a fluid marker
// scans its ~680 candidates and runs the pair body over its ~8 % hits only, in
// the walk order, so each marker sums the same pairs in the same order as
// before (bit for bit, on the card).  Every lane of a warp takes part in the
// walk's votes, so a thread past n walks nothing and writes nothing.  The hit
// buffer's depth (kCdHitDepth slots a thread, 40 KB a block), the scan's
// stretch (kCdUnroll candidates) and kCdMinBlocks (blocks of 256 an SM should
// hold, which caps the registers; no spills) were set by timing on the card;
// PERF.md gives the registers and the times.  What bounds it then: the scan's
// candidate loads (~25 warp iterations a fluid marker against ~2.3 body
// issues).
constexpr int kCdHitDepth = 40;
constexpr int kCdUnroll = 4;
constexpr int kCdMinBlocks = 3;

__global__ void __launch_bounds__(256, kCdMinBlocks)
sph_continuity_drift_kernel(const float* __restrict__ st,
                            const float* __restrict__ vel, Cells c,
                            float* __restrict__ out, int n, SphConsts k) {
  extern __shared__ int hits[];
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const bool mine = t < n;
  const int i = mine ? t : n - 1;
  const float flu = st[FLU * n + i];
  const float xi[3] = {st[PX * n + i], st[PY * n + i], st[PZ * n + i]};
  const float v1[3] = {vel[i], vel[n + i], vel[2 * n + i]};
  const float rho_i = st[RHO * n + i];
  float rho = rho_i;
  float x1[3] = {xi[0], xi[1], xi[2]};
  const bool walk = mine && flu > 0.5f && live(c, i);
  float drho = 0.0f, diff = 0.0f, corr[3] = {0.0f, 0.0f, 0.0f};
  for_pairs_compact<kCdHitDepth, kCdUnroll>(
      st + PX * n, st + PY * n, st + PZ * n, c, i, xi, k.h, walk, hits,
      [&](int j, const float* d, float r2, float r, float q) {
        const float gf =
            cubic_dwdr(q, k.h, k.sigma) / fmaxf(r, 1e-12f);
        const float gw[3] = {gf * d[0], gf * d[1], gf * d[2]};
        const float vj[3] = {vel[j], vel[n + j],
                             vel[2 * n + j]};
        drho += k.m * ((v1[0] - vj[0]) * gw[0] +
                       (v1[1] - vj[1]) * gw[1] +
                       (v1[2] - vj[2]) * gw[2]);
        if (st[FLU * n + j] < 0.5f) return;  // fluid-fluid
        const float rho_j = st[RHO * n + j];
        const float psi = 2.0f * (rho_j - rho_i) *
                          -(d[0] * gw[0] + d[1] * gw[1] +
                            d[2] * gw[2]) / (r2 + 1e-12f);
        diff += k.m * st[IRHO * n + j] * psi;
        const float wx =
            k.m / fmaxf(0.5f * (rho_i + rho_j), 1e-9f) *
            cubic_w(q, k.sigma);
        for (int a = 0; a < 3; ++a)
          corr[a] += wx * (vj[a] - v1[a]);
      });
  if (!mine) return;
  if (walk) {
    rho = rho_i + k.dt * (drho + k.dhc * diff);
    for (int a = 0; a < 3; ++a)
      x1[a] = xi[a] + k.dt * (v1[a] + k.xsph_eps * corr[a]);
  }
  rho = fminf(fmaxf(rho, 0.7f * k.rho0), 1.5f * k.rho0);
  for (int a = 0; a < 3; ++a) {
    out[(PX + a) * n + i] = x1[a];
    out[(VX + a) * n + i] = v1[a];
  }
  out[RHO * n + i] = rho;
  out[FLU * n + i] = flu;
  out[PRS * n + i] = tait_p(rho, k);
  out[IRHO * n + i] = 1.0f / fmaxf(rho, 1e-9f);
}

int blocks_for(int n) { return (n + 255) / 256; }

}  // namespace

// Launchers: run on `stream` and return cudaGetLastError() (0 on success).
// The caller checks shapes, types, devices and that no input is the output.

extern "C" int sph_adami_launch(const float* state, const int* order,
                                const int* cell, const int* start,
                                const int* count, float* out, int n, int nx,
                                int ny, int nz, int cap, const SphConsts* k,
                                void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = 256 * kAHitDepth * static_cast<int>(sizeof(int));
  err = cudaFuncSetAttribute(sph_adami_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Cells c{cell, start, count, nx, ny, nz, cap};
  sph_adami_kernel<<<blocks_for(n), 256, smem,
                     static_cast<cudaStream_t>(stream)>>>(state, order, c,
                                                          out, n, *k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sph_momentum_launch(const float* state, const float* adami,
                                   const int* cell, const int* start,
                                   const int* count, float* out, int n,
                                   int nx, int ny, int nz, int cap,
                                   const SphConsts* k, void* stream,
                                   int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = 256 * kBHitDepth * static_cast<int>(sizeof(int));
  err = cudaFuncSetAttribute(sph_momentum_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Cells c{cell, start, count, nx, ny, nz, cap};
  sph_momentum_kernel<<<blocks_for(n), 256, smem,
                        static_cast<cudaStream_t>(stream)>>>(state, adami, c,
                                                             out, n, *k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sph_continuity_drift_launch(const float* state,
                                           const float* vel, const int* cell,
                                           const int* start,
                                           const int* count, float* out,
                                           int n, int nx, int ny, int nz,
                                           int cap, const SphConsts* k,
                                           void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = 256 * kCdHitDepth * static_cast<int>(sizeof(int));
  err = cudaFuncSetAttribute(sph_continuity_drift_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Cells c{cell, start, count, nx, ny, nz, cap};
  sph_continuity_drift_kernel<<<blocks_for(n), 256, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      state, vel, c, out, n, *k);
  return static_cast<int>(cudaGetLastError());
}
