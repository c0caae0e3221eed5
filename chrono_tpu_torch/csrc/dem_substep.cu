// One fused DEM substep on cell slots, one thread per slot.
//
// Replaces the TPU kernel chrono_tpu/ops/pallas/dem_flat_kernel.py
// dem_flat_substep_pallas (pair physics _make_pair2, fused tail _make_post)
// and the cell-pair sweep it runs on, chrono_tpu/ops/pallas/
// flatlane_kernel.py sym_sweep_flat.
//
// Also the substep of the TPU kernels dem_sym_kernel.py
// dem_sym_substep_pallas and dem_pencil_kernel.py dem_pencil_substep_pallas,
// which compute the same fused substep in other layouts.
//
// Layout: feat is a (10, n_cells, C) float32 structure of arrays -- planes
// pos xyz, vel xyz, omega xyz, mask -- with cell id (i*ny + j)*nz + k.
// Each thread owns slot s = cell*C + slot.  A masked slot copies its values
// through.  A valid slot sums its pair forces with the 27-cell loop of
// dem_pairs.cuh (each pair from both of its sides, which gives the TPU
// kernel's (-F, +tau) reaction with no atomics and a fixed sum order).  Then
// static plane walls, gravity and semi-implicit Euler (v += dt(F/m + g),
// x += dt v, w += dt tau / I).  Out of place: the caller ping-pongs two
// buffers.
//
// What bounds it: at the bench scene (51 x 51 x 83 cells, C = 8: 1.73 M
// slots, 59 % filled) each substep makes 1.73 M x 216 candidate tests, each
// a mask load and, for valid neighbours, three position loads served from
// L1/L2; device memory sees only 70 MB read and 70 MB written.  The bound
// is the load and instruction rate of that 216-step loop, not DRAM
// bandwidth or FLOPs (the contact math runs only for overlapping pairs).
// This version is kept simple: staging a tile's 27-cell neighbourhood in
// shared memory and a half stencil are the ways to make it fast.

#include "dem_pairs.cuh"

constexpr int kMaxWalls = 6;

struct Wall {
  float n[3];   // unit normal into the domain
  float off;    // n . point
  float v[3];   // wall velocity
};

struct SubstepParams {
  int nx, ny, nz, C;
  float radius, kn, gn, kt, gt, mu, dt;  // pair: m* = m/2, r* = r/2
  int friction;
  int n_walls;
  Wall walls[kMaxWalls];
  float knw, gnw, ktw, gtw, muw;         // wall: m* = m, r* = r
  float gravity[3];
  float inv_m, inv_I;
};

template <bool kFriction>
__global__ void __launch_bounds__(256)
dem_substep_kernel(const float* __restrict__ in, float* __restrict__ out,
                   int n_slots, SubstepParams p) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n_slots) return;
  float x[kFeat];
  for (int f = 0; f < kFeat; ++f) x[f] = in[f * n_slots + s];
  if (x[kMask] < 0.5f) {
    for (int f = 0; f < kFeat; ++f) out[f * n_slots + s] = x[f];
    return;
  }
  const float r = p.radius;
  float F[3] = {0.0f, 0.0f, 0.0f};
  float T[3] = {0.0f, 0.0f, 0.0f};
  add_pair_forces<kFriction>(in, n_slots, s, x, p, F, T);

  // static plane walls (wall material: m* = m, r* = r)
#pragma unroll
  for (int w = 0; w < kMaxWalls; ++w) {
    if (w >= p.n_walls) break;
    const Wall& wl = p.walls[w];
    const float dwall =
        wl.n[0] * x[0] + wl.n[1] * x[1] + wl.n[2] * x[2] - wl.off;
    const float delta = fmaxf(r - dwall, 0.0f);
    if (delta <= 0.0f) continue;
    const float nh[3] = {-wl.n[0], -wl.n[1], -wl.n[2]};
    const float arm = r - 0.5f * delta;
    const float cr[3] = {x[7] * nh[2] - x[8] * nh[1],
                         x[8] * nh[0] - x[6] * nh[2],
                         x[6] * nh[1] - x[7] * nh[0]};
    float vr[3];
    for (int a = 0; a < 3; ++a) vr[a] = wl.v[a] - x[3 + a] - arm * cr[a];
    float pf[3];
    contact_force<kFriction>(nh, delta, vr, p.knw, p.gnw, p.ktw, p.gtw,
                             p.muw, p.dt, pf);
    for (int a = 0; a < 3; ++a) F[a] += pf[a];
    T[0] += arm * (nh[1] * pf[2] - nh[2] * pf[1]);
    T[1] += arm * (nh[2] * pf[0] - nh[0] * pf[2]);
    T[2] += arm * (nh[0] * pf[1] - nh[1] * pf[0]);
  }

  // gravity + semi-implicit Euler
  for (int a = 0; a < 3; ++a) {
    const float v1 = x[3 + a] + p.dt * (F[a] * p.inv_m + p.gravity[a]);
    out[a * n_slots + s] = x[a] + p.dt * v1;
    out[(3 + a) * n_slots + s] = v1;
    out[(6 + a) * n_slots + s] = x[6 + a] + p.dt * T[a] * p.inv_I;
  }
  out[kMask * n_slots + s] = x[kMask];
}

// Launch on `stream`; returns cudaGetLastError() (0 on success).  The caller
// checks shapes, types and that feat_in and feat_out do not overlap.
extern "C" int dem_substep_launch(const float* feat_in, float* feat_out,
                                  int n_slots, const SubstepParams* params,
                                  void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = 256;
  const int blocks = (n_slots + threads - 1) / threads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (params->friction)
    dem_substep_kernel<true><<<blocks, threads, 0, st>>>(feat_in, feat_out,
                                                         n_slots, *params);
  else
    dem_substep_kernel<false><<<blocks, threads, 0, st>>>(feat_in, feat_out,
                                                          n_slots, *params);
  return static_cast<int>(cudaGetLastError());
}
