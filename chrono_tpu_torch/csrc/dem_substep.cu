// One fused DEM substep on cell slots, one thread per slot.
//
// Replaces the TPU kernel chrono_tpu/ops/pallas/dem_flat_kernel.py
// dem_flat_substep_pallas (pair physics _make_pair2, fused tail _make_post)
// and the cell-pair sweep it runs on, chrono_tpu/ops/pallas/
// flatlane_kernel.py sym_sweep_flat.
//
// Layout: feat is a (10, n_cells, C) float32 structure of arrays -- planes
// pos xyz, vel xyz, omega xyz, mask -- with cell id (i*ny + j)*nz + k.
// Each thread owns slot s = cell*C + slot.  A masked slot copies its values
// through.  A valid slot walks the 27 neighbour cells (edge cells skipped) and
// their C slots in a fixed order and sums Hertz-Mindlin forces onto itself
// only: every pair is evaluated from both of its sides, and swapping the two
// sides flips the force and keeps the torque exactly, which is the TPU
// kernel's (-F, +tau) reaction.  So there are no atomics, and the sum order
// is deterministic.  Then static plane walls, gravity and semi-implicit Euler
// (v += dt(F/m + g), x += dt v, w += dt tau / I).  Out of place: the caller
// ping-pongs two buffers.
//
// What bounds it: at the bench scene (51 x 51 x 83 cells, C = 8: 1.73 M
// slots, 59 % filled) each substep makes 1.73 M x 216 candidate tests, each
// a mask load and, for valid neighbours, three position loads served from
// L1/L2; device memory sees only 70 MB read and 70 MB written.  The bound
// is the load and instruction rate of that 216-step loop, not DRAM
// bandwidth or FLOPs (the contact math runs only for overlapping pairs).
// This version is kept simple: staging a tile's 27-cell neighbourhood in
// shared memory and a half stencil are the ways to make it fast.

#include <cuda_runtime.h>

constexpr int kFeat = 10;
constexpr int kMask = 9;
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
  const int C = p.C;
  const int cell = s / C;
  const int k = cell % p.nz;
  const int j = (cell / p.nz) % p.ny;
  const int i = cell / (p.nz * p.ny);
  const float r = p.radius;
  float F[3] = {0.0f, 0.0f, 0.0f};
  float T[3] = {0.0f, 0.0f, 0.0f};

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
