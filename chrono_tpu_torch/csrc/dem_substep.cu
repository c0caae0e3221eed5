// One fused DEM substep on cell-sorted rows, one thread per occupied
// particle.
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
// Layout (dem_pairs.cuh, chrono_tpu_torch/dem/rows.py): in and out are
// (3, R, 4) float32 rows -- pos, vel, omega as float4 -- in cell order, with
// each row's cell and a per-cell (start, count) table built once per rebin.
// Each live row sums its pair forces over its nine neighbour runs
// (add_pair_forces: each pair from both of its sides, which gives the TPU
// kernel's (-F, +tau) reaction with no atomics and a fixed sum order), then
// static plane walls, gravity and semi-implicit Euler (v += dt(F/m + g),
// x += dt v, w += dt tau / I).  Out of place: the caller ping-pongs two
// row buffers.  Dead rows are neither read nor written.
//
// The redesign.  The first version ran one thread per slot of
// (10, n_cells, C) planes and tested all 27 x C candidate slots of the 27
// neighbour cells, each with a mask load, whether occupied or not; its
// time followed the slots, not the particles (0.395 ms on the settling
// box's 1.73 M slots at 59 % fill, 0.90 ms on the sym grid's 5.21 M slots
// at 19 % fill, for the same 1 M particles, on an H100 80GB HBM3 at
// 700 W).  Empty lanes idled in warps that walked every candidate.  Now
// one thread owns one occupied particle and its nine runs hold only
// occupied candidates (dem_pairs.cuh): 0.232 ms at the settling box (205
// candidates a particle) and 0.125 ms at sym (65), against a bound of
// ~0.022 ms by bytes (the rows' 72 bytes a particle in and out).  What
// bounds it is the walk: a 16-byte position load through L1 and a
// distance test per candidate, for ~0.11 contacts a particle in the bench
// scenes.  ptxas on the card: 40 registers (the kMinBlocks cap), 8 bytes
// of stack, 4-8 bytes of spills, no shared memory.

#include "dem_pairs.cuh"

constexpr int kMaxWalls = 6;

struct Wall {
  float n[3];   // unit normal into the domain
  float off;    // n . point
  float v[3];   // wall velocity
};

struct SubstepParams {
  int nx, ny, nz;
  float radius, kn, gn, kt, gt, mu, dt;  // pair: m* = m/2, r* = r/2
  int friction;
  int n_walls;
  Wall walls[kMaxWalls];
  float knw, gnw, ktw, gtw, muw;         // wall: m* = m, r* = r
  float gravity[3];
  float inv_m, inv_I;
};

template <bool kFriction>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
dem_substep_kernel(Rows rw, float4* __restrict__ out, SubstepParams p) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= rw.n_rows) return;
  const int cell = rw.cell[row];
  if (cell < 0) return;
  float F[3] = {0.0f, 0.0f, 0.0f};
  float T[3] = {0.0f, 0.0f, 0.0f};
  const float4 a = rw.pos[row], b = rw.vel[row], c = rw.omg[row];
  const float x[3] = {a.x, a.y, a.z};
  const float v[3] = {b.x, b.y, b.z};
  const float w[3] = {c.x, c.y, c.z};
  add_pair_forces<kFriction>(rw, p, row, cell, x, v, w, F, T);
  const float r = p.radius;

  // static plane walls (wall material: m* = m, r* = r)
#pragma unroll
  for (int b = 0; b < kMaxWalls; ++b) {
    if (b >= p.n_walls) break;
    const Wall& wl = p.walls[b];
    const float dwall =
        wl.n[0] * x[0] + wl.n[1] * x[1] + wl.n[2] * x[2] - wl.off;
    const float delta = fmaxf(r - dwall, 0.0f);
    if (delta <= 0.0f) continue;
    const float nh[3] = {-wl.n[0], -wl.n[1], -wl.n[2]};
    const float arm = r - 0.5f * delta;
    const float cr[3] = {w[1] * nh[2] - w[2] * nh[1],
                         w[2] * nh[0] - w[0] * nh[2],
                         w[0] * nh[1] - w[1] * nh[0]};
    float vr[3];
    for (int a = 0; a < 3; ++a) vr[a] = wl.v[a] - v[a] - arm * cr[a];
    float pf[3];
    contact_force<kFriction>(nh, delta, vr, p.knw, p.gnw, p.ktw, p.gtw,
                             p.muw, p.dt, pf);
    for (int a = 0; a < 3; ++a) F[a] += pf[a];
    T[0] += arm * (nh[1] * pf[2] - nh[2] * pf[1]);
    T[1] += arm * (nh[2] * pf[0] - nh[0] * pf[2]);
    T[2] += arm * (nh[0] * pf[1] - nh[1] * pf[0]);
  }

  // gravity + semi-implicit Euler
  float x1[3], v1[3], w1[3];
  for (int a = 0; a < 3; ++a) {
    v1[a] = v[a] + p.dt * (F[a] * p.inv_m + p.gravity[a]);
    x1[a] = x[a] + p.dt * v1[a];
    w1[a] = w[a] + p.dt * T[a] * p.inv_I;
  }
  const int R = rw.n_rows;
  out[row] = make_float4(x1[0], x1[1], x1[2], 0.0f);
  out[R + row] = make_float4(v1[0], v1[1], v1[2], 0.0f);
  out[2 * R + row] = make_float4(w1[0], w1[1], w1[2], 0.0f);
}

// Launch on `stream` over n_rows rows; returns the CUDA error of the launch
// (0 on success).  `in` and `out` are (3, n_rows, 4) float32, `cell`
// (n_rows,) int32, `table` (n_cells, 2) int32.  The caller checks shapes,
// types and that in and out do not overlap.
extern "C" int dem_substep_launch(const float* in, float* out,
                                  const int* cell, const int* table,
                                  int n_rows, const SubstepParams* params,
                                  void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float4* in4 = reinterpret_cast<const float4*>(in);
  const Rows rw{in4, in4 + n_rows, in4 + 2 * n_rows, cell,
                reinterpret_cast<const int2*>(table), n_rows};
  const int blocks = (n_rows + kThreads - 1) / kThreads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float4* out4 = reinterpret_cast<float4*>(out);
  if (params->friction)
    dem_substep_kernel<true><<<blocks, kThreads, 0, st>>>(rw, out4, *params);
  else
    dem_substep_kernel<false><<<blocks, kThreads, 0, st>>>(rw, out4, *params);
  return static_cast<int>(cudaGetLastError());
}
