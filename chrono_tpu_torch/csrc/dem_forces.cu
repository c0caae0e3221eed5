// DEM pair forces and torques alone on cell-sorted rows, one thread per
// occupied particle.
//
// Replaces the TPU kernels chrono_tpu/ops/pallas/dem_pencil_kernel.py
// dem_pencil_forces_pallas (pencil layout) and chrono_tpu/ops/pallas/
// dem_cell_kernel.py dem_cell_forces_pallas (cells in lanes): both compute
// the Hertz-Mindlin pair forces of every particle from its 27 neighbour
// cells and return force xyz and torque xyz, for the cell-dense forces path
// (make_cell_dense_advance with backend "pallas" or "xla"), which adds the
// wall pass and integrates outside the kernel.
//
// Layout (dem_pairs.cuh, chrono_tpu_torch/dem/rows.py): in is (3, R, 4)
// float32 rows -- pos, vel, omega as float4 -- in cell order, with each
// row's cell and a per-cell (start, count) table built once per rebin; out
// is (2, R, 4) float32: force and torque as float4 (w = 0), zeros on a
// dead row.  A live row sums its pairs over its nine neighbour runs with
// the code of the fused substep (add_pair_forces).
//
// The redesign.  The first version ran one thread per slot of
// (10, n_cells, C) planes and walked 27 x 16 = 432 candidate slots per
// particle at the pallas scene (52 x 52 x 82 cells, C = 16, 28 % full),
// each with a mask load from global memory: 1.15 ms per launch on an H100
// 80GB HBM3 at 700 W, 28x its bound.  Now one thread owns one occupied
// particle and its nine runs hold only the ~205 occupied candidates
// (dem_pairs.cuh): 0.247 ms, against a bound of ~0.018 ms by bytes (60
// bytes a particle); the forces path reads and writes the rows directly,
// so the per-substep gather and scatter of the occupied slots are gone.
// What bounds it is the walk, as in the fused substep.  ptxas on the card:
// 40 registers (the kMinBlocks cap), 8 bytes of stack, 4-8 bytes of
// spills, no shared memory.

#include "dem_pairs.cuh"

struct ForcesParams {
  int nx, ny, nz;
  float radius, kn, gn, kt, gt, mu, dt;  // pair: m* = m/2, r* = r/2
  int friction;
};

template <bool kFriction>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
dem_forces_kernel(Rows rw, float4* __restrict__ out, ForcesParams p) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= rw.n_rows) return;
  const int cell = rw.cell[row];
  float F[3] = {0.0f, 0.0f, 0.0f};
  float T[3] = {0.0f, 0.0f, 0.0f};
  if (cell >= 0) {
    const float4 a = rw.pos[row], b = rw.vel[row], c = rw.omg[row];
    const float x[3] = {a.x, a.y, a.z};
    const float v[3] = {b.x, b.y, b.z};
    const float w[3] = {c.x, c.y, c.z};
    add_pair_forces<kFriction>(rw, p, row, cell, x, v, w, F, T);
  }
  out[row] = make_float4(F[0], F[1], F[2], 0.0f);
  out[rw.n_rows + row] = make_float4(T[0], T[1], T[2], 0.0f);
}

// Launch on `stream` over n_rows rows; returns the CUDA error of the launch
// (0 on success).  `in` is (3, n_rows, 4) float32, `out` (2, n_rows, 4),
// `cell` (n_rows,) int32, `table` (n_cells, 2) int32.  The caller checks
// shapes, types and that in and out do not overlap.
extern "C" int dem_forces_launch(const float* in, float* out,
                                 const int* cell, const int* table,
                                 int n_rows, const ForcesParams* params,
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
    dem_forces_kernel<true><<<blocks, kThreads, 0, st>>>(rw, out4, *params);
  else
    dem_forces_kernel<false><<<blocks, kThreads, 0, st>>>(rw, out4, *params);
  return static_cast<int>(cudaGetLastError());
}
