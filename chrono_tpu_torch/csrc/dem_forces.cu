// DEM pair forces and torques alone on cell slots, one thread per slot.
//
// Replaces the TPU kernels chrono_tpu/ops/pallas/dem_pencil_kernel.py
// dem_pencil_forces_pallas (pencil layout) and chrono_tpu/ops/pallas/
// dem_cell_kernel.py dem_cell_forces_pallas (cells in lanes): both compute
// the Hertz-Mindlin pair forces of every slot from its 27 neighbour cells
// and return force xyz and torque xyz planes, for the cell-dense forces
// path (make_cell_dense_advance with backend "pallas" or "xla"), which adds
// the wall pass and integrates outside the kernel.
//
// Layout: in is the (10, n_cells, C) float32 slot planes (pos xyz, vel xyz,
// omega xyz, mask); out is (6, n_cells, C) float32: force xyz, torque xyz.
// A valid slot sums its pairs with the 27-cell loop of dem_pairs.cuh (the
// same code as the fused substep); an empty slot writes zeros, as the TPU
// kernels' pair mask gives.

#include "dem_pairs.cuh"

struct ForcesParams {
  int nx, ny, nz, C;
  float radius, kn, gn, kt, gt, mu, dt;  // pair: m* = m/2, r* = r/2
  int friction;
};

template <bool kFriction>
__global__ void __launch_bounds__(256)
dem_forces_kernel(const float* __restrict__ in, float* __restrict__ out,
                  int n_slots, ForcesParams p) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n_slots) return;
  float F[3] = {0.0f, 0.0f, 0.0f};
  float T[3] = {0.0f, 0.0f, 0.0f};
  if (in[kMask * n_slots + s] >= 0.5f) {
    float x[kFeat];
    for (int f = 0; f < kFeat; ++f) x[f] = in[f * n_slots + s];
    add_pair_forces<kFriction>(in, n_slots, s, x, p, F, T);
  }
  for (int a = 0; a < 3; ++a) {
    out[a * n_slots + s] = F[a];
    out[(3 + a) * n_slots + s] = T[a];
  }
}

// Launch on `stream`; returns cudaGetLastError() (0 on success).  The caller
// checks shapes, types and that in and out do not overlap.
extern "C" int dem_forces_launch(const float* feat_in, float* out,
                                 int n_slots, const ForcesParams* params,
                                 void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = 256;
  const int blocks = (n_slots + threads - 1) / threads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (params->friction)
    dem_forces_kernel<true><<<blocks, threads, 0, st>>>(feat_in, out,
                                                        n_slots, *params);
  else
    dem_forces_kernel<false><<<blocks, threads, 0, st>>>(feat_in, out,
                                                         n_slots, *params);
  return static_cast<int>(cudaGetLastError());
}
