// One CRM (elastoplastic granular SPH) substep as two neighbour sweeps on
// cell-sorted markers, one thread per marker, one launch per sweep.
//
// Replaces the TPU kernels chrono_tpu/ops/pallas/crm_sym_kernel.py
// crm_substep_sym (its M and G sweeps on _sym_sweep or sym_sweep_flat) and
// crm_substep_sym_dual (the same on flatlane_dual_kernel.py
// sym_sweep_flat_dual), including their forces-only and with_acc modes.
// The physics and the plane layout are in crm_sweeps.cuh.  G reads M's
// kicked velocity on every neighbour, so the two are separate launches
// into separate buffers.
//
// What bounds it: at the 10 x 4 m terrain bed (1 M granular markers, cells
// of 2h, up to ~14 markers per bed cell) a granular marker tests ~380
// candidates in its 27 cells, of which ~15 % lie inside the support.  The
// candidate loop (position loads served from L1, a distance test) and the
// ~90 (M) and ~60 (G) flops of each interacting pair bound it, not DRAM:
// each sweep moves ~100-200 MB.  Kept simple: no shared-memory staging, no
// half stencil.

#include <cuda_runtime.h>

#include "crm_sweeps.cuh"

namespace {

__global__ void __launch_bounds__(256)
crm_momentum_kernel(const float* __restrict__ st, Cells c,
                    float* __restrict__ mv, float* __restrict__ acc, int n,
                    CrmConsts k) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) crm::momentum(st, c, n, i, k, mv, acc);
}

__global__ void __launch_bounds__(256)
crm_gradv_stress_kernel(const float* __restrict__ st,
                        const float* __restrict__ mv, Cells c,
                        float* __restrict__ out, int n, CrmConsts k) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) crm::gradv_stress(st, mv, c, n, i, k, out);
}

int blocks_for(int n) { return (n + 255) / 256; }

}  // namespace

// Launchers: run on `stream` and return cudaGetLastError() (0 on success).
// Arguments: the state, the cell table, the other buffers, the sizes.  The
// caller checks shapes, types, devices and that no input is an output.

// mv (4, N) and acc (3, N) may each be null, not both: mv alone is the
// substep's kick, both its with_acc mode, acc alone the forces-only mode.
extern "C" int crm_momentum_launch(const float* state, const int* cell,
                                   const int* start, const int* count,
                                   float* mv, float* acc, int n, int nx,
                                   int ny, int nz, int cap,
                                   const CrmConsts* k, void* stream,
                                   int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Cells c{cell, start, count, nx, ny, nz, cap};
  crm_momentum_kernel<<<blocks_for(n), 256, 0,
                        static_cast<cudaStream_t>(stream)>>>(state, c, mv,
                                                             acc, n, *k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int crm_gradv_stress_launch(const float* state, const int* cell,
                                       const int* start, const int* count,
                                       const float* mv, float* out, int n,
                                       int nx, int ny, int nz, int cap,
                                       const CrmConsts* k, void* stream,
                                       int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Cells c{cell, start, count, nx, ny, nz, cap};
  crm_gradv_stress_kernel<<<blocks_for(n), 256, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      state, mv, c, out, n, *k);
  return static_cast<int>(cudaGetLastError());
}
