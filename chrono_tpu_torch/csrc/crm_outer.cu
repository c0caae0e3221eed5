// A whole CRM outer step, n substeps of the two sweeps, in one cooperative
// launch.
//
// Replaces the TPU kernel chrono_tpu/ops/pallas/crm_outer_kernel.py
// crm_outer_substeps: n substeps in one call, returning the state after
// them and the last M sweep's raw acceleration of every valid marker,
// evaluated at its pre-substep state (the dv_mode="last" input of the BCE
// reduction).  The TPU kernel exists because every pallas_call pays a
// fixed cost; here the same holds for kernel launches, and this kernel
// pays one instead of 2n.
//
// The 2n sweeps run as grid-stride loops over the per-marker device
// functions of crm_sweeps.cuh (the same code as the per-sweep kernels of
// crm_substep.cu), with cooperative_groups grid.sync() between sweeps and
// the states ping-ponging between two buffers in global memory: M reads
// state s and writes the kicked velocities, G reads both and writes state
// s+1 into the other buffer, arranged so that the last one lands in `out`.
// The launch has as many blocks as can be resident at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs), which a grid-wide
// barrier needs.  The TPU kernel's row trim (nx_act, clip_z) and its A/B
// slot tiers are TPU layout devices with no counterpart here: markers are
// cell-sorted and a thread of an empty region does nothing.
//
// What bounds it: the sweeps, as in crm_substep.cu; the barrier costs a few
// microseconds per sweep.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "crm_sweeps.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
crm_outer_kernel(const float* __restrict__ st0, Cells c, float* out,
                 float* spare, float* mv, float* acc, int n, int n_sub,
                 CrmConsts k) {
  cg::grid_group grid = cg::this_grid();
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  const float* cur = st0;
  for (int s = 0; s < n_sub; ++s) {
    float* next = (n_sub - 1 - s) % 2 == 0 ? out : spare;
    float* a = s == n_sub - 1 ? acc : nullptr;
    for (int i = first; i < n; i += stride)
      crm::momentum(cur, c, n, i, k, mv, a);
    grid.sync();
    for (int i = first; i < n; i += stride)
      crm::gradv_stress(cur, mv, c, n, i, k, next);
    grid.sync();
    cur = next;
  }
}

}  // namespace

// Runs on `stream` and returns a cudaError_t (0 on success).  st0 and out
// are (17, N), spare (17, N) and mv (4, N) scratch, acc (3, N); the caller
// checks shapes, types, devices and that no buffer aliases another.
extern "C" int crm_outer_launch(const float* st0, const int* cell,
                                const int* start, const int* count,
                                float* out, float* spare, float* mv,
                                float* acc, int n, int nx, int ny, int nz,
                                int cap, int n_sub, const CrmConsts* k,
                                void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, crm_outer_kernel, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  const int want = (n + kThreads - 1) / kThreads;
  const int blocks = want < per_sm * sms ? want : per_sm * sms;
  Cells c{cell, start, count, nx, ny, nz, cap};
  CrmConsts kk = *k;
  void* args[] = {&st0, &c, &out, &spare, &mv, &acc, &n, &n_sub, &kk};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(crm_outer_kernel), dim3(blocks),
      dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
