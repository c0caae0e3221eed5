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
// What bounds a sweep that walks the 27 cells: at the 10 x 4 m terrain lane
// (1 M granular markers, cells of 2h, ~14 markers a bed cell) a granular
// marker tests ~340 candidates, of which ~17 % lie inside the support, and
// a warp ran the ~90-flop pair body inline whenever any lane had a hit, a
// few lanes busy; G walked the same cells again for the same pairs.  Each
// sweep moves only ~100-450 MB.  The design:
//   - M walks for_pairs_compact (cell_pairs.cuh): the candidates are
//     scanned into a shared-memory hit buffer, and the body runs over the
//     hits.  A kicked marker lists its in-support neighbours, in walk
//     order, in a (K, N) slot-major list with their number.
//   - Positions change only in G's epilogue, so G's pairs are M's: G
//     replays M's list and does no candidate scan.  A marker with more than
//     K neighbours walks again (the same pairs in the same order), so
//     nothing is dropped.
//   - The pair bodies, not the scan, then bound M and G: their loads of
//     each neighbour's terms, twelve planes for M and seven for G, each its
//     own cache line.  A pack kernel ahead of each sweep writes those terms
//     as one record a marker (three float4 for M, two for G), which the
//     body reads in 16-byte loads (crm_sweeps.cuh RecordNbr, RecordMv).
// crm_outer.cu runs the same walk, list and records, so M and G give its
// per-substep bits.  (Culling the scan to z windows of the nine columns,
// over cells sorted by z, cut M's candidates by half but not the lane's
// time: PERF.md.)  The hit buffers' depths, the scans' stretches and the
// minimum blocks an SM are constants set by timing on the card (PERF.md).

#include <cuda_runtime.h>

#include "crm_sweeps.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMHitDepth = 40;
constexpr int kMUnroll = 2;
constexpr int kMMinBlocks = 4;
// G's buffer serves only the walk of a marker past its list
constexpr int kGHitDepth = 8;
constexpr int kGUnroll = 2;
constexpr int kGMinBlocks = 5;

__global__ void __launch_bounds__(kThreads)
crm_pack_kernel(const float* __restrict__ st, float4* __restrict__ rec,
                int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) crm::pack_momentum_record(st, n, i, rec);
}

__global__ void __launch_bounds__(kThreads, kMMinBlocks)
crm_momentum_kernel(const float* __restrict__ st,
                    const float4* __restrict__ rec, Cells c,
                    float* __restrict__ mv, float* __restrict__ acc,
                    int* __restrict__ list, int K,
                    int* __restrict__ n_listed, int n, CrmConsts k) {
  extern __shared__ int hits[];
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  crm::momentum_listing<kMHitDepth, kMUnroll>(
      st, c, n, t < n ? t : -1, k, rec, mv, acc, list, K, n_listed,
      nullptr, hits);
}

__global__ void __launch_bounds__(kThreads)
crm_pack_gradv_kernel(const float* __restrict__ st,
                      const float* __restrict__ mv,
                      float4* __restrict__ rec, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) crm::pack_gradv_record(st, mv, n, i, rec);
}

__global__ void __launch_bounds__(kThreads, kGMinBlocks)
crm_gradv_stress_kernel(const float* __restrict__ st,
                        const float* __restrict__ mv,
                        const float4* __restrict__ rec, Cells c,
                        float* __restrict__ out,
                        const int* __restrict__ list, int K,
                        const int* __restrict__ n_listed, int n,
                        CrmConsts k) {
  extern __shared__ int hits[];
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  crm::gradv_stress_listed<kGHitDepth, kGUnroll>(
      st, mv, c, n, t < n ? t : -1, k, crm::RecordMv{rec}, out, list, K,
      n_listed, hits);
}

int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

// Sets the kernel's dynamic shared memory to a hit buffer of depth rows.
template <class Kernel>
cudaError_t hit_buffer(Kernel kernel, int depth, int* smem) {
  *smem = kThreads * depth * static_cast<int>(sizeof(int));
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
}

}  // namespace

// Launchers: run on `stream` and return cudaGetLastError() (0 on success).
// Arguments: the state, the cell table, the other buffers, the sizes.  The
// caller checks shapes, types, devices and that no input is an output.

// mv (4, N) and acc (3, N) may each be null, not both: mv alone is the
// substep's kick, both its with_acc mode, acc alone the forces-only mode.
// list (K, N) and n_listed (N,), both null or both given, get the kicked
// markers' neighbours.  rec is scratch of 12 N floats, 16-byte aligned:
// the records that the pack kernel writes first.
extern "C" int crm_momentum_launch(const float* state, const int* cell,
                                   const int* start, const int* count,
                                   float* rec, float* mv, float* acc,
                                   int* list, int* n_listed, int n, int nx,
                                   int ny, int nz, int cap, int K,
                                   const CrmConsts* k,
                                   void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int smem = 0;
  err = hit_buffer(crm_momentum_kernel, kMHitDepth, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Cells c{cell, start, count, nx, ny, nz, cap};
  float4* rec4 = reinterpret_cast<float4*>(rec);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  crm_pack_kernel<<<blocks_for(n), kThreads, 0, s>>>(state, rec4, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  crm_momentum_kernel<<<blocks_for(n), kThreads, smem, s>>>(
      state, rec4, c, mv, acc, list, K, n_listed, n, *k);
  return static_cast<int>(cudaGetLastError());
}

// list (K, N) and n_listed (N,): sweep M's, from the same state.  rec is
// scratch of 8 N floats, 16-byte aligned: the records that the pack kernel
// writes first.
extern "C" int crm_gradv_stress_launch(const float* state, const int* cell,
                                       const int* start, const int* count,
                                       float* rec, const float* mv,
                                       float* out, const int* list,
                                       const int* n_listed, int n, int nx,
                                       int ny, int nz, int cap, int K,
                                       const CrmConsts* k,
                                       void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int smem = 0;
  err = hit_buffer(crm_gradv_stress_kernel, kGHitDepth, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Cells c{cell, start, count, nx, ny, nz, cap};
  float4* rec4 = reinterpret_cast<float4*>(rec);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  crm_pack_gradv_kernel<<<blocks_for(n), kThreads, 0, s>>>(state, mv, rec4,
                                                          n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  crm_gradv_stress_kernel<<<blocks_for(n), kThreads, smem, s>>>(
      state, mv, rec4, c, out, list, K, n_listed, n, *k);
  return static_cast<int>(cudaGetLastError());
}
