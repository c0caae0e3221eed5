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
// functions of crm_sweeps.cuh (the sweeps that the per-sweep kernels of
// crm_substep.cu run over another walk), with cooperative_groups
// grid.sync() between sweeps and the states ping-ponging between two
// buffers in global memory: M reads state s and writes the kicked
// velocities, G reads both and writes state s+1 into the other buffer,
// arranged so that the last one lands in `out`.  The TPU kernel's row trim
// (nx_act, clip_z) and its A/B slot tiers are TPU layout devices with no
// counterpart here.
//
// The design, for what bounds the per-sweep form (the candidate loop, and a
// pair body that a warp issues whenever any lane has a hit):
//   - M walks with for_pairs_compact (cell_pairs.cuh): a scan of the
//     candidates, then the pair body over the hits only.  An integrated
//     marker also writes its in-support neighbours, in walk order, to a
//     list (K, N) in global memory, slot-major so that a warp reads one
//     slot of consecutive markers at once.
//   - Ahead of each sweep the grid packs the terms that its pair body reads
//     of a neighbour into one record a marker (crm_sweeps.cuh RecordNbr,
//     RecordMv), as the per-sweep kernels do, behind a grid.sync().
//   - Positions change only in G's epilogue, so G finds M's pairs: it
//     replays M's list instead of walking again.  A marker with more than
//     K neighbours walks again in G (the same pairs in the same order) and
//     is reported through `most`, its largest neighbour count, which the
//     wrapper turns into the call's list overflow: nothing is dropped, and
//     nothing syncs the host.  The list is rebuilt every substep.
//   - The grid strides over `order`, the markers with the integrated ones
//     first, then the other valid ones (walls), then the rest, each in
//     sorted order, so the walks are packed at the front of every thread's
//     share, the warps of a block walk neighbouring markers (shared
//     candidates in L1), and the walls cost only their epilogues.  The
//     loop is warp-uniform (the walk votes).  (Shuffling 256-marker tiles
//     of it, to even out the warps' work, was 26 % slower: PERF.md.)
// The launch has as many blocks as can be resident at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor with the hit buffer's dynamic
// shared memory, x SMs), which a grid-wide barrier needs.  The hit buffer's
// depth (kHitDepth), the scan's stretch (kScanUnroll) and kOuterMinBlocks,
// which caps the registers for that count, were set by timing on the card
// (PERF.md gives the registers, the spills and the times; 3 blocks an SM was
// 12 % slower).
//
// What bounded it before the records, on an H100 at the 1.4 M-marker
// lane: sweep M, ~78 %
// of the time (its scan of ~350 candidates a marker, and in the last
// substep the walls' walk for the acceleration); G's list replay ~22 %
// (walking again in G instead costs 16 % more); the SMs wait at the
// barriers ~10 % of a sweep (PERF.md).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "crm_sweeps.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kHitDepth = 40;
constexpr int kScanUnroll = 2;
constexpr int kOuterMinBlocks = 4;

__global__ void __launch_bounds__(kThreads, kOuterMinBlocks)
crm_outer_kernel(const float* __restrict__ st0, Cells c, float* out,
                 float* spare, float* mv, float* acc, float4* rec,
                 const int* __restrict__ order, int* list, int K,
                 int* n_listed, int* most, int n, int n_sub, CrmConsts k) {
  extern __shared__ int hits[];
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  const int warp0 = first - lane;
  const int stride = gridDim.x * blockDim.x;
  const float* cur = st0;
  for (int s = 0; s < n_sub; ++s) {
    float* next = (n_sub - 1 - s) % 2 == 0 ? out : spare;
    float* a = s == n_sub - 1 ? acc : nullptr;
    for (int i = first; i < n; i += stride)
      crm::pack_momentum_record(cur, n, i, rec);
    grid.sync();
    for (int p0 = warp0; p0 < n; p0 += stride) {
      const int p = p0 + lane;
      crm::momentum_listing<kHitDepth, kScanUnroll>(
          cur, c, n, p < n ? order[p] : -1, k, rec, mv, a, list, K,
          n_listed, most, hits);
    }
    grid.sync();
    for (int i = first; i < n; i += stride)
      crm::pack_gradv_record(cur, mv, n, i, rec);
    grid.sync();
    for (int p0 = warp0; p0 < n; p0 += stride) {
      const int p = p0 + lane;
      crm::gradv_stress_listed<kHitDepth, kScanUnroll>(
          cur, mv, c, n, p < n ? order[p] : -1, k, crm::RecordMv{rec}, next,
          list, K, n_listed, hits);
    }
    grid.sync();
    cur = next;
  }
}

}  // namespace

// Runs on `stream` and returns a cudaError_t (0 on success).  st0 and out
// are (17, N), spare (17, N) and mv (4, N) scratch, acc (3, N); rec
// scratch of 12 N floats, 16-byte aligned, for the records; order (N,)
// a permutation of the markers, integrated ones first; list (K, N),
// n_listed (N,) scratch; most (N,) zeroed, gets each integrated marker's
// largest in-support neighbour count.  The caller checks shapes, types,
// devices and that no buffer aliases another.
extern "C" int crm_outer_launch(const float* st0, const int* cell,
                                const int* start, const int* count,
                                float* out, float* spare, float* mv,
                                float* acc, float* rec, const int* order,
                                int* list,
                                int* n_listed, int* most, int n, int nx,
                                int ny, int nz, int cap, int n_sub, int K,
                                const CrmConsts* k, void* stream,
                                int device) {
  if (K < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = static_cast<int>(sizeof(int)) * kThreads * kHitDepth;
  err = cudaFuncSetAttribute(crm_outer_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, crm_outer_kernel, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  const int want = (n + kThreads - 1) / kThreads;
  const int blocks = want < per_sm * sms ? want : per_sm * sms;
  Cells c{cell, start, count, nx, ny, nz, cap};
  CrmConsts kk = *k;
  float4* rec4 = reinterpret_cast<float4*>(rec);
  void* args[] = {&st0,  &c, &out,      &spare, &mv, &acc,   &rec4, &order,
                  &list, &K, &n_listed, &most,  &n,  &n_sub, &kk};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(crm_outer_kernel), dim3(blocks),
      dim3(kThreads), args, smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
