// NSC contact detection on cell-sorted bodies, a group of L lanes a body,
// once per DVI step.
//
// Counterpart of chrono_tpu/ops/pallas/nsc_half_kernel.py detect_half:58 (an
// XLA function on the JAX mixer's path).  Each pair within the envelope
// (gap < envelope) is owned by the side from which the other lies in the
// forward half stencil.  An owner walks the 14 forward classes in
// _class_offset order: the 12 cells (dx, dy) in {(0,1), (1,-1), (1,0),
// (1,1)} x dz in {-1, 0, 1}, then (0, 0, +1), then its own cell with the
// partner after it in sorted order (a stable sort keeps the JAX package's
// slot order).  It keeps its first P partners, in that rank order, and
// counts them all: max count - P is the partner overflow.
//
// The walk is six contiguous runs of sorted bodies, not 14 cells: for each
// of the four forward columns (dx, dy) the cells k-1..k+1 are consecutive
// ids, so classes 3q..3q+2 are one run (as dem_pairs.cuh's neighbour_run
// finds a DEM row's runs); then cell (0, 0, +1); then the owner's own cell
// after it.  Taken in that order the runs visit the candidates in class
// order.
//
// A group of L consecutive lanes of a warp (L = 1, 2, 4 or 8, the
// wrapper's choice) walks one body's runs together, L candidates a step:
// neighbouring lanes load neighbouring bodies (the three position planes
// coalesce), each lane tests its candidate, and the hits of a step are
// ranked in walk order by a ballot of the whole warp, masked to the group,
// and a popcount of the lanes below.  The warp steps while any of its
// groups has candidates left, so every vote has all 32 lanes (votes under
// the groups' own masks, which diverge, were serialised: 7.7x slower at one
// lane).  With L = 1 a thread walks its runs alone, with no votes.  The
// partner table and the counts are the one-thread walk's exactly
// (integers).
//
// The distance is computed with explicit round-to-nearest operations (no
// fused multiply-add) as (dx^2 + dy^2) + dz^2, so that the kernel and its
// plain twin (ops/cuda/nsc_detect.py) agree bit for bit.
//
// What bounds it: latency, far above its bytes bound.  At the bladed mixer
// (40,000 bodies) one thread a body left about one block of 256 threads on
// each of the 132 SMs, and its 14-cell walk took ~20 us a launch on an
// NVIDIA H100 80GB HBM3 at a 700 W limit; four lanes a body put four times
// as many warps in flight and took ~12 us.  At 400,000 bodies the card is
// full with one lane a body, and the six runs (two table loads each, not
// two a cell) took ~51 us against ~65.  It runs once per DVI step.

#include <cuda_runtime.h>

#include "cell_pairs.cuh"

namespace {

constexpr int kThreads = 256;

// Bodies [lo, hi) of the cells (ii, jj, k0..k1); empty off the grid.
__device__ __forceinline__ void body_run(const Cells& c, int ii, int jj,
                                         int k0, int k1, int& lo, int& hi) {
  if (ii >= c.nx || jj < 0 || jj >= c.ny || k0 > k1) {
    lo = hi = 0;
    return;
  }
  const int base = (ii * c.ny + jj) * c.nz;
  lo = c.start[base + k0];
  hi = c.start[base + k1] + c.count[base + k1];
}

// Whether body j lies within the envelope of (xi, yi, zi): the twin's
// operations and roundings.
__device__ __forceinline__ bool within(const float* px, const float* py,
                                       const float* pz, int j, float xi,
                                       float yi, float zi, float two_r,
                                       float envelope) {
  const float ddx = __fsub_rn(px[j], xi);
  const float ddy = __fsub_rn(py[j], yi);
  const float ddz = __fsub_rn(pz[j], zi);
  const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(ddx, ddx),
                                       __fmul_rn(ddy, ddy)),
                             __fmul_rn(ddz, ddz));
  const float dist = __fsqrt_rn(__fadd_rn(d2, 1e-18f));
  return __fsub_rn(dist, two_r) < envelope;
}

template <int L>
__global__ void __launch_bounds__(kThreads)
nsc_detect_kernel(const float* __restrict__ pos, Cells c,
                  int* __restrict__ partners, int* __restrict__ pcount,
                  int n, int P, float two_r, float envelope) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = t / L;
  // past the last body a group walks empty runs: with L > 1 the warp
  // stays whole, every lane at every vote
  const bool body = i < n;
  const int lane = t % L;
  const int wl = threadIdx.x & 31;
  const unsigned group = ((1u << L) - 1u) << (wl & ~(L - 1));
  const unsigned below = (1u << wl) - 1u;
  const float* px = pos;
  const float* py = pos + n;
  const float* pz = pos + 2 * n;
  float xi = 0.0f, yi = 0.0f, zi = 0.0f;
  int ci = 0, cj = 0, ck = 0, cell = 0;
  if (body) {
    xi = px[i], yi = py[i], zi = pz[i];
    cell = c.cell[i];
    ck = cell % c.nz;
    cj = (cell / c.nz) % c.ny;
    ci = cell / (c.nz * c.ny);
  }
  const int k0 = max(ck - 1, 0), k1 = min(ck + 1, c.nz - 1);
  int found = 0;
  for (int r = 0; r < 6; ++r) {
    int lo = 0, hi = 0;
    if (body && r < 4) {         // columns (0,1), (1,-1), (1,0), (1,1)
      body_run(c, ci + (r == 0 ? 0 : 1), cj + (r == 0 ? 1 : r - 2), k0, k1,
               lo, hi);
    } else if (body && r == 4) { // (0, 0, +1)
      body_run(c, ci, cj, ck + 1, min(ck + 1, c.nz - 1), lo, hi);
    } else if (body) {           // the own cell after i
      lo = i + 1;
      hi = c.start[cell] + c.count[cell];
    }
    if constexpr (L == 1) {
      for (int j = lo; j < hi; ++j) {
        if (within(px, py, pz, j, xi, yi, zi, two_r, envelope)) {
          if (found < P) partners[i * P + found] = j;
          ++found;
        }
      }
    } else {
      // the warp steps while any of its groups has candidates left
      for (int base = lo; __any_sync(0xffffffffu, base < hi); base += L) {
        const int j = base + lane;
        const bool hit =
            j < hi && within(px, py, pz, j, xi, yi, zi, two_r, envelope);
        const unsigned votes = __ballot_sync(0xffffffffu, hit) & group;
        if (hit) {
          const int rank = found + __popc(votes & below);
          if (rank < P) partners[i * P + rank] = j;
        }
        found += __popc(votes);
      }
    }
  }
  if (!body) return;
  for (int p = found + lane; p < P; p += L) partners[i * P + p] = -1;
  if (lane == 0) pcount[i] = found;
}

template <int L>
cudaError_t launch(const float* pos, const Cells& c, int* partners,
                   int* pcount, int n, int P, float two_r, float envelope,
                   cudaStream_t s) {
  const int blocks = static_cast<int>(
      (static_cast<long long>(n) * L + kThreads - 1) / kThreads);
  nsc_detect_kernel<L><<<blocks, kThreads, 0, s>>>(
      pos, c, partners, pcount, n, P, two_r, envelope);
  return cudaGetLastError();
}

}  // namespace

// Launcher: runs on `stream` with `lanes` lanes a body (1, 2, 4 or 8) and
// returns cudaGetLastError() (0 on success); any other lane count returns
// cudaErrorInvalidValue.  The caller checks shapes, types and
// devices.
extern "C" int nsc_detect_launch(const float* pos, const int* cell,
                                 const int* start, const int* count,
                                 int* partners, int* pcount, int n, int nx,
                                 int ny, int nz, int P, float two_r,
                                 float envelope, int lanes, void* stream,
                                 int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Cells c{cell, start, count, nx, ny, nz, 0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (lanes) {
    case 1: return static_cast<int>(
        launch<1>(pos, c, partners, pcount, n, P, two_r, envelope, s));
    case 2: return static_cast<int>(
        launch<2>(pos, c, partners, pcount, n, P, two_r, envelope, s));
    case 4: return static_cast<int>(
        launch<4>(pos, c, partners, pcount, n, P, two_r, envelope, s));
    case 8: return static_cast<int>(
        launch<8>(pos, c, partners, pcount, n, P, two_r, envelope, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
