// NSC contact detection on cell-sorted bodies, one thread per body, once per
// DVI step.
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
// The distance is computed with explicit round-to-nearest operations (no
// fused multiply-add) as (dx^2 + dy^2) + dz^2, so that the kernel and its
// plain twin (ops/cuda/nsc_detect.py) agree bit for bit.
//
// What bounds it: latency.  A thread walks up to 14 cells one after another,
// each candidate three position loads (served from L1: a warp's bodies share
// most neighbour cells) and ~12 flops, and writes its partners with scattered
// stores; at the bladed mixer (40,000 bodies) it took ~20 us per launch on an
// NVIDIA H100 80GB HBM3 at a 700 W limit, far above its bytes bound, and runs
// once per DVI step.

#include <cuda_runtime.h>

#include "cell_pairs.cuh"

namespace {

__global__ void __launch_bounds__(256)
nsc_detect_kernel(const float* __restrict__ pos, Cells c,
                  int* __restrict__ partners, int* __restrict__ pcount,
                  int n, int P, float two_r, float envelope) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float* px = pos;
  const float* py = pos + n;
  const float* pz = pos + 2 * n;
  const float xi = px[i], yi = py[i], zi = pz[i];
  const int cell = c.cell[i];
  const int ck = cell % c.nz;
  const int cj = (cell / c.nz) % c.ny;
  const int ci = cell / (c.nz * c.ny);
  int found = 0;
  for (int k = 0; k < 14; ++k) {
    int dx = 0, dy = 0, dz = 0;
    if (k < 12) {
      const int q = k / 3;                 // (0,1), (1,-1), (1,0), (1,1)
      dx = q == 0 ? 0 : 1;
      dy = q == 0 ? 1 : q - 2;
      dz = k % 3 - 1;
    } else if (k == 12) {
      dz = 1;
    }
    const int ii = ci + dx, jj = cj + dy, kk = ck + dz;
    if (ii >= c.nx || jj < 0 || jj >= c.ny || kk < 0 || kk >= c.nz) continue;
    const int nc = (ii * c.ny + jj) * c.nz + kk;
    const int s = c.start[nc];
    const int e = s + c.count[nc];
    for (int j = k == 13 ? i + 1 : s; j < e; ++j) {
      const float ddx = __fsub_rn(px[j], xi);
      const float ddy = __fsub_rn(py[j], yi);
      const float ddz = __fsub_rn(pz[j], zi);
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(ddx, ddx),
                                           __fmul_rn(ddy, ddy)),
                                 __fmul_rn(ddz, ddz));
      const float dist = __fsqrt_rn(__fadd_rn(d2, 1e-18f));
      if (__fsub_rn(dist, two_r) < envelope) {
        if (found < P) partners[i * P + found] = j;
        ++found;
      }
    }
  }
  for (int p = found; p < P; ++p) partners[i * P + p] = -1;
  pcount[i] = found;
}

}  // namespace

// Launcher: runs on `stream` and returns cudaGetLastError() (0 on success).
// The caller checks shapes, types and devices.
extern "C" int nsc_detect_launch(const float* pos, const int* cell,
                                 const int* start, const int* count,
                                 int* partners, int* pcount, int n, int nx,
                                 int ny, int nz, int P, float two_r,
                                 float envelope, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Cells c{cell, start, count, nx, ny, nz, 0};
  nsc_detect_kernel<<<(n + 255) / 256, 256, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      pos, c, partners, pcount, n, P, two_r, envelope);
  return static_cast<int>(cudaGetLastError());
}
