// A CPU stand-in for the parts of the CUDA runtime that the port's pair-walk
// kernels, the NSC sweeps and detection, and the DEM row migration use, so
// that tests/test_torch_emulated_walks.py can compile their sources with g++
// and run them on CPU threads: one std::thread per CUDA thread, __any_sync
// on a barrier of the warp's 32 threads, __ballot_sync, __match_any_sync
// and __syncwarp on a barrier of the lanes in their mask, __syncthreads() on
// a barrier of the block, grid.sync() on a barrier of the whole grid,
// dynamic shared memory per block.  Only what those kernels need; the
// arithmetic is the host compiler's, so results match the card to
// rounding, not bit for bit, except where a kernel spells out its rounding
// (__fadd_rn and the like, exact here too).
#pragma once

#include <algorithm>
#include <barrier>
#include <bit>
#include <cmath>
#include <cstddef>
#include <functional>
#include <map>
#include <memory>
#include <mutex>
#include <thread>
#include <tuple>
#include <type_traits>
#include <utility>
#include <vector>

using std::max;
using std::min;

#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)

struct alignas(16) float4 {
  float x, y, z, w;
};
inline float4 make_float4(float x, float y, float z, float w) {
  return {x, y, z, w};
}
struct alignas(8) int2 {
  int x, y;
};
inline int2 make_int2(int x, int y) { return {x, y}; }

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3 blockIdx, threadIdx;
inline dim3 blockDim, gridDim;
inline thread_local void* emu_smem;   // this block's dynamic shared memory

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
       cudaErrorLaunchOutOfResources = 2 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };

inline cudaError_t cudaSetDevice(int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
// two "SMs" of one resident block each: a cooperative grid of two blocks
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = 2;
  return cudaSuccess;
}
template <class F>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* v, F, int,
                                                          size_t) {
  *v = 1;
  return cudaSuccess;
}
template <class F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
  return cudaSuccess;
}

inline float fminf(float a, float b) { return std::fmin(a, b); }
inline float fmaxf(float a, float b) { return std::fmax(a, b); }
inline float sqrtf(float a) { return std::sqrt(a); }
inline float powf(float a, float b) { return std::pow(a, b); }
inline float rsqrtf(float a) { return 1.0f / std::sqrt(a); }
inline float __fmaf_rn(float a, float b, float c) {
  return std::fma(a, b, c);
}
// one IEEE single operation each, rounded to nearest (the host's SSE)
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fsqrt_rn(float a) { return std::sqrt(a); }
inline int __popc(unsigned v) { return std::popcount(v); }

namespace emu {

struct Warp {
  std::barrier<> bar{32};
  bool votes[32];
  int values[32];
  std::mutex lock;
  std::map<unsigned, std::unique_ptr<std::barrier<>>> groups;  // by mask

  // the barrier of the lanes in `mask`, made by the first to ask
  std::barrier<>& group(unsigned mask) {
    std::lock_guard<std::mutex> hold(lock);
    auto& b = groups[mask];
    if (!b) b = std::make_unique<std::barrier<>>(std::popcount(mask));
    return *b;
  }
};
inline std::vector<std::unique_ptr<Warp>> warps;   // by global warp id
inline std::unique_ptr<std::barrier<>> grid_barrier;
inline thread_local std::barrier<>* block_barrier;

// Runs fn on grid x block threads: block by block, or every block at once
// for a cooperative launch (whose grid.sync() needs them all).
inline void run(dim3 grid, dim3 block, size_t smem, cudaStream_t,
                std::function<void()> fn, bool cooperative = false) {
  gridDim = grid;
  blockDim = block;
  warps.clear();
  for (unsigned w = 0; w < grid.x * block.x / 32; ++w)
    warps.push_back(std::make_unique<Warp>());
  if (cooperative)
    grid_barrier = std::make_unique<std::barrier<>>(grid.x * block.x);
  const unsigned together = cooperative ? grid.x : 1;
  for (unsigned b0 = 0; b0 < grid.x; b0 += together) {
    std::vector<std::vector<char>> mem(together,
                                       std::vector<char>(smem + 16));
    std::vector<std::unique_ptr<std::barrier<>>> bars;
    for (unsigned b = 0; b < together; ++b)
      bars.push_back(std::make_unique<std::barrier<>>(block.x));
    std::vector<std::thread> threads;
    for (unsigned b = b0; b < b0 + together; ++b)
      for (unsigned t = 0; t < block.x; ++t)
        threads.emplace_back([&, b, t] {
          blockIdx = dim3(b);
          threadIdx = dim3(t);
          emu_smem = mem[b - b0].data();
          block_barrier = bars[b - b0].get();
          fn();
        });
    for (auto& t : threads) t.join();
  }
}

template <class... A, size_t... I>
void call(void (*k)(A...), void** args, std::index_sequence<I...>) {
  k(*static_cast<std::remove_cv_t<std::remove_reference_t<A>>*>(args[I])...);
}

template <class... A>
cudaError_t launch_cooperative(void (*k)(A...), dim3 grid, dim3 block,
                               void** args, size_t smem, cudaStream_t s) {
  run(grid, block, smem, s,
      [&] { call(k, args, std::index_sequence_for<A...>{}); }, true);
  return cudaSuccess;
}

}  // namespace emu

inline bool __any_sync(unsigned, bool p) {
  auto& w = *emu::warps[(blockIdx.x * blockDim.x + threadIdx.x) / 32];
  w.votes[threadIdx.x & 31] = p;
  w.bar.arrive_and_wait();
  bool any = false;
  for (bool v : w.votes) any |= v;
  w.bar.arrive_and_wait();
  return any;
}

inline unsigned __ballot_sync(unsigned mask, bool p) {
  auto& w = *emu::warps[(blockIdx.x * blockDim.x + threadIdx.x) / 32];
  auto& bar = w.group(mask);
  w.votes[threadIdx.x & 31] = p;
  bar.arrive_and_wait();
  unsigned votes = 0;
  for (unsigned lane = 0; lane < 32; ++lane)
    if ((mask >> lane & 1u) && w.votes[lane]) votes |= 1u << lane;
  bar.arrive_and_wait();
  return votes;
}

inline void __syncthreads() { emu::block_barrier->arrive_and_wait(); }

inline unsigned __match_any_sync(unsigned mask, int v) {
  auto& w = *emu::warps[(blockIdx.x * blockDim.x + threadIdx.x) / 32];
  auto& bar = w.group(mask);
  w.values[threadIdx.x & 31] = v;
  bar.arrive_and_wait();
  unsigned same = 0;
  for (unsigned lane = 0; lane < 32; ++lane)
    if ((mask >> lane & 1u) && w.values[lane] == v) same |= 1u << lane;
  bar.arrive_and_wait();
  return same;
}

inline void __syncwarp(unsigned mask = 0xffffffffu) {
  auto& w = *emu::warps[(blockIdx.x * blockDim.x + threadIdx.x) / 32];
  w.group(mask).arrive_and_wait();
}

inline int __clz(unsigned v) { return std::countl_zero(v); }
