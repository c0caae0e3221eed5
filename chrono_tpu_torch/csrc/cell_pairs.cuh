// The neighbour loop over cell-sorted markers that the SPH and CRM sweeps
// share: a per-cell (start, count) table, the cubic spline, and a walk over
// the 27 neighbour cells that hands each pair inside the support 2h to a
// per-pair callable.  Nothing here knows a sweep's plane layout: the loop
// reads the three position planes it is given.
//
// Ports the pair loop of chrono_tpu/ops/pallas/sph_sym_kernel.py _sym_sweep
// and flatlane_kernel.py sym_sweep_flat (their pair2 callback contract) in
// the GPU-native form: one thread per marker, every pair summed from the
// thread's own side only, in a fixed order, with no atomics.
//
// The walk order: the 27 neighbour cells (edge cells skipped) in (dx, dy,
// dz) order, each from -1 to 1, and in each cell its first `cap` markers in
// sorted order, the marker itself skipped.  for_pairs_compact hands the
// pairs inside 2h to the callable in that order, scanning the candidates
// first and running the pair body over the hits only (see there);
// for_listed_pairs replays a list that it wrote.
#pragma once

#include <cuda_runtime.h>

// A counter build (-DPAIR_COUNTERS, chip_smoke.py) tallies, per thread of
// the launch, [0] the warp's candidate iterations and [1] its pair-body
// issues, each counted once per converged group of lanes (by its lowest
// lane), and [2] the lane's candidates and [3] its pair-body runs.  The
// host binds a zeroed (threads, 4) int64 buffer before the launch.  The
// default build compiles the hooks to nothing.
#ifdef PAIR_COUNTERS
__device__ unsigned long long* pair_tally;

extern "C" int pair_tally_bind(void* p) {
  return static_cast<int>(cudaMemcpyToSymbol(pair_tally, &p, sizeof p));
}

__device__ __forceinline__ void tally_pair_event(int k) {
  const unsigned group = __activemask();
  unsigned long long* t =
      pair_tally + 4 * (blockIdx.x * blockDim.x + threadIdx.x);
  if ((threadIdx.x & 31) == __ffs(group) - 1) t[k] += 1;
  t[k + 2] += 1;
}
#define PAIR_TALLY(k) tally_pair_event(k)
#else
#define PAIR_TALLY(k)
#endif

struct Cells {
  const int* cell;    // (N,) cell id (i*ny + j)*nz + k of each sorted marker
  const int* start;   // (n_cells,) first sorted index in the cell
  const int* count;   // (n_cells,) markers in the cell
  int nx, ny, nz, cap;
};

// Cubic spline W and dW/dr at q = r/h, zero for q >= 2 (fsi/sph/kernels.py);
// sigma = 1/(pi h^3).
__device__ __forceinline__ float cubic_w(float q, float sigma) {
  if (q < 1.0f) return sigma * (1.0f - 1.5f * q * q + 0.75f * q * q * q);
  const float t = 2.0f - q;
  return sigma * (0.25f * t * t * t);
}

__device__ __forceinline__ float cubic_dwdr(float q, float h, float sigma) {
  if (q < 1.0f) return sigma / h * (-3.0f * q + 2.25f * q * q);
  const float t = 2.0f - q;
  return sigma / h * (-0.75f * t * t);
}

// Whether sorted marker i is among the first `cap` of its cell (takes part).
__device__ __forceinline__ bool live(const Cells& c, int i) {
  return i - c.start[c.cell[i]] < c.cap;
}

// d = x_i - x_j, r2, r = sqrt(r2 + 1e-12) and q = r/h of candidate j: the
// one arithmetic that hands a pair to a body, from a hit buffer or from a
// list, so that a pair gets the same bits either way.
__device__ __forceinline__ void pair_geometry(const float xj[3],
                                              const float xi[3], float h,
                                              float d[3], float& r2,
                                              float& r, float& q) {
  d[0] = xi[0] - xj[0];
  d[1] = xi[1] - xj[1];
  d[2] = xi[2] - xj[2];
  r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
  r = sqrtf(r2 + 1e-12f);
  q = r / h;
}

__device__ __forceinline__ void pair_geometry(const float* px,
                                              const float* py,
                                              const float* pz, int j,
                                              const float xi[3], float h,
                                              float d[3], float& r2,
                                              float& r, float& q) {
  const float xj[3] = {px[j], py[j], pz[j]};
  pair_geometry(xj, xi, h, d, r2, r, q);
}

// Calls pair(j, d, r2, r, q) for every marker j != i inside the support
// (q < 2), in the walk order, with d = x_i - x_j and r = sqrt(r2 + 1e-12)
// (pair_geometry); the pair body runs only over those hits.  The position
// pointers take no __restrict__: the CRM outer kernel reads buffers that
// it writes in a later sweep.
//
// Why: one thread per marker walks ~400-700 candidates of which 8-17 % lie
// inside 2h, and a walk that runs the body inline makes a warp issue the
// 40-90-flop body whenever any of its lanes has a hit, with a few lanes busy
// (on an H100: in 0.35 of the SPH dam break's warp candidate iterations with
// 7.4 lanes busy, 0.53 with 6.2 in the CRM lane; PERF.md). Here the walk is
// split in two.  The scan (three position loads, r^2 and the r2_cut test; the
// exact q < 2 test only in the thin shell where r^2 cannot decide it) writes
// each hit j, in walk order, to the lane's column of a hit buffer in shared
// memory; when any lane's column cannot take another stretch of the scan (the
// warp agrees by a vote), and once at the end, every lane runs the body over
// its own hits, so the body issues with most lanes busy.  Candidates are still
// read through L1; only the hits go through shared memory.
//
// The walk: for fixed (dx, dy) the cells k-1..k+1 are consecutive ids, so
// their markers form one contiguous run of sorted markers; a marker's 27
// cells are nine runs (columns off the grid skipped), walked in (dx, dy)
// order and each in sorted order: the walk order (dx, dy, dz, marker).
// Only the first c.cap markers of a cell take part, so a cell past its cap
// ends its run there and the next cell starts a new one; cells within
// their cap join the run (the next cell's markers start where theirs end).
// A lane scans a run to its end, kUnroll candidates at a time, or until
// its column is full, in a tight loop; the warp votes between those
// stretches only (a few times a run), never per candidate.  (Stretches of
// a fixed length that run on across run ends were 25 % slower: PERF.md.)
//
// Every lane of the warp must call it together (the votes need all 32),
// with walk false where the lane's marker has nothing to walk.  hits is
// the block's buffer of kDepth x blockDim.x ints (slot t of this thread at
// hits[t * blockDim.x + threadIdx.x]); the scan takes kUnroll candidates at
// a time.  Each kernel sets both by timing on the card (PERF.md).
//
// for_pairs_compact_kept takes a predicate keep(j) that the scan asks of
// each candidate inside the support before it buffers it, so the body runs
// over the kept ones only (SPH A keeps its fluid neighbours).
template <int kDepth, int kUnroll, class Keep, class Pair>
__device__ __forceinline__ void for_pairs_compact_kept(
    const float* px, const float* py, const float* pz, const Cells& c, int i,
    const float xi[3], float h, bool walk, int* hits, Keep&& keep,
    Pair&& pair) {
  static_assert(kUnroll >= 1 && kDepth >= kUnroll, "a stretch must fit");
  constexpr unsigned kWarp = 0xffffffffu;
  int* mine = hits + threadIdx.x;
  const int slot = blockDim.x;
  int ci = 0, cj = 0, ck = 0;
  if (walk) {
    const int cell = c.cell[i];
    ck = cell % c.nz;
    cj = (cell / c.nz) % c.ny;
    ci = cell / (c.nz * c.ny);
  }
  const int k0 = max(ck - 1, 0), k1 = min(ck + 1, c.nz - 1);
  // q >= 2 for certain beyond r2_cut and q < 2 for certain below r2_in
  // (margins over rounding), so the exact test runs in the shell between
  const float r2_cut = 4.0004f * h * h;
  const float r2_in = 3.9996f * h * h - 2e-12f;
  int col = -1;        // the current (dx, dy) = (col / 3 - 1, col % 3 - 1)
  int kk = k1 + 1;     // the column's next cell to start a run at
  int base = 0;        // the id of the column's cell k = 0
  int j = 0, end = 0;  // the run's candidates left, [j, end)
  int held = 0;        // hits in the lane's column of the buffer
  bool more = walk;
  const auto flush = [&]() {
    for (int t = 0; t < held; ++t) {
      const int jt = mine[t * slot];
      if (jt == i) continue;         // the scan keeps i; skipped here
      float d[3], r2, r, q;
      pair_geometry(px, py, pz, jt, xi, h, d, r2, r, q);
      PAIR_TALLY(1);
      pair(jt, d, r2, r, q);
    }
    held = 0;
  };
  while (__any_sync(kWarp, more)) {
    while (more && j >= end) {         // the next non-empty run
      if (kk > k1) {
        if (++col == 9) {
          more = false;
          break;
        }
        const int ii = ci + col / 3 - 1, jj = cj + col % 3 - 1;
        if (ii < 0 || ii >= c.nx || jj < 0 || jj >= c.ny) continue;
        base = (ii * c.ny + jj) * c.nz;
        kk = k0;
      }
      j = c.start[base + kk];
      int cnt = c.count[base + kk++];
      end = j + min(cnt, c.cap);
      while (cnt <= c.cap && kk <= k1) {
        cnt = c.count[base + kk++];
        end += min(cnt, c.cap);
      }
    }
    // candidate jc into the buffer if it lies inside the support, by r^2
    // against r2_cut and then q < 2 (a NaN passes both).  r^2 is written
    // out as the fused form nvcc gives d0 d0 + d1 d1 + d2 d2 (equal on
    // 2^24 random pairs on an H100: PERF.md), so that the test is one
    // fixed float32 expression, which crm_neighbour_counts_plain
    // evaluates to the same bits.
    const auto scan = [&](int jc) {
      PAIR_TALLY(0);
      const float d[3] = {xi[0] - px[jc], xi[1] - py[jc], xi[2] - pz[jc]};
      const float r2 =
          __fmaf_rn(d[2], d[2], __fmaf_rn(d[0], d[0], d[1] * d[1]));
      if (r2 > r2_cut) return;
      if (r2 >= r2_in && sqrtf(r2 + 1e-12f) / h >= 2.0f) return;
      if (!keep(jc)) return;
      mine[held++ * slot] = jc;
    };
    // kUnroll at a time while they fit, then one at a time to the run's
    // end or a full column
    for (; j + kUnroll <= end && held + kUnroll <= kDepth; j += kUnroll) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) scan(j + u);
    }
    while (j < end && held < kDepth) scan(j++);
    // flush before a lane is left unable to scan kUnroll more
    if (__any_sync(kWarp, held > kDepth - kUnroll)) flush();
  }
  flush();
}

template <int kDepth, int kUnroll, class Pair>
__device__ __forceinline__ void for_pairs_compact(
    const float* px, const float* py, const float* pz, const Cells& c, int i,
    const float xi[3], float h, bool walk, int* hits, Pair&& pair) {
  for_pairs_compact_kept<kDepth, kUnroll>(
      px, py, pz, c, i, xi, h, walk, hits, [](int) { return true; }, pair);
}

// Calls pair(j, d, r2, r, q) for the n_listed pairs of a marker that a
// compacted walk listed, in its order: entry t at row[t * step], with
// neighbour j's position from pos(j, xj) (a packed record holds the
// planes' values, so the pairs get the same bits).
template <class Pos, class Pair>
__device__ __forceinline__ void for_listed_pairs(const int* row, int step,
                                                 int n_listed,
                                                 const float xi[3], float h,
                                                 Pos&& pos, Pair&& pair) {
  for (int t = 0; t < n_listed; ++t) {
    const int j = row[t * step];
    float xj[3], d[3], r2, r, q;
    pos(j, xj);
    pair_geometry(xj, xi, h, d, r2, r, q);
    PAIR_TALLY(1);
    pair(j, d, r2, r, q);
  }
}
