// The grid-wide barrier of tests/cuda_emu/cuda_runtime.h's CPU stand-in.
#pragma once

#include "cuda_runtime.h"

namespace cooperative_groups {
struct grid_group {
  void sync() { emu::grid_barrier->arrive_and_wait(); }
};
inline grid_group this_grid() { return {}; }
}  // namespace cooperative_groups
