// Host stand-in for the cooperative-groups names that kernels/csrc/keyswitch.cu uses
// (tests/test_torch_keyswitch_host_kernel.py).  The harness runs the grid as one
// block (gridDim 1), so each work-item loop covers every item and a grid-wide
// barrier is the block barrier.
#pragma once

void __syncthreads();

namespace cooperative_groups {
struct grid_group {
  void sync() const { __syncthreads(); }
};
inline grid_group this_grid() { return {}; }
}  // namespace cooperative_groups
