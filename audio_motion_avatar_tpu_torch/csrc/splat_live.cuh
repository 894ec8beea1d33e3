// The live prefix of a packed splat tile, shared by kernel K1
// (splat_tiles.cu) and its backward K2 (splat_tiles_bwd.cu), so that both
// cut a tile's slots at the same place.
//
// The binning keeps each tile's gaussians as a prefix of its K slots and
// gives the padding opacity 0. A slot of opacity 0 has alpha 0 at every
// pixel: it adds log1p(-0) = -0 to the log-transmittance, weight 0 to the
// colour and exactly 0 to every gradient. So a kernel walks only the slots
// up to the last one of nonzero opacity; opacity-0 slots inside that prefix
// are walked and drop out by the alpha rule like any other.

#pragma once

#include <cuda_runtime.h>

namespace splat_live {

// 1 + the last k < K with op[k] != 0 (op: a tile's opacity row), 0 if there
// is none. Called by every thread of a block of NT threads; `warp_max` is
// NT / 32 ints of shared memory, free again after the caller's next
// __syncthreads. visit(k, op[k]) is called on every slot read, before the
// block's barrier: what it writes to shared memory is visible to the whole
// block on return.
template <int NT, typename Visit>
__device__ __forceinline__ int live_prefix(const float* __restrict__ op, int K, int* warp_max,
                                           Visit visit) {
  int live = 0;
  for (int k = threadIdx.x; k < K; k += NT) {
    const float o = op[k];
    if (o != 0.f) live = k + 1;
    visit(k, o);
  }
  live = __reduce_max_sync(0xffffffffu, live);
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = live;
  __syncthreads();
  live = 0;
#pragma unroll
  for (int w = 0; w < NT / 32; ++w) live = max(live, warp_max[w]);
  return live;
}

template <int NT>
__device__ __forceinline__ int live_prefix(const float* __restrict__ op, int K, int* warp_max) {
  return live_prefix<NT>(op, K, warp_max, [](int, float) {});
}

}  // namespace splat_live
