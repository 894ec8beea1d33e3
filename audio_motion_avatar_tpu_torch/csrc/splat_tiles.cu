// Kernel K1: tile splat composite of the default (non-serving) renderer and
// the novel-view renders.
//
// Replaces the TPU kernel `_composite_tiles_pallas` / `_tile_kernel` of
// audio_motion_avatar_tpu/ops/splat_pallas.py (the forward of
// `composite_tiles`). The host side (ops/splat_tiles.py pack_tile_params)
// bins every view's gaussians and packs each tile's first K depth-ordered
// ones into a (9, K) block [mx, my, cxx, cxy, cyy, op, r, g, b], the padding
// slots with opacity 0; F views' blocks are stacked into one (F * T, 9, K)
// array and composited by ONE launch, the tile origin taken from
// tile % tiles_per_frame as the TPU kernel's scalar-prefetched `ntpf`.
//
// Bound on the H100: the fp32 operations that the rule needs on these
// inputs at 67 TFLOP/s (a (pixel, live slot) pair 12 where it is far, 15
// where it is dropped otherwise, 19 where it is kept with its weight
// dropped, 27 where it is blended: splat_segments.cu, chip_smoke.py
// walk_operations), against the bytes it must move: the opacity row of
// every slot, the 8 other floats of each live slot, and the (T, 256, 3)
// output.
//
// Design: one block per 16x16 tile, one thread per pixel, the walk of
// splat_walk.cuh (shared with kernel S: the rule, dropped and far pairs
// skipped, T carried from kept slot to kept slot, three float4 a staged
// slot), and
// only the slots that can change a result; each step is an exact identity,
// so the output equals the plain version's sequential blend (and the first,
// all-slot version of this kernel) bit for bit.
//   - The live prefix (splat_live.cuh, shared with K2): one read of the
//     opacity row and a block max find the last slot of nonzero opacity;
//     the block stages and walks only up to it. A tile with no live slot
//     writes white (T_final = 1) and stops.
//   - Staging. Up to CH live slots a chunk go to shared memory. The first
//     chunk is staged by the scan itself (a slot of nonzero opacity reads
//     its other 8 parameters as soon as its opacity arrives), so that a
//     tile of at most CH live slots waits for device memory twice, not
//     three times, and passes one barrier.
// Built with --fmad=false (see splat_walk.cuh).

#include <cuda_runtime.h>

#include "splat_live.cuh"
#include "splat_walk.cuh"

// Phase probe, compiled only with -DSPLAT_TILES_PROBE (kernel_probe.py
// builds such a library apart): a mask in device memory skips the walk (1)
// and the staging (2), so that what is left can be timed (the output is
// then meaningless), or (4) walks without the far-pair cut (splat_walk.cuh
// FAR_CUT).
#ifdef SPLAT_TILES_PROBE
__device__ int g_probe_skip;
#define PROBE_SKIP(bit) ((g_probe_skip & (bit)) != 0)
extern "C" int splat_tiles_probe_set(int mask) {
  return (int)cudaMemcpyToSymbol(g_probe_skip, &mask, sizeof(int));
}
#else
#define PROBE_SKIP(bit) false
#endif

namespace {

using namespace splat_walk;

__global__ void __launch_bounds__(P) tile_composite_kernel(const float* __restrict__ params,
                                                            int K, int tx, int tiles_per_frame,
                                                            float* __restrict__ out) {
  __shared__ Chunk sp;
  __shared__ int warp_max[P / 32];
  const int t = blockIdx.x;
  const float* tp = params + (long long)t * NPARAM * K;
  float* o = out + (long long)t * P * 3;

  // the scan stages the first chunk on the way: slot k < CH of nonzero
  // opacity reads its 8 other parameters; one of opacity 0 is staged as
  // zeros with its opacity (alpha 0 whatever the rest: dropped, as in the
  // plain version)
  const int live = splat_live::live_prefix<P>(tp + 5LL * K, K, warp_max, [&](int k, float op) {
    if (k >= CH || PROBE_SKIP(2)) return;
    float v[NPARAM] = {0.f, 0.f, 0.f, 0.f, 0.f, op, 0.f, 0.f, 0.f};
    if (op != 0.f) {
#pragma unroll
      for (int row = 0; row < NPARAM; ++row)
        if (row != 5) v[row] = tp[(long long)row * K + k];
    }
    stage(sp, k, v);
  });
  if (live == 0) {
    store_white(o);
    return;
  }

  Pixel px(t, tx, tiles_per_frame);
  for (int base = 0; base < live; base += CH) {
    const int n = min(CH, live - base);
    if (base > 0) {   // the first chunk was staged by the scan
      __syncthreads();   // every thread is done with the last chunk
      for (int row = 0; row < (PROBE_SKIP(2) ? 0 : NPARAM); ++row)
        for (int j = threadIdx.x; j < n; j += P)
          reinterpret_cast<float*>(sp[j])[row] = tp[(long long)row * K + base + j];
      __syncthreads();
    }
    if (PROBE_SKIP(4))
      px.walk<false>(sp, n);
    else
      px.walk(sp, PROBE_SKIP(1) ? 0 : n);
  }
  px.store(o);
}

}  // namespace

// params (n_tiles, 9, K) f32 contiguous -> out (n_tiles, 256, 3).
// Returns cudaGetLastError() after the launch.
extern "C" int splat_tiles_launch(const float* params, int n_tiles, int K, int tx,
                                  int tiles_per_frame, float* out, void* stream) {
  if (n_tiles > 0) {
    tile_composite_kernel<<<n_tiles, P, 0, (cudaStream_t)stream>>>(params, K, tx,
                                                                    tiles_per_frame, out);
  }
  return (int)cudaGetLastError();
}
