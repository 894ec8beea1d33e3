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
// Design: the shared blend of splat_blend.cuh (one block per 16x16 tile, one
// thread per pixel, 128 slots staged through shared memory at a time,
// coalesced along K), over all K slots of the tile: a padding slot has
// alpha 0 and changes nothing. Built with --fmad=false (see the header).
//
// Bound on the H100: ~27 fp32 operations per (pixel, valid slot) pair
// against the (F * T, 9, K) fp32 input read once (75.5 MB a view at 1024^2,
// K = 512), so operations bound it where tiles are full and bytes where
// they are mostly padding. This first version pays for every slot, padding
// included, in a sequential per-pixel loop; skipping empty slots (the
// packing knows each tile's count) and retiring warps whose pixels all fell
// under T_EPS are the later steps toward that bound.

#include "splat_blend.cuh"

namespace {

__global__ void __launch_bounds__(splat::P) tile_composite_kernel(
    const float* __restrict__ params, int K, int tx, int tiles_per_frame,
    float* __restrict__ out) {
  const int t = blockIdx.x;
  const float* tp = params + (long long)t * splat::NPARAM * K;
  splat::composite_tile(
      t, tx, tiles_per_frame, K,
      [&](int row, int k) { return tp[(long long)row * K + k]; }, out);
}

}  // namespace

// params (n_tiles, 9, K) f32 contiguous -> out (n_tiles, 256, 3).
// Returns cudaGetLastError() after the launch.
extern "C" int splat_tiles_launch(const float* params, int n_tiles, int K,
                                  int tx, int tiles_per_frame, float* out,
                                  void* stream) {
  if (n_tiles > 0) {
    tile_composite_kernel<<<n_tiles, splat::P, 0, (cudaStream_t)stream>>>(
        params, K, tx, tiles_per_frame, out);
  }
  return (int)cudaGetLastError();
}
