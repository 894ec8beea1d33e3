// Kernel S: segmented splat composite for the serving renderer.
//
// Replaces the TPU kernel `_composite_segments_pallas` / `_seg_kernel` of
// audio_motion_avatar_tpu/ops/splat_pallas.py. The host side
// (ops/splat_segmented.py) sorts every frame's gaussian candidates by
// (tile, depth) into one (9, NP) array; tile t owns the contiguous segment
// [starts[t], starts[t] + counts[t]) with counts already clamped to K.
//
// Design: the blend of splat_blend.cuh (one block per 16x16 tile, one
// thread per pixel, the segment staged through shared memory 128 gaussians
// at a time), loading tile t's gaussians from its segment. Built with
// --fmad=false (see the header).
//
// Bound on the H100: the work is ~27 fp32 operations per (pixel, gaussian)
// pair of the segments (data dependent) against 9 floats read per gaussian,
// so it is bound by operations (67 TFLOP/s fp32 outside the tensor cores).
// The sequential per-pixel loop is latency bound in practice: a tile's blend
// cannot be split along the segment without a second pass. A faster version
// would keep several chunks in flight (cp.async double buffering) and retire
// whole warps once all their pixels fall under T_EPS.

#include "splat_blend.cuh"

namespace {

__global__ void __launch_bounds__(splat::P) seg_composite_kernel(
    const float* __restrict__ params, long long np_stride,
    const int* __restrict__ starts, const int* __restrict__ counts,
    int tx, int tiles_per_frame, float* __restrict__ out) {
  const int t = blockIdx.x;
  const long long start = starts[t];
  splat::composite_tile(
      t, tx, tiles_per_frame, counts[t],
      [&](int row, int k) { return params[row * np_stride + start + k]; },
      out);
}

}  // namespace

// params (9, np_stride) f32, starts/counts (n_tiles,) i32 -> out (n_tiles, 256, 3).
// Returns cudaGetLastError() after the launch.
extern "C" int splat_segments_launch(const float* params, long long np_stride,
                                     const int* starts, const int* counts,
                                     int n_tiles, int tx, int tiles_per_frame,
                                     float* out, void* stream) {
  if (n_tiles > 0) {
    seg_composite_kernel<<<n_tiles, splat::P, 0, (cudaStream_t)stream>>>(
        params, np_stride, starts, counts, tx, tiles_per_frame, out);
  }
  return (int)cudaGetLastError();
}
