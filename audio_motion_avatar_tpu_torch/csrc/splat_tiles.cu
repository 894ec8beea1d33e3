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
// The rule is the TPU kernel's: alpha = min(op * exp(min(power, 0)), 0.99),
// zeroed where power > 0 or alpha < 1/255; a weight is dropped where
// T_after < 1e-4, but log(1 - alpha) keeps accumulating (no 3DGS early exit)
// and T_final multiplies the white background; the output is clamped to
// [0, 1]. The TPU kernel forms the transmittance with a triangular-matmul
// prefix sum; the sequential sum here differs from it only in rounding.
//
// Bound on the H100: 27 fp32 operations a (pixel, live slot) pair (the
// function's work: dx, dy, power, the alpha rule, log1p, exp, the weight and
// three colour sums) at 67 TFLOP/s, against the bytes it must move: the
// opacity row of every slot, the 8 other floats of each live slot, and the
// (T, 256, 3) output.
//
// Design: one block per 16x16 tile, one thread per pixel, and only the work
// that changes a result; each step is an exact identity, so the output
// equals the plain version's sequential blend (and the first, all-slot
// version of this kernel) bit for bit.
//   - The live prefix (splat_live.cuh, shared with K2): one read of the
//     opacity row and a block max find the last slot of nonzero opacity;
//     the block stages and walks only up to it. A tile with no live slot
//     writes white (T_final = 1) and stops.
//   - Dropped pairs. Where power > 0 or alpha < 1/255 the pair adds
//     log1p(-0) = -0 to log T and weight 0 to the colour: the thread skips
//     everything but the test.
//   - Each exp once. T = exp(log T) is carried from one kept slot to the next
//     (a kept slot's T after is the next kept slot's T before: dropped slots
//     leave log T as it is), so a kept pair pays one exp(power), one log1p
//     and one exp.
//   - No early exit on T. A pixel under T 1e-4 still sums log(1 - alpha) of
//     every kept slot, since T_final multiplies the background.
//   - Staging. Up to CH live slots a chunk go to shared memory as three
//     float4 a slot, (mx, my, cxx, cxy), (cyy, op, r, g), (b, -, -, -): the
//     test reads two broadcast 16-byte loads, a kept pair one more. The
//     first chunk is staged by the scan itself (a slot of nonzero opacity
//     reads its other 8 parameters as soon as its opacity arrives), so that
//     a tile of at most CH live slots waits for device memory twice, not
//     three times, and passes one barrier.
// Built with --fmad=false, so that every product and sum rounds as the plain
// PyTorch version (ops/splat.py blend_tiles_plain) does, operation for
// operation.

#include <cuda_runtime.h>

#include "splat_live.cuh"

// Phase probe, compiled only with -DSPLAT_TILES_PROBE (kernel_probe.py
// builds such a library apart): a mask in device memory skips the walk (1)
// and the staging (2), so that what is left can be timed; the output is
// then meaningless.
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

constexpr int TILE = 16;
constexpr int P = TILE * TILE;   // pixels per tile = threads per block
constexpr int NPARAM = 9;        // mx, my, cxx, cxy, cyy, opacity, r, g, b
constexpr int CH = 128;          // live slots staged a chunk
constexpr float ALPHA_MAX = 0.99f;
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float T_EPS = 1e-4f;

__global__ void __launch_bounds__(P) tile_composite_kernel(const float* __restrict__ params,
                                                            int K, int tx, int tiles_per_frame,
                                                            float* __restrict__ out) {
  __shared__ float4 sp[CH][3];
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
    sp[k][0] = make_float4(v[0], v[1], v[2], v[3]);
    sp[k][1] = make_float4(v[4], v[5], v[6], v[7]);
    sp[k][2].x = v[8];
  });
  if (live == 0) {
    for (int i = threadIdx.x; i < P * 3; i += P) o[i] = 1.f;
    return;
  }

  const int tid = t % tiles_per_frame;
  const int pix = threadIdx.x;
  const float px = (float)(pix % TILE) + (float)((tid % tx) * TILE);
  const float py = (float)(pix / TILE) + (float)((tid / tx) * TILE);
  float logT = 0.f, T = 1.f, acc_r = 0.f, acc_g = 0.f, acc_b = 0.f;

  for (int base = 0; base < live; base += CH) {
    const int n = min(CH, live - base);
    if (base > 0) {   // the first chunk was staged by the scan
      __syncthreads();   // every thread is done with the last chunk
      for (int row = 0; row < (PROBE_SKIP(2) ? 0 : NPARAM); ++row)
        for (int j = threadIdx.x; j < n; j += P)
          reinterpret_cast<float*>(sp[j])[row] = tp[(long long)row * K + base + j];
      __syncthreads();
    }
    for (int j = 0; j < (PROBE_SKIP(1) ? 0 : n); ++j) {
      const float4 a = sp[j][0], b = sp[j][1];
      const float dx = px - a.x;
      const float dy = py - a.y;
      const float power = -0.5f * (a.z * dx * dx + b.x * dy * dy) - a.w * dx * dy;
      const float alpha = fminf(b.y * expf(fminf(power, 0.f)), ALPHA_MAX);
      if (power > 0.f || alpha < ALPHA_MIN) continue;   // dropped: nothing changes
      const float logT_after = logT + log1pf(-alpha);
      const float T_after = expf(logT_after);
      if (!(T_after < T_EPS)) {
        const float w = alpha * T;
        acc_r = acc_r + w * b.z;
        acc_g = acc_g + w * b.w;
        acc_b = acc_b + w * sp[j][2].x;
      }
      logT = logT_after;
      T = T_after;
    }
  }
  o[pix * 3 + 0] = fminf(fmaxf(acc_r + T, 0.f), 1.f);
  o[pix * 3 + 1] = fminf(fmaxf(acc_g + T, 0.f), 1.f);
  o[pix * 3 + 2] = fminf(fmaxf(acc_b + T, 0.f), 1.f);
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
