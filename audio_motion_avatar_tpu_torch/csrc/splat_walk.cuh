// The per-pixel front-to-back walk shared by kernel K1 (splat_tiles.cu)
// and kernel S (splat_segments.cu): both stage a tile's depth-ordered
// gaussians into shared memory a chunk at a time, in one layout, and every
// thread (one per pixel of the 16x16 tile) walks the chunk in order.
//
// The rule is the TPU kernels': alpha = min(op * exp(min(power, 0)), 0.99),
// zeroed where power > 0 or alpha < 1/255; a weight is dropped where
// T_after < 1e-4, but log(1 - alpha) keeps accumulating (no 3DGS early exit)
// and T_final multiplies the white background; the output is clamped to
// [0, 1]. The TPU kernels form the transmittance with a triangular-matmul
// prefix sum; the sequential sum here differs from it only in rounding.
//
// Only the work that changes a result is done, and each cut is an exact
// identity, so the output equals the plain version's sequential blend
// (ops/splat.py blend_tiles_plain) bit for bit:
//   - Dropped pairs. Where power > 0 or alpha < 1/255 the pair adds
//     log1p(-0) = -0 to log T and weight 0 to the colour: the thread skips
//     everything but the test.
//   - Far pairs. A pair of power < -5.6 and opacity <= 1 is dropped before
//     its exp: exp(-5.6) < 0.0037 < 1/255, so the rule drops it too (most
//     pairs of the serving splat are such, kernel_probe.py).
//   - Each exp once. T = exp(log T) is carried from one kept slot to the next
//     (a kept slot's T after is the next kept slot's T before: dropped slots
//     leave log T as it is), so a kept pair pays one exp(power), one log1p
//     and one exp, a far pair none.
//   - No early exit on T. A pixel under T 1e-4 still sums log(1 - alpha) of
//     every kept slot, since T_final multiplies the background.
//   - Layout. A staged slot is three float4, (mx, my, cxx, cxy),
//     (cyy, op, r, g), (b, -, -, -): the test reads two broadcast 16-byte
//     loads, a kept pair one more.
// Sources that include this header are built with --fmad=false, so that
// every product and sum rounds as the plain PyTorch version does, operation
// for operation.

#pragma once

#include <cuda_runtime.h>

namespace splat_walk {

constexpr int TILE = 16;
constexpr int P = TILE * TILE;   // pixels per tile = threads per block
constexpr int NPARAM = 9;        // mx, my, cxx, cxy, cyy, opacity, r, g, b
constexpr int CH = 128;          // slots staged a chunk
constexpr float ALPHA_MAX = 0.99f;
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float T_EPS = 1e-4f;

// One staged chunk: CH slots of three float4.
typedef float4 Chunk[CH][3];

// Writes slot k's nine parameters v into the chunk.
__device__ __forceinline__ void stage(Chunk& sp, int k, const float (&v)[NPARAM]) {
  sp[k][0] = make_float4(v[0], v[1], v[2], v[3]);
  sp[k][1] = make_float4(v[4], v[5], v[6], v[7]);
  sp[k][2].x = v[8];
}

// A thread's pixel of tile t (its origin from t % tiles_per_frame) and what
// it carries from slot to slot.
struct Pixel {
  float px, py;
  float logT = 0.f, T = 1.f, r = 0.f, g = 0.f, b = 0.f;

  __device__ __forceinline__ Pixel(int t, int tx, int tiles_per_frame) {
    const int tid = t % tiles_per_frame;
    const int pix = threadIdx.x;
    px = (float)(pix % TILE) + (float)((tid % tx) * TILE);
    py = (float)(pix / TILE) + (float)((tid / tx) * TILE);
  }

  // Blends the first n slots of the chunk, in order (FAR_CUT false: without
  // the far-pair cut, for probe builds).
  template <bool FAR_CUT = true>
  __device__ __forceinline__ void walk(const Chunk& sp, int n) {
    for (int j = 0; j < n; ++j) {
      const float4 a = sp[j][0], c = sp[j][1];
      const float dx = px - a.x;
      const float dy = py - a.y;
      const float power = -0.5f * (a.z * dx * dx + c.x * dy * dy) - a.w * dx * dy;
      if (FAR_CUT && power < -5.6f && c.y <= 1.f) continue;   // far: dropped
      const float alpha = fminf(c.y * expf(fminf(power, 0.f)), ALPHA_MAX);
      if (power > 0.f || alpha < ALPHA_MIN) continue;   // dropped: nothing changes
      const float logT_after = logT + log1pf(-alpha);
      const float T_after = expf(logT_after);
      if (!(T_after < T_EPS)) {
        const float w = alpha * T;
        r = r + w * c.z;
        g = g + w * c.w;
        b = b + w * sp[j][2].x;
      }
      logT = logT_after;
      T = T_after;
    }
  }

  // The pixel over the white background, clamped, into the tile's
  // (256, 3) output o.
  __device__ __forceinline__ void store(float* __restrict__ o) const {
    const int pix = threadIdx.x;
    o[pix * 3 + 0] = fminf(fmaxf(r + T, 0.f), 1.f);
    o[pix * 3 + 1] = fminf(fmaxf(g + T, 0.f), 1.f);
    o[pix * 3 + 2] = fminf(fmaxf(b + T, 0.f), 1.f);
  }
};

// A tile with nothing to blend: white. Called by every thread of the block.
__device__ __forceinline__ void store_white(float* __restrict__ o) {
  for (int i = threadIdx.x; i < P * 3; i += P) o[i] = 1.f;
}

}  // namespace splat_walk
