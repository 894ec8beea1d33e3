// The per-tile front-to-back blend of kernel S (splat_segments.cu): a
// tile's depth-ordered gaussians come from a contiguous segment of one
// sorted (9, NP) array. (Kernel K1, splat_tiles.cu, applies the same rule
// with a body of its own that walks only each tile's live prefix.)
//
// One block per 16x16 tile, one thread per pixel. The block stages the
// tile's gaussians through shared memory 128 (9 floats each) at a time;
// every thread then blends the chunk in order, carrying its
// log-transmittance. The rule is the TPU kernels' exactly:
//   alpha = min(op * exp(min(power, 0)), 0.99), zeroed where power > 0 or
//   alpha < 1/255; a weight is dropped where T_after < 1e-4, but log(1-alpha)
//   keeps accumulating (no 3DGS early exit) and T_final multiplies the white
//   background; the output is clamped to [0, 1].
// The TPU kernels form the transmittance with a triangular-matmul prefix
// sum; the sequential sum here differs from it only in rounding. Sources
// that include this header are built with --fmad=false so that they round
// exactly as the plain PyTorch version (ops/splat.py blend_tiles_plain)
// does, operation for operation.

#pragma once

#include <cuda_runtime.h>

namespace splat {

constexpr int TILE = 16;
constexpr int P = TILE * TILE;   // pixels per tile = threads per block
constexpr int CH = 128;          // gaussians staged per chunk
constexpr int NPARAM = 9;        // mx, my, cxx, cxy, cyy, opacity, r, g, b
constexpr float ALPHA_MAX = 0.99f;
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float T_EPS = 1e-4f;

// Blends the `count` gaussians of tile t (load(row, k) reads parameter
// `row` of the tile's k-th gaussian) and writes its 256 x 3 pixels to out.
// Called by every thread of a block of P threads.
template <typename Load>
__device__ __forceinline__ void composite_tile(int t, int tx,
                                               int tiles_per_frame, int count,
                                               Load load,
                                               float* __restrict__ out) {
  __shared__ float sp[NPARAM][CH];
  const int pix = threadIdx.x;
  const int tid = t % tiles_per_frame;
  const float px = (float)(pix % TILE) + (float)((tid % tx) * TILE);
  const float py = (float)(pix / TILE) + (float)((tid / tx) * TILE);

  float logT = 0.f, acc_r = 0.f, acc_g = 0.f, acc_b = 0.f;
  for (int base = 0; base < count; base += CH) {
    const int n = min(CH, count - base);
    for (int i = threadIdx.x; i < NPARAM * CH; i += P) {
      const int row = i / CH, col = i % CH;
      sp[row][col] = col < n ? load(row, base + col) : 0.f;
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float dx = px - sp[0][j];
      const float dy = py - sp[1][j];
      const float power = -0.5f * (sp[2][j] * dx * dx + sp[4][j] * dy * dy)
                          - sp[3][j] * dx * dy;
      float alpha = fminf(sp[5][j] * expf(fminf(power, 0.f)), ALPHA_MAX);
      if (power > 0.f || alpha < ALPHA_MIN) alpha = 0.f;
      const float log1m = log1pf(-alpha);
      const float logT_after = logT + log1m;
      if (!(expf(logT_after) < T_EPS)) {
        const float w = alpha * expf(logT);
        acc_r = acc_r + w * sp[6][j];
        acc_g = acc_g + w * sp[7][j];
        acc_b = acc_b + w * sp[8][j];
      }
      logT = logT_after;
    }
    __syncthreads();
  }
  const float T_final = expf(logT);
  float* o = out + ((long long)t * P + pix) * 3;
  o[0] = fminf(fmaxf(acc_r + T_final, 0.f), 1.f);
  o[1] = fminf(fmaxf(acc_g + T_final, 0.f), 1.f);
  o[2] = fminf(fmaxf(acc_b + T_final, 0.f), 1.f);
}

}  // namespace splat
