// Kernel K2: backward of the tile splat composite K1 (splat_tiles.cu).
//
// Replaces the TPU kernel `_composite_tiles_bwd_pallas` / `_tile_bwd_kernel`
// of audio_motion_avatar_tpu/ops/splat_pallas.py, the custom-VJP backward of
// `composite_tiles`: from the packed (T, 9, K) tile params
// [mx, my, cxx, cxy, cyy, op, r, g, b] and the output gradient (T, 256, 3)
// it writes d params (T, 9, K), each tile's gradient in its own slots (the
// autograd of the packing gather scatter-adds them onto the gaussians). It
// recomputes the blend (nothing of O(P K) is saved by the forward) and
// applies the TPU kernel's rules:
//   - the clip mask on the pre-clip output: g_c counts where 0 < out_c < 1;
//   - G = sum_c g_c colour_c and gT = sum_c g_c (white background);
//   - dalpha_k = [not cut] G_k T_before_k
//                - (sum_{j>k} G_j w_j + gT T_final) / (1 - alpha_k),
//     zeroed where the slot was dropped (power > 0 or alpha < 1/255);
//   - the activation backward gated on op * e < 0.99 and power < 0;
//   - a weight dropped under T 1e-4 while log(1 - alpha) keeps summing.
//
// Bound on the H100: bytes where tiles are mostly padding (read the
// (T, 9, K) params and write d params of the same size, plus the gradient)
// and fp32 operations where they are full: 93 a (pixel, live slot) pair (one
// recomputed forward blend, one backward walk with the blend and activation
// backward and the nine reductions).
//
// Design: one block per tile, one thread per pixel, and only the work that
// changes a result.
//   - The live prefix (splat_live.cuh, shared with K1): the block finds the
//     last slot of nonzero opacity (one read of the opacity row, a block
//     max) and walks only up to it; the slots past it get 0 written.
//   - Dropped pixels. Where a pixel drops a slot (power > 0 or alpha <
//     1/255) the same holds for that pixel alone: the thread skips
//     everything but the test, and a warp in which no pixel keeps the slot
//     writes 0 to its reduction row and skips the reductions.
//   - Each exp and log once. The forward sweep carries T = exp(log T) from
//     one kept slot to the next; the backward walk carries the transmittance
//     after the slot (the one before the later slot, or T_final), so a kept
//     pair takes one log1p in the sweep, one exp in the walk. Every value is
//     the one the sweep computed, bit for bit: an exact identity, not a
//     re-derivation (subtracting log1p(-alpha) back to front would drift;
//     the sum reaches ~-2000 at K = 512).
//   - Chunks of 32 slots. The sweep keeps each chunk's starting
//     log-transmittance per pixel in shared memory; the backward walks the
//     chunks back to front, rebuilding each chunk's per-slot
//     log-transmittance forward from its start, the last chunk's kept from
//     the sweep itself (most tiles have one or two chunks live). 32 slots
//     keep shared memory at ~58 KB a block at K = 512: 3 blocks an SM.
//   - The nine per-slot sums over a warp's 32 pixels: eight values reduced by
//     halving exchanges (4 + 2 + 1 shuffles leave each lane one value, two
//     more finish it), the ninth by a butterfly: 14 shuffles where nine
//     butterflies take 45. The per-warp rows are added over the 8 warps in a
//     fixed order into the tile's own slots: no atomics, the same result
//     every run.
// Built with --fmad=false, as K1, so the recomputed forward rounds as K1 and
// the plain version do.

#include <cuda_runtime.h>

#include "splat_live.cuh"

namespace {

constexpr int TILE = 16;
constexpr int P = TILE * TILE;
constexpr int CH = 32;
constexpr int NPARAM = 9;
constexpr int NWARP = P / 32;
constexpr float ALPHA_MAX = 0.99f;
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float T_EPS = 1e-4f;
constexpr unsigned FULL = 0xffffffffu;

struct Slot {
  float dx, dy, power, e, araw, alpha;
  bool keep;
};

// The forward's alpha of staged slot j at pixel (px, py), operation for
// operation as K1 (splat_tiles.cu).
__device__ __forceinline__ Slot eval_slot(float (*sp)[CH], int j, float px, float py) {
  Slot s;
  s.dx = px - sp[0][j];
  s.dy = py - sp[1][j];
  s.power = -0.5f * (sp[2][j] * s.dx * s.dx + sp[4][j] * s.dy * s.dy) - sp[3][j] * s.dx * s.dy;
  s.e = expf(fminf(s.power, 0.f));
  s.araw = sp[5][j] * s.e;
  const float alpha_c = fminf(s.araw, ALPHA_MAX);
  s.keep = !(s.power > 0.f || alpha_c < ALPHA_MIN);
  s.alpha = s.keep ? alpha_c : 0.f;
  return s;
}

// Sums v[0..7] over the warp: afterwards lane l holds the sum of value
// 4 (l >> 4 & 1) + 2 (l >> 3 & 1) + (l >> 2 & 1), the same in the 4 lanes
// of a quad. Each halving step keeps the half of the values its side of the
// exchange owns and adds the partner's copy of it.
__device__ __forceinline__ float warp_sum8(float (&v)[8], int lane) {
  const bool hi16 = lane & 16, hi8 = lane & 8, hi4 = lane & 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float send = hi16 ? v[i] : v[i + 4];
    const float keep = hi16 ? v[i + 4] : v[i];
    v[i] = keep + __shfl_xor_sync(FULL, send, 16);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float send = hi8 ? v[i] : v[i + 2];
    const float keep = hi8 ? v[i + 2] : v[i];
    v[i] = keep + __shfl_xor_sync(FULL, send, 8);
  }
  const float send = hi4 ? v[0] : v[1];
  float x = (hi4 ? v[1] : v[0]) + __shfl_xor_sync(FULL, send, 4);
  x += __shfl_xor_sync(FULL, x, 2);
  x += __shfl_xor_sync(FULL, x, 1);
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
  return x;
}

__global__ void __launch_bounds__(P, 3) tile_bwd_kernel(const float* __restrict__ params,
                                                     const float* __restrict__ grad, int K,
                                                     int tx, int tiles_per_frame,
                                                     float* __restrict__ dparams) {
  extern __shared__ float smem[];
  float(*sp)[CH] = reinterpret_cast<float(*)[CH]>(smem);                // [9][CH]
  float* lt = smem + NPARAM * CH;                                        // [CH][P]
  float(*red)[NPARAM][CH] = reinterpret_cast<float(*)[NPARAM][CH]>(lt + CH * P);  // [NWARP][9][CH]
  float* cs = lt + CH * P + NWARP * NPARAM * CH;                         // [nchunk][P]
  __shared__ int live_w[NWARP];

  const int t = blockIdx.x;
  const int pix = threadIdx.x;
  const int warp = pix / 32, lane = pix % 32;
  const int tid = t % tiles_per_frame;
  const float px = (float)(pix % TILE) + (float)((tid % tx) * TILE);
  const float py = (float)(pix / TILE) + (float)((tid / tx) * TILE);
  const float* tp = params + (long long)t * NPARAM * K;
  float* dp = dparams + (long long)t * NPARAM * K;

  // ---- the live prefix: up to the last slot of nonzero opacity ----
  const int live = splat_live::live_prefix<P>(tp + 5LL * K, K, live_w);
  for (int row = 0; row < NPARAM; ++row)
    for (int k = live + pix; k < K; k += P) dp[(long long)row * K + k] = 0.f;
  const int nchunk = (live + CH - 1) / CH;

  auto stage = [&](int base, int n) {
    __syncthreads();
    for (int i = threadIdx.x; i < NPARAM * CH; i += P) {
      const int row = i / CH, col = i % CH;
      sp[row][col] = col < n ? tp[(long long)row * K + base + col] : 0.f;
    }
    __syncthreads();
  };

  // ---- forward sweep: chunk-start log T, the last chunk's per-slot log T,
  // the pre-clip output ----
  float logT = 0.f, T = 1.f, acc_r = 0.f, acc_g = 0.f, acc_b = 0.f;
  for (int c = 0; c < nchunk; ++c) {
    const int base = c * CH, n = min(CH, live - base);
    const bool last = c == nchunk - 1;
    cs[c * P + pix] = logT;
    stage(base, n);
    for (int j = 0; j < n; ++j) {
      if (last) lt[j * P + pix] = logT;
      const Slot s = eval_slot(sp, j, px, py);
      if (!s.keep) continue;   // alpha 0: log T and the colour stay as they are
      const float logT_after = logT + log1pf(-s.alpha);
      const float T_after = expf(logT_after);
      if (!(T_after < T_EPS)) {
        const float w = s.alpha * T;
        acc_r = acc_r + w * sp[6][j];
        acc_g = acc_g + w * sp[7][j];
        acc_b = acc_b + w * sp[8][j];
      }
      logT = logT_after;
      T = T_after;
    }
  }
  const float T_final = T;
  const float r_pre = acc_r + T_final, g_pre = acc_g + T_final, b_pre = acc_b + T_final;
  const float* gp = grad + ((long long)t * P + pix) * 3;
  const float gr = (r_pre > 0.f && r_pre < 1.f) ? gp[0] : 0.f;
  const float gg = (g_pre > 0.f && g_pre < 1.f) ? gp[1] : 0.f;
  const float gb = (b_pre > 0.f && b_pre < 1.f) ? gp[2] : 0.f;
  const float gT = gr + gg + gb;
  const float bg = gT * T_final;

  // ---- backward: chunks back to front, slots back to front ----
  float S = 0.f;         // sum over the later slots of G_j w_j
  float T_after = T_final;   // the transmittance after the slot walked
  for (int c = nchunk - 1; c >= 0; --c) {
    const int base = c * CH, n = min(CH, live - base);
    if (c != nchunk - 1) {   // the last chunk's params and log T are in place
      stage(base, n);
      float lg = cs[c * P + pix];
      for (int j = 0; j < n; ++j) {
        lt[j * P + pix] = lg;
        const Slot s = eval_slot(sp, j, px, py);
        if (s.keep) lg = lg + log1pf(-s.alpha);
      }
    }
    for (int j = n - 1; j >= 0; --j) {
      const Slot s = eval_slot(sp, j, px, py);
      if (!__any_sync(FULL, s.keep)) {
        if (lane < NPARAM) red[warp][lane][j] = 0.f;
        continue;
      }
      float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f}, v8 = 0.f;
      if (s.keep) {
        const float Tb = expf(lt[j * P + pix]);
        const bool notcut = !(T_after < T_EPS);
        const float w = notcut ? s.alpha * Tb : 0.f;
        const float G = gr * sp[6][j] + gg * sp[7][j] + gb * sp[8][j];
        const float dalpha = (notcut ? G * Tb : 0.f) - (S + bg) / (1.f - s.alpha);
        S = S + G * w;
        const float dar = s.araw < ALPHA_MAX ? dalpha : 0.f;
        const float dpow = s.power < 0.f ? dar * s.araw : 0.f;
        v[0] = dpow * (sp[2][j] * s.dx + sp[3][j] * s.dy);
        v[1] = dpow * (sp[4][j] * s.dy + sp[3][j] * s.dx);
        v[2] = dpow * (-0.5f * s.dx * s.dx);
        v[3] = dpow * (-s.dx * s.dy);
        v[4] = dpow * (-0.5f * s.dy * s.dy);
        v[5] = dar * s.e;
        v[6] = gr * w;
        v[7] = gg * w;
        v8 = gb * w;
        T_after = Tb;
      }
      const float sum8 = warp_sum8(v, lane);
      const float sum_b = warp_sum(v8);
      if ((lane & 3) == 0)
        red[warp][4 * ((lane >> 4) & 1) + 2 * ((lane >> 3) & 1) + ((lane >> 2) & 1)][j] = sum8;
      if (lane == 0) red[warp][8][j] = sum_b;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < NPARAM * n; i += P) {
      const int row = i / n, col = i % n;
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < NWARP; ++w) v += red[w][row][col];
      dp[(long long)row * K + base + col] = v;
    }
  }
}

}  // namespace

// Shared memory a launch with K slots needs, in bytes.
static size_t smem_bytes(int K) {
  const int nchunk = (K + CH - 1) / CH;
  return sizeof(float) * (NPARAM * CH + CH * P + NWARP * NPARAM * CH + (size_t)nchunk * P);
}

extern "C" int splat_tiles_bwd_smem(int K) { return (int)smem_bytes(K); }

// params (n_tiles, 9, K) f32 and grad (n_tiles, 256, 3) f32, contiguous ->
// dparams (n_tiles, 9, K). Returns cudaGetLastError() after the launch.
extern "C" int splat_tiles_bwd_launch(const float* params, const float* grad,
                                      int n_tiles, int K, int tx,
                                      int tiles_per_frame, float* dparams,
                                      void* stream) {
  if (n_tiles > 0 && K > 0) {
    const size_t smem = smem_bytes(K);
    cudaError_t err = cudaFuncSetAttribute(
        tile_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    tile_bwd_kernel<<<n_tiles, P, smem, (cudaStream_t)stream>>>(
        params, grad, K, tx, tiles_per_frame, dparams);
  }
  return (int)cudaGetLastError();
}
