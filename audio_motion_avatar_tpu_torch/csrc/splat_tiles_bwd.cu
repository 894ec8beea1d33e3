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
// Design: one block per tile, one thread per pixel. A forward sweep over the
// slots (staged through shared memory) keeps each 64-slot chunk's starting
// log-transmittance per pixel in shared memory and forms the pre-clip output.
// The backward walks the chunks back to front; for each it rebuilds the
// chunk's per-slot log-transmittance forward from the chunk's start (so every
// T_before is the forward's own sum, in the forward's order: recovering it by
// subtracting log1p(-alpha) back to front would drift, the sum reaching
// ~-2000 at K = 512), then walks the chunk's slots back to front carrying the
// suffix sum sum_{j>k} G_j w_j. The nine per-slot sums over the 256 pixels go
// through warp shuffles into a per-warp row of shared memory and are added
// over the 8 warps in a fixed order into the tile's own slots: no atomics,
// the same result every run. The chunk is 64 slots, not K1's 128, because
// the per-(slot, pixel) log-transmittance of a chunk lives in shared memory
// (64 KB). Built with --fmad=false, as K1, so the recomputed forward rounds
// as K1 and the plain version do.
//
// Bound on the H100: like K1, bytes where tiles are mostly padding (read the
// (T, 9, K) params and write d params of the same size, plus the gradient)
// and fp32 operations where they are full (93 a (pixel, valid slot) pair:
// one recomputed forward blend, one backward walk with the blend and
// activation backward and the nine reductions). This first version walks
// every slot, padding included, and evaluates each alpha three times (the
// sweep, the chunk's prefix rebuild, the walk).

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 16;
constexpr int P = TILE * TILE;
constexpr int CH = 64;
constexpr int NPARAM = 9;
constexpr int NWARP = P / 32;
constexpr float ALPHA_MAX = 0.99f;
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float T_EPS = 1e-4f;

struct Slot {
  float dx, dy, power, e, araw, alpha;
  bool keep;
};

// The forward's alpha of staged slot j at pixel (px, py), operation for
// operation as splat_blend.cuh.
__device__ __forceinline__ Slot eval_slot(float (*sp)[CH], int j,
                                          float px, float py) {
  Slot s;
  s.dx = px - sp[0][j];
  s.dy = py - sp[1][j];
  s.power = -0.5f * (sp[2][j] * s.dx * s.dx + sp[4][j] * s.dy * s.dy)
            - sp[3][j] * s.dx * s.dy;
  s.e = expf(fminf(s.power, 0.f));
  s.araw = sp[5][j] * s.e;
  const float alpha_c = fminf(s.araw, ALPHA_MAX);
  s.keep = !(s.power > 0.f || alpha_c < ALPHA_MIN);
  s.alpha = s.keep ? alpha_c : 0.f;
  return s;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__global__ void __launch_bounds__(P) tile_bwd_kernel(
    const float* __restrict__ params, const float* __restrict__ grad, int K,
    int tx, int tiles_per_frame, float* __restrict__ dparams) {
  extern __shared__ float smem[];
  float (*sp)[CH] = reinterpret_cast<float (*)[CH]>(smem);   // [9][CH]
  float* lt = smem + NPARAM * CH;                             // [CH][P]
  float (*red)[NPARAM][CH] =
      reinterpret_cast<float (*)[NPARAM][CH]>(lt + CH * P);   // [NWARP][9][CH]
  float* cs = lt + CH * P + NWARP * NPARAM * CH;              // [nchunk][P]

  const int t = blockIdx.x;
  const int pix = threadIdx.x;
  const int warp = pix / 32, lane = pix % 32;
  const int tid = t % tiles_per_frame;
  const float px = (float)(pix % TILE) + (float)((tid % tx) * TILE);
  const float py = (float)(pix / TILE) + (float)((tid / tx) * TILE);
  const float* tp = params + (long long)t * NPARAM * K;
  float* dp = dparams + (long long)t * NPARAM * K;
  const int nchunk = (K + CH - 1) / CH;

  auto stage = [&](int base, int n) {
    __syncthreads();
    for (int i = threadIdx.x; i < NPARAM * CH; i += P) {
      const int row = i / CH, col = i % CH;
      sp[row][col] = col < n ? tp[(long long)row * K + base + col] : 0.f;
    }
    __syncthreads();
  };

  // ---- forward sweep: chunk-start log T, the pre-clip output ----
  float logT = 0.f, acc_r = 0.f, acc_g = 0.f, acc_b = 0.f;
  for (int c = 0; c < nchunk; ++c) {
    const int base = c * CH, n = min(CH, K - base);
    cs[c * P + pix] = logT;
    stage(base, n);
    for (int j = 0; j < n; ++j) {
      const Slot s = eval_slot(sp, j, px, py);
      const float logT_after = logT + log1pf(-s.alpha);
      if (!(expf(logT_after) < T_EPS)) {
        const float w = s.alpha * expf(logT);
        acc_r = acc_r + w * sp[6][j];
        acc_g = acc_g + w * sp[7][j];
        acc_b = acc_b + w * sp[8][j];
      }
      logT = logT_after;
    }
  }
  const float T_final = expf(logT);
  const float r_pre = acc_r + T_final, g_pre = acc_g + T_final,
              b_pre = acc_b + T_final;
  const float* gp = grad + ((long long)t * P + pix) * 3;
  const float gr = (r_pre > 0.f && r_pre < 1.f) ? gp[0] : 0.f;
  const float gg = (g_pre > 0.f && g_pre < 1.f) ? gp[1] : 0.f;
  const float gb = (b_pre > 0.f && b_pre < 1.f) ? gp[2] : 0.f;
  const float gT = gr + gg + gb;
  const float bg = gT * T_final;

  // ---- backward: chunks back to front, slots back to front ----
  float S = 0.f;   // sum over the later slots of G_j w_j
  for (int c = nchunk - 1; c >= 0; --c) {
    const int base = c * CH, n = min(CH, K - base);
    stage(base, n);
    float lg = cs[c * P + pix];
    for (int j = 0; j < n; ++j) {
      lt[j * P + pix] = lg;
      lg = lg + log1pf(-eval_slot(sp, j, px, py).alpha);
    }
    for (int j = n - 1; j >= 0; --j) {
      const Slot s = eval_slot(sp, j, px, py);
      const float lb = lt[j * P + pix];
      const float la = lb + log1pf(-s.alpha);
      const float Tb = expf(lb);
      const bool notcut = !(expf(la) < T_EPS);
      const float w = notcut ? s.alpha * Tb : 0.f;
      const float G = gr * sp[6][j] + gg * sp[7][j] + gb * sp[8][j];
      float dalpha = (notcut ? G * Tb : 0.f) - (S + bg) / (1.f - s.alpha);
      if (!s.keep) dalpha = 0.f;
      S = S + G * w;
      const float dar = s.araw < ALPHA_MAX ? dalpha : 0.f;
      const float dpow = s.power < 0.f ? dar * s.araw : 0.f;
      float vals[NPARAM] = {
          dpow * (sp[2][j] * s.dx + sp[3][j] * s.dy),
          dpow * (sp[4][j] * s.dy + sp[3][j] * s.dx),
          dpow * (-0.5f * s.dx * s.dx),
          dpow * (-s.dx * s.dy),
          dpow * (-0.5f * s.dy * s.dy),
          dar * s.e,
          gr * w, gg * w, gb * w};
#pragma unroll
      for (int q = 0; q < NPARAM; ++q) {
        const float v = warp_sum(vals[q]);
        if (lane == 0) red[warp][q][j] = v;
      }
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
  return sizeof(float) * (NPARAM * CH + CH * P + NWARP * NPARAM * CH +
                          (size_t)nchunk * P);
}

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
