// Kernel Q-bwd: the backward of the quad-row build (kernel Q).
//
// Replaces the gradient that jax.grad takes of the XLA function `quad_rows`
// (audio_motion_avatar_tpu/ops/triplane.py:364), which the JAX package
// trains with; its TPU forward `quad_rows_pallas` has no backward. Kernel Q
// copies every texel t(y, x) of slot u into four places of the quad rows
// (tap 0 of (y, x), tap 1 of (y, x-1), tap 2 of (y-1, x), tap 3 of
// (y-1, x-1)); a texel on the left column or top row is read instead by the
// slots whose right / bottom / diagonal neighbour is u. The transpose
// gathers those four (or more) terms back:
//   dt_u[y, x] = ((t1 + t2) + t3) + t4, in fp32, rounded once;
//   t1 = q_u[y, x, 0];
//   t2 = q_u[y, x-1, 1] (x >= 1), else S_R(q_s[y, T-1, 1]);
//   t3 = q_u[y-1, x, 2] (y >= 1), else S_B(q_s[T-1, x, 2]);
//   t4 = q_u[y-1, x-1, 3] (y, x >= 1); S_R(q_s[y-1, T-1, 3]) (x = 0);
//        S_B(q_s[T-1, x-1, 3]) (y = 0); S_D(q_s[T-1, T-1, 3]) (both 0);
// each S a sum from 0 over the incoming slots of u (R, B, D: `src` /
// `start` from ops/triplane.incoming_slots) in ascending slot order. Slots
// no tile maps to all alias tile 0's neighbours, so a target can have up
// to cap incoming slots. The plain `quad_rows_bwd_plain` adds the same
// fp32 terms in the same order (adds alone: no FMA contraction), so the two
// agree bit for bit, and with no atomics every launch gives the same bits.
//
// Design: one block per (frame-plane, target slot), 256 threads striding
// over (texel, 16-byte vector of channels): 8 bf16 or 4 fp32 channels a
// thread, neighbouring threads on neighbouring addresses for the store and
// within each tap's load. Each thread gathers its terms, sums them in
// registers and writes its vector once.
//
// Bound on the H100: bytes. The quad rows are read once and the tiles'
// gradient written once: 5 x FP x cap x T^2 x C x 2 bytes in bf16; reckoned
// at the H100 SXM's 3.35 TB/s, ~0.90 ms at the serving chunk's (18, 256,
// 16, 16, 256) and ~0.15 ms at a training frame's (3, 256, 16, 16, 256).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <bool BF16>
struct Lanes {
  static constexpr int N = BF16 ? 8 : 4;  // channels in a 16-byte vector
};

// the vector's channels in fp32 (a bf16 value is the high half of its float)
template <bool BF16>
__device__ __forceinline__ void unpack(float (&f)[Lanes<BF16>::N], const uint4& v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  if constexpr (BF16) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) f[i] = __uint_as_float(w[i]);
  }
}

template <bool BF16>
__device__ __forceinline__ void add_sum(float (&acc)[Lanes<BF16>::N],
                                        const float (&term)[Lanes<BF16>::N]) {
#pragma unroll
  for (int i = 0; i < Lanes<BF16>::N; ++i) acc[i] += term[i];
}

template <bool BF16>
__device__ __forceinline__ void add_vec(float (&acc)[Lanes<BF16>::N], const uint4& v) {
  float f[Lanes<BF16>::N];
  unpack<BF16>(f, v);
  add_sum<BF16>(acc, f);
}

template <bool BF16>
__device__ __forceinline__ uint4 pack(const float (&acc)[Lanes<BF16>::N]) {
  uint32_t w[4];
  if constexpr (BF16) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(acc[2 * i]));
      const uint32_t hi = __bfloat16_as_ushort(__float2bfloat16_rn(acc[2 * i + 1]));
      w[i] = lo | (hi << 16);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = __float_as_uint(acc[i]);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <bool BF16>
__global__ void __launch_bounds__(256) quad_rows_bwd_kernel(
    const uint4* __restrict__ dquad, const int* __restrict__ src,
    const int* __restrict__ start, uint4* __restrict__ dtiles, int cap, int T,
    int cv) {
  constexpr int N = Lanes<BF16>::N;
  const int u = blockIdx.x;
  const long long fp = blockIdx.y;
  const long long tile_q = (long long)T * T * 4 * cv;  // vectors of one slot's quad rows
  const uint4* q = dquad + fp * cap * tile_q;
  const int* srcs = src + fp * 3 * cap;            // (3, cap): right, bottom, diagonal
  const int* st = start + fp * 3 * (cap + 1);      // (3, cap + 1)
  const int r0 = st[u], r1 = st[u + 1];
  const int b0 = st[cap + 1 + u], b1 = st[cap + 1 + u + 1];
  const int d0 = st[2 * (cap + 1) + u], d1 = st[2 * (cap + 1) + u + 1];
  uint4* out = dtiles + (fp * cap + u) * T * T * cv;
  const long long total = (long long)T * T * cv;
  for (long long v = threadIdx.x; v < total; v += blockDim.x) {
    const int c = (int)(v % cv);
    const int yx = (int)(v / cv);
    const int y = yx / T, x = yx % T;
    // tap k of texel (yy, xx) of slot s
    auto at = [&](int s, int yy, int xx, int k) {
      return q[(long long)s * tile_q + ((long long)(yy * T + xx) * 4 + k) * cv + c];
    };
    // S over the incoming slots srcs[dir * cap + lo .. hi) of tap k at (yy, xx)
    auto incoming = [&](float (&acc)[N], int dir, int lo, int hi, int yy, int xx, int k) {
      float term[N];
#pragma unroll
      for (int i = 0; i < N; ++i) term[i] = 0.0f;
      for (int j = lo; j < hi; ++j) add_vec<BF16>(term, at(srcs[dir * cap + j], yy, xx, k));
      add_sum<BF16>(acc, term);
    };
    float acc[N];
    unpack<BF16>(acc, at(u, y, x, 0));
    if (x >= 1) add_vec<BF16>(acc, at(u, y, x - 1, 1));
    else incoming(acc, 0, r0, r1, y, T - 1, 1);
    if (y >= 1) add_vec<BF16>(acc, at(u, y - 1, x, 2));
    else incoming(acc, 1, b0, b1, T - 1, x, 2);
    if (y >= 1 && x >= 1) add_vec<BF16>(acc, at(u, y - 1, x - 1, 3));
    else if (y >= 1) incoming(acc, 0, r0, r1, y - 1, T - 1, 3);
    else if (x >= 1) incoming(acc, 1, b0, b1, T - 1, x - 1, 3);
    else incoming(acc, 2, d0, d1, T - 1, T - 1, 3);
    out[v] = pack<BF16>(acc);
  }
}

}  // namespace

// dquad (FP, cap, T, T, 4C), src (FP, 3, cap) i32, start (FP, 3, cap + 1)
// i32 -> dtiles (FP, cap, T, T, C); a texel's C channels are
// `vecs_per_texel` 16-byte vectors; bf16 != 0 for bfloat16, else float32.
// Returns cudaGetLastError() after the launch.
extern "C" int quad_rows_bwd_launch(const void* dquad, const int* src, const int* start,
                                    void* dtiles, int fp, int cap, int T,
                                    int vecs_per_texel, int bf16, void* stream) {
  if (fp > 0 && cap > 0) {
    dim3 grid(cap, fp);
    if (bf16)
      quad_rows_bwd_kernel<true><<<grid, 256, 0, (cudaStream_t)stream>>>(
          (const uint4*)dquad, src, start, (uint4*)dtiles, cap, T, vecs_per_texel);
    else
      quad_rows_bwd_kernel<false><<<grid, 256, 0, (cudaStream_t)stream>>>(
          (const uint4*)dquad, src, start, (uint4*)dtiles, cap, T, vecs_per_texel);
  }
  return (int)cudaGetLastError();
}
