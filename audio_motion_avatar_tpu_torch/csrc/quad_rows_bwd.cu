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
// each S a sum from +0 over the incoming slots of u (R, B, D: `src` /
// `start` from ops/triplane.incoming_slots) in ascending slot order. Slots
// no tile maps to all alias tile 0's neighbours, so a target can have up
// to cap incoming slots. The plain `quad_rows_bwd_plain` adds the same
// fp32 terms in the same order (adds alone: no FMA contraction), so the two
// agree bit for bit, and with no atomics every launch gives the same bits.
//
// Bound on the H100: bytes. The quad rows are read once and the tiles'
// gradient written once: 5 x FP x cap x T^2 x C x 2 bytes in bf16; reckoned
// at the H100 SXM's 3.35 TB/s, ~0.90 ms at the serving chunk's (18, 256,
// 16, 16, 256) and ~0.15 ms at a training frame's (3, 256, 16, 16, 256).
//
// Design: one block per (frame-plane, target slot u), 256 threads, 16-byte
// vectors (8 bf16 or 4 fp32 channels), neighbouring threads on neighbouring
// vectors of a texel. Every incoming sum lies on u's left column or top
// row, so the block first spreads those (2T - 1) x cv edge vectors evenly
// over all its threads (the left column first, then the top row), and only
// then the (T - 1)^2 x cv interior ones. A sum stays whole in one thread
// (its order is the bits); only different output vectors are spread. The
// three source runs of u are staged in shared memory by one coalesced load
// before the sums, which then read their source slots there; a sum issues
// the 16-byte loads of 8 sources before it adds them in ascending order, so
// 8 loads are in flight where one was. The interior is a pure bandwidth
// pass: two output vectors a thread an iteration, their 8 own-slot loads
// issued before any add, each vector written once. All index arithmetic is
// 32-bit within a slot. No atomics.
//
// Long runs: the unused slots alias onto the three targets of tile 0's
// neighbours, up to cap - 4 sources each, and those targets' blocks sum
// them whole, so on a plane of few covered tiles they take the longest.
// A training step's real slot maps covered none of tile 0's neighbours (at
// most one incoming slot a target), so no run there is long.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;   // source loads in flight a sum

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

// acc += S: S summed from +0 over the n staged source slots `run` (in
// ascending slot order) of the vector at `off` within each source slot's
// quad rows; the loads of kUnroll sources are issued before their adds.
template <bool BF16>
__device__ __forceinline__ void add_incoming(float (&acc)[Lanes<BF16>::N],
                                             const uint4* __restrict__ q, long long tile_q,
                                             const int* run, int n, int off) {
  float s[Lanes<BF16>::N];
#pragma unroll
  for (int i = 0; i < Lanes<BF16>::N; ++i) s[i] = 0.0f;
  for (int j = 0; j < n; j += kUnroll) {
    uint4 v[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k)
      v[k] = j + k < n ? __ldg(q + run[j + k] * tile_q + off) : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int k = 0; k < kUnroll; ++k)
      if (j + k < n) add_vec<BF16>(s, v[k]);
  }
  add_sum<BF16>(acc, s);
}

// One block a (target slot u, frame-plane): grid (cap, FP).
template <bool BF16>
__global__ void __launch_bounds__(kThreads, 3) quad_rows_bwd_kernel(
    const uint4* __restrict__ dquad, const int* __restrict__ src,
    const int* __restrict__ start, uint4* __restrict__ dtiles, int cap, int T,
    int cv) {
  constexpr int N = Lanes<BF16>::N;
  extern __shared__ int staged[];   // u's right, bottom, diagonal source runs
  const int u = blockIdx.x;
  const long long fp = blockIdx.y;
  const int texel = 4 * cv;                           // vectors of a texel's quad row
  const long long tile_q = (long long)T * T * texel;  // vectors of a slot's quad rows
  const uint4* q = dquad + fp * cap * tile_q;
  const uint4* qu = q + u * tile_q;
  const int* srcs = src + fp * 3 * cap;               // (3, cap)
  const int* st = start + fp * 3 * (cap + 1);         // (3, cap + 1)
  uint4* out = dtiles + (fp * cap + u) * T * T * cv;

  // stage the three runs back to back, one coalesced load a run
  const int* run[3];
  int n[3];
  int staged_n = 0;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const int lo = st[d * (cap + 1) + u];
    n[d] = st[d * (cap + 1) + u + 1] - lo;
    for (int j = threadIdx.x; j < n[d]; j += kThreads) staged[staged_n + j] = srcs[d * cap + lo + j];
    run[d] = staged + staged_n;
    staged_n += n[d];
  }
  __syncthreads();

  // the left column (y, 0), y < T, then the top row (0, x), 1 <= x < T
  const int n_edge = (2 * T - 1) * cv;
  for (int e = threadIdx.x; e < n_edge; e += kThreads) {
    const int c = e % cv, k = e / cv;
    const int y = k < T ? k : 0, x = k < T ? 0 : k - T + 1;
    float acc[N];
    unpack<BF16>(acc, __ldg(qu + (y * T + x) * texel + c));
    if (x >= 1) add_vec<BF16>(acc, __ldg(qu + (y * T + x - 1) * texel + cv + c));
    else add_incoming<BF16>(acc, q, tile_q, run[0], n[0], (y * T + T - 1) * texel + cv + c);
    if (y >= 1) add_vec<BF16>(acc, __ldg(qu + ((y - 1) * T + x) * texel + 2 * cv + c));
    else add_incoming<BF16>(acc, q, tile_q, run[1], n[1], ((T - 1) * T + x) * texel + 2 * cv + c);
    if (y >= 1)
      add_incoming<BF16>(acc, q, tile_q, run[0], n[0], ((y - 1) * T + T - 1) * texel + 3 * cv + c);
    else if (x >= 1)
      add_incoming<BF16>(acc, q, tile_q, run[1], n[1], ((T - 1) * T + x - 1) * texel + 3 * cv + c);
    else
      add_incoming<BF16>(acc, q, tile_q, run[2], n[2], ((T - 1) * T + T - 1) * texel + 3 * cv + c);
    out[(y * T + x) * cv + c] = pack<BF16>(acc);
  }

  // the interior (y, x), 1 <= y, x < T: every term from u's own quad rows
  const int Ti = T - 1, n_in = Ti * Ti * cv;
  for (int i0 = threadIdx.x; i0 < n_in; i0 += 2 * kThreads) {
    uint4 v[2][4];
    int o[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = i0 + h * kThreads;
      const int c = i % cv, k = i / cv;
      const int y = 1 + k / Ti, x = 1 + k % Ti;
      const uint4* p = qu + (y * T + x) * texel + c;   // tap 0 of (y, x)
      o[h] = (y * T + x) * cv + c;
      if (i < n_in) {
        v[h][0] = __ldg(p);
        v[h][1] = __ldg(p - texel + cv);               // tap 1 of (y, x - 1)
        v[h][2] = __ldg(p - T * texel + 2 * cv);       // tap 2 of (y - 1, x)
        v[h][3] = __ldg(p - (T + 1) * texel + 3 * cv); // tap 3 of (y - 1, x - 1)
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (i0 + h * kThreads < n_in) {
        float acc[N];
        unpack<BF16>(acc, v[h][0]);
        add_vec<BF16>(acc, v[h][1]);
        add_vec<BF16>(acc, v[h][2]);
        add_vec<BF16>(acc, v[h][3]);
        out[o[h]] = pack<BF16>(acc);
      }
    }
  }
}

}  // namespace

// dquad (FP, cap, T, T, 4C), src (FP, 3, cap) i32, start (FP, 3, cap + 1)
// i32 -> dtiles (FP, cap, T, T, C); a texel's C channels are
// `vecs_per_texel` 16-byte vectors; bf16 != 0 for bfloat16, else float32.
// Stages up to 3 x cap source slots a block in dynamic shared memory (cap
// up to 19,370 on the H100). Returns cudaGetLastError() after the launch.
extern "C" int quad_rows_bwd_launch(const void* dquad, const int* src, const int* start,
                                    void* dtiles, int fp, int cap, int T,
                                    int vecs_per_texel, int bf16, void* stream) {
  if (fp > 0 && cap > 0) {
    const size_t smem = 3 * (size_t)cap * sizeof(int);
    void (*kernel)(const uint4*, const int*, const int*, uint4*, int, int, int) =
        bf16 ? quad_rows_bwd_kernel<true> : quad_rows_bwd_kernel<false>;
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    kernel<<<dim3(cap, fp), kThreads, smem, (cudaStream_t)stream>>>(
        (const uint4*)dquad, src, start, (uint4*)dtiles, cap, T, vecs_per_texel);
  }
  return (int)cudaGetLastError();
}
