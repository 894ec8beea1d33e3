// Kernel A: exact attention forward, softmax(q k^T * scale + key_mask) v.
//
// Replaces the TPU attention forwards of the serving path: the stock Pallas
// flash_attention forward called by models/transformer.py (Attention._flash,
// the audio self-attention) and models/ptv3.py (_PatchAttention, D = 64),
// and the repo's own forward kernels computing the same function
// (ops/serve_attention.py, ops/hpack_attention.py, ops/flash2.py).
//
// Design: flash style. One block of 4 warps owns 64 queries of one
// (batch, head); each warp owns 16 query rows. The block walks the keys in
// blocks of 64: K and V tiles are staged in shared memory, the warp forms
// its 16 x 64 logits with bf16 WMMA tiles (fp32 accumulation), runs the
// online softmax in fp32 (base 2, scale * log2(e) folded in) with two lanes
// per row, rounds the probabilities to bf16 for the P V product, and keeps
// its output rows in fp32 registers. Keys past Skv contribute nothing; a
// masked key's logit is replaced by -1e30, so a row whose keys are all
// masked averages them uniformly, as the dense reference with a
// large-negative mask does. Validated shapes only: D = 64, bf16,
// contiguous (B, H, S, D); any Sq / Skv (the ragged edge is masked).
//
// For training, the launch can also write each query row's softmax
// statistics (m, l): the running maximum of the base-2 logits and the sum of
// exp2(logit - m), kept apart rather than folded into one log-sum-exp,
// because in fp32 a masked row's -1e30 + log2(l) rounds back to -1e30.
// attention_bwd.cu recomputes the probabilities from them. Writing them
// changes nothing in the output.
//
// Bound on the H100: operations, 4 B H Sq Skv D FLOP on the bf16 tensor
// cores (~0.165 ms at 989 TFLOP/s for the audio self-attention,
// B=2 H=8 S=6304). This first version uses mma.sync-class WMMA tiles and a
// shared-memory round trip for the softmax; wgmma + TMA with the softmax in
// registers is the later step toward that bound.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int D = 64;
constexpr int BQ = 64;       // queries per block
constexpr int BK = 64;       // keys per step
constexpr int NWARP = BQ / 16;
constexpr int NTHREAD = NWARP * 32;
constexpr float MASKED = -1e30f;
// Padded shared-memory row strides: 72 bf16 (144 B) keeps the 8 rows of a
// WMMA tile load on distinct banks; 68 floats keeps a lane pair per row
// (interleaved columns) within 2-way conflicts. Unpadded strides of 64
// elements put every row of a tile on the same banks.
constexpr int LDH = D + 8;         // bf16 tiles (Q / P, K, V); D == BK
constexpr int LDS = BK + 4;        // fp32 logits / P V scratch

struct __align__(128) Smem {
  __nv_bfloat16 qp[BQ * LDH];      // Q tile at start, then each warp's P rows
  __nv_bfloat16 k[BK * LDH];
  __nv_bfloat16 v[BK * LDH];
  float s[NWARP][16 * LDS];        // per-warp logits, then P V partials
  float kbias[BK];                 // 0 valid, MASKED masked, -inf past Skv
};
static_assert(D == BK, "the P tile reuses the Q tile's rows");

__global__ void __launch_bounds__(NTHREAD) attn_fwd_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const uint8_t* __restrict__ kv_mask,
    __nv_bfloat16* __restrict__ out, float* __restrict__ stats, int H,
    int Sq, int Skv, float scale_log2) {
  __shared__ Smem sm;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const __nv_bfloat16* qb = q + (size_t)bh * Sq * D;
  const __nv_bfloat16* kb = k + (size_t)bh * Skv * D;
  const __nv_bfloat16* vb = v + (size_t)bh * Skv * D;
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);
  constexpr int VPR = D / 8;       // 16-byte vectors per row

  for (int i = threadIdx.x; i < BQ * VPR; i += NTHREAD) {
    const int row = i / VPR, c8 = i % VPR;
    uint4 val = zero4;
    if (q0 + row < Sq) val = reinterpret_cast<const uint4*>(qb + (size_t)(q0 + row) * D)[c8];
    reinterpret_cast<uint4*>(sm.qp + row * LDH)[c8] = val;
  }
  __syncthreads();

  __nv_bfloat16* pw = sm.qp + warp * 16 * LDH;  // this warp's Q rows, then P
  float* sw = sm.s[warp];
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> qf[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) wmma::load_matrix_sync(qf[kk], pw + kk * 16, LDH);
  __syncwarp();

  // a lane pair per row; lane `half` owns the interleaved columns 2 j + half
  const int r = lane >> 1, half = lane & 1;
  float o[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) o[j] = 0.f;
  float m = -INFINITY, l = 0.f;

  const int nkb = (Skv + BK - 1) / BK;
  for (int kbi = 0; kbi < nkb; ++kbi) {
    const int k0 = kbi * BK;
    __syncthreads();   // every warp is done with the previous K / V tiles
    for (int i = threadIdx.x; i < BK * VPR; i += NTHREAD) {
      const int row = i / VPR, c8 = i % VPR;
      uint4 kv = zero4, vv = zero4;
      if (k0 + row < Skv) {
        kv = reinterpret_cast<const uint4*>(kb + (size_t)(k0 + row) * D)[c8];
        vv = reinterpret_cast<const uint4*>(vb + (size_t)(k0 + row) * D)[c8];
      }
      reinterpret_cast<uint4*>(sm.k + row * LDH)[c8] = kv;
      reinterpret_cast<uint4*>(sm.v + row * LDH)[c8] = vv;
    }
    for (int j = threadIdx.x; j < BK; j += NTHREAD) {
      const int key = k0 + j;
      float bias = 0.f;
      if (key >= Skv) bias = -INFINITY;
      else if (kv_mask != nullptr && !kv_mask[(size_t)b * Skv + key]) bias = MASKED;
      sm.kbias[j] = bias;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows
#pragma unroll
    for (int nt = 0; nt < BK / 16; ++nt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> kf;
        wmma::load_matrix_sync(kf, sm.k + nt * 16 * LDH + kk * 16, LDH);
        wmma::mma_sync(acc, qf[kk], kf, acc);
      }
      wmma::store_matrix_sync(sw + nt * 16, acc, LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax over row r, columns 2 j + half
    float sv[32];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = 2 * j + half;
      const float bias = sm.kbias[c];
      const float x = bias == 0.f ? sw[r * LDS + c] * scale_log2 : bias;
      sv[j] = x;
      mx = fmaxf(mx, x);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    const float corr = exp2f(m - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float p = exp2f(sv[j] - m_new);
      sum += p;
      pw[r * LDH + 2 * j + half] = __float2bfloat16(p);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l = l * corr + sum;
    m = m_new;
#pragma unroll
    for (int j = 0; j < 32; ++j) o[j] *= corr;
    __syncwarp();

    // P V into the warp's scratch, then into the register accumulator
#pragma unroll
    for (int nt = 0; nt < D / 16; ++nt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> pf;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> vf;
        wmma::load_matrix_sync(pf, pw + kk * 16, LDH);
        wmma::load_matrix_sync(vf, sm.v + kk * 16 * LDH + nt * 16, LDH);
        wmma::mma_sync(acc, pf, vf, acc);
      }
      wmma::store_matrix_sync(sw + nt * 16, acc, LDS, wmma::mem_row_major);
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 32; ++j) o[j] += sw[r * LDS + 2 * j + half];
  }

  // Lanes 2r and 2r+1 hold the even and odd columns of row r: each writes
  // column pairs assembled with its partner's values. Every lane takes part
  // in the shuffles; only rows inside Sq are stored.
  const int row = q0 + warp * 16 + r;
  const float inv = 1.f / l;
  if (stats != nullptr && row < Sq && half == 0) {
    stats[((size_t)bh * Sq + row) * 2] = m;
    stats[((size_t)bh * Sq + row) * 2 + 1] = l;
  }
  __nv_bfloat16* orow = out + ((size_t)bh * Sq + row) * D;
#pragma unroll
  for (int j = 0; j < 32; j += 2) {
    const float mine0 = o[j] * inv, mine1 = o[j + 1] * inv;   // cols 2j+half, 2j+2+half
    const float other0 = __shfl_xor_sync(0xffffffffu, mine0, 1);
    const float other1 = __shfl_xor_sync(0xffffffffu, mine1, 1);
    if (row < Sq) {
      if (half == 0) {   // columns 2j, 2j+1
        *reinterpret_cast<__nv_bfloat162*>(orow + 2 * j) =
            __floats2bfloat162_rn(mine0, other0);
      } else {           // columns 2j+2, 2j+3
        *reinterpret_cast<__nv_bfloat162*>(orow + 2 * j + 2) =
            __floats2bfloat162_rn(other1, mine1);
      }
    }
  }
}

}  // namespace

// q (B, H, Sq, 64), k / v (B, H, Skv, 64) bf16 contiguous; kv_mask (B, Skv)
// bool or null -> out (B, H, Sq, 64) bf16; stats (B, H, Sq, 2) fp32 (m, l)
// or null. Returns cudaGetLastError().
extern "C" int attention_launch(const void* q, const void* k, const void* v,
                                const void* kv_mask, void* out, void* stats,
                                int B, int H, int Sq, int Skv, float scale,
                                void* stream) {
  if (B > 0 && H > 0 && Sq > 0 && Skv > 0) {
    dim3 grid((Sq + BQ - 1) / BQ, B * H);
    const float scale_log2 = scale * 1.4426950408889634f;
    attn_fwd_kernel<<<grid, NTHREAD, 0, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
        (const __nv_bfloat16*)v, (const uint8_t*)kv_mask,
        (__nv_bfloat16*)out, (float*)stats, H, Sq, Skv, scale_log2);
  }
  return (int)cudaGetLastError();
}
