// Kernel A-bwd: the backward of kernel A's attention, dQ / dK / dV of
// out = softmax(q k^T * scale + key_mask) v.
//
// Replaces the backward half of the stock Pallas flash_attention that the
// JAX package differentiates in training (models/transformer.py
// Attention._flash, whose dkv / dq block sizes are set at lines 254-260, and
// models/ptv3.py _PatchAttention at D = 64): the audio self-attention, the
// stage-1 SMPL-X predictor and fusion cross- and self-attention, and the
// PTv3 decoder's masked patches.
//
// Design: FlashAttention-2's backward in two launches.
//   1. attn_bwd_dot_kernel: Delta_i = rowsum(dO_i * O_i) in fp32, one warp
//      per query row.
//   2. attn_bwd_kernel: one block of 4 warps per (batch, head, 64-key
//      block). K and V of the block stay in shared memory; the block walks
//      the query blocks of 64: stages Q and dO, recomputes the logits with
//      bf16 WMMA tiles (fp32 accumulation), forms P = exp2(x - m) / l from
//      the forward's per-row statistics (m and l kept apart: in fp32 a
//      masked row's -1e30 + log2 l rounds back to -1e30), dP = dO V^T and
//      dS = P (dP - Delta), rounds P and dS to bf16, and accumulates
//      dV += P^T dO and dK += dS^T Q in WMMA accumulators (registers) for
//      the whole walk; dQ += dS K goes to an fp32 buffer through atomics.
//   Masks as kernel A: a key past Skv has P = 0; a masked key's logit was
//   replaced by -1e30, so it has P = exp2(-1e30 - m) / l (uniform over an
//   all-masked row, 0 elsewhere) and no dS (no gradient to q or k through
//   it). Query rows past Sq contribute nothing.
//   Validated shapes only: D = 64, bf16, contiguous (B, H, S, D).
//
// Bound on the H100: operations, 10 B H Sq Skv D FLOP on the bf16 tensor
// cores (five products of the forward's size: S, dP, dV, dK, dQ; ~0.41 ms
// at 989 TFLOP/s for the audio self-attention B=2 H=8 S=6304). This first
// version uses mma.sync-class WMMA tiles with the softmax through shared
// memory and fp32 atomics for dQ; wgmma + TMA and a dQ pass without atomics
// are the later steps toward that bound.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int D = 64;
constexpr int BQ = 64;       // queries per step of the walk
constexpr int BK = 64;       // keys per block
constexpr int NWARP = 4;
constexpr int NTHREAD = NWARP * 32;
constexpr float MASKED = -1e30f;
constexpr int LDH = D + 8;   // padded bf16 row stride (see attention.cu)
constexpr int LDS = BK + 4;  // padded fp32 row stride
constexpr int VPR = D / 8;   // 16-byte vectors per row

static_assert(BQ == NWARP * 16 && BK == NWARP * 16, "a warp owns 16 rows");
static_assert(D == BK, "tiles share the row stride");

struct __align__(128) Smem {
  __nv_bfloat16 k[BK * LDH];
  __nv_bfloat16 v[BK * LDH];
  __nv_bfloat16 q[BQ * LDH];
  __nv_bfloat16 dout[BQ * LDH];
  __nv_bfloat16 p[BQ * LDH];       // P of the query block, bf16
  __nv_bfloat16 ds[BQ * LDH];      // dS of the query block, bf16
  float s[NWARP][16 * LDS];        // per-warp logits, then dP, then dQ rows
  float row_m[BQ], row_inv_l[BQ], row_delta[BQ];
  float kbias[BK];                 // 0 valid, MASKED masked, -inf past Skv
};

__global__ void attn_bwd_dot_kernel(const __nv_bfloat16* __restrict__ dout,
                                    const __nv_bfloat16* __restrict__ out,
                                    float* __restrict__ delta, int rows) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const __nv_bfloat162 a = reinterpret_cast<const __nv_bfloat162*>(dout + (size_t)row * D)[lane];
  const __nv_bfloat162 b = reinterpret_cast<const __nv_bfloat162*>(out + (size_t)row * D)[lane];
  float s = __low2float(a) * __low2float(b) + __high2float(a) * __high2float(b);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) delta[row] = s;
}

// A 16 x 64 fp32 product of this warp, a (16 x 64, row-major at `a`) times
// b^T (64 x 64 rows at `b`, read as col-major), into `dst` (ld LDS).
__device__ __forceinline__ void rows_times_tile_t(const __nv_bfloat16* a,
                                                  const __nv_bfloat16* b,
                                                  float* dst) {
#pragma unroll
  for (int nt = 0; nt < BK / 16; ++nt) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bf;
      wmma::load_matrix_sync(af, a + kk * 16, LDH);
      wmma::load_matrix_sync(bf, b + nt * 16 * LDH + kk * 16, LDH);
      wmma::mma_sync(acc, af, bf, acc);
    }
    wmma::store_matrix_sync(dst + nt * 16, acc, LDS, wmma::mem_row_major);
  }
}

__global__ void __launch_bounds__(NTHREAD) attn_bwd_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const uint8_t* __restrict__ kv_mask,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ stats,
    const float* __restrict__ delta, float* __restrict__ dq_acc,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int H,
    int Sq, int Skv, float scale, float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int k0 = blockIdx.x * BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = lane >> 1, half = lane & 1;   // a lane pair per row
  const __nv_bfloat16* qb = q + (size_t)bh * Sq * D;
  const __nv_bfloat16* kb = k + (size_t)bh * Skv * D;
  const __nv_bfloat16* vb = v + (size_t)bh * Skv * D;
  const __nv_bfloat16* ob = dout + (size_t)bh * Sq * D;
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);

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

  // dV and dK of this warp's 16 keys, 64 wide: 4 accumulator tiles each
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dv_acc[D / 16], dk_acc[D / 16];
#pragma unroll
  for (int nt = 0; nt < D / 16; ++nt) {
    wmma::fill_fragment(dv_acc[nt], 0.f);
    wmma::fill_fragment(dk_acc[nt], 0.f);
  }
  float* sw = sm.s[warp];
  const int wr = warp * 16;        // this warp's first row in a tile

  const int nqb = (Sq + BQ - 1) / BQ;
  for (int qbi = 0; qbi < nqb; ++qbi) {
    const int q0 = qbi * BQ;
    __syncthreads();   // every warp is done with the previous Q / dO / P / dS
    for (int i = threadIdx.x; i < BQ * VPR; i += NTHREAD) {
      const int row = i / VPR, c8 = i % VPR;
      uint4 qv = zero4, ov = zero4;
      if (q0 + row < Sq) {
        qv = reinterpret_cast<const uint4*>(qb + (size_t)(q0 + row) * D)[c8];
        ov = reinterpret_cast<const uint4*>(ob + (size_t)(q0 + row) * D)[c8];
      }
      reinterpret_cast<uint4*>(sm.q + row * LDH)[c8] = qv;
      reinterpret_cast<uint4*>(sm.dout + row * LDH)[c8] = ov;
    }
    for (int j = threadIdx.x; j < BQ; j += NTHREAD) {
      const int row = q0 + j;
      float m = 0.f, inv_l = 0.f, d = 0.f;
      if (row < Sq) {
        const size_t idx = (size_t)bh * Sq + row;
        m = stats[idx * 2];
        inv_l = 1.f / stats[idx * 2 + 1];
        d = delta[idx];
      }
      sm.row_m[j] = m;
      sm.row_inv_l[j] = inv_l;   // 0 past Sq: those rows get P = 0
      sm.row_delta[j] = d;
    }
    __syncthreads();

    // logits of this warp's 16 query rows against the 64 keys
    rows_times_tile_t(sm.q + wr * LDH, sm.k, sw);
    __syncwarp();
    const float m_i = sm.row_m[wr + r], inv_l = sm.row_inv_l[wr + r];
    const float d_i = sm.row_delta[wr + r];
    float pv[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = 2 * j + half;
      const float bias = sm.kbias[c];
      const float x = bias == 0.f ? sw[r * LDS + c] * scale_log2 : bias;
      const float p = bias == -INFINITY ? 0.f : exp2f(x - m_i) * inv_l;
      pv[j] = p;
      sm.p[(wr + r) * LDH + c] = __float2bfloat16(p);
    }
    __syncwarp();
    // dP = dO V^T for the same rows
    rows_times_tile_t(sm.dout + wr * LDH, sm.v, sw);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = 2 * j + half;
      const float ds = sm.kbias[c] == 0.f ? pv[j] * (sw[r * LDS + c] - d_i) : 0.f;
      sm.ds[(wr + r) * LDH + c] = __float2bfloat16(ds);
    }
    __syncthreads();   // P and dS of every warp's rows are in place

    // dV += P^T dO, dK += dS^T Q over the block's 64 queries, for this
    // warp's 16 keys (P^T read as a col-major view of P)
#pragma unroll
    for (int nt = 0; nt < D / 16; ++nt) {
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> pf, sf;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> of, qf;
        wmma::load_matrix_sync(pf, sm.p + kk * 16 * LDH + wr, LDH);
        wmma::load_matrix_sync(of, sm.dout + kk * 16 * LDH + nt * 16, LDH);
        wmma::mma_sync(dv_acc[nt], pf, of, dv_acc[nt]);
        wmma::load_matrix_sync(sf, sm.ds + kk * 16 * LDH + wr, LDH);
        wmma::load_matrix_sync(qf, sm.q + kk * 16 * LDH + nt * 16, LDH);
        wmma::mma_sync(dk_acc[nt], sf, qf, dk_acc[nt]);
      }
    }
    // dQ rows of this warp: dS (16 x 64 keys) K (64 keys x 64)
#pragma unroll
    for (int nt = 0; nt < D / 16; ++nt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> sf;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> kf;
        wmma::load_matrix_sync(sf, sm.ds + wr * LDH + kk * 16, LDH);
        wmma::load_matrix_sync(kf, sm.k + kk * 16 * LDH + nt * 16, LDH);
        wmma::mma_sync(acc, sf, kf, acc);
      }
      wmma::store_matrix_sync(sw + nt * 16, acc, LDS, wmma::mem_row_major);
    }
    __syncwarp();
    const int qrow = q0 + wr + r;
    if (qrow < Sq) {
      float* dst = dq_acc + ((size_t)bh * Sq + qrow) * D;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int c = 2 * j + half;
        atomicAdd(dst + c, sw[r * LDS + c] * scale);
      }
    }
  }

  // dK (times the scale) and dV of this warp's 16 keys
  const int key = k0 + wr + r;
#pragma unroll
  for (int which = 0; which < 2; ++which) {
    __syncwarp();
#pragma unroll
    for (int nt = 0; nt < D / 16; ++nt)
      wmma::store_matrix_sync(sw + nt * 16, which == 0 ? dk_acc[nt] : dv_acc[nt],
                              LDS, wmma::mem_row_major);
    __syncwarp();
    if (key < Skv) {
      __nv_bfloat16* dst = (which == 0 ? dk : dv) + ((size_t)bh * Skv + key) * D;
      const float f = which == 0 ? scale : 1.f;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int c = 2 * j + half;
        dst[c] = __float2bfloat16(sw[r * LDS + c] * f);
      }
    }
  }
}

}  // namespace

// q / dq (B, H, Sq, 64), k / v / dk / dv (B, H, Skv, 64) bf16 contiguous;
// out / dout (B, H, Sq, 64) bf16: the forward's output and its gradient;
// stats (B, H, Sq, 2) fp32: kernel A's (m, l); kv_mask (B, Skv) bool or null;
// delta (B, H, Sq) fp32 scratch; dq_acc (B, H, Sq, 64) fp32, zeroed by the
// caller, receives dQ. Returns cudaGetLastError().
extern "C" int attention_bwd_launch(const void* q, const void* k, const void* v,
                                    const void* kv_mask, const void* out,
                                    const void* dout, const void* stats,
                                    void* delta, void* dq_acc, void* dk,
                                    void* dv, int B, int H, int Sq, int Skv,
                                    float scale, void* stream) {
  if (B > 0 && H > 0 && Sq > 0 && Skv > 0) {
    const int rows = B * H * Sq;
    attn_bwd_dot_kernel<<<(rows + 7) / 8, 256, 0, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)dout, (const __nv_bfloat16*)out, (float*)delta, rows);
    const int smem = (int)sizeof(Smem);
    cudaError_t err = cudaFuncSetAttribute(
        attn_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((Skv + BK - 1) / BK, B * H);
    const float scale_log2 = scale * 1.4426950408889634f;
    attn_bwd_kernel<<<grid, NTHREAD, smem, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
        (const __nv_bfloat16*)v, (const uint8_t*)kv_mask,
        (const __nv_bfloat16*)dout, (const float*)stats, (const float*)delta,
        (float*)dq_acc, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, H, Sq, Skv,
        scale, scale_log2);
  }
  return (int)cudaGetLastError();
}
