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
// Bound on the H100: operations. The function needs 10 B H Sq Skv D FLOP on
// the bf16 tensor cores (five products of the forward's size: S, dP, dV, dK,
// dQ; ~0.41 ms at 989 TFLOP/s for the audio self-attention B=2 H=8
// S=6304); its bytes (q, k, v, out, dout, the statistics in; dq, dk, dv out)
// take ~0.04 ms.
//
// Design (FlashAttention-2/3's backward for Hopper), two launches:
//   1. attn_bwd_rows: per query row {m, 1/l, Delta = rowsum(dO * O) in fp32,
//      0}, rows padded per head to a multiple of 128 with {0, 0, 0, 0} (so a
//      row past Sq has P = 0: its zero-filled q gives logit 0, times 1/l = 0).
//   2. attn_bwd_main: the dK / dV blocks and the dQ blocks side by side in
//      one grid. Each block has two consumer warpgroups of 64 rows (wgmma's
//      M) and one producer warp; a key's bias (0 valid, -1e30 masked, -inf
//      past Skv) is taken from the mask where it is used.
//      dK / dV block, one per (batch, head, 128 keys), the keys as rows: K
//      and V of the block come once by TMA (128-byte swizzled 64 x 64 bf16
//      boxes: a row of D = 64 bf16 is 128 bytes; rows past Skv read 0). The
//      producer streams 64-query tiles of Q and dO by TMA, with their row
//      statistics by a bulk copy, through a ring of 3 stages under mbarriers.
//      Each step: S^T = K Q^T and dP^T = V dO^T by wgmma from shared memory
//      into registers; P^T = exp2(x - m) / l and dS^T = P^T (dP^T - Delta) in
//      registers; their bf16 values fed straight back as the register A
//      operand of dV += P^T dO and dK += dS^T Q (Q and dO read MN-major from
//      the same tiles). dK and dV stay in registers (2 x 64 x 64 fp32 a
//      warpgroup) for the whole walk over the queries, and are written once.
//      dQ block, one per (batch, head, 128 queries): Q and dO once by TMA,
//      the producer streams 64-key tiles of K and V; S = Q K^T and dP = dO
//      V^T by wgmma, dS in registers, dQ += dS K (K read MN-major) in
//      registers, written once.
//   dQ route: a separate pass, as the TPU kernel does (its dq block sizes),
//   and not fp32 atomics or bulk reduce-adds from the dK / dV blocks: it recomputes S
//   and dP (14 products' worth of work instead of 10), but it needs no
//   zeroed fp32 buffer, no atomic traffic into L2 (per-element fp32 atomics
//   would add B H Sq D ceil(Skv / 64) values, ~639 M at the audio shape), no
//   exchange of dS between the two warpgroups, and it is deterministic: two
//   launches on the same inputs give bit-identical dQ, dK and dV.
//
// Roundings, as chip_smoke's attention_bwd_rounded repeats them:
// P rounded to bf16 for dV = P^T dO; dS = P (dP - Delta) rounded to bf16 for
// dQ = dS K and dK = dS^T Q; fp32 accumulation; Delta in fp32 from the
// forward's bf16 output; dK times the scale before its one rounding; dQ
// times the scale, rounded once. Masks as kernel A: a key past Skv has P = 0;
// a masked key's logit is -1e30, so it has P = exp2(-1e30 - m) / l (uniform
// over an all-masked row, 0 elsewhere) and no dS; rows past Sq contribute
// nothing. (m, l) are read apart: in fp32 -1e30 + log2 l rounds back to
// -1e30. Validated shapes only: D = 64, bf16, contiguous (B, H, S, D).

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int D = 64;
constexpr int TILE = 64;                     // rows of a TMA box / a warpgroup
constexpr int BLOCK = 128;                   // keys (dkdv) or queries (dq) a block
constexpr int NCONS = 256;                   // two consumer warpgroups
constexpr int NTHREAD = NCONS + 32;          // and one producer warp
constexpr int STAGES = 3;
constexpr uint32_t TILE_BYTES = TILE * D * 2;

struct RowStat {
  float m, inv_l, delta, pad;
};

struct __align__(1024) DkdvSmem {
  __nv_bfloat16 k[2][TILE * D];
  __nv_bfloat16 v[2][TILE * D];
  __nv_bfloat16 q[STAGES][TILE * D];
  __nv_bfloat16 dout[STAGES][TILE * D];
  RowStat rows[STAGES][TILE];
  uint64_t full[STAGES], empty[STAGES], kv_full;
};

struct __align__(1024) DqSmem {
  __nv_bfloat16 q[2][TILE * D];
  __nv_bfloat16 dout[2][TILE * D];
  __nv_bfloat16 k[STAGES][TILE * D];
  __nv_bfloat16 v[STAGES][TILE * D];
  uint64_t full[STAGES], empty[STAGES], q_full;
};

__global__ void attn_bwd_rows(const __nv_bfloat16* __restrict__ dout,
                              const __nv_bfloat16* __restrict__ out,
                              const float* __restrict__ stats, RowStat* __restrict__ rows,
                              int Sq, int Sq_pad, long long nrows) {
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= nrows) return;
  const long long bh = row / Sq_pad;
  const int i = (int)(row % Sq_pad);
  if (i >= Sq) {
    if (lane == 0) rows[row] = RowStat{0.f, 0.f, 0.f, 0.f};
    return;
  }
  const size_t src = (size_t)bh * Sq + i;
  const __nv_bfloat162 a = reinterpret_cast<const __nv_bfloat162*>(dout + src * D)[lane];
  const __nv_bfloat162 b = reinterpret_cast<const __nv_bfloat162*>(out + src * D)[lane];
  float s = __low2float(a) * __low2float(b) + __high2float(a) * __high2float(b);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) rows[row] = RowStat{stats[src * 2], 1.f / stats[src * 2 + 1], s, 0.f};
}

// a key's logit bias: 0 valid, -1e30 masked, -inf past Skv
__device__ __forceinline__ float key_bias(const uint8_t* __restrict__ kv_mask, int b, int Skv,
                                          int key) {
  if (key >= Skv) return -INFINITY;
  if (kv_mask != nullptr && !kv_mask[(size_t)b * Skv + key]) return kMaskedLogit;
  return 0.f;
}

// ---- the dK / dV blocks ------------------------------------------------------

__device__ __forceinline__ void attn_bwd_dkdv(
    unsigned char* smem_raw, int kblock, int bh, const CUtensorMap& tq, const CUtensorMap& tk,
    const CUtensorMap& tv, const CUtensorMap& tdo, const RowStat* __restrict__ rows,
    const uint8_t* __restrict__ kv_mask, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int H, int Sq, int Skv, int Sq_pad, float scale,
    float scale_log2) {
  DkdvSmem& sm = aligned_smem<DkdvSmem>(smem_raw);
  const int b = bh / H;
  const int k0 = kblock * BLOCK;
  const int nq = (Sq + TILE - 1) / TILE;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], NCONS / 32);   // one arrival a consumer warp
    }
    mbar_init(&sm.kv_full, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= NCONS) {   // producer warp: one thread issues every copy
    if (tid == NCONS) {
      mbar_expect_tx(&sm.kv_full, 4 * TILE_BYTES);
      for (int w = 0; w < 2; ++w) {
        tma_load_3d(sm.k[w], &tk, &sm.kv_full, 0, k0 + TILE * w, bh);
        tma_load_3d(sm.v[w], &tv, &sm.kv_full, 0, k0 + TILE * w, bh);
      }
      for (int i = 0; i < nq; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(&sm.empty[s], (i / STAGES - 1) & 1);
        mbar_expect_tx(&sm.full[s], 2 * TILE_BYTES + TILE * sizeof(RowStat));
        tma_load_3d(sm.q[s], &tq, &sm.full[s], 0, TILE * i, bh);
        tma_load_3d(sm.dout[s], &tdo, &sm.full[s], 0, TILE * i, bh);
        bulk_load(sm.rows[s], rows + (size_t)bh * Sq_pad + TILE * i, TILE * sizeof(RowStat),
                  &sm.full[s]);
      }
    }
    return;
  }

  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int r0 = warp * 16 + lane / 4;             // this thread's rows r0, r0 + 8
  const int cq = 2 * (lane % 4);                   // its column offset in each 8
  const int key0 = k0 + TILE * wg + r0;
  const float bias[2] = {key_bias(kv_mask, b, Skv, key0), key_bias(kv_mask, b, Skv, key0 + 8)};

  float dk_acc[32], dv_acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  mbar_wait(&sm.kv_full, 0);
  const uint64_t desc_k = desc_sw128(sm.k[wg]), desc_v = desc_sw128(sm.v[wg]);

  for (int i = 0; i < nq; ++i) {
    const int s = i % STAGES;
    mbar_wait(&sm.full[s], (i / STAGES) & 1);
    const uint64_t desc_q = desc_sw128(sm.q[s]), desc_o = desc_sw128(sm.dout[s]);
    float st[32], dpt[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) st[j] = dpt[j] = 0.f;
    fence_acc(st);
    fence_acc(dpt);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)   // S^T = K Q^T (keys x queries)
      wgmma_ss<0, 0>(st, desc_add(desc_k, 32 * kk), desc_add(desc_q, 32 * kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)   // dP^T = V dO^T
      wgmma_ss<0, 0>(dpt, desc_add(desc_v, 32 * kk), desc_add(desc_o, 32 * kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(st);
    fence_acc(dpt);

    // P^T and dS^T of this thread's 2 keys x 16 queries, packed as A operands
    uint32_t pa[16], dsa[16];
    const RowStat* rs = sm.rows[s];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const RowStat q0 = rs[8 * j + cq], q1 = rs[8 * j + cq + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float p[2], ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const RowStat& qr = e == 0 ? q0 : q1;
          const int idx = 4 * j + 2 * h + e;
          const float x = bias[h] == 0.f ? st[idx] * scale_log2 : bias[h];
          p[e] = bias[h] == -INFINITY ? 0.f : exp2f(x - qr.m) * qr.inv_l;
          ds[e] = bias[h] == 0.f ? p[e] * (dpt[idx] - qr.delta) : 0.f;
        }
        pa[2 * j + h] = pack_bf16(p[0], p[1]);
        dsa[2 * j + h] = pack_bf16(ds[0], ds[1]);
      }
    }

    fence_acc(dv_acc);
    fence_acc(dk_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk) {   // dV += P^T dO, dK += dS^T Q
      const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3]};
      wgmma_rs<1>(dv_acc, a, desc_add(desc_o, 2048 * kk));
    }
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk) {
      const uint32_t a[4] = {dsa[4 * kk], dsa[4 * kk + 1], dsa[4 * kk + 2], dsa[4 * kk + 3]};
      wgmma_rs<1>(dk_acc, a, desc_add(desc_q, 2048 * kk));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(dv_acc);
    fence_acc(dk_acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[s]);
  }

  // dK (times the scale) and dV of this thread's 2 keys x 16 columns
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = key0 + 8 * h;
    if (key >= Skv) continue;
    const size_t base = ((size_t)bh * Skv + key) * D + cq;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int idx = 4 * j + 2 * h;
      *reinterpret_cast<uint32_t*>(dk + base + 8 * j) =
          pack_bf16(dk_acc[idx] * scale, dk_acc[idx + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + base + 8 * j) = pack_bf16(dv_acc[idx], dv_acc[idx + 1]);
    }
  }
}

// ---- the dQ blocks --------------------------------------------------------------

__device__ __forceinline__ void attn_bwd_dq(
    unsigned char* smem_raw, int qblock, int bh, const CUtensorMap& tq, const CUtensorMap& tk,
    const CUtensorMap& tv, const CUtensorMap& tdo, const RowStat* __restrict__ rows,
    const uint8_t* __restrict__ kv_mask, __nv_bfloat16* __restrict__ dq, int H, int Sq,
    int Skv, int Sq_pad, float scale, float scale_log2) {
  DqSmem& sm = aligned_smem<DqSmem>(smem_raw);
  const int b = bh / H;
  const int q0 = qblock * BLOCK;
  const int nk = (Skv + TILE - 1) / TILE;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], NCONS / 32);
    }
    mbar_init(&sm.q_full, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= NCONS) {
    if (tid == NCONS) {
      mbar_expect_tx(&sm.q_full, 4 * TILE_BYTES);
      for (int w = 0; w < 2; ++w) {
        tma_load_3d(sm.q[w], &tq, &sm.q_full, 0, q0 + TILE * w, bh);
        tma_load_3d(sm.dout[w], &tdo, &sm.q_full, 0, q0 + TILE * w, bh);
      }
      for (int i = 0; i < nk; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(&sm.empty[s], (i / STAGES - 1) & 1);
        mbar_expect_tx(&sm.full[s], 2 * TILE_BYTES);
        tma_load_3d(sm.k[s], &tk, &sm.full[s], 0, TILE * i, bh);
        tma_load_3d(sm.v[s], &tv, &sm.full[s], 0, TILE * i, bh);
      }
    }
    return;
  }

  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int r0 = warp * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  const int row0 = q0 + TILE * wg + r0;           // rows row0, row0 + 8 (< Sq_pad)
  RowStat stat[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) stat[h] = rows[(size_t)bh * Sq_pad + row0 + 8 * h];

  float dq_acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq_acc[i] = 0.f;

  mbar_wait(&sm.q_full, 0);
  const uint64_t desc_q = desc_sw128(sm.q[wg]), desc_o = desc_sw128(sm.dout[wg]);

  for (int i = 0; i < nk; ++i) {
    const int s = i % STAGES;
    mbar_wait(&sm.full[s], (i / STAGES) & 1);
    const uint64_t desc_k = desc_sw128(sm.k[s]), desc_v = desc_sw128(sm.v[s]);
    float sc[32], dp[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) sc[j] = dp[j] = 0.f;
    fence_acc(sc);
    fence_acc(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)   // S = Q K^T (queries x keys)
      wgmma_ss<0, 0>(sc, desc_add(desc_q, 32 * kk), desc_add(desc_k, 32 * kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)   // dP = dO V^T
      wgmma_ss<0, 0>(dp, desc_add(desc_o, 32 * kk), desc_add(desc_v, 32 * kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(sc);
    fence_acc(dp);

    uint32_t dsa[16];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int key = TILE * i + 8 * j + cq;
      const float kbj[2] = {key_bias(kv_mask, b, Skv, key), key_bias(kv_mask, b, Skv, key + 1)};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int idx = 4 * j + 2 * h + e;
          const float p = exp2f(sc[idx] * scale_log2 - stat[h].m) * stat[h].inv_l;
          ds[e] = kbj[e] == 0.f ? p * (dp[idx] - stat[h].delta) : 0.f;
        }
        dsa[2 * j + h] = pack_bf16(ds[0], ds[1]);
      }
    }

    fence_acc(dq_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk) {   // dQ += dS K
      const uint32_t a[4] = {dsa[4 * kk], dsa[4 * kk + 1], dsa[4 * kk + 2], dsa[4 * kk + 3]};
      wgmma_rs<1>(dq_acc, a, desc_add(desc_k, 2048 * kk));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(dq_acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[s]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= Sq) continue;
    const size_t base = ((size_t)bh * Sq + row) * D + cq;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int idx = 4 * j + 2 * h;
      *reinterpret_cast<uint32_t*>(dq + base + 8 * j) =
          pack_bf16(dq_acc[idx] * scale, dq_acc[idx + 1] * scale);
    }
  }
}

constexpr size_t DKDV_SMEM = sizeof(DkdvSmem) + 1024;
constexpr size_t DQ_SMEM = sizeof(DqSmem) + 1024;
constexpr size_t MAIN_SMEM = DKDV_SMEM > DQ_SMEM ? DKDV_SMEM : DQ_SMEM;

// One launch for both passes (they only share the read-only inputs): the
// first nkb blocks of each (batch, head) row of the grid are dK / dV blocks,
// the rest dQ blocks, so that the two kinds run side by side.
__global__ void __launch_bounds__(NTHREAD, 1) attn_bwd_main(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
    const RowStat* __restrict__ rows, const uint8_t* __restrict__ kv_mask,
    __nv_bfloat16* __restrict__ dq, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int H, int Sq, int Skv, int Sq_pad, int nkb, float scale,
    float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  if ((int)blockIdx.x < nkb)
    attn_bwd_dkdv(smem_raw, blockIdx.x, blockIdx.y, tq, tk, tv, tdo, rows, kv_mask, dk, dv, H,
                  Sq, Skv, Sq_pad, scale, scale_log2);
  else
    attn_bwd_dq(smem_raw, blockIdx.x - nkb, blockIdx.y, tq, tk, tv, tdo, rows, kv_mask, dq, H,
                Sq, Skv, Sq_pad, scale, scale_log2);
}

}  // namespace

// dynamic shared memory of a block of attn_bwd_main
extern "C" int attention_bwd_smem() { return (int)MAIN_SMEM; }

// q / dq (B, H, Sq, 64), k / v / dk / dv (B, H, Skv, 64) bf16 contiguous;
// out / dout (B, H, Sq, 64) bf16: the forward's output and its gradient;
// stats (B, H, Sq, 2) fp32: kernel A's (m, l); kv_mask (B, Skv) bool or null;
// scratch: rows (B, H, Sq_pad, 4) fp32, Sq_pad = Sq rounded up to a
// multiple of 128. Returns
// cudaGetLastError(), or cudaErrorInvalidValue when a tensor map cannot be
// encoded (the driver lacks cuTensorMapEncodeTiled, a misaligned pointer).
extern "C" int attention_bwd_launch(const void* q, const void* k, const void* v,
                                    const void* kv_mask, const void* out,
                                    const void* dout, const void* stats, void* rows,
                                    void* dq, void* dk, void* dv, int B,
                                    int H, int Sq, int Skv, float scale, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Skv <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const int Sq_pad = (Sq + BLOCK - 1) / BLOCK * BLOCK;
  const int BH = B * H;
  CUtensorMap tq, tk, tv, tdo;
  if (!make_map_3d(&tq, q, D, Sq, BH, D, TILE) || !make_map_3d(&tk, k, D, Skv, BH, D, TILE) ||
      !make_map_3d(&tv, v, D, Skv, BH, D, TILE) ||
      !make_map_3d(&tdo, dout, D, Sq, BH, D, TILE))
    return (int)cudaErrorInvalidValue;

  const long long nrows = (long long)BH * Sq_pad;
  attn_bwd_rows<<<(unsigned)((nrows + 7) / 8), 256, 0, st>>>(
      (const __nv_bfloat16*)dout, (const __nv_bfloat16*)out, (const float*)stats,
      (RowStat*)rows, Sq, Sq_pad, nrows);
  const cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_main, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)MAIN_SMEM);
  if (err != cudaSuccess) return (int)err;
  const int nkb = (Skv + BLOCK - 1) / BLOCK, nqb = Sq_pad / BLOCK;
  attn_bwd_main<<<dim3(nkb + nqb, BH), NTHREAD, MAIN_SMEM, st>>>(
      tq, tk, tv, tdo, (const RowStat*)rows, (const uint8_t*)kv_mask, (__nv_bfloat16*)dq,
      (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, H, Sq, Skv, Sq_pad, nkb, scale,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}
