// Kernel A: exact attention forward, softmax(q k^T * scale + key_mask) v.
//
// Replaces the TPU attention forwards of the serving path: the stock Pallas
// flash_attention forward called by models/transformer.py (Attention._flash,
// the audio self-attention) and models/ptv3.py (_PatchAttention, D = 64),
// the stock splash kernel (models/transformer.py, q pre-scaled), and the
// repo's own forward kernels computing the same function
// (ops/serve_attention.py, ops/hpack_attention.py, ops/flash2.py).
//
// Bound on the H100: operations, 4 B H Sq Skv D FLOP on the bf16 tensor
// cores (~0.165 ms at 989 TFLOP/s for the audio self-attention, B=2 H=8
// S=6304); its bytes (q, k, v in, out) take ~0.03 ms. At D = 64 the softmax
// is nearly as costly: one exp2 for every 128 multiply-adds, and the SM's
// 16 exp2 a clock against its ~2048 bf16 multiply-adds a clock make the
// exponentials alone about as long as the products.
//
// Design (FlashAttention-3's forward for Hopper, on csrc/sm90.cuh): a block
// owns 64 NWG queries of one (batch, head): NWG consumer warpgroups of 64
// rows (wgmma's M), NWG = 2 or 3 chosen per launch for the fewer waves, and
// one producer warp. Q comes once by TMA (128-byte swizzled 64 x 64 bf16
// boxes of a 3-D tensor map; rows past Sq read 0) and each warpgroup moves
// its Q tile into registers, the A operand of S = Q K^T. The producer streams
// 64-key tiles of K and V by TMA through a ring of 4 stages under mbarriers.
// Each step, by wgmma into registers: S of the next key tile is issued
// before O += P V of this one (P the bf16 probabilities, fed back as the
// register A operand, V read MN-major), so the next tile's softmax runs while
// this tile's product is on the tensor cores. The online softmax works on the
// m64n64 accumulator layout: a row lives in 4 lanes, whose maximum takes two
// shuffles; each lane keeps its part of the row sum until the end. O stays
// in registers and is written once (the rescale skipped where no row maximum
// moved). With a key mask, the producer warp stages each tile's 64 mask bytes
// beside K and V; a key's bias is taken from them where it is used. Tiles
// that are whole (every key of the warp's rows counts) skip it.
//
// Roundings and masks, as chip_smoke's attention_rounded repeats them: the
// logits times scale * log2(e) in fp32 (in a tile where every key counts,
// fused into the exponent: exp2(s * scale * log2 e - m) by one multiply-add,
// as A-bwd recomputes it); the unnormalised probabilities exp2(x - m_running)
// (ex2.approx.ftz: below 2^-126 they flush to 0) rounded to bf16 for the
// P V product, fp32 accumulation; the output divided by the fp32 row sum l
// (times 1 / l) and rounded to bf16 once. Keys past Skv contribute nothing;
// a masked key's logit is replaced by -1e30, so a row whose keys are all
// masked averages them uniformly, as the dense reference with a
// large-negative mask does.
// Validated shapes only: D = 64, bf16, contiguous (B, H, S, D); any Sq / Skv.
//
// For training, the launch can also write each query row's softmax
// statistics (m, l): the running maximum of the base-2 logits and the sum of
// exp2(logit - m), kept apart rather than folded into one log-sum-exp,
// because in fp32 a masked row's -1e30 + log2(l) rounds back to -1e30.
// attention_bwd.cu recomputes the probabilities from them. Writing them
// changes nothing in the output.

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int D = 64;
constexpr int TILE = 64;                     // keys a stage; query rows a warpgroup
constexpr int STAGES = 4;
constexpr uint32_t TILE_BYTES = TILE * D * 2;

template <int NWG>
struct __align__(1024) FwdSmem {
  __nv_bfloat16 q[NWG][TILE * D];
  __nv_bfloat16 k[STAGES][TILE * D];
  __nv_bfloat16 v[STAGES][TILE * D];
  uint8_t mask[STAGES][TILE];   // the tile's key mask (0 past Skv), with a mask
  uint64_t full[STAGES], empty[STAGES], q_full;
};

template <int NWG>
constexpr size_t fwd_smem() {
  return sizeof(FwdSmem<NWG>) + 1024;
}

template <int NWG>
__global__ void __launch_bounds__(NWG * 128 + 32, 1) attn_fwd_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const uint8_t* __restrict__ kv_mask,
    __nv_bfloat16* __restrict__ out, float* __restrict__ stats, int H, int Sq, int Skv,
    float scale_log2) {
  constexpr int NCONS = NWG * 128;
  extern __shared__ unsigned char smem_raw[];
  FwdSmem<NWG>& sm = aligned_smem<FwdSmem<NWG>>(smem_raw);
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int q0 = blockIdx.x * TILE * NWG;
  const int nk = (Skv + TILE - 1) / TILE;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], NCONS / 32);   // one arrival a consumer warp
    }
    mbar_init(&sm.q_full, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= NCONS) {   // producer warp: lane 0 issues every copy
    const int pl = tid - NCONS;
    if (pl == 0) {
      mbar_expect_tx(&sm.q_full, NWG * TILE_BYTES);
      for (int w = 0; w < NWG; ++w) tma_load_3d(sm.q[w], &tq, &sm.q_full, 0, q0 + TILE * w, bh);
    }
    if (kv_mask == nullptr && pl != 0) return;
    for (int i = 0; i < nk; ++i) {
      const int s = i % STAGES;
      if (i >= STAGES) mbar_wait(&sm.empty[s], (i / STAGES - 1) & 1);
      if (kv_mask != nullptr) {   // the warp stages the tile's mask bytes
        for (int c = pl; c < TILE; c += 32) {
          const int key = TILE * i + c;
          sm.mask[s][c] = key < Skv ? kv_mask[(size_t)b * Skv + key] : 0;
        }
        __syncwarp();   // ordered before lane 0's arrival, which releases them
      }
      if (pl == 0) {
        mbar_expect_tx(&sm.full[s], 2 * TILE_BYTES);
        tma_load_3d(sm.k[s], &tk, &sm.full[s], 0, TILE * i, bh);
        tma_load_3d(sm.v[s], &tv, &sm.full[s], 0, TILE * i, bh);
      }
    }
    return;
  }

  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int r0 = warp * 16 + lane / 4;             // this thread's rows r0, r0 + 8
  const int cq = 2 * (lane % 4);                   // its column offset in each 8

  // Q of this warpgroup as the register A operand: register m holds row
  // r0 + 8 (m % 2), columns 8 (m / 2) + cq and + 1, read from the swizzled
  // tile (16-byte chunk c of row r at r * 128 + ((c ^ (r % 8)) * 16))
  mbar_wait(&sm.q_full, 0);
  uint32_t qa[16];
  {
    const unsigned char* qt = reinterpret_cast<const unsigned char*>(sm.q[wg]);
#pragma unroll
    for (int m = 0; m < 16; ++m) {
      const int row = r0 + 8 * (m & 1), chunk = m >> 1;
      qa[m] = *reinterpret_cast<const uint32_t*>(qt + row * 128 + ((chunk ^ (row & 7)) << 4) +
                                                 2 * cq);
    }
  }

  float o[32], s[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_part[2] = {0.f, 0.f};

  // S = Q K^T of the key tile in stage `st`, issued and committed (the
  // first of the four products overwrites s)
  auto issue_s = [&](int st) {
    fence_acc(s);
    wgmma_fence();
    const uint64_t desc_k = desc_sw128(sm.k[st]);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t a[4] = {qa[4 * kk], qa[4 * kk + 1], qa[4 * kk + 2], qa[4 * kk + 3]};
      wgmma_rs<0>(s, a, desc_add(desc_k, 32 * kk), kk > 0);
    }
    wgmma_commit();
  };

  // which of this thread's 16 keys of the tile at k0 (in stage st) count:
  // bit 2 j + e for key k0 + 8 j + cq + e, set where it is below Skv and not
  // masked (the mask from the stage, where the producer wrote 0 past Skv)
  auto valid_bits = [&](int k0, int st) {
    uint32_t bits = 0;
    if (kv_mask != nullptr) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t two = *reinterpret_cast<const uint16_t*>(&sm.mask[st][8 * j + cq]);
        bits |= (((two & 0xFFu) != 0) | ((two >> 8) != 0) << 1) << (2 * j);
      }
      return bits;
    }
    if (k0 + TILE <= Skv) return 0xFFFFu;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) bits |= (uint32_t)(k0 + 8 * j + cq + e < Skv) << (2 * j + e);
    return bits;
  };

  // the online softmax of the logits in s (keys k0 .., `bits` as above): the
  // new running maximum, the tile's bf16 probabilities as A operand
  // registers `p`, the factor `corr` of the earlier sums, this lane's part
  // of the row sums. A key past Skv gets -inf, a masked one -1e30. Where
  // every key of the warp's rows counts, the maximum is taken of the raw
  // logits (scaling by a positive factor keeps the order, and rounds the
  // maximum to the same value) and each exponent is one fused multiply-add;
  // the choice is the warp's, as the 4 lanes of a row combine their maxima.
  auto softmax = [&](int k0, uint32_t bits, uint32_t (&p)[16], float (&corr)[2]) {
    const bool whole = __all_sync(0xffffffffu, bits == 0xFFFFu) && scale_log2 > 0.f;
    if (!whole) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok = (bits >> (2 * j + e)) & 1u;
          const float bias = k0 + 8 * j + cq + e < Skv ? kMaskedLogit : -INFINITY;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int idx = 4 * j + 2 * h + e;
            s[idx] = ok ? s[idx] * scale_log2 : bias;
          }
        }
      }
    }
    const float f = whole ? scale_log2 : 1.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[h], mx * f);
      corr[h] = exp2_ftz(m_run[h] - m_new);
      m_run[h] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p0 = exp2_ftz(fmaf(s[4 * j + 2 * h], f, -m_new));
        const float p1 = exp2_ftz(fmaf(s[4 * j + 2 * h + 1], f, -m_new));
        sum += p0 + p1;
        p[2 * j + h] = pack_bf16(p0, p1);
      }
      l_part[h] = l_part[h] * corr[h] + sum;
    }
  };

  uint32_t pa[16];
  // O += P V of the key tile in stage `st`, issued and committed
  auto issue_pv = [&](int st) {
    fence_acc(o);
    wgmma_fence();
    const uint64_t desc_v = desc_sw128(sm.v[st]);
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk) {
      const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3]};
      wgmma_rs<1>(o, a, desc_add(desc_v, 2048 * kk));
    }
    wgmma_commit();
  };

  {
    mbar_wait(&sm.full[0], 0);
    const uint32_t bits = valid_bits(0, 0);
    issue_s(0);
    wgmma_wait<0>();
    fence_acc(s);
    float corr[2];
    softmax(0, bits, pa, corr);
  }
  // every step but the last: S of the next key tile is issued before O += P V
  // of this one, and the next softmax runs while P V is on the tensor cores
  for (int i = 0; i + 1 < nk; ++i) {
    const int st = i % STAGES, sn = (i + 1) % STAGES;
    mbar_wait(&sm.full[sn], ((i + 1) / STAGES) & 1);
    const uint32_t bits = valid_bits((i + 1) * TILE, sn);
    issue_s(sn);
    issue_pv(st);
    uint32_t pn[16];
    float corr[2];
    wgmma_wait<1>();
    fence_acc(s);
    softmax((i + 1) * TILE, bits, pn, corr);
    wgmma_wait<0>();
    fence_acc(o);
    fence_regs(pa);
    fence_regs(qa);
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[st]);
    if (corr[0] != 1.f || corr[1] != 1.f) {   // the row maxima moved
#pragma unroll
      for (int idx = 0; idx < 32; ++idx) o[idx] *= corr[(idx >> 1) & 1];
    }
#pragma unroll
    for (int m = 0; m < 16; ++m) pa[m] = pn[m];
  }
  issue_pv((nk - 1) % STAGES);
  wgmma_wait<0>();
  fence_acc(o);
  fence_regs(pa);

  // the row sums over the 4 lanes of a row; rows past Sq are not written
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_part[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = q0 + TILE * wg + r0 + 8 * h;
    if (row >= Sq) continue;
    const size_t r = (size_t)bh * Sq + row;
    if (stats != nullptr && cq == 0) {
      stats[r * 2] = m_run[h];
      stats[r * 2 + 1] = l;
    }
    const float inv = 1.f / l;
    __nv_bfloat16* orow = out + r * D + cq;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j) =
          pack_bf16(o[4 * j + 2 * h] * inv, o[4 * j + 2 * h + 1] * inv);
  }
}

template <int NWG>
int launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
           const uint8_t* kv_mask, __nv_bfloat16* out, float* stats, int B, int H, int Sq,
           int Skv, float scale, cudaStream_t st) {
  const cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_kernel<NWG>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)fwd_smem<NWG>());
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + TILE * NWG - 1) / (TILE * NWG), B * H);
  attn_fwd_kernel<NWG><<<grid, NWG * 128 + 32, fwd_smem<NWG>(), st>>>(
      tq, tk, tv, kv_mask, out, stats, H, Sq, Skv, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

// NWG = 3 where its blocks fill the SMs in fewer waves of equal work: a
// wave of 3-warpgroup blocks takes ~0.8 x 3/2 of a wave of 2-warpgroup ones
// (three warpgroups an SM hide more of each other's softmax; measured on the
// H100 at the audio, ViT, PTv3 and fusion shapes)
int choose_nwg(int B, int H, int Sq) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  const long long bh = (long long)B * H;
  const long long waves2 = (bh * ((Sq + 127) / 128) + sms - 1) / sms;
  const long long waves3 = (bh * ((Sq + 191) / 192) + sms - 1) / sms;
  return 12 * waves3 < 10 * waves2 ? 3 : 2;
}

}  // namespace

// dynamic shared memory of a block with `nwg` consumer warpgroups (2 or 3)
extern "C" int attention_smem(int nwg) {
  return nwg == 3 ? (int)fwd_smem<3>() : (int)fwd_smem<2>();
}

// q (B, H, Sq, 64), k / v (B, H, Skv, 64) bf16 contiguous; kv_mask (B, Skv)
// bool or null -> out (B, H, Sq, 64) bf16; stats (B, H, Sq, 2) fp32 (m, l)
// or null. nwg: consumer warpgroups a block, 2 or 3, or 0 to choose.
// Returns cudaGetLastError(), or cudaErrorInvalidValue when a tensor map
// cannot be encoded (the driver lacks cuTensorMapEncodeTiled, a misaligned
// pointer) or nwg is not 0, 2 or 3.
extern "C" int attention_launch_nwg(const void* q, const void* k, const void* v,
                                    const void* kv_mask, void* out, void* stats, int B, int H,
                                    int Sq, int Skv, float scale, void* stream, int nwg) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Skv <= 0) return (int)cudaGetLastError();
  const int BH = B * H;
  CUtensorMap tq, tk, tv;
  if (!make_map_3d(&tq, q, D, Sq, BH, D, TILE) || !make_map_3d(&tk, k, D, Skv, BH, D, TILE) ||
      !make_map_3d(&tv, v, D, Skv, BH, D, TILE))
    return (int)cudaErrorInvalidValue;
  if (nwg == 0) nwg = choose_nwg(B, H, Sq);
  const uint8_t* mask = (const uint8_t*)kv_mask;
  __nv_bfloat16* o = (__nv_bfloat16*)out;
  cudaStream_t st = (cudaStream_t)stream;
  if (nwg == 2) return launch<2>(tq, tk, tv, mask, o, (float*)stats, B, H, Sq, Skv, scale, st);
  if (nwg == 3) return launch<3>(tq, tk, tv, mask, o, (float*)stats, B, H, Sq, Skv, scale, st);
  return (int)cudaErrorInvalidValue;
}

// The same, the block shape chosen per launch.
extern "C" int attention_launch(const void* q, const void* k, const void* v,
                                const void* kv_mask, void* out, void* stats,
                                int B, int H, int Sq, int Skv, float scale,
                                void* stream) {
  return attention_launch_nwg(q, k, v, kv_mask, out, stats, B, H, Sq, Skv, scale, stream, 0);
}
