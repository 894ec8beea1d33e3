// Kernels K9a and K9b: 3x3 stride-1 convolution by Winograd F(2x2, 3x3),
// NHWC, bf16 operands.
//
// Replaces the TPU kernels of the JAX package's ops/winograd.py:
// `_wino_kernel` via winograd_conv3x3 (K9a) and `_wino_gn_kernel` via
// winograd_conv3x3_gn_relu (K9b), which computes conv3x3(relu(a x + c)) with
// a per-image channel affine (a folded GroupNorm) fused into the window
// assembly. One body; the template flag GN switches the affine on.
//
// Per 2x2 output tile with 4x4 input window d: Y = A^T [U . (B^T d B)] A,
// U = G w G^T (16, C, K) computed by the wrapper in fp32 and rounded to
// bf16. The input transform rounds as the JAX kernel and the plain version
// (ops/winograd.py) do: the row combination R = B^T d to bf16, then the
// column combination R B to bf16. In the GN variant relu(a x + c) is taken
// in fp32 (no fused multiply-add, as the plain version), rounded to bf16, and
// a window position outside the image (SAME padding) is zero after the
// affine, since relu(c) != 0.
//
// Design: one block of 8 warps owns BT = 32 consecutive output tiles and
// BK = 64 output channels and walks the input channels in steps of BC = 32.
// Each step, every thread assembles one tile's 4x4 window for 4 channels
// straight from device memory (neighbouring rows and columns read directly:
// no halo copy), transforms it and writes the 16 transformed values to
// shared memory (V: 16 x BT x BC); the block stages U's 16 x BC x BK slice;
// then each warp runs bf16 WMMA (m16n16k16, fp32 accumulators) for two of
// the 16 products, (BT x BC) . (BC x BK) each. After the last step the
// 16 accumulators go through shared memory, and each output (tile, k) takes
// A^T M A in fp32 in the plain version's order of terms, adds the fp32 bias
// and is stored as bf16.
//
// Bound on the H100: operations of the 16 products, 2 * 16 * tiles * C * K
// FLOP at 989 TFLOP/s (0.625 ms at (18, 256^2, 256) SAME). This first version
// reads U from L2 once per 32 tiles and the input once per 64 output
// channels (~96 KB of L2 traffic a tile at C = K = 256), with one block of
// mma.sync-class WMMA per SM and no copy / compute overlap; wgmma with TMA
// and U held across tiles is the later step toward the bound.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BT = 32;                 // output tiles a block
constexpr int BK = 64;                 // output channels a block
constexpr int BC = 32;                 // input channels a step
constexpr int NWARP = 8;
constexpr int NTHREAD = NWARP * 32;
constexpr int CPT = 4;                 // channels a thread transforms
constexpr int LDV = BC + 8;            // bf16 row stride of V[pq] (BT x BC)
constexpr int LDU = BK + 8;            // bf16 row stride of U[pq] (BC x BK)
constexpr int LDM = BK + 4;            // fp32 row stride of M[pq] (BT x BK)
static_assert(BT * BC / CPT == NTHREAD, "one (tile, 4 channels) item a thread");
static_assert(16 == 2 * NWARP, "two of the 16 products a warp");

struct StepSmem {
  __nv_bfloat16 v[16][BT * LDV];
  __nv_bfloat16 u[16][BC * LDU];
};
struct OutSmem {
  float m[16][BT * LDM];
};
constexpr size_t SMEM_BYTES =
    sizeof(StepSmem) > sizeof(OutSmem) ? sizeof(StepSmem) : sizeof(OutSmem);

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// A^T's entries: row 0 = (1, 1, 1, 0), row 1 = (0, 1, -1, -1)
__host__ __device__ constexpr float at(int u, int p) {
  return u == 0 ? (p < 3 ? 1.f : 0.f) : (p == 0 ? 0.f : (p == 1 ? 1.f : -1.f));
}

// B^T row p as a signed pair of taps: p0: t0 - t2, p1: t1 + t2, p2: t2 - t1,
// p3: t1 - t3; one rounding to bf16 (the sum of two bf16 values in fp32)
__device__ __forceinline__ void bt_rounded(const float t[4], float o[4]) {
  o[0] = round_bf16(t[0] - t[2]);
  o[1] = round_bf16(t[1] + t[2]);
  o[2] = round_bf16(t[2] - t[1]);
  o[3] = round_bf16(t[1] - t[3]);
}

template <bool GN>
__global__ void __launch_bounds__(NTHREAD, 1) winograd_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ u,
    const float* __restrict__ bias, const float* __restrict__ aff_a,
    const float* __restrict__ aff_c, __nv_bfloat16* __restrict__ out, int H,
    int W, int C, int K, int Hh, int Wh, int pad, long long ntiles, int nkb) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  StepSmem& st = *reinterpret_cast<StepSmem*>(smem_raw);
  OutSmem& os = *reinterpret_cast<OutSmem*>(smem_raw);

  const int k0 = (blockIdx.x % nkb) * BK;
  const long long t0 = (long long)(blockIdx.x / nkb) * BT;
  const int warp = threadIdx.x / 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][BT / 16][BK / 16];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int tb = 0; tb < BT / 16; ++tb)
#pragma unroll
      for (int kb = 0; kb < BK / 16; ++kb) wmma::fill_fragment(acc[j][tb][kb], 0.f);

  // this thread's transform item: tile tl of the block, channels 4 cg .. 4 cg + 3
  const int tl = threadIdx.x / (BC / CPT);
  const int cg = threadIdx.x % (BC / CPT);
  const long long tile = t0 + tl;
  const bool tvalid = tile < ntiles;
  int n = 0, wr = 0, wc = 0;
  if (tvalid) {
    const long long per = (long long)Hh * Wh;
    n = (int)(tile / per);
    const int rem = (int)(tile % per);
    wr = 2 * (rem / Wh) - pad;   // window origin in the unpadded input
    wc = 2 * (rem % Wh) - pad;
  }

  for (int c0 = 0; c0 < C; c0 += BC) {
    const int ch = c0 + CPT * cg;
    // 1. the 4x4 window for 4 channels, 8 bytes a position
    uint2 raw[4][4];
    bool inside[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int y = wr + r, xx = wc + s;
        inside[r][s] = tvalid && y >= 0 && y < H && xx >= 0 && xx < W;
        raw[r][s] = make_uint2(0u, 0u);
        if (inside[r][s])
          raw[r][s] = *reinterpret_cast<const uint2*>(
              x + (((size_t)n * H + y) * W + xx) * C + ch);
      }
    float aa[CPT] = {0.f, 0.f, 0.f, 0.f}, cc[CPT] = {0.f, 0.f, 0.f, 0.f};
    if constexpr (GN) {
      const float4 a4 = *reinterpret_cast<const float4*>(aff_a + (size_t)n * C + ch);
      const float4 c4 = *reinterpret_cast<const float4*>(aff_c + (size_t)n * C + ch);
      aa[0] = a4.x; aa[1] = a4.y; aa[2] = a4.z; aa[3] = a4.w;
      cc[0] = c4.x; cc[1] = c4.y; cc[2] = c4.z; cc[3] = c4.w;
    }
    // 2. V = (B^T d) B per channel, two roundings, into shared memory
    uint2 packed[16];   // the 4 channels' bf16 values of each product
    __nv_bfloat16* vout = reinterpret_cast<__nv_bfloat16*>(packed);
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      float d[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const __nv_bfloat16* hv = reinterpret_cast<const __nv_bfloat16*>(&raw[r][s]);
          float val = __bfloat162float(hv[i]);
          if constexpr (GN)
            val = inside[r][s]
                      ? round_bf16(fmaxf(__fadd_rn(__fmul_rn(val, aa[i]), cc[i]), 0.f))
                      : 0.f;
          d[r][s] = val;
        }
      float R[4][4];   // R[p][s] = (B^T d)[p][s]
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const float col[4] = {d[0][s], d[1][s], d[2][s], d[3][s]};
        float o[4];
        bt_rounded(col, o);
#pragma unroll
        for (int p = 0; p < 4; ++p) R[p][s] = o[p];
      }
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        float o[4];
        bt_rounded(R[p], o);
#pragma unroll
        for (int q = 0; q < 4; ++q) vout[CPT * (4 * p + q) + i] = __float2bfloat16_rn(o[q]);
      }
    }
#pragma unroll
    for (int pq = 0; pq < 16; ++pq)
      *reinterpret_cast<uint2*>(&st.v[pq][tl * LDV + CPT * cg]) = packed[pq];
    // 3. U's slice: 16 x BC rows of BK channels, 16 bytes a thread a load
    for (int i = threadIdx.x; i < 16 * BC * (BK / 8); i += NTHREAD) {
      const int pq = i / (BC * (BK / 8));
      const int rem = i % (BC * (BK / 8));
      const int row = rem / (BK / 8), c8 = rem % (BK / 8);
      *reinterpret_cast<uint4*>(&st.u[pq][row * LDU + 8 * c8]) =
          *reinterpret_cast<const uint4*>(u + ((size_t)pq * C + c0 + row) * K + k0 + 8 * c8);
    }
    __syncthreads();
    // 4. two of the 16 products a warp
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int pq = 2 * warp + j;
#pragma unroll
      for (int kk = 0; kk < BC / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af[BT / 16];
#pragma unroll
        for (int tb = 0; tb < BT / 16; ++tb)
          wmma::load_matrix_sync(af[tb], &st.v[pq][tb * 16 * LDV + kk * 16], LDV);
#pragma unroll
        for (int kb = 0; kb < BK / 16; ++kb) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf;
          wmma::load_matrix_sync(bf, &st.u[pq][kk * 16 * LDU + kb * 16], LDU);
#pragma unroll
          for (int tb = 0; tb < BT / 16; ++tb)
            wmma::mma_sync(acc[j][tb][kb], af[tb], bf, acc[j][tb][kb]);
        }
      }
    }
    __syncthreads();   // V and U are rewritten next step, M overlays them after
  }

  // 5. the products through shared memory, then A^T M A + bias per (tile, k)
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int tb = 0; tb < BT / 16; ++tb)
#pragma unroll
      for (int kb = 0; kb < BK / 16; ++kb)
        wmma::store_matrix_sync(&os.m[2 * warp + j][tb * 16 * LDM + kb * 16],
                                acc[j][tb][kb], LDM, wmma::mem_row_major);
  __syncthreads();
  const int Wo = 2 * Wh;
  for (int i = threadIdx.x; i < BT * BK; i += NTHREAD) {
    const int t = i / BK, k = i % BK;
    const long long tg = t0 + t;
    if (tg >= ntiles) continue;
    float y[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float m = os.m[4 * p + q][t * LDM + k];
#pragma unroll
        for (int uu = 0; uu < 2; ++uu)
#pragma unroll
          for (int vv = 0; vv < 2; ++vv) {
            const float sign = at(uu, p) * at(vv, q);
            if (sign > 0.f) y[uu][vv] = y[uu][vv] + m;
            else if (sign < 0.f) y[uu][vv] = y[uu][vv] - m;
          }
      }
    const long long per = (long long)Hh * Wh;
    const int ni = (int)(tg / per);
    const int rem = (int)(tg % per);
    const int orow = 2 * (rem / Wh), ocol = 2 * (rem % Wh);
    const float bk = bias[k0 + k];
#pragma unroll
    for (int uu = 0; uu < 2; ++uu)
#pragma unroll
      for (int vv = 0; vv < 2; ++vv)
        out[(((size_t)ni * (2 * Hh) + orow + uu) * Wo + ocol + vv) * K + k0 + k] =
            __float2bfloat16_rn(y[uu][vv] + bk);
  }
}

}  // namespace

// x (N, H, W, C) bf16 contiguous; u (16, C, K) bf16 = G w G^T; bias (K,)
// fp32; aff_a / aff_c (N, C) fp32 for K9b, both null for K9a -> out (N, H',
// W', K) bf16, H' = H (same) or H - 2 (valid). C % 32 == 0, K % 64 == 0,
// even H' and W'. Returns cudaGetLastError() (or cudaErrorInvalidValue on
// a shape the kernel does not take).
extern "C" int winograd_launch(const void* x, const void* u, const void* bias,
                               const void* aff_a, const void* aff_c, void* out,
                               int N, int H, int W, int C, int K, int same,
                               void* stream) {
  const int pad = same ? 1 : 0;
  const int Hh = same ? H / 2 : (H - 2) / 2, Wh = same ? W / 2 : (W - 2) / 2;
  if (C % BC != 0 || K % BK != 0 || H % 2 != 0 || W % 2 != 0 || Hh < 1 || Wh < 1 ||
      (aff_a == nullptr) != (aff_c == nullptr))
    return (int)cudaErrorInvalidValue;
  const long long ntiles = (long long)N * Hh * Wh;
  if (ntiles == 0) return (int)cudaGetLastError();
  const int nkb = K / BK;
  const long long nblocks = (ntiles + BT - 1) / BT * nkb;
  if (nblocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const auto* xb = (const __nv_bfloat16*)x;
  const auto* ub = (const __nv_bfloat16*)u;
  auto* ob = (__nv_bfloat16*)out;
  cudaError_t e;
  if (aff_a != nullptr) {
    e = cudaFuncSetAttribute(winograd_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    winograd_kernel<true><<<(unsigned)nblocks, NTHREAD, SMEM_BYTES, s>>>(
        xb, ub, (const float*)bias, (const float*)aff_a, (const float*)aff_c, ob, H, W,
        C, K, Hh, Wh, pad, ntiles, nkb);
  } else {
    e = cudaFuncSetAttribute(winograd_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    winograd_kernel<false><<<(unsigned)nblocks, NTHREAD, SMEM_BYTES, s>>>(
        xb, ub, (const float*)bias, nullptr, nullptr, ob, H, W, C, K, Hh, Wh, pad,
        ntiles, nkb);
  }
  return (int)cudaGetLastError();
}
