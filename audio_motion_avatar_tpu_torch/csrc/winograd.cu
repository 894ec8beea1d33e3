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
// column combination R B to bf16 (each a bf16 add of two bf16 values, one
// rounding: the same value as the fp32 sum rounded to bf16). In the GN
// variant relu(a x + c) is taken in fp32 (no fused multiply-add, as the
// plain version), rounded to bf16, and a window position outside the image
// (SAME padding) is zero after the affine, since relu(c) != 0. The 16
// products accumulate in fp32, A^T M A and the bias in fp32, one rounding of
// the output.
//
// Bound on the H100: operations of the 16 products, 2 * 16 * tiles * C * K
// FLOP at 989 TFLOP/s (0.625 ms at (18, 256^2, 256) SAME); the bytes (input,
// weights, output once) take 0.36 ms there.
//
// Design for Hopper. A block of two warpgroups owns BT = 128 consecutive
// output tiles (tiles may span images: the VALID convs of many 20^2
// windows) and BK = 64 output channels, and walks the input channels in
// chunks of CC = 32. The register file sets the block: 16 products of
// 128 x 64 fp32 accumulators would need 512 KB, so each warpgroup keeps
// only the four outputs Y[u][v] of its 64 tiles x 64 channels (128 fp32 a
// thread) and lets the tensor cores apply A^T M A: Y[u][v] += A^T[u][p]
// A^T[v][q] V[pq] U[pq] over the 36 nonzero (pq, uv), the sign as wgmma's
// scale of U (m64n64k16, V and U from shared memory, one commit and one wait
// a chunk). That is 36 products where 16 would do, but no fold of products
// into the outputs on the fp32 pipes and no product registers: measured on
// the H100, folding 16 products (each into fresh registers) cost more than
// the 20 extra products, and its register pressure spilled. U is read from
// L2 once per 128 tiles.
// The cs blocks of a cluster (cs = 2 when K has an even number of 64-channel
// blocks) own the same tiles and different output channels: each assembles
// and transforms a cs-th of the tiles' windows and stores the 16 transformed
// values into V of every block of the cluster (distributed shared memory),
// which halves the window loads from L2 and the transform work a block
// (the window loads were the largest cost of the kernel without it). Each
// chunk: one thread asks TMA for U's 16 x 32 x 64 slice (128-byte swizzled
// rows, read MN-major as wgmma's B); every thread assembles one (tile, 4
// channels) window straight from device memory (8-byte loads), transforms
// it in bf16 pairs and stores the 16 values as K-major core matrices
// (wgmma's A: 8 tiles x 16 bytes, no swizzle; a warp's 32 items fill 256
// contiguous bytes); a cluster barrier; the 36 products; a cluster barrier.
// The bias and the one rounding run from the registers, stored as bf16
// pairs.

#include <cooperative_groups.h>

#include "sm90.cuh"

namespace {

using namespace sm90;
namespace cg = cooperative_groups;

constexpr int BT = 128;                // output tiles a block
constexpr int BK = 64;                 // output channels a block
constexpr int CC = 32;                 // input channels a chunk
constexpr int NTHREAD = 256;           // two warpgroups of 64 tiles each
constexpr int ITEMS = BT * CC / 4 / NTHREAD;   // (tile, 4 channels) items a thread
                                               // of a cluster of one block
constexpr int MAX_CLUSTER = 2;                 // blocks sharing a tile block's transform
constexpr uint32_t U_BYTES = CC * BK * 2;      // one product's U slice
constexpr uint32_t V_BYTES = BT * CC * 2;      // one product's transformed input
constexpr uint32_t V_LBO = 128;                // core matrices along the channels
constexpr uint32_t V_SBO = (CC / 8) * 128;     // 8-tile groups
static_assert(ITEMS == 4 && CC / 4 == 8, "item i: c4 in bits 3-5, 8-tile group i >> 6");

struct __align__(1024) Smem {
  __nv_bfloat16 u[16][CC * BK];
  __nv_bfloat16 v[16][BT * CC];
  int4 tiles[BT];
  uint64_t u_full;
};
constexpr size_t SMEM_BYTES = sizeof(Smem) + 1024;

// A^T's entries: row 0 = (1, 1, 1, 0), row 1 = (0, 1, -1, -1)
__host__ __device__ constexpr int at(int u, int p) {
  return u == 0 ? (p < 3 ? 1 : 0) : (p == 0 ? 0 : (p == 1 ? 1 : -1));
}

// B^T row p as a signed pair of taps: p0: t0 - t2, p1: t1 + t2, p2: t2 - t1,
// p3: t1 - t3; a bf16 add rounds once
__device__ __forceinline__ void bt_pair(const __nv_bfloat162 t[4], __nv_bfloat162 o[4]) {
  o[0] = __hsub2(t[0], t[2]);
  o[1] = __hadd2(t[1], t[2]);
  o[2] = __hsub2(t[2], t[1]);
  o[3] = __hsub2(t[1], t[3]);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void fence_acc4(float (&y)[4][32]) {
#pragma unroll
  for (int o = 0; o < 4; ++o) fence_acc(y[o]);
}

// One item's window `raw` (tile info ti: image, window origin; 4 channels at
// ch): the GN affine (K9b), V = (B^T d) B with two roundings, the 16 values
// stored at byte `off` of V[pq] in every block of the cluster.
template <bool GN>
__device__ __forceinline__ void transform_store(const uint2 (&raw)[4][4], int4 ti,
                                                const float* __restrict__ aff_a,
                                                const float* __restrict__ aff_c, int C, int ch,
                                                int H, int W, unsigned char* const (&vdst)[MAX_CLUSTER],
                                                uint32_t off, int cs) {
  __nv_bfloat162 d[4][4][2];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      d[r][s][0] = *reinterpret_cast<const __nv_bfloat162*>(&raw[r][s].x);
      d[r][s][1] = *reinterpret_cast<const __nv_bfloat162*>(&raw[r][s].y);
    }
  if constexpr (GN) {
    if (ti.x >= 0) {
      const float4 a4 = *reinterpret_cast<const float4*>(aff_a + (size_t)ti.x * C + ch);
      const float4 c4v = *reinterpret_cast<const float4*>(aff_c + (size_t)ti.x * C + ch);
      const float aa[4] = {a4.x, a4.y, a4.z, a4.w}, cc[4] = {c4v.x, c4v.y, c4v.z, c4v.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const int yy = ti.y + r, xx = ti.z + s;
          if (yy < 0 || yy >= H || xx < 0 || xx >= W) continue;   // border: 0
#pragma unroll
          for (int w = 0; w < 2; ++w) {
            const float lo = round_bf16(fmaxf(
                __fadd_rn(__fmul_rn(__low2float(d[r][s][w]), aa[2 * w]), cc[2 * w]), 0.f));
            const float hi = round_bf16(fmaxf(
                __fadd_rn(__fmul_rn(__high2float(d[r][s][w]), aa[2 * w + 1]), cc[2 * w + 1]),
                0.f));
            d[r][s][w] = __floats2bfloat162_rn(lo, hi);
          }
        }
    }
  }
  // R[p][s] = (B^T d)[p][s], in place column by column
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      const __nv_bfloat162 col[4] = {d[0][s][w], d[1][s][w], d[2][s][w], d[3][s][w]};
      __nv_bfloat162 o[4];
      bt_pair(col, o);
#pragma unroll
      for (int p = 0; p < 4; ++p) d[p][s][w] = o[p];
    }
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    __nv_bfloat162 o0[4], o1[4];
    const __nv_bfloat162 r0[4] = {d[p][0][0], d[p][1][0], d[p][2][0], d[p][3][0]};
    const __nv_bfloat162 r1[4] = {d[p][0][1], d[p][1][1], d[p][2][1], d[p][3][1]};
    bt_pair(r0, o0);
    bt_pair(r1, o1);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint2 val;
      val.x = *reinterpret_cast<uint32_t*>(&o0[q]);
      val.y = *reinterpret_cast<uint32_t*>(&o1[q]);
#pragma unroll
      for (int dd = 0; dd < MAX_CLUSTER; ++dd)
        if (dd < cs) *reinterpret_cast<uint2*>(vdst[dd] + off + (4 * p + q) * V_BYTES) = val;
    }
  }
}

template <bool GN>
__global__ void __launch_bounds__(NTHREAD, 1) winograd_kernel(
    const __grid_constant__ CUtensorMap tu, const __nv_bfloat16* __restrict__ x,
    const float* __restrict__ bias, const float* __restrict__ aff_a,
    const float* __restrict__ aff_c, __nv_bfloat16* __restrict__ out, int H, int W, int C,
    int K, int Hh, int Wh, int pad, long long ntiles, int nkb, int cs) {
  extern __shared__ unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  const int tid = threadIdx.x;
  const int k0 = (blockIdx.x % nkb) * BK;
  const long long t0 = (long long)(blockIdx.x / nkb) * BT;
  const long long per = (long long)Hh * Wh;

  if (tid == 0) {
    mbar_init(&sm.u_full, 1);
    fence_barrier_init();
  }
  // the block's tiles: image and window origin in the unpadded input, or
  // image -1 past the last tile
  for (int t = tid; t < BT; t += NTHREAD) {
    const long long tile = t0 + t;
    const int rem = (int)(tile % per);
    sm.tiles[t] = tile < ntiles ? make_int4((int)(tile / per), 2 * (rem / Wh) - pad,
                                            2 * (rem % Wh) - pad, 0)
                                : make_int4(-1, 0, 0, 0);
  }
  cluster.sync();   // barriers and tiles set; every block of the cluster runs
  // The block's items are (tile 8 (i >> 6) + (i & 7), channels 4 c4 .. 4 c4
  // + 3 of the chunk), i < 1024, c4 = (i >> 3) & 7 (a warp's 32 items fill 256
  // contiguous bytes of V). The cs blocks of a cluster share one tile block
  // (cs of its output-channel blocks): each transforms a cs-th of the items
  // (rounds of i = tid + 256 (rank rounds + it)) and stores them into the V of
  // every block of the cluster.
  const int c4 = (tid >> 3) & 7;
  const int rounds = ITEMS / cs;

  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  float y[4][32];   // the outputs Y[2 u + v] of this warpgroup's tiles
#pragma unroll
  for (int o = 0; o < 4; ++o)
#pragma unroll
    for (int i = 0; i < 32; ++i) y[o][i] = 0.f;
  const uint64_t desc_v0 = desc_add(desc_interleave(sm.v[0], V_LBO, V_SBO), wg * 64 * CC * 2);
  const uint64_t desc_u0 = desc_sw128(sm.u[0]);

  const int nchunks = C / CC;
  for (int chunk = 0; chunk < nchunks; ++chunk) {
    const int c0 = chunk * CC;
    if (tid == 0) {
      mbar_expect_tx(&sm.u_full, 16 * U_BYTES);
#pragma unroll 1
      for (int pq = 0; pq < 16; ++pq) tma_load_3d(sm.u[pq], &tu, &sm.u_full, k0, c0, pq);
    }
    // 1. windows -> V = (B^T d) B, two roundings, into the cluster's V
    const int ch = c0 + 4 * c4;
    unsigned char* vdst[MAX_CLUSTER];
#pragma unroll
    for (int d = 0; d < MAX_CLUSTER; ++d)
      vdst[d] = cluster.map_shared_rank(reinterpret_cast<unsigned char*>(sm.v[0]),
                                        d < cs ? d : 0);
#pragma unroll 1
    for (int it = 0; it < rounds; ++it) {
      const int i = tid + NTHREAD * (rank * rounds + it);
      const int4 ti = sm.tiles[(i >> 6) * 8 + (i & 7)];
      uint2 raw[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const int yy = ti.y + r, xx = ti.z + s;
          raw[r][s] = make_uint2(0u, 0u);
          if (ti.x >= 0 && yy >= 0 && yy < H && xx >= 0 && xx < W)
            raw[r][s] =
                *reinterpret_cast<const uint2*>(x + (((size_t)ti.x * H + yy) * W + xx) * C + ch);
        }
      const uint32_t off = (i >> 6) * V_SBO + (c4 >> 1) * V_LBO + (i & 7) * 16 + (c4 & 1) * 8;
      transform_store<GN>(raw, ti, aff_a, aff_c, C, ch, H, W, vdst, off, cs);
    }
    fence_proxy_async_all();
    cluster.sync();   // the cluster's V of this chunk is complete
    fence_proxy_async();
    mbar_wait(&sm.u_full, chunk & 1);

    // 2. Y[2 u + v] += A^T[u][p] A^T[v][q] V[pq] U[pq] over the 36 nonzero
    //    (pq, uv), the sign as wgmma's scale of U
    fence_acc4(y);
    wgmma_fence();
#pragma unroll
    for (int pq = 0; pq < 16; ++pq)
#pragma unroll
      for (int o = 0; o < 4; ++o) {
        const int sign = at(o >> 1, pq / 4) * at(o & 1, pq % 4);
#pragma unroll
        for (int kk = 0; kk < CC / 16; ++kk) {
          const uint64_t dv = desc_add(desc_v0, pq * V_BYTES + kk * 2 * V_LBO);
          const uint64_t du = desc_add(desc_u0, pq * U_BYTES + kk * 2048);
          if (sign > 0) wgmma_ss<0, 1, 1>(y[o], dv, du, 1);
          else if (sign < 0) wgmma_ss<0, 1, -1>(y[o], dv, du, 1);
        }
      }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc4(y);
    cluster.sync();   // V (by every block of the cluster) and U are rewritten next
  }

  // 3. bias, one rounding, bf16 pairs: rows are tiles, columns channels
  const int cq = 2 * (lane % 4);
  float2 bj[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) bj[j] = *reinterpret_cast<const float2*>(bias + k0 + 8 * j + cq);
  const int Wo = 2 * Wh;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long tg = t0 + 64 * wg + 16 * warp + lane / 4 + 8 * h;
    if (tg >= ntiles) continue;
    const int ni = (int)(tg / per);
    const int rem = (int)(tg % per);
    const int orow = 2 * (rem / Wh), ocol = 2 * (rem % Wh);
#pragma unroll
    for (int o = 0; o < 4; ++o) {
      __nv_bfloat16* dst =
          out + (((size_t)ni * (2 * Hh) + orow + (o >> 1)) * Wo + ocol + (o & 1)) * K + k0 + cq;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int idx = 4 * j + 2 * h;
        *reinterpret_cast<uint32_t*>(dst + 8 * j) =
            pack_bf16(y[o][idx] + bj[j].x, y[o][idx + 1] + bj[j].y);
      }
    }
  }
}

}  // namespace

// dynamic shared memory of a block
extern "C" int winograd_smem() { return (int)SMEM_BYTES; }

// x (N, H, W, C) bf16 contiguous; u (16, C, K) bf16 = G w G^T; bias (K,)
// fp32; aff_a / aff_c (N, C) fp32 for K9b, both null for K9a -> out (N, H',
// W', K) bf16, H' = H (same) or H - 2 (valid). C % 32 == 0, K % 64 == 0,
// even H' and W'. Returns cudaGetLastError() (or cudaErrorInvalidValue on
// a shape the kernel does not take or a tensor map that cannot be encoded).
extern "C" int winograd_launch(const void* x, const void* u, const void* bias,
                               const void* aff_a, const void* aff_c, void* out,
                               int N, int H, int W, int C, int K, int same,
                               void* stream) {
  const int pad = same ? 1 : 0;
  const int Hh = same ? H / 2 : (H - 2) / 2, Wh = same ? W / 2 : (W - 2) / 2;
  if (C % CC != 0 || K % BK != 0 || H % 2 != 0 || W % 2 != 0 || Hh < 1 || Wh < 1 ||
      (aff_a == nullptr) != (aff_c == nullptr))
    return (int)cudaErrorInvalidValue;
  const long long ntiles = (long long)N * Hh * Wh;
  if (ntiles == 0) return (int)cudaGetLastError();
  const int nkb = K / BK;
  const long long nblocks = (ntiles + BT - 1) / BT * nkb;
  if (nblocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  CUtensorMap tu;
  if (!make_map_3d(&tu, u, K, C, 16, BK, CC)) return (int)cudaErrorInvalidValue;
  // a cluster: two output-channel blocks of one tile block
  const int cs = nkb % 2 == 0 ? 2 : 1;
  const auto* xb = (const __nv_bfloat16*)x;
  auto* ob = (__nv_bfloat16*)out;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)nblocks);
  cfg.blockDim = dim3(NTHREAD);
  cfg.dynamicSmemBytes = SMEM_BYTES;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e;
  if (aff_a != nullptr) {
    e = cudaFuncSetAttribute(winograd_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    e = cudaLaunchKernelEx(&cfg, winograd_kernel<true>, tu, xb, (const float*)bias,
                           (const float*)aff_a, (const float*)aff_c, ob, H, W, C, K, Hh, Wh,
                           pad, ntiles, nkb, cs);
  } else {
    e = cudaFuncSetAttribute(winograd_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    e = cudaLaunchKernelEx(&cfg, winograd_kernel<false>, tu, xb, (const float*)bias,
                           (const float*)nullptr, (const float*)nullptr, ob, H, W, C, K, Hh,
                           Wh, pad, ntiles, nkb, cs);
  }
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
