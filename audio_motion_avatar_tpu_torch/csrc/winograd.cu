// Kernels K9a and K9b: 3x3 stride-1 convolution by Winograd F(2x2, 3x3),
// NHWC, bf16 operands.
//
// Replaces the TPU kernels of the JAX package's ops/winograd.py:
// `_wino_kernel` via winograd_conv3x3 (K9a) and `_wino_gn_kernel` via
// winograd_conv3x3_gn_relu (K9b), which computes conv3x3(relu(a x + c)) with
// a per-image channel affine (a folded GroupNorm) fused into the window
// assembly.
//
// Per 2x2 output tile with 4x4 input window d: Y = A^T [U . (B^T d B)] A,
// U = G w G^T (16, C, K) computed by the wrapper in fp32 and rounded to
// bf16. The input transform rounds as the JAX kernel and the plain version
// (ops/winograd.py) do: the row combination R = B^T d to bf16, then the
// column combination R B to bf16 (each a bf16 add of two bf16 values, one
// rounding: the same value as the fp32 sum rounded to bf16). In K9b relu(a x
// + c) is taken in fp32 (no fused multiply-add, as the plain version) and
// rounded to bf16 once, and a window position outside the image (SAME
// padding) is zero after the affine, since relu(c) != 0. The 16 products
// accumulate in fp32, A^T M A and the bias in fp32, one rounding of the
// output.
//
// Bound on the H100: operations of the 16 products, 2 * 16 * tiles * C * K
// FLOP at 989 TFLOP/s (0.625 ms at (18, 256^2, 256) SAME); the bytes (input,
// weights, output once) take 0.36 ms there.
//
// Design for Hopper, common to both kernels below. The register file sets
// the shape: 16 products of 64 x 64 fp32 accumulators would need 256 KB a
// warpgroup, so a consumer warpgroup keeps only the four outputs Y[u][v] of
// its 64 tiles x 64 output channels (128 fp32 a thread) and lets the tensor
// cores apply A^T M A: Y[u][v] += A^T[u][p] A^T[v][q] V[pq] U[pq] over the
// 36 nonzero (pq, uv), the sign as wgmma's scale of U (m64n64k16, V and U
// from shared memory). That is 36 products where 16 would do, but no fold of
// products into the outputs on the fp32 pipes and no product registers:
// measured on the H100, folding 16 products (each into fresh registers)
// cost more than the 20 extra products, and its register pressure spilled.
// U comes by TMA (128-byte swizzled rows, read MN-major as wgmma's B); the
// transformed input V is stored by threads as K-major core matrices
// (wgmma's A: 8 tiles x 16 bytes, no swizzle). The bias and the one
// rounding run from the registers, stored as bf16 pairs.
//
// The raster kernel (`winograd_kernel`; K9a's VALID convs of many small
// windows and any shape the rectangles would not tile exactly): blocks of
// 128 consecutive tiles in raster order (they may span images) x 64
// channels, two warpgroups, input channels in chunks of 32. The two blocks
// of a cluster own the same tiles and different channels: each assembles
// half of the windows straight from device memory (8-byte loads),
// transforms them in bf16 pairs and stores them into V of both blocks
// (distributed shared memory); a cluster barrier; the 36 products; a
// cluster barrier.
//
// The rectangle kernel (`winograd_rect_kernel`; K9b always, K9a where the
// rectangles tile every image exactly, as on the serving path's dense
// levels): blocks of a TR x TC rectangle of 64 tiles of one image (TC = 32,
// or 16 where the image is at most 16 tiles wide) x 128 channels, warp
// specialized over chunks of 16 input channels in a two-stage ring:
//  - a producer warpgroup copies the rectangle's input rows with the halo,
//    (2 TR + 2) x (2 TC + 2) positions, into shared memory by 16-byte
//    cp.async (zero outside the image), applies K9b's relu(a x + c) there
//    once per input element (not once per window position: the 4x4
//    windows of stride 2 overlap four times), assembles the windows from
//    it and stores V; it runs up to two chunks ahead of the products;
//  - two consumer warpgroups (64 channels each) run the 36 products of
//    each chunk on the V they share;
//  - the cluster's two blocks own two rectangles and the same channels:
//    each loads half of U's boxes by TMA multicast into both, so U crosses
//    L2 once per 128 tiles; a stage is free again when both blocks'
//    consumers are done with it.
// The region's 128-byte lines are XOR-swizzled (8 x 16-byte pieces) so that
// a warp's window reads (8 consecutive tiles, 2 positions apart) hit
// distinct banks. Measured (kernel_probe.py's timeline of the SM clock),
// the producer takes twice the products' time a chunk: the next step is
// more producer warps, which needs registers moved from the consumers.
// The two kernels store the same V; they sum the products in another
// order (chunks of 32 against 16 channels), so their outputs agree within
// the fp32 sums' rounding, not bit for bit.

#include <cooperative_groups.h>

#include <type_traits>

#include "sm90.cuh"

// Phase probe, compiled only with -DWINOGRAD_PROBE (kernel_probe.py builds
// such a library apart): a mask in device memory skips phases of the kernels
// so that the cost of each can be timed; the output is then meaningless.
#ifdef WINOGRAD_PROBE
__device__ int g_probe_skip;
#define PROBE_SKIP(bit) ((g_probe_skip & (bit)) != 0)
extern "C" int winograd_probe_set(int mask) {
  return (int)cudaMemcpyToSymbol(g_probe_skip, &mask, sizeof(int));
}
// the mask's bits: window loads (the rectangle kernel: the region's
// copies), the GroupNorm affine, the input transform and its stores, the
// products, (the raster kernel) the per-chunk cluster barriers, (the
// rectangle kernel) U's copies after the first two chunks
constexpr int SKIP_LOADS = 1, SKIP_AFFINE = 2, SKIP_TRANSFORM = 4, SKIP_PRODUCTS = 8,
              SKIP_BARRIERS = 16, SKIP_U = 32;
// a timeline of one cluster of the rectangle kernel (the one in the middle
// of the grid): the SM clock of the producer's first thread at points 0-4
// and of the first consumer thread at points 5-7 of each of the first 8
// chunks, in each block of the cluster
__device__ long long g_probe_clock[2][8][8];
#define PROBE_MARK(chunk, point)                                                      \
  if (threadIdx.x % 256 == 0 && (chunk) < 8 && blockIdx.x / 2 == gridDim.x / 4)       \
    g_probe_clock[blockIdx.x & 1][chunk][point] = clock64();
extern "C" int winograd_probe_clock(long long* host) {
  return (int)cudaMemcpyFromSymbol(host, g_probe_clock, sizeof(g_probe_clock));
}
#else
#define PROBE_SKIP(bit) false
#define PROBE_MARK(chunk, point)
#endif

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

// The rectangle kernel: blocks of RT = 64 tiles x RK = 128 output channels,
// a producer warpgroup and two consumer warpgroups (64 channels each), the
// input channels in chunks of RCC = 16 through two stages of U, V and the
// staged input rows (the larger of TC = 32: 6 rows x 66 columns, and
// TC = 16: 10 x 34; 16 bf16 channels a position).
constexpr int RT = 64, RK = 128, RCC = 16, RTHREAD = 384;
constexpr uint32_t RV_PQ = RT * RCC * 2;       // one product's V
constexpr uint32_t RU_PQ = RCC * BK * 2;       // one product's U, one consumer's channels
constexpr uint32_t RV_SBO = (RCC / 8) * 128;   // 8-tile groups of V
constexpr int REGION_BYTES = 6 * 66 * RCC * 2;
static_assert(10 * 34 * RCC * 2 <= REGION_BYTES && REGION_BYTES % 128 == 0, "the regions fit");

struct __align__(1024) RectSmem {
  __nv_bfloat16 u[2][2][16][RCC * BK];   // [stage][consumer][pq]
  __nv_bfloat16 v[2][16][RT * RCC];      // [stage][pq]
  alignas(128) unsigned char region[2][REGION_BYTES];
  uint64_t u_full[2], v_full[2], empty[2];
};
constexpr size_t RECT_SMEM_BYTES = sizeof(RectSmem) + 1024;

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

__device__ __forceinline__ void fence_acc4(float (&y)[4][32]) {
#pragma unroll
  for (int o = 0; o < 4; ++o) fence_acc(y[o]);
}

// One item's window `raw` (4 channels a position): V = (B^T d) B with two
// roundings, the 16 values stored at byte `off` of V[pq] (PQ_BYTES apart)
// in the first cs blocks of the cluster.
template <uint32_t PQ_BYTES>
__device__ __forceinline__ void transform_store(const uint2 (&raw)[4][4],
                                                unsigned char* const (&vdst)[MAX_CLUSTER],
                                                uint32_t off, int cs) {
  __nv_bfloat162 d[4][4][2];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      d[r][s][0] = *reinterpret_cast<const __nv_bfloat162*>(&raw[r][s].x);
      d[r][s][1] = *reinterpret_cast<const __nv_bfloat162*>(&raw[r][s].y);
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
        if (dd < cs) *reinterpret_cast<uint2*>(vdst[dd] + off + (4 * p + q) * PQ_BYTES) = val;
    }
  }
}

// byte of item i's 8 bytes in V[pq]: tile 8 (i >> 6) + (i & 7), channels
// 4 c4 .. 4 c4 + 3 (a warp's 32 items fill 256 contiguous bytes)
__device__ __forceinline__ uint32_t v_offset(int i, int c4) {
  return (i >> 6) * V_SBO + (c4 >> 1) * V_LBO + (i & 7) * 16 + (c4 & 1) * 8;
}

// Y[2 u + v] += A^T[u][p] A^T[v][q] V[pq] U[pq] over the 36 nonzero (pq, uv),
// the sign as wgmma's scale of U (V[pq], U[pq] VPQ, UPQ bytes apart, KS
// 16-deep steps a chunk); issued, not waited for
template <uint32_t VPQ, uint32_t UPQ, int KS>
__device__ __forceinline__ void issue_products(float (&y)[4][32], uint64_t desc_v0,
                                               uint64_t desc_u0) {
  fence_acc4(y);
  wgmma_fence();
  if (!PROBE_SKIP(SKIP_PRODUCTS)) {
#pragma unroll
    for (int pq = 0; pq < 16; ++pq)
#pragma unroll
      for (int o = 0; o < 4; ++o) {
        const int sign = at(o >> 1, pq / 4) * at(o & 1, pq % 4);
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          const uint64_t dv = desc_add(desc_v0, pq * VPQ + kk * 2 * V_LBO);
          const uint64_t du = desc_add(desc_u0, pq * UPQ + kk * 2048);
          if (sign > 0) wgmma_ss<0, 1, 1>(y[o], dv, du, 1);
          else if (sign < 0) wgmma_ss<0, 1, -1>(y[o], dv, du, 1);
        }
      }
  }
  wgmma_commit();
}

// The bias, one rounding, bf16 pairs: the warpgroup's accumulator rows are
// the block's tiles row0 .. row0 + 63, its columns channels k0 .. k0 + 63.
// tile_at(t) gives tile t's (image, tile row, tile column), image -1 where
// there is no tile.
template <typename TileAt>
__device__ __forceinline__ void store_outputs(const float (&y)[4][32],
                                              const float* __restrict__ bias,
                                              __nv_bfloat16* __restrict__ out, int k0, int K,
                                              int Hh, int Wh, int row0, TileAt tile_at) {
  const int tid = threadIdx.x;
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int cq = 2 * (lane % 4);
  float2 bj[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) bj[j] = *reinterpret_cast<const float2*>(bias + k0 + 8 * j + cq);
  const int Wo = 2 * Wh;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int3 ti = tile_at(row0 + 16 * warp + lane / 4 + 8 * h);
    if (ti.x < 0) continue;
    const int orow = 2 * ti.y, ocol = 2 * ti.z;
#pragma unroll
    for (int o = 0; o < 4; ++o) {
      __nv_bfloat16* dst =
          out + (((size_t)ti.x * (2 * Hh) + orow + (o >> 1)) * Wo + ocol + (o & 1)) * K + k0 + cq;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int idx = 4 * j + 2 * h;
        *reinterpret_cast<uint32_t*>(dst + 8 * j) =
            pack_bf16(y[o][idx] + bj[j].x, y[o][idx + 1] + bj[j].y);
      }
    }
  }
}

__global__ void __launch_bounds__(NTHREAD, 1) winograd_kernel(
    const __grid_constant__ CUtensorMap tu, const __nv_bfloat16* __restrict__ x,
    const float* __restrict__ bias, __nv_bfloat16* __restrict__ out, int H, int W, int C, int K,
    int Hh, int Wh, int pad, long long ntiles, int nkb, int cs) {
  extern __shared__ unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  Smem& sm = aligned_smem<Smem>(smem_raw);
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
  // + 3 of the chunk), i < 1024, c4 = (i >> 3) & 7. The cs blocks of a
  // cluster share one tile block (cs of its output-channel blocks): each
  // transforms a cs-th of the items (rounds of i = tid + 256 (rank rounds +
  // it)) and stores them into the V of every block of the cluster.
  const int c4 = (tid >> 3) & 7;
  const int rounds = ITEMS / cs;

  const int wg = tid / 128;
  float y[4][32];   // the outputs Y[2 u + v] of this warpgroup's tiles
#pragma unroll
  for (int o = 0; o < 4; ++o)
#pragma unroll
    for (int i = 0; i < 32; ++i) y[o][i] = 0.f;
  const uint64_t desc_v0 = desc_add(desc_interleave(sm.v[0], V_LBO, V_SBO), wg * 64 * CC * 2);
  const uint64_t desc_u0 = desc_sw128(sm.u[0]);

  const int nchunks = C / CC;
#ifdef WINOGRAD_PROBE
  uint32_t sink = 0;
#endif
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
          if (ti.x >= 0 && yy >= 0 && yy < H && xx >= 0 && xx < W && !PROBE_SKIP(SKIP_LOADS))
            raw[r][s] =
                *reinterpret_cast<const uint2*>(x + (((size_t)ti.x * H + yy) * W + xx) * C + ch);
        }
#ifdef WINOGRAD_PROBE
      if (PROBE_SKIP(SKIP_TRANSFORM)) {   // keep the loads alive
        for (int r = 0; r < 4; ++r)
          for (int s = 0; s < 4; ++s) sink ^= raw[r][s].x ^ raw[r][s].y;
        continue;
      }
#endif
      transform_store<V_BYTES>(raw, vdst, v_offset(i, c4), cs);
    }
    fence_proxy_async_all();
    if (!PROBE_SKIP(SKIP_BARRIERS)) cluster.sync();   // the cluster's V of this chunk is complete
    fence_proxy_async();
    mbar_wait(&sm.u_full, chunk & 1);

    // 2. the 36 products
    issue_products<V_BYTES, U_BYTES, CC / 16>(y, desc_v0, desc_u0);
    wgmma_wait<0>();
    fence_acc4(y);
    if (!PROBE_SKIP(SKIP_BARRIERS))
      cluster.sync();   // V (by every block of the cluster) and U are rewritten next
    else
      __syncthreads();   // (probe) thread 0 may not run ahead to the next U
  }
#ifdef WINOGRAD_PROBE
  cluster.sync();   // no block leaves while another may still store into its V
  if (sink == 0x9e3779b9u) y[0][0] += 1.f;
#endif

  // 3. bias, one rounding, bf16 pairs
  store_outputs(y, bias, out, k0, K, Hh, Wh, 64 * wg, [&](int t) {
    const long long tg = t0 + t;
    if (tg >= ntiles) return make_int3(-1, 0, 0);
    const int rem = (int)(tg % per);
    return make_int3((int)(tg / per), rem / Wh, rem % Wh);
  });
}

// ---- the rectangle kernel ----------------------------------------------------------------

__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// wait until at most N of this thread's copy groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// one box of U into the same offset of every block of the cluster in `mask`,
// completing on each one's barrier at `bar`'s offset
__device__ __forceinline__ void tma_load_3d_multicast(void* dst, const CUtensorMap* map,
                                                      uint64_t* bar, int c0, int c1, int c2,
                                                      uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%3, %4, %5}], [%2], %6;" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "h"(mask)
      : "memory");
}

// arrive on the barrier at `bar`'s offset in block `rank` of the cluster
__device__ __forceinline__ void mbar_arrive_remote(uint64_t* bar, uint32_t rank) {
  asm volatile(
      "{\n"
      ".reg .b32 ra;\n"
      "mapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [ra];\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(rank)
      : "memory");
}

// mbar_wait with cluster-scope acquire: the phase was completed by
// arrivals from both blocks of the cluster
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 26)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// a barrier of the producer warpgroup's 128 threads alone
__device__ __forceinline__ void producer_sync() { asm volatile("bar.sync 1, 128;" ::: "memory"); }

// byte of 16-byte piece g (channels 8 g .. 8 g + 7 of the chunk) of region
// position p: four positions a 128-byte line, its 8 pieces XOR-swizzled by
// the line index
__device__ __forceinline__ uint32_t region_offset(int p, int g) {
  const int line = p >> 2;
  return line * 128 + ((((p & 3) << 1) | g) ^ (line & 7)) * 16;
}

// relu(a x + c) of 8 bf16 values: fp32 mul then add (no FMA), relu, one
// bf16 rounding
__device__ __forceinline__ uint4 affine8(uint4 v, const float (&a)[8], const float (&c)[8]) {
  uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&w[j]);
    const float lo = fmaxf(__fadd_rn(__fmul_rn(__low2float(h), a[2 * j]), c[2 * j]), 0.f);
    const float hi = fmaxf(__fadd_rn(__fmul_rn(__high2float(h), a[2 * j + 1]), c[2 * j + 1]), 0.f);
    w[j] = pack_bf16(lo, hi);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <bool GN, int TC>
__global__ void __launch_bounds__(RTHREAD, 1) winograd_rect_kernel(
    const __grid_constant__ CUtensorMap tu, const __nv_bfloat16* __restrict__ x,
    const float* __restrict__ bias, const float* __restrict__ aff_a,
    const float* __restrict__ aff_c, __nv_bfloat16* __restrict__ out, int H, int W, int C,
    int K, int Hh, int Wh, int pad, int ntr, int ntc, int ntb, int nkb) {
  constexpr int TR = RT / TC;          // tile rows of the rectangle
  constexpr int RC = 2 * TC + 2;       // staged columns (input positions)
  constexpr int NPIECE = (2 * TR + 2) * RC * 2;   // 16-byte pieces of a chunk's region
  constexpr int ROUNDS = (NPIECE + 127) / 128;
  constexpr uint32_t U_STAGE = 2 * 16 * RU_PQ, V_STAGE = 16 * RV_PQ;
  static_assert(NPIECE * 16 <= REGION_BYTES && TC % 8 == 0, "the region fits");
  extern __shared__ unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const uint32_t rank = cluster.block_rank();
  RectSmem& sm = aligned_smem<RectSmem>(smem_raw);
  const int tid = threadIdx.x;
  // the cluster's two blocks: two tile rectangles (the second past the last
  // one where their count is odd), the same 128 output channels
  const int cl = blockIdx.x / 2;
  const int k0 = (cl % nkb) * RK;
  const int tb = (cl / nkb) * 2 + (int)rank;
  const bool has_tiles = tb < ntb;
  const int n = has_tiles ? tb / (ntr * ntc) : 0;
  const int tr0 = (tb / ntc) % ntr * TR, tc0 = tb % ntc * TC;
  const int nchunks = C / RCC;

  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < 2; ++st) {
      mbar_init(&sm.u_full[st], 1);
      mbar_init(&sm.v_full[st], 128);
      mbar_init(&sm.empty[st], 2 * 256);   // both blocks' consumers: U is shared
    }
    fence_barrier_init();
  }
  cluster.sync();   // barriers set in both blocks; both run

  if (tid >= 256) {
    // ---- producer: per chunk, the region (copies, then relu(a x + c) in
    // K9b), U's half by multicast TMA, the windows transformed into V ----
    const int pt = tid - 256;
    const int g = pt & 1;   // the thread's piece of every position: channels 8 g .. 8 g + 7
    const int ry0 = 2 * tr0 - pad, cx0 = 2 * tc0 - pad;
    const __nv_bfloat16* xn = x + (size_t)n * H * W * C + 8 * g;
    // the thread's pieces, the same in every chunk but for the channels:
    // source (elements past xn; -1 outside the image) and destination byte
    long long src[ROUNDS];
    uint32_t dst[ROUNDS];
#pragma unroll
    for (int m = 0; m < ROUNDS; ++m) {
      const int k = pt + 128 * m;
      const int p = k >> 1, yy = ry0 + p / RC, xx = cx0 + p % RC;
      const bool in = has_tiles && k < NPIECE && yy >= 0 && yy < H && xx >= 0 && xx < W;
      src[m] = in ? ((long long)yy * W + xx) * C : -1;
      dst[m] = region_offset(p, g);
    }
    auto region_issue = [&](int chunk) {
      if (!PROBE_SKIP(SKIP_LOADS)) {
        const uint32_t rb = smem_u32(sm.region[chunk & 1]);
        const int c0 = chunk * RCC;
#pragma unroll
        for (int m = 0; m < ROUNDS; ++m)
          if (pt + 128 * m < NPIECE)
            cp_async_16(rb + dst[m], src[m] >= 0 ? xn + src[m] + c0 : x, src[m] >= 0 ? 16 : 0);
      }
      cp_async_commit();
    };
    // K9b: a and c of the thread's channels of the chunk the region holds
    // next, loaded a chunk ahead
    [[maybe_unused]] float a[8], c[8];
    auto load_affine = [&](int chunk) {
      const int c0 = chunk * RCC + 8 * g;
      const float4* pa = reinterpret_cast<const float4*>(aff_a + (size_t)n * C + c0);
      const float4* pc = reinterpret_cast<const float4*>(aff_c + (size_t)n * C + c0);
      const float4 a0 = pa[0], a1 = pa[1], c0v = pc[0], c1v = pc[1];
      a[0] = a0.x, a[1] = a0.y, a[2] = a0.z, a[3] = a0.w;
      a[4] = a1.x, a[5] = a1.y, a[6] = a1.z, a[7] = a1.w;
      c[0] = c0v.x, c[1] = c0v.y, c[2] = c0v.z, c[3] = c0v.w;
      c[4] = c1v.x, c[5] = c1v.y, c[6] = c1v.z, c[7] = c1v.w;
    };
    // the wait for the chunk's copies (with the next chunk's in flight, or
    // not), then in K9b relu(a x + c) in place inside the image
    auto region_finish = [&](int chunk, auto pending) {
      cp_async_wait<decltype(pending)::value>();
      if constexpr (GN) {
        if (PROBE_SKIP(SKIP_AFFINE)) return;
        unsigned char* rb = sm.region[chunk & 1];
#pragma unroll
        for (int m = 0; m < ROUNDS; ++m) {
          if (src[m] >= 0) {
            uint4* piece = reinterpret_cast<uint4*>(rb + dst[m]);
            *piece = affine8(*piece, a, c);
          }
        }
      }
    };
    // the thread's two items (tile 8 (i >> 5) + (i & 7), channels 4 c4 ..
    // 4 c4 + 3, c4 = (i >> 3) & 3), i = pt and pt + 128: a warp's 32 items
    // fill 256 contiguous bytes of V; their windows' first positions
    const int c4 = (pt >> 3) & 3;
    int p0[2];
    uint32_t voff[2];
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int i = pt + 128 * it;
      const int t = (i >> 5) * 8 + (i & 7);
      p0[it] = 2 * (t / TC) * RC + 2 * (t % TC);
      voff[it] = (i >> 5) * RV_SBO + (c4 >> 1) * V_LBO + (i & 7) * 16 + (c4 & 1) * 8;
    }
    if constexpr (GN) load_affine(0);
    region_issue(0);
    region_issue(1);   // C % 32 == 0: at least two chunks
    for (int chunk = 0; chunk < nchunks; ++chunk) {
      const int st = chunk & 1;
      PROBE_MARK(chunk, 0)
      if (chunk + 1 < nchunks) region_finish(chunk, std::integral_constant<int, 1>{});
      else region_finish(chunk, std::integral_constant<int, 0>{});
      if constexpr (GN) {
        if (chunk + 1 < nchunks) load_affine(chunk + 1);
      }
      producer_sync();   // the chunk's region is staged
      PROBE_MARK(chunk, 1)
      // stage st free: both blocks' consumers are done with chunk - 2
      if (chunk >= 2) mbar_wait_cluster(&sm.empty[st], ((chunk >> 1) - 1) & 1);
      PROBE_MARK(chunk, 2)
      if (pt == 0 && (chunk < 2 || !PROBE_SKIP(SKIP_U))) {
        // both consumers' U of the chunk: this block loads pq 8 rank .. 8
        // rank + 7 into both blocks
        mbar_expect_tx(&sm.u_full[st], U_STAGE);
#pragma unroll 1
        for (int w = 0; w < 2; ++w)
#pragma unroll 1
          for (int pq = 8 * rank; pq < 8 * rank + 8; ++pq)
            tma_load_3d_multicast(sm.u[st][w][pq], &tu, &sm.u_full[st], k0 + BK * w,
                                  chunk * RCC, pq, 0x3);
      }
      if (!PROBE_SKIP(SKIP_TRANSFORM)) {
        const unsigned char* rb = sm.region[st];
        unsigned char* const vdst[MAX_CLUSTER] = {reinterpret_cast<unsigned char*>(sm.v[st][0]),
                                                  nullptr};
        uint2 raw[2][4][4];
#pragma unroll
        for (int it = 0; it < 2; ++it)
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int s = 0; s < 4; ++s)
              raw[it][r][s] = *reinterpret_cast<const uint2*>(
                  rb + region_offset(p0[it] + r * RC + s, c4 >> 1) + (c4 & 1) * 8);
#pragma unroll
        for (int it = 0; it < 2; ++it) transform_store<RV_PQ>(raw[it], vdst, voff[it], 1);
      }
      fence_proxy_async();   // the V stores, to the consumers' products
      mbar_arrive(&sm.v_full[st]);
      PROBE_MARK(chunk, 3)
      producer_sync();   // every producer thread is done with the region
      if (chunk + 2 < nchunks) region_issue(chunk + 2);
      PROBE_MARK(chunk, 4)
    }
  } else {
    // ---- consumers: warpgroup w, the rectangle's 64 tiles x channels
    // k0 + 64 w .. + 63 ----
    const int w = tid / 128;
    float y[4][32];   // the outputs Y[2 u + v]
#pragma unroll
    for (int o = 0; o < 4; ++o)
#pragma unroll
      for (int i = 0; i < 32; ++i) y[o][i] = 0.f;
    const uint64_t desc_v0 = desc_interleave(sm.v[0][0], V_LBO, RV_SBO);
    const uint64_t desc_u0 = desc_sw128(sm.u[0][w][0]);
    for (int chunk = 0; chunk < nchunks; ++chunk) {
      const int st = chunk & 1;
      PROBE_MARK(chunk, 5)
      mbar_wait(&sm.v_full[st], (chunk >> 1) & 1);
      if (chunk < 2 || !PROBE_SKIP(SKIP_U)) mbar_wait(&sm.u_full[st], (chunk >> 1) & 1);
      PROBE_MARK(chunk, 6)
      issue_products<RV_PQ, RU_PQ, 1>(y, desc_add(desc_v0, st * V_STAGE),
                                      desc_add(desc_u0, st * U_STAGE));
      wgmma_wait<0>();
      fence_acc4(y);
      PROBE_MARK(chunk, 7)
      // stage st is free here and, for U, in the other block
      mbar_arrive_remote(&sm.empty[st], rank);
      mbar_arrive_remote(&sm.empty[st], rank ^ 1);
    }
    // bias, one rounding, bf16 pairs
    store_outputs(y, bias, out, k0 + BK * w, K, Hh, Wh, 0, [&](int t) {
      const int tr = tr0 + t / TC, tc = tc0 + t % TC;
      return has_tiles && tr < Hh && tc < Wh ? make_int3(n, tr, tc) : make_int3(-1, 0, 0);
    });
  }
  // no block leaves while the other may still arrive on its barriers
  cluster.sync();
}

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, long long nblocks, int nthread, int cluster, size_t smem,
                   void* stream, Args... args) {
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)nblocks);
  cfg.blockDim = dim3(nthread);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

}  // namespace

// dynamic shared memory of a block of the raster kernel (rect 0) or the
// rectangle kernel (rect 1)
extern "C" int winograd_smem(int rect) { return (int)(rect ? RECT_SMEM_BYTES : SMEM_BYTES); }

// x (N, H, W, C) bf16 contiguous; u (16, C, K) bf16 = G w G^T; bias (K,)
// fp32; aff_a / aff_c (N, C) fp32 for K9b, both null for K9a -> out (N, H',
// W', K) bf16, H' = H (same) or H - 2 (valid). C % 32 == 0, K % 64 == 0
// (K9b: K % 128 == 0), even H' and W'. K9b always runs the rectangle
// kernel; K9a runs it where the rectangles tile every image exactly (the
// serving path's dense levels) and K % 128 == 0, the raster kernel
// elsewhere (the sparse level's VALID convs of many small windows, which
// rectangles would leave part empty). The two compute every output alike,
// bit for bit. Returns cudaGetLastError() (or cudaErrorInvalidValue on a
// shape the kernels do not take or a tensor map that cannot be encoded).
extern "C" int winograd_launch(const void* x, const void* u, const void* bias,
                               const void* aff_a, const void* aff_c, void* out,
                               int N, int H, int W, int C, int K, int same,
                               void* stream) {
  const int pad = same ? 1 : 0;
  const int Hh = same ? H / 2 : (H - 2) / 2, Wh = same ? W / 2 : (W - 2) / 2;
  const bool gn = aff_a != nullptr;
  if (C % CC != 0 || K % BK != 0 || H % 2 != 0 || W % 2 != 0 || Hh < 1 || Wh < 1 ||
      (aff_a == nullptr) != (aff_c == nullptr) || (gn && K % (2 * BK) != 0))
    return (int)cudaErrorInvalidValue;
  const long long ntiles = (long long)N * Hh * Wh;
  if (ntiles == 0) return (int)cudaGetLastError();
  CUtensorMap tu;
  const auto* xb = (const __nv_bfloat16*)x;
  const auto* bf = (const float*)bias;
  auto* ob = (__nv_bfloat16*)out;
  // the rectangle: TC tiles wide (16 for images at most 16 tiles wide), TR high
  const int tc = Wh > 16 ? 32 : 16, tr = RT / tc;
  const bool rect = gn || (K % RK == 0 && Hh % tr == 0 && Wh % tc == 0);
  cudaError_t e;
  if (rect) {
    // a cluster: two tile rectangles (a last odd one paired with none), the
    // same 128 output channels
    if (!make_map_3d(&tu, u, K, C, 16, BK, RCC)) return (int)cudaErrorInvalidValue;
    const int ntr = (Hh + tr - 1) / tr, ntc = (Wh + tc - 1) / tc;
    const long long ntb = (long long)N * ntr * ntc, nkb = K / RK;
    const long long nblocks = (ntb + 1) / 2 * 2 * nkb;
    if (nblocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const auto* fa = (const float*)aff_a;
    const auto* fc = (const float*)aff_c;
    auto kernel = gn ? (tc == 32 ? winograd_rect_kernel<true, 32> : winograd_rect_kernel<true, 16>)
                     : (tc == 32 ? winograd_rect_kernel<false, 32>
                                 : winograd_rect_kernel<false, 16>);
    e = launch(kernel, nblocks, RTHREAD, 2, RECT_SMEM_BYTES, stream, tu, xb, bf, fa, fc, ob, H,
               W, C, K, Hh, Wh, pad, ntr, ntc, (int)ntb, (int)nkb);
  } else {
    // a cluster: two output-channel blocks of one tile block
    if (!make_map_3d(&tu, u, K, C, 16, BK, CC)) return (int)cudaErrorInvalidValue;
    const int nkb = K / BK;
    const int cs = nkb % 2 == 0 ? 2 : 1;
    const long long nblocks = (ntiles + BT - 1) / BT * nkb;
    if (nblocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    e = launch(winograd_kernel, nblocks, NTHREAD, cs, SMEM_BYTES, stream, tu, xb, bf, ob, H, W,
               C, K, Hh, Wh, pad, ntiles, nkb, cs);
  }
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
