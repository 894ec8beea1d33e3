// Kernel SC: submanifold sparse 3-D convolution over one point level's
// voxels, a gather-GEMM over a neighbour map (spconv's SubMConv3d).
//
// Replaces no TPU kernel: the JAX package swapped PTv3's spconv CPE and
// stem for a depthwise conv along the curve and a Dense embed, since a
// hash-gather conv is slow on a TPU. On the H100 a gather-GEMM is the
// native form. For output voxel v (rows of `nbr`) and offset o:
//   y[v] = bias + sum_o W[:, o, :] x[nbr[v, o]]     (nbr -1: absent, adds 0)
// x (R, C_in) bf16, nbr (M, K) int32, W (C_out, K, C_in) bf16 (spconv 2.x's
// (C_out, k, k, k, C_in) with the stencil flattened), bias (C_out,) fp32 or
// null, y (M, C_out) bf16; every sum in fp32, rounded once at the end.
//
// Design: output-stationary. A block of 4 warps owns 64 output voxels and
// BN (32, 64 or 128) output channels. It stages its 64 rows of the map in
// shared memory, and keeps the offsets that at least one of its voxels has
// (an absent offset costs no load and no product). It then walks
// (offset, 32-channel chunk) steps through a 3-stage cp.async ring: the
// neighbours' 64 x 32 rows are gathered into shared memory (16 bytes a
// copy, zero-filled where absent), the offset's BN x 32 weight slice beside
// them, and each warp multiplies its 16 rows by all BN columns with
// mma.sync m16n8k16 (bf16 in, fp32 accumulators), fragments by ldmatrix
// from rows padded to 80 bytes (no bank conflicts).
//
// Bound on the H100: at the stem (125 offsets, 768 -> 32) the products of
// the present pairs, ~2 pairs x 768 x 32 FLOPs a (row, present offset); at
// the CPEs (27 offsets, C -> C) the same at C x C. The block computes every
// offset that any of its 64 voxels has, so absent pairs inside a present
// offset cost products: the design trades them for dense tensor-core tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;       // output voxels a block
constexpr int kBK = 32;       // input channels a step
constexpr int kStride = 40;   // bf16 a staged row (80 bytes: ldmatrix without conflicts)
constexpr int kStages = 3;
constexpr int kThreads = 128;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const int bytes = valid ? 16 : 0;     // 0: zero-fill, src not read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int BN>
__global__ void __launch_bounds__(kThreads) subm_conv_kernel(
    const __nv_bfloat16* __restrict__ x, const int* __restrict__ nbr,
    const __nv_bfloat16* __restrict__ w, const float* __restrict__ bias,
    __nv_bfloat16* __restrict__ y, int M, int K, int C_in, int C_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem);                 // [stage][64][40]
  __nv_bfloat16* sB = sA + kStages * kBM * kStride;                          // [stage][BN][40]
  int* sNbr = reinterpret_cast<int*>(sB + kStages * BN * kStride);           // [64][K]
  int* sOff = sNbr + kBM * K;                                                // [K]
  __shared__ int sCount;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * BN;

  // the block's rows of the map (coalesced: they are contiguous), -1 past M
  const int rows = min(kBM, M - m0);
  const int* src = nbr + (long long)m0 * K;
  for (int i = tid; i < kBM * K; i += kThreads) sNbr[i] = i < rows * K ? src[i] : -1;
  __syncthreads();
  // offsets at least one of the block's voxels has, in offset order
  for (int o = tid; o < K; o += kThreads) {
    int any = 0;
    for (int r = 0; r < rows && !any; ++r) any = sNbr[r * K + o] >= 0;
    sOff[o] = any;
  }
  __syncthreads();
  if (tid == 0) {
    int c = 0;
    for (int o = 0; o < K; ++o)
      if (sOff[o]) sOff[c++] = o;
    sCount = c;
  }
  __syncthreads();

  const int chunks = C_in / kBK;
  const int steps = sCount * chunks;

  auto load = [&](int stage, int s) {
    const int o = sOff[s / chunks];
    const int k0 = (s % chunks) * kBK;
    __nv_bfloat16* a = sA + stage * kBM * kStride;
#pragma unroll
    for (int i = 0; i < (kBM * 4) / kThreads; ++i) {
      const int c = tid + i * kThreads, r = c >> 2, part = c & 3;
      const int row = sNbr[r * K + o];
      const __nv_bfloat16* g = x + (long long)max(row, 0) * C_in + k0 + part * 8;
      cp_async16(a + r * kStride + part * 8, g, row >= 0);
    }
    __nv_bfloat16* b = sB + stage * BN * kStride;
#pragma unroll
    for (int i = 0; i < (BN * 4) / kThreads; ++i) {
      const int c = tid + i * kThreads, n = c >> 2, part = c & 3;
      const __nv_bfloat16* g = w + ((long long)(n0 + n) * K + o) * C_in + k0 + part * 8;
      cp_async16(b + n * kStride + part * 8, g, true);
    }
  };

  float acc[BN / 8][4];
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int t = 0; t < 4; ++t) acc[j][t] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load(s, s);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = s + kStages - 1;
    if (next < steps) load(next % kStages, next);
    cp_async_commit();

    const __nv_bfloat16* a = sA + (s % kStages) * kBM * kStride + warp * 16 * kStride;
    const __nv_bfloat16* b = sB + (s % kStages) * BN * kStride;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[4];
      ldmatrix_x4(af, a + (lane & 15) * kStride + kk + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < BN / 8; j += 2) {
        uint32_t bf[4];
        const int n = j * 8 + (lane & 7) + ((lane >> 4) << 3);
        ldmatrix_x4(bf, b + n * kStride + kk + ((lane >> 3) & 1) * 8);
        mma_bf16(acc[j], af, bf[0], bf[1]);
        mma_bf16(acc[j + 1], af, bf[2], bf[3]);
      }
    }
  }
  cp_async_wait<0>();

  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + j * 8 + 2 * q;
    const float b0 = bias ? bias[col] : 0.f, b1 = bias ? bias[col + 1] : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + warp * 16 + g + 8 * h;
      if (m < M) {
        __nv_bfloat162 v = __floats2bfloat162_rn(acc[j][2 * h] + b0, acc[j][2 * h + 1] + b1);
        *reinterpret_cast<__nv_bfloat162*>(y + (long long)m * C_out + col) = v;
      }
    }
  }
}

template <int BN>
int launch(const void* x, const int* nbr, const void* w, const float* bias, void* y, int M,
           int K, int C_in, int C_out, cudaStream_t s) {
  const size_t smem = (size_t)kStages * (kBM + BN) * kStride * sizeof(__nv_bfloat16) +
                      (size_t)(kBM + 1) * K * sizeof(int);
  static size_t allowed = 0;   // the shared memory already allowed: set again only to grow it
  if (smem > allowed) {
    cudaError_t err = cudaFuncSetAttribute(subm_conv_kernel<BN>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    allowed = smem;
  }
  dim3 grid((M + kBM - 1) / kBM, C_out / BN);
  subm_conv_kernel<BN><<<grid, kThreads, smem, s>>>(
      (const __nv_bfloat16*)x, nbr, (const __nv_bfloat16*)w, bias, (__nv_bfloat16*)y, M, K,
      C_in, C_out);
  return (int)cudaGetLastError();
}

}  // namespace

// x (R, C_in) bf16, nbr (M, K) int32 (-1 absent), w (C_out, K, C_in) bf16,
// bias (C_out,) fp32 or null -> y (M, C_out) bf16. C_in and C_out multiples
// of 32, K at most 343. One launch on `stream`; returns cudaGetLastError().
extern "C" int subm_conv_launch(const void* x, const void* nbr, const void* w,
                                const void* bias, void* y, int M, int K, int C_in, int C_out,
                                void* stream) {
  if (C_in % kBK || C_out % 32 || K < 1 || K > 343) return (int)cudaErrorInvalidValue;
  if (M <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int* n = (const int*)nbr;
  const float* b = (const float*)bias;
  if (C_out % 128 == 0) return launch<128>(x, n, w, b, y, M, K, C_in, C_out, s);
  if (C_out % 64 == 0) return launch<64>(x, n, w, b, y, M, K, C_in, C_out, s);
  return launch<32>(x, n, w, b, y, M, K, C_in, C_out, s);
}
