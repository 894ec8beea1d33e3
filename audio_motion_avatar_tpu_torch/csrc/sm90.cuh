// Hopper (sm_90a) building blocks shared by the redesigned kernels A
// (attention.cu), A-bwd (attention_bwd.cu) and K9a / K9b (winograd.cu):
// mbarriers, TMA loads, warpgroup matrix products (wgmma) with their
// shared-memory descriptors, and the host-side encoding of TMA tensor maps.
//
// Operand tiles in shared memory take one of two canonical layouts:
//  - 128-byte swizzled rows (what TMA writes with CU_TENSOR_MAP_SWIZZLE_128B):
//    a [rows][64] bf16 tile, row r at r * 128 bytes, its 16-byte chunks
//    XOR-permuted by r % 8, the tile 1024-byte aligned. The same image is
//    K-major (the 64 contiguous values are the product's depth; advance
//    16 deep by 32 bytes) or MN-major (the 64 contiguous values are M or N,
//    the rows the depth; advance 16 deep by 16 rows = 2048 bytes, and set
//    the transpose flag). 8-row groups lie 1024 bytes apart in both.
//  - no swizzle, K-major "core matrices" of 8 rows x 16 bytes (128
//    contiguous bytes): `lbo` bytes between core matrices along the depth,
//    `sbo` bytes between 8-row groups.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// a T at the first 1024-byte boundary of dynamic shared memory (allocate
// sizeof(T) + 1024 bytes): 128-byte swizzled tiles need that alignment
template <typename T>
__device__ __forceinline__ T& aligned_smem(unsigned char* raw) {
  const uint32_t a = smem_u32(raw);
  return *reinterpret_cast<T*>(raw + ((1024 - (a & 1023)) & 1023));
}

// a masked key's logit in kernels A and A-bwd: it replaces the logit, so a
// row whose keys are all masked averages them uniformly
constexpr float kMaskedLogit = -1e30f;

// ---- mbarriers -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// arrive once and add `bytes` to the transaction count the phase waits for
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// wait until the phase of parity `parity` has completed (the n-th completion
// of a barrier has parity n & 1). A wait that never ends (a fault in the
// ring's bookkeeping) traps, so that the launch fails instead of hanging the
// card: no legitimate wait comes near 2^26 polls.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 26)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// ---- TMA -------------------------------------------------------------------

// one box of a 3-D tensor map into shared memory; rows out of range read 0
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// a contiguous copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// generic-proxy stores to shared memory made visible to wgmma / TMA
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// the same for stores into the shared memory of other blocks of the cluster
__device__ __forceinline__ void fence_proxy_async_all() {
  asm volatile("fence.proxy.async;" ::: "memory");
}

// ---- wgmma -----------------------------------------------------------------

constexpr uint64_t kSwizzle128 = 1ull << 62;

// descriptor of a 128-byte swizzled tile (see above); LBO is unused there
__device__ __forceinline__ uint64_t desc_sw128(const void* tile) {
  return static_cast<uint64_t>((smem_u32(tile) & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | kSwizzle128;
}

// descriptor of a K-major tile of core matrices without swizzle
__device__ __forceinline__ uint64_t desc_interleave(const void* tile, uint32_t lbo,
                                                    uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(tile) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32);
}

// the descriptor `d` moved on by `bytes` (a multiple of 16)
__device__ __forceinline__ uint64_t desc_add(uint64_t d, uint32_t bytes) {
  return d + (bytes >> 4);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous product that owns it
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// the same for the registers of a register A operand: called after the wait
// for the products that read them, it keeps the compiler from giving those
// registers to other values while the products are in flight
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Accumulator layout of an m64n64 fp32 product (each thread 32 values): warp
// w of the warpgroup owns rows 16 w .. 16 w + 15; value 4 j + 2 h + e sits
// at row 16 w + lane / 4 + 8 h, column 8 j + 2 (lane % 4) + e. Packed to
// bf16 pairs, values (2 m, 2 m + 1) become register m of the A operand of a
// register-A product: k-step kk takes registers 4 kk .. 4 kk + 3.

// d (+)= A (SB B), A and B from shared memory; TA / TB: 1 = MN-major
// (transposed); SB: 1 or -1
template <int TA, int TB, int SB = 1>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, %37, %35, %36;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB), "n"(SB));
}

// d (+)= A B, A from registers (4 bf16 pairs a thread, K-major), B from
// shared memory; TB: 1 = MN-major; accumulate 0 overwrites d
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                         int accumulate = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %38, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %37;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(TB), "r"(accumulate));
}

// 2^x by the SFU alone (ex2.approx.ftz: results below 2^-126 flush to 0)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---- host: TMA tensor maps ---------------------------------------------------

// cuTensorMapEncodeTiled is a driver function; it is taken from the driver
// library the CUDA runtime has already loaded (no link against libcuda, no
// dependence on the runtime's entry-point API, which changed across
// toolkits).
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (h == nullptr) h = dlopen("libcuda.so.1", RTLD_NOW);
    if (h != nullptr) fn = reinterpret_cast<EncodeTiledFn>(dlsym(h, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// Makes the primary context of the device that holds `ptr` current on the
// calling thread. A thread that has made no runtime call yet has none (the
// autograd engine's device thread, running a backward or a checkpointed
// forward, until some runtime call binds it), and cuTensorMapEncodeTiled, a
// driver call, fails there: make_map_3d binds and encodes again.
inline bool bind_context(const void* ptr) {
  cudaPointerAttributes attr;
  if (cudaPointerGetAttributes(&attr, ptr) != cudaSuccess) {
    cudaGetLastError();
    return false;
  }
  return cudaSetDevice(attr.device) == cudaSuccess;
}

// A bf16 tensor of `planes` x `rows` x `cols` contiguous values (cols * 2
// bytes a multiple of 16) read in boxes of box_rows x box_cols (box_cols * 2
// <= 128) with 128-byte swizzle. Returns false when it cannot be encoded.
inline bool make_map_3d(CUtensorMap* map, const void* base, uint64_t cols, uint64_t rows,
                        uint64_t planes, uint32_t box_cols, uint32_t box_rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr || (reinterpret_cast<uintptr_t>(base) & 15) != 0) return false;
  const cuuint64_t dims[3] = {cols, rows, planes};
  const cuuint64_t strides[2] = {cols * 2, cols * rows * 2};
  const cuuint32_t box[3] = {box_cols, box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  auto encode = [&] {
    return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
              box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
              CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
           CUDA_SUCCESS;
  };
  return encode() || (bind_context(base) && encode());
}

}  // namespace sm90
