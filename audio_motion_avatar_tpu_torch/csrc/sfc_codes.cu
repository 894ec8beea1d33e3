// Kernel SFC: the space-filling-curve codes of one PTv3 level, every curve
// order asked for in one pass.
//
// Replaces no TPU kernel: the JAX package computes the codes
// (audio_motion_avatar_tpu/ops/serialization.py) as jnp integer ops that
// XLA fuses into one loop. The eager port issued that chain op by op: ~800
// launches a level (a Hilbert encode alone is ~365 bitwise / shift / where
// ops), ~3,900 a PTv3 call, each of microseconds of device work, and the
// "-trans" orders copied a host index list to the card. This kernel does
// the whole chain of `ops/serialization.sfc_codes_plain` in registers:
//   g = floor(p * res) as int32 (one fp32 multiply, rounded to nearest, as
//       PyTorch's tensor-by-scalar product), less the cloud's per-axis
//       minimum over every row (the zero padding rows included), clamped to
//       [0, 2^depth - 1] (depth, the bits an axis, 1 to 10; 10 by default;
//       Morton codes do not depend on it, Hilbert codes do);
//   per order: the "-trans" rotation of the axes (1, 2, 0), then the Morton
//       code (bits spread by `part1by2`) or the Hilbert code by the
//       Skilling transform, step for step, whose transposed bits are
//       interleaved x0-major (x0's bit b at 3b + 2, x1's at 3b + 1, x2's at
//       3b: the plain version's bit-by-bit loop, done by `part1by2`);
//   PAD_CODE (2^30) where the point's mask is false.
// Integers only after the multiply, so the codes equal the plain
// version's bit for bit.
//
// Design: two launches. A min pass, one 1024-thread block a cloud, reduces
// the cloud's grid coordinates per axis (no atomics, no scratch to clear:
// deterministic) into a (B, 3) int32 scratch; the code pass, one thread a
// point, reads it and writes every order's code, coalesced along N.
//
// Bound on the H100: bytes, and in practice launches. 12 bytes are read and
// 4 K written a point, the mask's byte once an index (~5.2 MB at B = 6,
// N = 30,720, K = 4: ~1.6 us at 3.35 TB/s), so the device work is far below
// one launch's host cost; the design aims at the fewest launches.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPadCode = 1 << 30;

__device__ __forceinline__ int grid_coord(float p, float res) {
  return (int)floorf(__fmul_rn(p, res));
}

__device__ __forceinline__ int part1by2(int x) {
  x &= 0x3FF;
  x = (x | (x << 16)) & 0x30000FF;
  x = (x | (x << 8)) & 0x300F00F;
  x = (x | (x << 4)) & 0x30C30C3;
  x = (x | (x << 2)) & 0x9249249;
  return x;
}

__device__ __forceinline__ int morton(int x, int y, int z) {
  return part1by2(x) | (part1by2(y) << 1) | (part1by2(z) << 2);
}

__device__ __forceinline__ int hilbert(int x0, int x1, int x2, int depth) {
  // the Skilling transform to the Hilbert-transposed form
  for (int q = 1 << (depth - 1); q > 1; q >>= 1) {
    const int p = q - 1;
    x0 = (x0 & q) ? (x0 ^ p) : x0;
    {
      const bool set = (x1 & q) != 0;
      const int t = (x0 ^ x1) & p;
      const int a = set ? (x0 ^ p) : (x0 ^ t);
      x1 = set ? x1 : (x1 ^ t);
      x0 = a;
    }
    {
      const bool set = (x2 & q) != 0;
      const int t = (x0 ^ x2) & p;
      const int a = set ? (x0 ^ p) : (x0 ^ t);
      x2 = set ? x2 : (x2 ^ t);
      x0 = a;
    }
  }
  // Gray decode
  x1 ^= x0;
  x2 ^= x1;
  int t = 0;
  for (int q = 1 << (depth - 1); q > 1; q >>= 1) t = (x2 & q) ? (t ^ (q - 1)) : t;
  x0 ^= t;
  x1 ^= t;
  x2 ^= t;
  return (part1by2(x0) << 2) | (part1by2(x1) << 1) | part1by2(x2);
}

__global__ void __launch_bounds__(1024) sfc_min_kernel(
    const float* __restrict__ pts, int n, float res, int* __restrict__ gmin) {
  const float* p = pts + (long long)blockIdx.x * n * 3;
  int m0 = INT_MAX, m1 = INT_MAX, m2 = INT_MAX;
#pragma unroll 4
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    m0 = min(m0, grid_coord(p[3 * i], res));
    m1 = min(m1, grid_coord(p[3 * i + 1], res));
    m2 = min(m2, grid_coord(p[3 * i + 2], res));
  }
  m0 = __reduce_min_sync(0xffffffffu, m0);
  m1 = __reduce_min_sync(0xffffffffu, m1);
  m2 = __reduce_min_sync(0xffffffffu, m2);
  __shared__ int part[3][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    part[0][warp] = m0;
    part[1][warp] = m1;
    part[2][warp] = m2;
  }
  __syncthreads();
  if (warp == 0) {
    const int warps = blockDim.x >> 5;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const int m = __reduce_min_sync(0xffffffffu, lane < warps ? part[a][lane] : INT_MAX);
      if (lane == 0) gmin[blockIdx.x * 3 + a] = m;
    }
  }
}

// orders: K 2-bit order ids, order k at bits 2k: bit 0 the "-trans"
// rotation, bit 1 Hilbert (0 z, 1 z-trans, 2 hilbert, 3 hilbert-trans)
__global__ void __launch_bounds__(256) sfc_codes_kernel(
    const float* __restrict__ pts, const uint8_t* __restrict__ mask,
    const int* __restrict__ gmin, int B, int n, float res, int K, int orders, int depth,
    int* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (i >= n) return;
  const float* p = pts + ((long long)b * n + i) * 3;
  int g[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    // unsigned difference: two's-complement wrap, as the int32 tensor op
    const int d = (int)((unsigned)grid_coord(p[a], res) - (unsigned)gmin[b * 3 + a]);
    g[a] = min(max(d, 0), (1 << depth) - 1);
  }
  const bool valid = mask[i] != 0;
  for (int k = 0; k < K; ++k) {
    const int o = (orders >> (2 * k)) & 3;
    int code = kPadCode;
    if (valid) {
      const int x = (o & 1) ? g[1] : g[0];
      const int y = (o & 1) ? g[2] : g[1];
      const int z = (o & 1) ? g[0] : g[2];
      code = (o & 2) ? hilbert(x, y, z, depth) : morton(x, y, z);
    }
    out[((long long)k * B + b) * n + i] = code;
  }
}

}  // namespace

// pts (B, N, 3) fp32, mask (N,) bytes 0 / 1 -> out (K, B, N) int32 codes at
// `depth` bits an axis (1 to 10); gmin a (B, 3) int32 scratch. Two launches
// on `stream`; returns cudaGetLastError() after them.
extern "C" int sfc_codes_launch(const float* pts, const void* mask, int* gmin, int* out,
                                int B, int n, float res, int K, int orders, int depth,
                                void* stream) {
  if (depth < 1 || depth > 10) return (int)cudaErrorInvalidValue;
  if (B > 0 && n > 0 && K > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    sfc_min_kernel<<<B, 1024, 0, s>>>(pts, n, res, gmin);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
    dim3 grid((n + 255) / 256, B);
    sfc_codes_kernel<<<grid, 256, 0, s>>>(pts, (const uint8_t*)mask, gmin, B, n, res, K,
                                          orders, depth, out);
  }
  return (int)cudaGetLastError();
}
