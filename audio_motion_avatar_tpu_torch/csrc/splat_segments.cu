// Kernel S: segmented splat composite for the serving renderer.
//
// Replaces the TPU kernel `_composite_segments_pallas` / `_seg_kernel` of
// audio_motion_avatar_tpu/ops/splat_pallas.py. The host side
// (ops/splat_segmented.py) sorts every frame's gaussian candidates by
// (tile, depth) into one (9, NP) array; tile t owns the contiguous segment
// [starts[t], starts[t] + counts[t]) with counts already clamped to K. A
// segment is its tile's live prefix already: an invalid gaussian is never
// emitted into a tile, so there is nothing to scan for.
//
// Bound on the H100: the fp32 operations that the rule needs on these
// inputs at 67 TFLOP/s, against the bytes it must move: the 9 floats of
// every segment entry, starts and counts (4 bytes a tile each) and the
// (T, 256, 3) output. A (pixel, segment entry) pair needs 12 operations
// where it is far (dx, dy, power, one compare), 15 where it is dropped
// otherwise (power's tests, one exp and the opacity product), 19 where it
// is kept but its weight dropped (T < 1e-4: the 0.99 clamp, log1p, log T's
// sum and the T test) and 27 where it is blended (T's exp, the weight and
// three colour products and sums); chip_smoke.py counts each class on its
// inputs (walk_operations). The operations bound it (at the serving shape
// by about three times the bytes' time).
//
// Design: one block per 16x16 tile, one thread per pixel, the walk of
// splat_walk.cuh (shared with K1): a dropped pair skips everything but its
// test, a far one (power < -5.6) its exp too, T = exp(log T) is carried
// from kept slot to kept slot (a kept pair pays one exp(power), one log1p
// and one exp), three float4 a staged slot. What is left of a pair is that
// walk (91 % of the launch at the serving shape, kernel_probe.py), so the design spends
// little else:
//   - Longest tiles first. A tile's walk is sequential along its segment
//     (a pixel's T depends on every entry before it), so the longest
//     segment alone takes about a quarter of the launch (kernel_probe.py);
//     started in the natural order, the last frame's long tiles ran on
//     after the rest. A one-block pre-pass buckets the tiles by length (32
//     entries a bucket) and block b takes the b-th tile of that order.
//     Which block runs a tile changes no bit of its output.
//   - A tile reads starts[t] and counts[t]; one with no entry writes white
//     and stops, before any barrier.
//   - Staging. Thread j < n of a chunk of n <= CH entries reads entry j's
//     nine rows (scalar loads, coalesced along the segment: a start has no
//     alignment) and stores them as the slot's three float4; one barrier
//     before the walk, one more before the next chunk overwrites it. The
//     next chunk loaded by cp.async into a second buffer during the walk
//     gained nothing: the other blocks of the SM cover the wait.
//   - Exactness. Every cut is an identity (splat_walk.cuh), so under
//     --fmad=false the output is the plain version's sequential blend
//     (ops/splat.py blend_tiles_plain) and the first version of this kernel
//     bit for bit, and the same across launches.

#include <cuda_runtime.h>

#include "splat_walk.cuh"

// Phase probe, compiled only with -DSPLAT_SEGMENTS_PROBE (kernel_probe.py
// builds such a library apart): a mask skips the walk (1) and the staging
// (2), so that what is left can be timed (the output is then meaningless),
// takes the tiles in their own order, without the pre-pass (8), or walks
// without the far-pair cut (16, splat_walk.cuh FAR_CUT). An order array,
// where one is set, maps block b to tile order[b] instead of the pre-pass.
#ifdef SPLAT_SEGMENTS_PROBE
__device__ int g_probe_skip;
__device__ const int* g_probe_order;
static int g_probe_host_mask;
#define PROBE_SKIP(bit) ((g_probe_skip & (bit)) != 0)
extern "C" int splat_segments_probe_set(int mask) {
  g_probe_host_mask = mask;
  return (int)cudaMemcpyToSymbol(g_probe_skip, &mask, sizeof(int));
}
extern "C" int splat_segments_probe_order(const int* order) {
  return (int)cudaMemcpyToSymbol(g_probe_order, &order, sizeof(order));
}
#else
#define PROBE_SKIP(bit) false
#endif

namespace {

using namespace splat_walk;

constexpr int ORDER_THREADS = 1024;
constexpr int BUCKET = 32;   // segment entries a bucket of the tile order
constexpr int NBUCKET = 64;  // the last takes every segment of 2016 entries or more

// order[0, n_tiles) <- the tiles, longest bucket first (the order of the
// tiles within a bucket is the atomics', and changes nothing but which
// block runs which tile). One block.
__global__ void __launch_bounds__(ORDER_THREADS) seg_order_kernel(
    const int* __restrict__ counts, int n_tiles, int* __restrict__ order) {
  __shared__ int next[NBUCKET];
  auto bucket = [](int count) { return min((count + BUCKET - 1) / BUCKET, NBUCKET - 1); };
  for (int b = threadIdx.x; b < NBUCKET; b += ORDER_THREADS) next[b] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < n_tiles; i += ORDER_THREADS) atomicAdd(&next[bucket(counts[i])], 1);
  __syncthreads();
  if (threadIdx.x == 0) {   // each bucket's first place, the longest bucket first
    int place = 0;
    for (int b = NBUCKET - 1; b >= 0; --b) {
      const int size = next[b];
      next[b] = place;
      place += size;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_tiles; i += ORDER_THREADS)
    order[atomicAdd(&next[bucket(counts[i])], 1)] = i;
}

__global__ void __launch_bounds__(P) seg_composite_kernel(
    const float* __restrict__ params, long long np_stride,
    const int* __restrict__ starts, const int* __restrict__ counts,
    const int* __restrict__ order, int tx, int tiles_per_frame, float* __restrict__ out) {
  __shared__ Chunk sp;
#ifdef SPLAT_SEGMENTS_PROBE
  const int t = g_probe_order != nullptr ? g_probe_order[blockIdx.x]
                : PROBE_SKIP(8)            ? (int)blockIdx.x
                                           : order[blockIdx.x];
#else
  const int t = order[blockIdx.x];
#endif
  const int count = counts[t];
  float* o = out + (long long)t * P * 3;
  if (count == 0) {
    store_white(o);
    return;
  }
  const float* seg = params + starts[t];
  Pixel px(t, tx, tiles_per_frame);
  for (int base = 0; base < count; base += CH) {
    const int n = min(CH, count - base);
    if (base > 0) __syncthreads();   // every thread is done with the last chunk
    if (threadIdx.x < n && !PROBE_SKIP(2)) {
      float v[NPARAM];
#pragma unroll
      for (int row = 0; row < NPARAM; ++row)
        v[row] = seg[row * np_stride + base + threadIdx.x];
      stage(sp, threadIdx.x, v);
    }
    __syncthreads();
    if (PROBE_SKIP(16))
      px.walk<false>(sp, n);
    else
      px.walk(sp, PROBE_SKIP(1) ? 0 : n);
  }
  px.store(o);
}

}  // namespace

// params (9, np_stride) f32, starts/counts (n_tiles,) i32 -> out
// (n_tiles, 256, 3) f32; order: n_tiles ints of scratch (the tile order).
// Returns cudaGetLastError() after the launches.
extern "C" int splat_segments_launch(const float* params, long long np_stride,
                                     const int* starts, const int* counts,
                                     int n_tiles, int tx, int tiles_per_frame,
                                     int* order, float* out, void* stream) {
  if (n_tiles > 0) {
#ifdef SPLAT_SEGMENTS_PROBE
    if (!(g_probe_host_mask & 8))
#endif
      seg_order_kernel<<<1, ORDER_THREADS, 0, (cudaStream_t)stream>>>(counts, n_tiles, order);
    seg_composite_kernel<<<n_tiles, P, 0, (cudaStream_t)stream>>>(
        params, np_stride, starts, counts, order, tx, tiles_per_frame, out);
  }
  return (int)cudaGetLastError();
}
