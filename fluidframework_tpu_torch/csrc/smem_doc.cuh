// Building blocks of the shared-memory kernels (mergetree_blocks_smem.cu,
// matrix_steps_smem.cu): one thread block stages one document's row in
// dynamic shared memory, FIELD-MAJOR (every field of a slot table is its
// own plane of S ints, props and overlap words included), works on it
// there and writes it back once.
//
// Two ideas keep the barriers few:
//   * scans and reductions are warp shuffles; a block-wide one writes one
//     partial per warp and takes ONE barrier. The partials are double
//     buffered (``par`` flips on every call), so the next call never
//     overwrites a partial another thread has not read yet: it writes the
//     other half, and the call after it is ordered behind its barrier;
//   * an in-place shift of a table is done by whole fields: field f
//     belongs to one warp, which moves it chunk by chunk in the order that
//     never reads a value it already wrote, with __syncwarp between a
//     chunk's reads and its writes. No block barrier inside; the caller
//     takes one when every field has moved.
//
// Integer sums wrap as int32 (mt::wadd), as the plain versions' do.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "merge_apply.cuh"

#define SM_FULL 0xffffffffu

namespace sm {

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }
__device__ __forceinline__ int warp_id() { return threadIdx.x >> 5; }

// Inclusive scan over the warp's lanes.
__device__ __forceinline__ int warp_incl_scan(int x) {
  const int lane = lane_id();
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(SM_FULL, x, o);
    if (lane >= o) x = mt::wadd(x, y);
  }
  return x;
}

__device__ __forceinline__ int warp_sum(int x) {
  for (int o = 16; o > 0; o >>= 1)
    x = mt::wadd(x, __shfl_xor_sync(SM_FULL, x, o));
  return x;
}

__device__ __forceinline__ unsigned warp_min(unsigned x) {
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned y = __shfl_xor_sync(SM_FULL, x, o);
    x = y < x ? y : x;
  }
  return x;
}

__device__ __forceinline__ int warp_max(int x) {
  for (int o = 16; o > 0; o >>= 1) {
    const int y = __shfl_xor_sync(SM_FULL, x, o);
    x = y > x ? y : x;
  }
  return x;
}

// Exclusive prefix of ``x`` over the block's threads in thread order, and
// the block total in ``*total``; one barrier. ``part`` is [2][32] ints of
// shared memory.
__device__ __forceinline__ int block_excl_scan(int x, int* part, int& par,
                                               int* total) {
  const int lane = lane_id(), warp = warp_id();
  const int nwarps = (blockDim.x + 31) >> 5;
  const int incl = warp_incl_scan(x);
  if (lane == 31) part[par * 32 + warp] = incl;
  __syncthreads();
  int before = 0, all = 0;
  for (int w = 0; w < nwarps; ++w) {
    const int v = part[par * 32 + w];
    if (w < warp) before = mt::wadd(before, v);
    all = mt::wadd(all, v);
  }
  par ^= 1;
  *total = all;
  return mt::wadd(before, mt::wsub(incl, x));
}

// Block-wide minima of two unsigned keys; one barrier. ``part`` is
// [2][2][32] unsigned of shared memory.
__device__ __forceinline__ void block_min2(unsigned& a, unsigned& b,
                                           unsigned* part, int& par) {
  const int nwarps = (blockDim.x + 31) >> 5;
  a = warp_min(a);
  b = warp_min(b);
  if (lane_id() == 0) {
    part[(par * 2 + 0) * 32 + warp_id()] = a;
    part[(par * 2 + 1) * 32 + warp_id()] = b;
  }
  __syncthreads();
  for (int w = 0; w < nwarps; ++w) {
    const unsigned x = part[(par * 2 + 0) * 32 + w];
    const unsigned y = part[(par * 2 + 1) * 32 + w];
    a = x < a ? x : a;
    b = y < b ? y : b;
  }
  par ^= 1;
}

// Slots [from, to) of plane ``p`` take their left neighbour's value, by
// the calling warp alone, highest chunk first.
__device__ __forceinline__ void warp_shift_right(int* p, int from, int to) {
  if (from >= to) return;
  const int lane = lane_id();
  for (int base = ((to - 1) >> 5) << 5; base + 31 >= from; base -= 32) {
    const int j = base + lane;
    const bool on = j >= from && j < to;
    const int v = on ? p[j - 1] : 0;
    __syncwarp();
    if (on) p[j] = v;
    __syncwarp();
  }
}

// Slots [from, to) of plane ``p`` take their right neighbour's value, by
// the calling warp alone, lowest chunk first.
__device__ __forceinline__ void warp_shift_left(int* p, int from, int to) {
  if (from >= to) return;
  const int lane = lane_id();
  for (int base = (from >> 5) << 5; base < to; base += 32) {
    const int j = base + lane;
    const bool on = j >= from && j < to;
    const int v = on ? p[j + 1] : 0;
    __syncwarp();
    if (on) p[j] = v;
    __syncwarp();
  }
}

__device__ __forceinline__ bool aligned16(const void* a, const void* b) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b))
          & 15) == 0;
}

// n ints from ``src`` to ``dst`` (global to shared or back): 16 bytes a
// thread where both sides allow it.
__device__ __forceinline__ void copy_ints(int* dst, const int* src, int n) {
  if (aligned16(dst, src) && (n & 3) == 0) {
    int4* d4 = reinterpret_cast<int4*>(dst);
    const int4* s4 = reinterpret_cast<const int4*>(src);
    for (int t = threadIdx.x; t < (n >> 2); t += blockDim.x) d4[t] = s4[t];
  } else {
    for (int t = threadIdx.x; t < n; t += blockDim.x) dst[t] = src[t];
  }
}

// n bytes (torch.bool storage) to ints and back.
__device__ __forceinline__ void bytes_to_ints(int* dst, const uint8_t* src,
                                              int n) {
  for (int t = threadIdx.x; t < n; t += blockDim.x) dst[t] = src[t];
}

__device__ __forceinline__ void ints_to_bytes(uint8_t* dst, const int* src,
                                              int n) {
  for (int t = threadIdx.x; t < n; t += blockDim.x) dst[t] = (uint8_t)src[t];
}

// An interleaved [n, F] global plane to F shared planes of stride
// ``stride`` (coalesced reads), and back (coalesced writes).
__device__ __forceinline__ void split_fields(int* planes, int stride,
                                             const int* src, int n, int F) {
  for (int t = threadIdx.x; t < n * F; t += blockDim.x)
    planes[(t % F) * stride + t / F] = src[t];
}

__device__ __forceinline__ void join_fields(int* dst, const int* planes,
                                            int stride, int n, int F) {
  for (int t = threadIdx.x; t < n * F; t += blockDim.x)
    dst[t] = planes[(t % F) * stride + t / F];
}

}  // namespace sm
