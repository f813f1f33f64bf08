// Windowed SharedMap last-writer-wins fold — one thread block per document.
//
// Replaces the TPU kernel fluidframework_tpu/ops/map_pallas.py:_fold_kernel
// (pallas_call at map_pallas.py:158, wrapper fold_words). Same function:
// op k of row d applies when lo[d] <= k < hi[d], with
// seq = base[d] + 1 + (k - lo[d]); the last in-window clear blanks the row
// and stamps cleared_seq; each key slot then takes its last live op after
// that clear. A slot whose winner is a delete keeps its pre-tick value.
//
// Design: the result of a slot depends only on its LAST live op after the
// clear barrier, so no op-by-op scan is needed. The block's threads stride
// once over the row's window (coalesced 4-byte words), keep the largest
// clear index in a register, and atomicMax each non-clear op's index into
// a shared int[S] per slot. After one block reduce of the clear index,
// slot s has a winner iff its max index exceeds the clear index, and each
// slot is written once. Deterministic: max is order-free.
//
// Bound on H100: bytes. Every window word is read once (4 bytes/op) and
// the [S] planes are read and written once; arithmetic is a few integer
// ops per word. Layout is row-major [B, K] / [B, S], so one document's ops
// are contiguous (the TPU's docs-on-lanes transposes are not carried over).
//
// Plain C interface for ctypes; the launcher returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#define MAP_SET 0
#define MAP_DELETE 1
#define MAP_CLEAR 2
#define MAP_FOLD_THREADS 256

__global__ void __launch_bounds__(MAP_FOLD_THREADS)
map_fold_kernel(const int32_t* __restrict__ words, int K,
                const int32_t* __restrict__ lo_in,
                const int32_t* __restrict__ hi_in,
                const int32_t* __restrict__ base_in,
                const uint8_t* __restrict__ present_in,
                const int32_t* __restrict__ value_in,
                const int32_t* __restrict__ vseq_in,
                const int32_t* __restrict__ cleared_in,
                uint8_t* __restrict__ present_out,
                int32_t* __restrict__ value_out,
                int32_t* __restrict__ vseq_out,
                int32_t* __restrict__ cleared_out,
                int S) {
  extern __shared__ int32_t win[];  // [S] last live op index per slot
  __shared__ int32_t warp_clear[MAP_FOLD_THREADS / 32];
  const int d = blockIdx.x;
  const int tid = threadIdx.x;
  const int lo = max(lo_in[d], 0);
  const int hi = min(hi_in[d], K);
  const int base = base_in[d];
  const int32_t* row = words + (size_t)d * K;

  for (int s = tid; s < S; s += blockDim.x) win[s] = -1;
  __syncthreads();

  int last_clear = -1;
  for (int k = lo + tid; k < hi; k += blockDim.x) {
    const int32_t w = row[k];
    const int kind = w & 3;
    if (kind == MAP_CLEAR) {
      last_clear = k;  // k rises along this thread's stride
    } else {
      const int slot = (w >> 2) & 0x3FF;
      if (slot < S) atomicMax(&win[slot], k);
    }
  }
  for (int off = 16; off > 0; off >>= 1)
    last_clear = max(last_clear, __shfl_xor_sync(0xffffffffu, last_clear, off));
  if ((tid & 31) == 0) warp_clear[tid >> 5] = last_clear;
  __syncthreads();
  last_clear = -1;
  for (int i = 0; i < (int)(blockDim.x >> 5); ++i)
    last_clear = max(last_clear, warp_clear[i]);
  const bool cleared = last_clear >= 0;

  const size_t r = (size_t)d * S;
  for (int s = tid; s < S; s += blockDim.x) {
    const int k = win[s];
    if (k > last_clear) {
      const int32_t w = row[k];
      const bool is_set = (w & 3) == MAP_SET;
      present_out[r + s] = is_set ? 1 : 0;
      value_out[r + s] = is_set ? ((w >> 12) & 0xFFFFF) : value_in[r + s];
      vseq_out[r + s] = base + 1 + k - lo_in[d];
    } else {
      present_out[r + s] = cleared ? 0 : present_in[r + s];
      value_out[r + s] = value_in[r + s];
      vseq_out[r + s] = cleared ? -1 : vseq_in[r + s];
    }
  }
  if (tid == 0)
    cleared_out[d] = cleared ? base + 1 + last_clear - lo_in[d] : cleared_in[d];
}

extern "C" int map_fold_launch(const void* words, int B, int K,
                               const void* lo, const void* hi,
                               const void* base, const void* present_in,
                               const void* value_in, const void* vseq_in,
                               const void* cleared_in, void* present_out,
                               void* value_out, void* vseq_out,
                               void* cleared_out, int S, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  map_fold_kernel<<<B, MAP_FOLD_THREADS, S * sizeof(int32_t),
                    (cudaStream_t)stream>>>(
      (const int32_t*)words, K, (const int32_t*)lo, (const int32_t*)hi,
      (const int32_t*)base, (const uint8_t*)present_in,
      (const int32_t*)value_in, (const int32_t*)vseq_in,
      (const int32_t*)cleared_in, (uint8_t*)present_out, (int32_t*)value_out,
      (int32_t*)vseq_out, (int32_t*)cleared_out, S);
  return (int)cudaGetLastError();
}
