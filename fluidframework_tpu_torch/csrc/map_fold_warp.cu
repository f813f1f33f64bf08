// Windowed SharedMap last-writer-wins fold, warp variant — one warp per
// document, several documents a block.
//
// Replaces the TPU kernel fluidframework_tpu/ops/map_pallas.py:_fold_kernel
// (pallas_call at map_pallas.py:158, wrapper fold_words), as map_fold.cu
// does; the same function as the plain ops/map_kernel.py:fold_words_plain:
// op k of row d applies when lo[d] <= k < hi[d], with
// seq = base[d] + 1 + (k - lo[d]); the last in-window clear blanks the row
// and stamps cleared_seq; each key slot then takes its last live op after
// that clear; a slot whose winner is a delete keeps its pre-tick value;
// slots >= S are ignored.
//
// Bound on H100: bytes — every window word read once (4 bytes an op) and
// the [B, S] planes read and written once, a few integer ops a word.
// map_fold.cu runs one 256-thread block a document: about ten waves of
// short blocks, 3-4 scalar loads in flight a thread with a shared
// atomicMax between them, three block barriers, 192 of 256 threads idle
// while 64 slots are written, and each winning word read a second time.
//
// Design: one warp takes one document, and a block holds MFW_DOCS
// documents (half as many for S > 512). Each lane first reads the
// pre-tick planes of its first MFW_PREFETCH slot chunks, then its share
// of the window with 16-byte loads, MFW_UNROLL of them issued before any
// is used; the window's unaligned head and tail (lo and hi off a 16-byte
// boundary, K % 4 != 0, or a row that does not start on one) are at most
// three words each, read as scalars by lanes 0-2. Each word folds into
// its warp's own win[S] in shared memory as an atomicMax of a key that
// orders by op index and carries the winner's kind and value, so they
// need no second read: (k + 1) << 21 | set << 20 | value in 32 bits for
// windows of fewer than MFW_NARROW_K ops (on an NVIDIA H100 80GB HBM3 at
// 700 W a 64-bit shared atomicMax cost about as much as the loads on the
// map path's ticks, a 32-bit one nothing measurable), else
// (k + 1) << 32 | word in 64. The last clear is
// a __reduce_max_sync of each lane's; only __syncwarp, no block barrier.
// Each lane then writes S / 32 slots.
//
// Plain C interface for ctypes; the launcher returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#define MAP_SET 0
#define MAP_CLEAR 2
// Windows shorter than this pack their winners into 32 bits.
#define MFW_NARROW_K 2048
// Documents (warps) a block holds for S <= MFW_WIDE_S, and half as many
// above it.
#define MFW_DOCS 8
#define MFW_WIDE_S 512
// 16-byte loads a lane issues before it folds them.
#define MFW_UNROLL 4
// Chunks of 32 slots whose pre-tick planes a lane reads before the window.
#define MFW_PREFETCH 2

// A live op's winner key: its index and word, ordered by index (unique
// per op). Windows of fewer than 2,048 ops pack (k + 1, set bit, 20-bit
// value) into 32 bits; longer ones keep (k + 1) << 32 | word in 64.
template <class T>
struct WinKey;
template <>
struct WinKey<unsigned> {
  static __device__ __forceinline__ unsigned pack(int k, int32_t w) {
    return ((unsigned)(k + 1) << 21) | ((unsigned)((w & 3) == MAP_SET) << 20) |
           ((unsigned)(w >> 12) & 0xFFFFFu);
  }
  static __device__ __forceinline__ int index(unsigned key) {
    return (int)(key >> 21) - 1;
  }
  static __device__ __forceinline__ bool is_set(unsigned key) {
    return (key >> 20) & 1u;
  }
  static __device__ __forceinline__ int value(unsigned key) {
    return (int)(key & 0xFFFFFu);
  }
};
template <>
struct WinKey<unsigned long long> {
  static __device__ __forceinline__ unsigned long long pack(int k,
                                                            int32_t w) {
    return ((unsigned long long)(unsigned)(k + 1) << 32) | (unsigned)w;
  }
  static __device__ __forceinline__ int index(unsigned long long key) {
    return (int)(key >> 32) - 1;
  }
  static __device__ __forceinline__ bool is_set(unsigned long long key) {
    return ((unsigned)key & 3u) == MAP_SET;
  }
  static __device__ __forceinline__ int value(unsigned long long key) {
    return ((int32_t)(unsigned)key >> 12) & 0xFFFFF;
  }
};

template <class T>
__device__ __forceinline__ void fold_word(T* win, int S, int k, int32_t w,
                                          int& last_clear) {
  if ((w & 3) == MAP_CLEAR) {
    last_clear = k > last_clear ? k : last_clear;
  } else {
    const int slot = (w >> 2) & 0x3FF;
    if (slot < S) atomicMax(&win[slot], WinKey<T>::pack(k, w));
  }
}

template <class T>
__global__ void __launch_bounds__(MFW_DOCS * 32)
map_fold_warp_kernel(const int32_t* __restrict__ words, int B, int K,
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
                     int32_t* __restrict__ cleared_out, int S) {
  extern __shared__ int4 mfw_dyn[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int d = blockIdx.x * (blockDim.x >> 5) + warp;
  if (d >= B) return;
  T* win = reinterpret_cast<T*>(mfw_dyn) + (size_t)warp * S;
  for (int s = lane; s < S; s += 32) win[s] = 0;  // 0: no live op
  const int lo_raw = lo_in[d];
  const int lo = max(lo_raw, 0);
  const int hi = min(hi_in[d], K);
  // Sums wrap as int32, as the plain version's.
  const unsigned seq0 = (unsigned)base_in[d] + 1u - (unsigned)lo_raw;
  const int cleared_seq = cleared_in[d];
  const int32_t* row = words + (size_t)d * K;
  const size_t r = (size_t)d * S;
  // The first MFW_PREFETCH slots a lane writes: their pre-tick planes are
  // read now, under the window's loads.
  int pre[MFW_PREFETCH][3];
#pragma unroll
  for (int c = 0; c < MFW_PREFETCH; ++c) {
    const int s = lane + 32 * c;
    if (s < S) {
      pre[c][0] = present_in[r + s];
      pre[c][1] = value_in[r + s];
      pre[c][2] = vseq_in[r + s];
    }
  }
  __syncwarp();

  int last_clear = -1;
  if (lo < hi) {
    // [lo, a0) and [a1, hi) are scalar; [a0, a1) is whole 16-byte words.
    const int mis = (int)((reinterpret_cast<uintptr_t>(row + lo) >> 2) & 3);
    const int a0 = min(lo + ((4 - mis) & 3), hi);
    const int n4 = (hi - a0) >> 2;
    const int a1 = a0 + 4 * n4;
    if (lane < a0 - lo) fold_word(win, S, lo + lane, row[lo + lane],
                                  last_clear);
    if (lane < hi - a1) fold_word(win, S, a1 + lane, row[a1 + lane],
                                  last_clear);
    const int4* body = reinterpret_cast<const int4*>(row + a0);
    for (int q0 = 0; q0 < n4; q0 += 32 * MFW_UNROLL) {
      int4 v[MFW_UNROLL];
#pragma unroll
      for (int u = 0; u < MFW_UNROLL; ++u) {
        const int q = q0 + u * 32 + lane;
        if (q < n4) v[u] = __ldcs(body + q);
      }
#pragma unroll
      for (int u = 0; u < MFW_UNROLL; ++u) {
        const int q = q0 + u * 32 + lane;
        if (q < n4) {
          const int k = a0 + 4 * q;
          fold_word(win, S, k, v[u].x, last_clear);
          fold_word(win, S, k + 1, v[u].y, last_clear);
          fold_word(win, S, k + 2, v[u].z, last_clear);
          fold_word(win, S, k + 3, v[u].w, last_clear);
        }
      }
    }
  }
  last_clear = __reduce_max_sync(0xffffffffu, last_clear);
  __syncwarp();
  const bool cleared = last_clear >= 0;
  auto write = [&](int s, int present, int value, int vseq) {
    const T key = win[s];
    const int k = WinKey<T>::index(key);
    if (k > last_clear) {
      const bool set = WinKey<T>::is_set(key);
      present_out[r + s] = set ? 1 : 0;
      value_out[r + s] = set ? WinKey<T>::value(key) : value;
      vseq_out[r + s] = (int32_t)(seq0 + (unsigned)k);
    } else {
      present_out[r + s] = cleared ? 0 : (uint8_t)present;
      value_out[r + s] = value;
      vseq_out[r + s] = cleared ? -1 : vseq;
    }
  };
#pragma unroll
  for (int c = 0; c < MFW_PREFETCH; ++c)
    if (lane + 32 * c < S)
      write(lane + 32 * c, pre[c][0], pre[c][1], pre[c][2]);
  for (int s = lane + 32 * MFW_PREFETCH; s < S; s += 32)
    write(s, present_in[r + s], value_in[r + s], vseq_in[r + s]);
  if (lane == 0)
    cleared_out[d] =
        cleared ? (int32_t)(seq0 + (unsigned)last_clear) : cleared_seq;
}

// Documents one block holds at S key slots.
__host__ __forceinline__ int warp_docs(int S) {
  return S <= MFW_WIDE_S ? MFW_DOCS : MFW_DOCS / 2;
}

extern "C" int map_fold_warp_launch(const void* words, int B, int K,
                                    const void* lo, const void* hi,
                                    const void* base, const void* present_in,
                                    const void* value_in, const void* vseq_in,
                                    const void* cleared_in, void* present_out,
                                    void* value_out, void* vseq_out,
                                    void* cleared_out, int S, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (S < 1 || S > 1024) return (int)cudaErrorInvalidValue;
  const int docs = warp_docs(S);
  const bool narrow = K < MFW_NARROW_K;
  const size_t smem =
      (size_t)docs * S *
      (narrow ? sizeof(unsigned) : sizeof(unsigned long long));
  void (*kernel)(const int32_t*, int, int, const int32_t*, const int32_t*,
                 const int32_t*, const uint8_t*, const int32_t*,
                 const int32_t*, const int32_t*, uint8_t*, int32_t*,
                 int32_t*, int32_t*, int) =
      narrow ? map_fold_warp_kernel<unsigned>
             : map_fold_warp_kernel<unsigned long long>;
  kernel<<<(B + docs - 1) / docs, docs * 32, smem, (cudaStream_t)stream>>>(
      (const int32_t*)words, B, K, (const int32_t*)lo, (const int32_t*)hi,
      (const int32_t*)base, (const uint8_t*)present_in,
      (const int32_t*)value_in, (const int32_t*)vseq_in,
      (const int32_t*)cleared_in, (uint8_t*)present_out, (int32_t*)value_out,
      (int32_t*)vseq_out, (int32_t*)cleared_out, S);
  return (int)cudaGetLastError();
}
