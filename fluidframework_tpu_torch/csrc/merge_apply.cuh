// One sequenced merge-tree op on one document's FLAT segment table, run by
// one thread block — the per-op step of the flat merge tick
// (mergetree_flat.cu), kept in a header so other kernels that walk a merge
// axis (the SharedMatrix tick) can include it.
//
// Same function as ops/mergetree_kernel.py:_apply_op (the reference's
// fluidframework_tpu/ops/mergetree_kernel.py:_apply_op and its Pallas
// twin merge_apply_vec, mergetree_pallas.py:141): visibility to
// (refSeq, client), the exclusive prefix of visible lengths, up to two
// interior splits, the tie-broken placement on the post-split frame, ONE
// shift of 0/1/2 slots over every plane, then the remove mark (with the
// overlap bitmask) or the annotate on the moved table.
//
// Design: the planes stay in global memory (S grows with the document).
// A block walks the slot axis in tiles of blockDim.x with a running
// carry; each tile is a warp-shuffle scan. "First true" is a block min
// over (index << 32 | value) keys. The shift writes in place, tiles in
// DESCENDING order, each plane read into registers before a barrier and
// written after it: a slot's source lies at most two slots below it, so
// no read sees a value this op already wrote. The shift's wrapped reads
// (roll semantics: slot i < 2 reads slot S - 2 + i) come from copies of
// the top two slots saved before the shift. Integer sums wrap as int32.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define MT_INSERT 0
#define MT_REMOVE 1
#define MT_NONE_SEQ 0x7fffffff
#define MT_NOKEY 0xffffffffffffffffull

namespace mt {

enum { LENGTH = 0, INS_SEQ, INS_CLIENT, REM_SEQ, REM_CLIENT, POOL_START,
       NUM_PLANES };

// One document's flat table: plane[f][i], prop[i * P + p],
// overlap[i * W + w]; valid is torch.bool storage.
struct FlatDoc {
  uint8_t* valid;
  int32_t* plane[NUM_PLANES];
  int32_t* prop;
  int32_t* overlap;
  int S, P, W;
};

struct Op {
  int valid, kind, pos, end, seq, ref_seq, client, pool_start, text_len,
      prop_key, prop_val;
};

// Shared scratch of the block: warp totals for the scans and reductions,
// and the document's count.
struct Shared {
  int warp_int[32];
  unsigned long long warp_key[32];
  int count;
};

__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ unsigned long long key_of(int i, int v) {
  return ((unsigned long long)(unsigned)i << 32) | (unsigned)v;
}

// Visible length of slot i for (ref, client): nodeLength.
__device__ __forceinline__ int vis_len(const FlatDoc& d, int i, int ref,
                                       int client) {
  if (!d.valid[i]) return 0;
  const bool ins_vis = d.plane[INS_SEQ][i] <= ref ||
                       d.plane[INS_CLIENT][i] == client;
  const int rem = d.plane[REM_SEQ][i];
  bool removed_vis = false;
  if (rem != MT_NONE_SEQ) {
    const int c = clampi(client, 0, 32 * d.W - 1);
    const unsigned word = (unsigned)d.overlap[(size_t)i * d.W + (c >> 5)];
    removed_vis = rem <= ref || d.plane[REM_CLIENT][i] == client ||
                  ((word >> (c & 31)) & 1u);
  }
  return (ins_vis && !removed_vis) ? d.plane[LENGTH][i] : 0;
}

// Block-wide exclusive scan over slots [0, n): value(i) gives slot i's
// term, visit(i, excl, v) runs for each slot with its exclusive prefix.
// Returns the total to every thread. Every thread of the block must call
// it.
template <class Value, class Visit>
__device__ int block_scan(int n, Value value, Visit visit, Shared& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  int carry = 0;
  for (int base = 0; base < n; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const int v = i < n ? value(i) : 0;
    int x = v;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x = wadd(x, y);
    }
    if (lane == 31) sh.warp_int[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int t = lane < nwarps ? sh.warp_int[lane] : 0;
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, t, o);
        if (lane >= o) t = wadd(t, y);
      }
      if (lane < nwarps) sh.warp_int[lane] = t;
    }
    __syncthreads();
    const int before = warp ? sh.warp_int[warp - 1] : 0;
    const int total = sh.warp_int[nwarps - 1];
    if (i < n) visit(i, wadd(carry, wadd(before, wsub(x, v))), v);
    carry = wadd(carry, total);
    __syncthreads();
  }
  return carry;
}

// Block-wide min of a 64-bit key; every thread gets the result.
__device__ unsigned long long block_min(unsigned long long v, Shared& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long y = __shfl_xor_sync(0xffffffffu, v, o);
    v = y < v ? y : v;
  }
  if (lane == 0) sh.warp_key[warp] = v;
  __syncthreads();
  v = sh.warp_key[0];
  for (int w = 1; w < nwarps; ++w) v = sh.warp_key[w] < v ? sh.warp_key[w] : v;
  __syncthreads();
  return v;
}

// Apply one VALID op to the document. ``saved`` is dynamic shared memory
// of 2 * (NUM_PLANES + 1 + P + W) ints. Every thread must call it.
__device__ void apply_op(const FlatDoc& d, const Op& op, Shared& sh,
                         int* saved) {
  const int S = d.S, P = d.P, W = d.W;
  const int ref = op.ref_seq, client = op.client;
  const bool is_insert = op.kind == MT_INSERT;
  const bool is_remove = op.kind == MT_REMOVE;
  const int p1 = op.pos;
  const int p2 = is_insert ? -1 : op.end;

  // 1. Visible prefix; the slots that the two split points fall inside.
  unsigned long long k1 = MT_NOKEY, k2 = MT_NOKEY;
  block_scan(
      S, [&](int i) { return vis_len(d, i, ref, client); },
      [&](int i, int cum, int vis) {
        const int hi = wadd(cum, vis);
        if (cum < p1 && p1 < hi) k1 = k1 < key_of(i, cum) ? k1 : key_of(i, cum);
        if (cum < p2 && p2 < hi && p2 != p1)
          k2 = k2 < key_of(i, cum) ? k2 : key_of(i, cum);
      },
      sh);
  k1 = block_min(k1, sh);
  k2 = block_min(k2, sh);
  const bool has1 = k1 != MT_NOKEY, has2 = k2 != MT_NOKEY;
  // argmax of an all-false row is 0, whose exclusive prefix is 0.
  const int i1 = has1 ? (int)(k1 >> 32) : 0;
  const int i2 = has2 ? (int)(k2 >> 32) : 0;
  const int o1 = wsub(p1, has1 ? (int)(unsigned)k1 : 0);
  const int o2 = wsub(p2, has2 ? (int)(unsigned)k2 : 0);
  const bool same = has1 && has2 && i1 == i2;
  const int t1 = i1 + 1;
  const int t2 = i2 + 1 + ((has1 && i1 <= i2) ? 1 : 0);
  const int vis_i1 = vis_len(d, i1, ref, client);

  // 2. Placement: first slot of the post-first-split frame at p1 that is
  // not skipped (invalid, or removed at/below ref); else the count.
  auto src1 = [&](int i) { return (has1 && i >= t1) ? (i - 1 + S) % S : i; };
  unsigned long long kc = MT_NOKEY;
  block_scan(
      S,
      [&](int i) {
        if (has1 && i == i1) return o1;
        if (has1 && i == t1) return wsub(vis_i1, o1);
        return vis_len(d, src1(i), ref, client);
      },
      [&](int i, int cum, int) {
        const int j = src1(i);
        const int rem = d.plane[REM_SEQ][j];
        const bool skip = !d.valid[j] || (rem != MT_NONE_SEQ && rem <= ref);
        if (cum == p1 && !skip) kc = kc < (unsigned long long)i ? kc : i;
      },
      sh);
  kc = block_min(kc, sh);
  const int count = sh.count;
  const int tp = kc != MT_NOKEY ? (int)kc : wadd(count, has1 ? 1 : 0);

  // 3. The fused shift of 0/1/2 slots with the split and placement
  // overrides, in place.
  const int t1f = (is_insert && tp <= t1) ? t1 + 1 : t1;
  const int point_b = is_insert ? tp : t2;
  const bool gate_b = is_insert || has2;
  const int head2 = i2 + ((has1 && i1 < i2) ? 1 : 0);
  if (has1 || gate_b) {
    const int nrows = NUM_PLANES + 1 + P + W;
    for (int q = threadIdx.x; q < 2 * nrows; q += blockDim.x) {
      const int r = q / nrows, f = q % nrows;
      const int j = ((S - 2 + r) % S + S) % S;
      int v;
      if (f < NUM_PLANES) v = d.plane[f][j];
      else if (f == NUM_PLANES) v = d.valid[j];
      else if (f < NUM_PLANES + 1 + P) v = d.prop[(size_t)j * P + (f - NUM_PLANES - 1)];
      else v = d.overlap[(size_t)j * W + (f - NUM_PLANES - 1 - P)];
      saved[r * nrows + f] = v;
    }
    __syncthreads();
    for (int base = ((S - 1) / (int)blockDim.x) * (int)blockDim.x; base >= 0;
         base -= blockDim.x) {
      const int i = base + threadIdx.x;
      const bool on = i < S;
      const int shift = ((has1 && i >= t1f) ? 1 : 0) +
                        ((gate_b && i >= point_b) ? 1 : 0);
      const int src = i - shift;
      const bool tail1 = has1 && i == t1f;
      const bool tail2 = !is_insert && has2 && i == point_b;
      const bool head1 = has1 && i == i1;
      const bool head2b = !is_insert && has2 && !same && i == head2;
      const bool placed = is_insert && i == tp;
      const int start_off = tail2 ? o2 : (tail1 ? o1 : 0);
      auto load = [&](int f) -> int {
        if (src >= 0) {
          if (f < NUM_PLANES) return d.plane[f][src];
          if (f == NUM_PLANES) return d.valid[src];
          if (f < NUM_PLANES + 1 + P)
            return d.prop[(size_t)src * P + (f - NUM_PLANES - 1)];
          return d.overlap[(size_t)src * W + (f - NUM_PLANES - 1 - P)];
        }
        return saved[(src + 2) * nrows + f];
      };
      for (int f = 0; f < nrows; ++f) {
        const int v = on ? load(f) : 0;
        __syncthreads();
        if (!on) continue;
        if (f == LENGTH) {
          const int end_off = head1 ? o1
                              : (same && tail1) ? o2
                              : head2b ? o2 : v;
          d.plane[f][i] = placed ? op.text_len : wsub(end_off, start_off);
        } else if (f == INS_SEQ) {
          d.plane[f][i] = placed ? op.seq : v;
        } else if (f == INS_CLIENT) {
          d.plane[f][i] = placed ? op.client : v;
        } else if (f == REM_SEQ) {
          d.plane[f][i] = placed ? MT_NONE_SEQ : v;
        } else if (f == REM_CLIENT) {
          d.plane[f][i] = placed ? -1 : v;
        } else if (f == POOL_START) {
          d.plane[f][i] = placed ? op.pool_start : wadd(v, start_off);
        } else if (f == NUM_PLANES) {
          d.valid[i] = placed ? 1 : (uint8_t)v;
        } else if (f < NUM_PLANES + 1 + P) {
          d.prop[(size_t)i * P + (f - NUM_PLANES - 1)] = placed ? 0 : v;
        } else {
          d.overlap[(size_t)i * W + (f - NUM_PLANES - 1 - P)] = placed ? 0 : v;
        }
      }
    }
  }
  __syncthreads();
  if (threadIdx.x == 0)
    sh.count = wadd(wadd(count, has1 ? 1 : 0),
                    is_insert ? 1 : (has2 ? 1 : 0));

  // 4. Remove mark or annotate over the moved table's [pos, end).
  if (!is_insert) {
    const int c = clampi(client, 0, 32 * W - 1);
    const int bit = (int)(1u << (c & 31));
    block_scan(
        S, [&](int i) { return vis_len(d, i, ref, client); },
        [&](int i, int cum, int vis) {
          if (!(vis > 0 && cum >= op.pos && cum < op.end)) return;
          if (is_remove) {
            if (d.plane[REM_SEQ][i] == MT_NONE_SEQ) {
              d.plane[REM_SEQ][i] = op.seq;
              d.plane[REM_CLIENT][i] = client;
            } else {
              d.overlap[(size_t)i * W + (c >> 5)] |= bit;
            }
          } else if (op.prop_key >= 0 && op.prop_key < P) {
            d.prop[(size_t)i * P + op.prop_key] = op.prop_val;
          }
        },
        sh);
  }
  __syncthreads();
}

}  // namespace mt
