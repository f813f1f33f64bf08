// SharedTree tick, shared-memory warp kernel — one warp applies one
// document's K tree ops, in order, to the document's node table held in
// shared memory; one launch a tick.
//
// Replaces the XLA tick fluidframework_tpu/ops/tree_kernel.py:apply_tick
// (jitted JAX, not a Pallas kernel); the same function as the plain
// ops/tree_kernel.py:apply_tick, bit for bit: per valid op of a document,
// in order, set_value, detach (the node's whole subtree), insert at the
// end or start of a trait or before or after a sibling, the two
// constraints, and the four moves (the subtree keeps its shape, its root
// takes the new parent, trait and rank). Ranks are i32 and every sum wraps
// as torch's i32 does: the midpoint sums prev + r and r + next are added
// as unsigned and cast back, halving is an arithmetic shift (floor), the
// default neighbours are r -/+ 2 * RANK_GAP, and abs(INT32_MIN) stays
// negative. Invalid ops change nothing and read applied = overflow = 0.
//
// Bound on H100: bytes. perfbench/metrics/_work.py:tree_bytes counts each
// valid op's fields read once and the node it names read and written once
// (~0.28 us a tick of mixed_8k's 16,384 tree ops at 3.35 TB/s); the
// outputs are new tensors, so every row's 17 bytes a slot are read and
// written once besides (35.7 MB, ~11 us, at 8,192 documents x 128 slots).
// The plain version runs ~60 launches over the whole [B, N] state a step,
// and 32 passes of gather/and/or more where any document detaches or
// moves: ~1,300 launches a tick at K = 8, each nearly idle, paced by the
// host.
//
// Design: one warp a document, tt_docs(N) documents a block (8, fewer for
// rows wider than TT_BLOCK_BYTES / 8: from N alone). A document with a
// valid op stages its row (exists u8, parent, trait, rank, payload i32;
// 17 bytes a slot, and two mark bytes) in dynamic shared memory with
// 16-byte loads where the row allows, applies its ops there and writes the
// row back once; a document with none copies its row through, global to
// global. Lane j holds op j of each 32-op chunk and broadcasts it by
// shuffles; slot s belongs to lane s % 32. The five sibling reductions
// (count, max and min rank, the rank just below and just above the
// anchor) are __reduce_*_sync over each lane's slots, taken only for ops
// that read them (inserts, moves, the count constraint). The subtree sweep
// of a detach or move is Jacobi: each pass reads the previous pass's
// marks and writes the other mark buffer, marking a slot whose parent was
// marked (stale detached slots included, as in the plain version); it
// stops at the first pass that adds nothing, and a 32nd pass that still
// adds sets depth_blown, which is exactly the plain version's "marked
// after 32 passes != after 31". A sweep in place would converge sooner
// and change overflow on chains deeper than 32. A step marked off in the
// launch's step mask takes the seed as its mask and never reports depth.
// Every sync is __syncwarp or __any_sync: no block barrier. One warp, not
// a block, a document: a step touches N / 32 slots a lane at the serving
// widths (4 at N = 128), so a block's barriers and shared reductions
// would cost more than the step's work, and eight documents a block keep
// 64 warps an SM in flight.
//
// Plain C interface for ctypes; the launcher returns cudaGetLastError().

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define TT_SET_VALUE 0
#define TT_DETACH 1
#define TT_INSERT 2
#define TT_INSERT_BEFORE 3
#define TT_INSERT_AFTER 4
#define TT_INSERT_START 5
#define TT_CONSTRAINT_EXISTS 6
#define TT_CONSTRAINT_COUNT 7
#define TT_MOVE 8
#define TT_MOVE_BEFORE 9
#define TT_MOVE_AFTER 10
#define TT_MOVE_START 11

#define TT_RANK_GAP 65536
#define TT_RANK_LIMIT (1 << 30)
#define TT_MAX_DEPTH_PASSES 32

// Documents (warps) a block holds at most, and the shared memory a block
// is given before it holds fewer.
#define TT_DOCS 8
#define TT_BLOCK_BYTES 49152
// Shared bytes a slot: exists, parent, trait, rank, payload, two marks.
#define TT_SLOT_BYTES 19
// 64-step words of the step mask a launch carries by value.
#define TT_STEP_WORDS 128

#define TT_FULL 0xffffffffu

struct TreeTickArgs {
  const uint8_t* exists;
  const int32_t* parent;
  const int32_t* trait;
  const int32_t* rank;
  const int32_t* payload;
  const uint8_t* op_valid;
  const int32_t* op_kind;
  const int32_t* op_node;
  const int32_t* op_parent;
  const int32_t* op_trait;
  const int32_t* op_payload;
  uint8_t* o_exists;
  int32_t* o_parent;
  int32_t* o_trait;
  int32_t* o_rank;
  int32_t* o_payload;
  uint8_t* applied;
  uint8_t* overflow;
  int B, N, K;
  int all_steps;  // 1: every step sweeps (steps=None)
  unsigned long long steps[TT_STEP_WORDS];
};

// Shared bytes one document takes, rounded to 16.
__host__ __device__ __forceinline__ long long tt_doc_bytes(int N) {
  return ((long long)TT_SLOT_BYTES * N + 15) / 16 * 16;
}

// Documents one block holds at N slots.
__host__ __forceinline__ int tt_docs(int N) {
  const long long d = TT_BLOCK_BYTES / tt_doc_bytes(N);
  return d < 1 ? 1 : (d > TT_DOCS ? TT_DOCS : (int)d);
}

__device__ __forceinline__ bool tt_aligned(const void* a, const void* b) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) &
          15) == 0;
}

__device__ __forceinline__ void copy_i32(int32_t* dst, const int32_t* src,
                                         int n, int lane) {
  if ((n & 3) == 0 && tt_aligned(dst, src)) {
    const int4* s4 = reinterpret_cast<const int4*>(src);
    int4* d4 = reinterpret_cast<int4*>(dst);
    for (int q = lane; q < (n >> 2); q += 32) d4[q] = s4[q];
  } else {
    for (int s = lane; s < n; s += 32) dst[s] = src[s];
  }
}

__device__ __forceinline__ void copy_u8(uint8_t* dst, const uint8_t* src,
                                        int n, int lane) {
  if ((n & 15) == 0 && tt_aligned(dst, src)) {
    const int4* s4 = reinterpret_cast<const int4*>(src);
    int4* d4 = reinterpret_cast<int4*>(dst);
    for (int q = lane; q < (n >> 4); q += 32) d4[q] = s4[q];
  } else {
    for (int s = lane; s < n; s += 32) dst[s] = src[s];
  }
}

__device__ __forceinline__ int tt_clamp(int v, int n) {
  return v < 0 ? 0 : (v > n - 1 ? n - 1 : v);
}

// i32 sums that wrap as torch's do.
__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

// One document's row in shared memory.
struct Row {
  int32_t* par;
  int32_t* tra;
  int32_t* rnk;
  int32_t* pay;
  uint8_t* ex;
  uint8_t* mk[2];
};

// One valid op on the row: sets ok and ovf (the same on every lane).
__device__ __forceinline__ void tt_step(const Row& r, int N, int lane,
                                        bool sweep, int kind, int node,
                                        int opp, int otr, int opay, bool& ok,
                                        bool& ovf) {
  const bool is_set = kind == TT_SET_VALUE, is_detach = kind == TT_DETACH;
  const bool is_insert = kind >= TT_INSERT && kind <= TT_INSERT_START;
  const bool is_move = kind >= TT_MOVE && kind <= TT_MOVE_START;
  const bool is_cexists = kind == TT_CONSTRAINT_EXISTS;
  const bool is_ccount = kind == TT_CONSTRAINT_COUNT;
  const bool place_end = kind == TT_INSERT || kind == TT_MOVE;
  const bool place_start = kind == TT_INSERT_START || kind == TT_MOVE_START;
  const bool place_before =
      kind == TT_INSERT_BEFORE || kind == TT_MOVE_BEFORE;
  const bool place_after = kind == TT_INSERT_AFTER || kind == TT_MOVE_AFTER;
  const bool sibling_rel = place_before || place_after;

  const int node_slot = tt_clamp(node, N), anchor = tt_clamp(opp, N);
  const bool node_in_range = node >= 0 && node < N;
  const bool nonroot = node != 0;
  const bool sib_in_range = opp > 0 && opp < N;
  const bool node_exists = r.ex[node_slot] != 0;

  // Destination (parent, trait): sibling-relative placements inherit the
  // sibling's, the rest name it directly.
  const int ins_parent = sibling_rel ? r.par[anchor] : opp;
  const int ins_trait = sibling_rel ? r.tra[anchor] : otr;
  const int ins_parent_slot = tt_clamp(ins_parent, N);
  const bool parent_exists =
      r.ex[ins_parent_slot] != 0 && ins_parent >= 0 && ins_parent < N;
  const bool sib_exists = r.ex[anchor] != 0 && sib_in_range;
  const bool anchor_ok = sibling_rel ? sib_exists : parent_exists;
  const bool node_ok = node_exists && node_in_range;

  // The destination trait's siblings: their count and the rank of each
  // placement flavour with its gap and overflow check.
  int sib_count = 0, new_rank = 0;
  bool gap_ok = false;
  if (is_insert || is_move || is_ccount) {
    const int r_s = r.rnk[anchor];
    const int fill_prev = wrap_add(r_s, -2 * TT_RANK_GAP);
    const int fill_next = wrap_add(r_s, 2 * TT_RANK_GAP);
    int cnt = 0, mx = INT_MIN, mn = INT_MAX, pv = INT_MIN, nx = INT_MAX;
    for (int s = lane; s < N; s += 32) {
      const bool sib =
          r.ex[s] != 0 && r.par[s] == ins_parent && r.tra[s] == ins_trait;
      const int rk = r.rnk[s];
      cnt += sib;
      mx = max(mx, sib ? rk : -TT_RANK_LIMIT);
      mn = min(mn, sib ? rk : TT_RANK_LIMIT);
      pv = max(pv, sib && rk < r_s ? rk : fill_prev);
      nx = min(nx, sib && rk > r_s ? rk : fill_next);
    }
    sib_count = __reduce_add_sync(TT_FULL, cnt);
    const int max_r = __reduce_max_sync(TT_FULL, mx);
    const int min_r = __reduce_min_sync(TT_FULL, mn);
    const int prev_r = __reduce_max_sync(TT_FULL, pv);
    const int next_r = __reduce_min_sync(TT_FULL, nx);
    const bool has_sibs = sib_count > 0;
    const int end_rank = has_sibs ? wrap_add(max_r, TT_RANK_GAP) : 0;
    const int start_rank = has_sibs ? wrap_add(min_r, -TT_RANK_GAP) : 0;
    const int before_rank = wrap_add(prev_r, r_s) >> 1;
    const int after_rank = wrap_add(r_s, next_r) >> 1;
    new_rank = place_end ? end_rank
               : place_start ? start_rank
               : place_before ? before_rank
                              : after_rank;
    const bool before_ok = before_rank > prev_r && before_rank < r_s;
    const bool after_ok = after_rank > r_s && after_rank < next_r;
    // abs as torch's: abs(INT32_MIN) is INT32_MIN.
    const int mag =
        new_rank < 0 ? (int)(0u - (unsigned)new_rank) : new_rank;
    gap_ok = mag < TT_RANK_LIMIT &&
             (place_before ? before_ok : (!place_after || after_ok));
  }

  const bool insert_would = is_insert && anchor_ok && !node_exists &&
                            nonroot && node_in_range;
  const bool insert_ok = insert_would && gap_ok;

  // Subtree mask of the node (detach's removal set, move's cycle check).
  const bool seeded = node_ok && nonroot && (is_detach || is_move);
  const uint8_t* marked = nullptr;
  bool blown = false;
  if (seeded) {
    uint8_t* cur = r.mk[0];
    uint8_t* nxt = r.mk[1];
    for (int s = lane; s < N; s += 32) cur[s] = s == node_slot;
    __syncwarp();
    if (sweep) {
      for (int pass = 0; pass < TT_MAX_DEPTH_PASSES; ++pass) {
        bool grew = false;
        for (int s = lane; s < N; s += 32) {
          uint8_t v = cur[s];
          const int p = r.par[s];
          if (!v && p >= 0 && p < N && cur[p]) {
            v = 1;
            grew = true;
          }
          nxt[s] = v;
        }
        __syncwarp();
        uint8_t* t = cur;
        cur = nxt;
        nxt = t;
        if (!__any_sync(TT_FULL, grew)) break;
        if (pass == TT_MAX_DEPTH_PASSES - 1) blown = true;
      }
    }
    marked = cur;
  }

  // Move validity: destination anchored outside the moved subtree.
  const bool dest_in_sub =
      marked != nullptr &&
      marked[sibling_rel ? anchor : ins_parent_slot] != 0;
  const bool move_would =
      is_move && node_ok && nonroot && anchor_ok && !dest_in_sub;
  const bool move_ok = move_would && gap_ok && !blown;
  const bool detach_would = is_detach && node_ok && nonroot;
  ovf = ((insert_would || move_would) && !gap_ok) ||
        ((detach_would || move_would) && blown);
  const bool ccount_ok = parent_exists && sib_count == opay;
  const bool other_ok = node_ok && (!is_detach || (nonroot && !blown));
  ok = is_insert    ? insert_ok
       : is_move    ? move_ok
       : is_cexists ? node_ok && nonroot
       : is_ccount  ? ccount_ok
                    : other_ok;

  __syncwarp();  // every lane has read the pre-step row
  if (ok) {
    if (is_detach) {
      for (int s = lane; s < N; s += 32)
        if (marked[s]) r.ex[s] = 0;
    } else if (lane == 0) {
      if (is_set) {
        r.pay[node_slot] = opay;
      } else if (is_insert || is_move) {
        if (is_insert) {
          r.ex[node_slot] = 1;
          r.pay[node_slot] = opay;
        }
        r.par[node_slot] = ins_parent;
        r.tra[node_slot] = ins_trait;
        r.rnk[node_slot] = new_rank;
      }
    }
  }
  __syncwarp();
}

__global__ void __launch_bounds__(TT_DOCS * 32)
    tree_tick_smem_kernel(const TreeTickArgs a) {
  extern __shared__ int4 tt_smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int d = blockIdx.x * (blockDim.x >> 5) + warp;
  if (d >= a.B) return;
  const int N = a.N, K = a.K;
  const size_t row = (size_t)d * N, orow = (size_t)d * K;

  bool any = false;
  for (int k = lane; k < K; k += 32) any |= a.op_valid[orow + k] != 0;
  if (!__any_sync(TT_FULL, any)) {
    // No valid op: the row copies through and every flag reads 0.
    copy_u8(a.o_exists + row, a.exists + row, N, lane);
    copy_i32(a.o_parent + row, a.parent + row, N, lane);
    copy_i32(a.o_trait + row, a.trait + row, N, lane);
    copy_i32(a.o_rank + row, a.rank + row, N, lane);
    copy_i32(a.o_payload + row, a.payload + row, N, lane);
    for (int k = lane; k < K; k += 32) {
      a.applied[orow + k] = 0;
      a.overflow[orow + k] = 0;
    }
    return;
  }

  char* base = reinterpret_cast<char*>(tt_smem) + warp * tt_doc_bytes(N);
  Row r;
  r.par = reinterpret_cast<int32_t*>(base);
  r.tra = r.par + N;
  r.rnk = r.tra + N;
  r.pay = r.rnk + N;
  r.ex = reinterpret_cast<uint8_t*>(r.pay + N);
  r.mk[0] = r.ex + N;
  r.mk[1] = r.mk[0] + N;
  copy_u8(r.ex, a.exists + row, N, lane);
  copy_i32(r.par, a.parent + row, N, lane);
  copy_i32(r.tra, a.trait + row, N, lane);
  copy_i32(r.rnk, a.rank + row, N, lane);
  copy_i32(r.pay, a.payload + row, N, lane);
  __syncwarp();

  for (int c = 0; c < K; c += 32) {
    const int k = c + lane;
    int valid = 0, kind = 0, node = 0, opp = 0, otr = 0, opay = 0;
    if (k < K) {
      valid = a.op_valid[orow + k];
      kind = a.op_kind[orow + k];
      node = a.op_node[orow + k];
      opp = a.op_parent[orow + k];
      otr = a.op_trait[orow + k];
      opay = a.op_payload[orow + k];
    }
    bool my_ok = false, my_ovf = false;
    const int n_steps = min(32, K - c);
    for (int j = 0; j < n_steps; ++j) {
      if (!__shfl_sync(TT_FULL, valid, j)) continue;
      const int i = c + j;
      const bool sweep =
          a.all_steps || ((a.steps[i >> 6] >> (i & 63)) & 1ull) != 0;
      bool ok, ovf;
      tt_step(r, N, lane, sweep, __shfl_sync(TT_FULL, kind, j),
              __shfl_sync(TT_FULL, node, j), __shfl_sync(TT_FULL, opp, j),
              __shfl_sync(TT_FULL, otr, j), __shfl_sync(TT_FULL, opay, j),
              ok, ovf);
      if (lane == j) {
        my_ok = ok;
        my_ovf = ovf;
      }
    }
    if (k < K) {
      a.applied[orow + k] = my_ok;
      a.overflow[orow + k] = my_ovf;
    }
  }

  copy_u8(a.o_exists + row, r.ex, N, lane);
  copy_i32(a.o_parent + row, r.par, N, lane);
  copy_i32(a.o_trait + row, r.tra, N, lane);
  copy_i32(a.o_rank + row, r.rnk, N, lane);
  copy_i32(a.o_payload + row, r.pay, N, lane);
}

extern "C" const char* tree_tick_smem_layout() {
  return "exists,parent,trait,rank,payload,"
         "op_valid,op_kind,op_node,op_parent,op_trait,op_payload,"
         "o_exists,o_parent,o_trait,o_rank,o_payload,"
         "applied,overflow";
}

extern "C" int tree_tick_smem_optin() {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  return v;
}

// p: the 18 tensors in tree_tick_smem_layout()'s order. steps: n_words
// 64-step words (bit i & 63 of word i >> 6 is step i), or NULL to sweep
// every step.
extern "C" int tree_tick_smem_launch(void** p, int B, int N, int K,
                                     int smem_bytes,
                                     const unsigned long long* steps,
                                     int n_words, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (N < 1 || K < 0) return (int)cudaErrorInvalidValue;
  // The binding computes the same bytes from N and passes them.
  if ((long long)smem_bytes != tt_docs(N) * tt_doc_bytes(N))
    return (int)cudaErrorInvalidValue;
  if (steps != nullptr &&
      (n_words < 0 || n_words > TT_STEP_WORDS || 64LL * n_words < K))
    return (int)cudaErrorInvalidValue;
  TreeTickArgs a;
  a.exists = (const uint8_t*)p[0];
  a.parent = (const int32_t*)p[1];
  a.trait = (const int32_t*)p[2];
  a.rank = (const int32_t*)p[3];
  a.payload = (const int32_t*)p[4];
  a.op_valid = (const uint8_t*)p[5];
  a.op_kind = (const int32_t*)p[6];
  a.op_node = (const int32_t*)p[7];
  a.op_parent = (const int32_t*)p[8];
  a.op_trait = (const int32_t*)p[9];
  a.op_payload = (const int32_t*)p[10];
  a.o_exists = (uint8_t*)p[11];
  a.o_parent = (int32_t*)p[12];
  a.o_trait = (int32_t*)p[13];
  a.o_rank = (int32_t*)p[14];
  a.o_payload = (int32_t*)p[15];
  a.applied = (uint8_t*)p[16];
  a.overflow = (uint8_t*)p[17];
  a.B = B;
  a.N = N;
  a.K = K;
  a.all_steps = steps == nullptr;
  for (int w = 0; w < TT_STEP_WORDS; ++w)
    a.steps[w] = steps != nullptr && w < n_words ? steps[w] : 0ull;
  const int docs = tt_docs(N);
  const cudaError_t err =
      cudaFuncSetAttribute(tree_tick_smem_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_bytes);
  if (err != cudaSuccess) return (int)err;
  tree_tick_smem_kernel<<<(B + docs - 1) / docs, docs * 32, smem_bytes,
                          (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
