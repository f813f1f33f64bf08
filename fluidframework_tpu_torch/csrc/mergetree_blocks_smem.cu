// Block merge-tree tick, shared-memory variant — one thread block per
// document walks its K ops over the [NB, Bk] block table held in shared
// memory.
//
// Replaces the TPU kernel fluidframework_tpu/ops/mergetree_blocks_pallas.py:
// 73 _tick_kernel (pallas_call at mergetree_blocks_pallas.py:153), as
// mergetree_blocks.cu does; the same function as the plain
// ops/mergetree_blocks.py:apply_tick_blocks, bit for bit: per op a split
// at pos, a split at end, then place (insert), mark (remove) or annotate;
// two-level frames (a cold block, blk_max_seq <= ref, contributes
// blk_live_len verbatim); an op whose target block is full reverts
// entirely and records its index in the sticky per-doc ovf.
//
// Bound on H100: not the bytes (the row is read once and written once,
// about 0.14 ms for 8,192 docs of 4 x 128 slots) but the latency of one
// document's op chain: every op is three frames and up to three shifts,
// one after another, each behind barriers. mergetree_blocks.cu runs them
// over the row in global memory through L2, with NB block scans in
// series per frame and a barrier per field per tile in each shift.
//
// Design: the row (six slot planes, P prop and W overlap planes, all
// field-major; the four [NB] summaries; the ops) is staged in dynamic
// shared memory with 16-byte loads and written back once. A frame scans
// the NB blocks in parallel, one warp per block (shuffle scans), and
// takes one barrier; every later pass reads a block's prefix from the
// [NB] block sums with one warp sum. The reductions over the whole table
// (first hit, the sum of gcum over hits, the head's tombstone flag), as
// the plain version runs them, so inexact summaries give the same result,
// are warp reductions and one barrier. A shift moves whole fields, one
// warp per field (smem_doc.cuh), with no block barrier inside. There is
// no saved block: a split records only the target block's old last slot
// (the one value its shift drops), its old head length and the block's
// count and tombstones, and a revert shifts the block back. About ten
// barriers an op. The launcher is picked by shape
// (ops/mergetree_blocks_cuda.py): rows that do not fit the card's
// per-block shared memory run mergetree_blocks.cu.
//
// Plain C interface for ctypes; the launcher returns cudaGetLastError().

#include "merge_apply.cuh"
#include "smem_doc.cuh"

#define MTS_THREADS 128
#define MTS_WARPS (MTS_THREADS / 32)
#define MTS_HEADER_INTS 256
#define MTS_OP_FIELDS 11
#define MTS_OVF_NONE 0x7fffffff
#define MTS_NOSLOT 0xffffffffu

enum { S_COUNT = 0, S_LIVE_LEN, S_MAX_SEQ, S_TOMB, S_NUM };

struct SmemBlockArgs {
  int B, NB, Bk, P, W, K;
  const int32_t* length;
  const int32_t* ins_seq;
  const int32_t* ins_client;
  const int32_t* rem_seq;
  const int32_t* rem_client;
  const int32_t* rem_overlap;
  const int32_t* pool_start;
  const int32_t* prop_val;
  const int32_t* blk_count;
  const int32_t* blk_live_len;
  const int32_t* blk_max_seq;
  const int32_t* blk_tomb;
  const int32_t* count;
  const uint8_t* op_valid;
  const int32_t* op_kind;
  const int32_t* op_pos;
  const int32_t* op_end;
  const int32_t* op_seq;
  const int32_t* op_ref_seq;
  const int32_t* op_client;
  const int32_t* op_pool_start;
  const int32_t* op_text_len;
  const int32_t* op_prop_key;
  const int32_t* op_prop_val;
  int32_t* o_length;
  int32_t* o_ins_seq;
  int32_t* o_ins_client;
  int32_t* o_rem_seq;
  int32_t* o_rem_client;
  int32_t* o_rem_overlap;
  int32_t* o_pool_start;
  int32_t* o_prop_val;
  int32_t* o_blk_count;
  int32_t* o_blk_live_len;
  int32_t* o_blk_max_seq;
  int32_t* o_blk_tomb;
  int32_t* o_count;
  int32_t* o_ovf;
};

// The first MTS_HEADER_INTS ints of shared memory.
struct Header {
  int count;  // occupied slots of the document (thread 0 alone)
  int last;   // one past the last valid op
  // Up to two splits of the current op, for its revert.
  int rec_b[2], rec_i[2], rec_len[2], rec_fill[2], rec_tomb[2];
  // Double-buffered per-warp partials of the reductions.
  unsigned red_k[2][MTS_WARPS];
  int red_s[2][MTS_WARPS];
  int red_r[2][MTS_WARPS];
  int red_t[2][MTS_WARPS];
};
static_assert(sizeof(Header) <= MTS_HEADER_INTS * 4, "header too large");

// One document's row in shared memory. Field f of slot i (i = b * Bk + j)
// is pl[f * S + i]: the six slot planes (mt::LENGTH ... mt::POOL_START),
// then P props, then W overlap words.
struct Row {
  int NB, Bk, P, W, S, F;
  int* pl;
  int* summ;       // S_NUM planes of NB
  int* vis;        // [S] the frame's visible lengths
  int* wcum;       // [S] the frame's within-block prefix
  int* bsum;       // [NB] the frame's per-block visible length
  int* last_slot;  // [2][F] a split's dropped last slot
  int* ops;        // [K][MTS_OP_FIELDS]
  Header* h;
  __device__ __forceinline__ int* field(int f) const {
    return pl + (size_t)f * S;
  }
  __device__ __forceinline__ int* sm(int f) const { return summ + f * NB; }
};

struct OpV {
  int kind, pos, end, seq, ref, client, pool_start, text_len, prop_key,
      prop_val;
};

__device__ __forceinline__ int slot_vis(const Row& d, int b, int j, int ref,
                                        int client) {
  if (j >= d.sm(S_COUNT)[b]) return 0;
  const int i = b * d.Bk + j;
  const bool ins_vis = d.field(mt::INS_SEQ)[i] <= ref ||
                       d.field(mt::INS_CLIENT)[i] == client;
  const int rem = d.field(mt::REM_SEQ)[i];
  bool removed_vis = false;
  if (rem != MT_NONE_SEQ) {
    const int c = mt::clampi(client, 0, 32 * d.W - 1);
    const unsigned word =
        (unsigned)d.field(mt::NUM_PLANES + d.P + (c >> 5))[i];
    removed_vis = rem <= ref || d.field(mt::REM_CLIENT)[i] == client ||
                  ((word >> (c & 31)) & 1u);
  }
  return (ins_vis && !removed_vis) ? d.field(mt::LENGTH)[i] : 0;
}

// The (ref, client) frame: vis and wcum of every slot, each block's
// visible length in bsum (blk_live_len for a cold block). One warp per
// block, each lane a contiguous run of ceil(Bk / 32) slots, so the block
// takes one warp scan; runs of up to MTS_RUN slots are held in registers,
// so their loads are all in flight at once. Ends with the barrier after
// which any warp may read bsum.
#define MTS_RUN 4
__device__ void frame(const Row& d, int ref, int client) {
  const int lane = sm::lane_id();
  const int q = (d.Bk + 31) >> 5;
  for (int b = sm::warp_id(); b < d.NB; b += MTS_WARPS) {
    const int j0 = min(d.Bk, lane * q), j1 = min(d.Bk, lane * q + q);
    const int base = b * d.Bk;
    int local = 0;
    int v[MTS_RUN];
    if (q <= MTS_RUN) {
#pragma unroll
      for (int k = 0; k < MTS_RUN; ++k) {
        v[k] = j0 + k < j1 ? slot_vis(d, b, j0 + k, ref, client) : 0;
        local = mt::wadd(local, v[k]);
      }
    } else {
      for (int j = j0; j < j1; ++j) {
        const int x = slot_vis(d, b, j, ref, client);
        d.vis[base + j] = x;
        local = mt::wadd(local, x);
      }
    }
    const int x = sm::warp_incl_scan(local);
    int c = mt::wsub(x, local);
    if (q <= MTS_RUN) {
#pragma unroll
      for (int k = 0; k < MTS_RUN; ++k) {
        if (j0 + k < j1) {
          d.vis[base + j0 + k] = v[k];
          d.wcum[base + j0 + k] = c;
        }
        c = mt::wadd(c, v[k]);
      }
    } else {
      for (int j = j0; j < j1; ++j) {
        d.wcum[base + j] = c;
        c = mt::wadd(c, d.vis[base + j]);
      }
    }
    const int total = __shfl_sync(SM_FULL, x, 31);
    if (lane == 0)
      d.bsum[b] = d.sm(S_MAX_SEQ)[b] > ref ? total : d.sm(S_LIVE_LEN)[b];
  }
  __syncthreads();
}

// The frame's position of block b's first slot, to every lane of a warp.
__device__ __forceinline__ int block_prefix(const Row& d, int b) {
  int acc = 0;
  for (int l = sm::lane_id(); l < b; l += 32) acc = mt::wadd(acc, d.bsum[l]);
  return sm::warp_sum(acc);
}

// Block-wide min of k and wrapping sums of s and r; t becomes the ``tag``
// of the winning k, which each warp reads BEFORE the barrier (so a write
// after the reduction cannot race with it). One barrier.
template <class Tag>
__device__ void reduce(const Row& d, unsigned& k, int& s, int& r, int& t,
                       Tag tag, int& par) {
  k = sm::warp_min(k);
  s = sm::warp_sum(s);
  r = sm::warp_sum(r);
  const int w = sm::warp_id();
  if (sm::lane_id() == 0) {
    d.h->red_k[par][w] = k;
    d.h->red_s[par][w] = s;
    d.h->red_r[par][w] = r;
    d.h->red_t[par][w] = k == MTS_NOSLOT ? 0 : tag(k);
  }
  __syncthreads();
  k = MTS_NOSLOT;
  s = r = t = 0;
  for (int q = 0; q < MTS_WARPS; ++q) {
    const unsigned kq = d.h->red_k[par][q];
    if (kq < k) {
      k = kq;
      t = d.h->red_t[par][q];
    }
    s = mt::wadd(s, d.h->red_s[par][q]);
    r = mt::wadd(r, d.h->red_r[par][q]);
  }
  par ^= 1;
}

// Interior split at visible position pos: 0 when no slot holds pos
// inside it, 1 when split, 2 on overflow (nothing written).
__device__ int split_at(const Row& d, int pos, int ref, int client,
                        int& n_rec, int& par) {
  frame(d, ref, client);
  const int lane = sm::lane_id();
  unsigned k = MTS_NOSLOT;
  int sum_gcum = 0, removed = 0, fill = 0;
  for (int b = sm::warp_id(); b < d.NB; b += MTS_WARPS) {
    const int pre = block_prefix(d, b);
    for (int j = lane; j < d.Bk; j += 32) {
      const int i = b * d.Bk + j;
      const int g = mt::wadd(pre, d.wcum[i]);
      if (g < pos && pos < mt::wadd(g, d.vis[i])) {
        k = k < (unsigned)i ? k : (unsigned)i;
        sum_gcum = mt::wadd(sum_gcum, g);
        removed += d.field(mt::REM_SEQ)[i] != MT_NONE_SEQ;
      }
    }
  }
  reduce(d, k, sum_gcum, removed, fill,
         [&](unsigned key) { return d.sm(S_COUNT)[key / d.Bk]; }, par);
  if (k == MTS_NOSLOT) return 0;
  if (fill >= d.Bk) return 2;
  const int b = (int)k / d.Bk, i = (int)k - b * d.Bk;
  const int off = mt::wsub(pos, sum_gcum);
  const int q = n_rec++;
  // Slots (i, Bk) move right by one; slot i keeps [0, off), slot i + 1
  // (the old slot i) takes [off, len). Each field's owner saves what the
  // shift drops first.
  for (int f = sm::warp_id(); f < d.F; f += MTS_WARPS) {
    int* p = d.field(f) + b * d.Bk;
    if (lane == 0) {
      d.last_slot[q * d.F + f] = p[d.Bk - 1];
      if (f == mt::LENGTH) d.h->rec_len[q] = p[i];
    }
    __syncwarp();
    sm::warp_shift_right(p, i + 1, d.Bk);
    if (lane == 0) {
      if (f == mt::LENGTH) {
        p[i] = off;
        p[i + 1] = mt::wsub(p[i + 1], off);
      } else if (f == mt::POOL_START) {
        p[i + 1] = mt::wadd(p[i + 1], off);
      }
    }
    __syncwarp();
  }
  if (threadIdx.x == 0) {
    d.h->rec_b[q] = b;
    d.h->rec_i[q] = i;
    d.h->rec_fill[q] = fill;
    d.h->rec_tomb[q] = d.sm(S_TOMB)[b];
    d.sm(S_COUNT)[b] = fill + 1;
    d.sm(S_TOMB)[b] = mt::wadd(d.sm(S_TOMB)[b], removed);
    d.h->count = mt::wadd(d.h->count, 1);
  }
  __syncthreads();
  return 1;
}

// Insert placement on the current frame. Returns overflow (nothing
// written then).
__device__ bool place(const Row& d, const OpV& op, int& par) {
  const int lane = sm::lane_id();
  unsigned k = MTS_NOSLOT;
  for (int b = sm::warp_id(); b < d.NB; b += MTS_WARPS) {
    const int pre = block_prefix(d, b);
    const int cnt = d.sm(S_COUNT)[b];
    for (int j = lane; j < d.Bk; j += 32) {
      const int i = b * d.Bk + j;
      const int rem = d.field(mt::REM_SEQ)[i];
      const bool dead = rem != MT_NONE_SEQ && rem <= op.ref;
      if (j < cnt && !dead && mt::wadd(pre, d.wcum[i]) == op.pos)
        k = k < (unsigned)i ? k : (unsigned)i;
    }
  }
  // The last occupied block (0 when none), its fill and the next block's,
  // read before the reduction's barrier.
  int last = 0;
  for (int b = lane; b < d.NB; b += 32)
    if (d.sm(S_COUNT)[b] > 0) last = b > last ? b : last;
  last = sm::warp_max(last);
  const int last_fill = d.sm(S_COUNT)[last];
  const int next_fill = last + 1 < d.NB ? d.sm(S_COUNT)[last + 1] : 0;
  int s = 0, r = 0, fill = 0;
  reduce(d, k, s, r, fill,
         [&](unsigned key) { return d.sm(S_COUNT)[key / d.Bk]; }, par);
  const bool hasc = k != MTS_NOSLOT;
  int b, i;
  bool no_spill = false;
  if (hasc) {
    b = (int)k / d.Bk;
    i = (int)k - b * d.Bk;
  } else {
    const bool full = last_fill >= d.Bk;
    b = full ? last + 1 : last;
    i = full ? 0 : last_fill;
    fill = full ? next_fill : last_fill;
    no_spill = full && last + 1 >= d.NB;
  }
  if (!(b < d.NB && fill < d.Bk) || (!hasc && no_spill)) return true;
  for (int f = sm::warp_id(); f < d.F; f += MTS_WARPS) {
    int* p = d.field(f) + b * d.Bk;
    sm::warp_shift_right(p, i + 1, d.Bk);
    if (lane == 0) {
      int v = 0;  // props and overlap words
      switch (f) {
        case mt::LENGTH: v = op.text_len; break;
        case mt::INS_SEQ: v = op.seq; break;
        case mt::INS_CLIENT: v = op.client; break;
        case mt::REM_SEQ: v = (int)MT_NONE_SEQ; break;
        case mt::REM_CLIENT: v = -1; break;
        case mt::POOL_START: v = op.pool_start; break;
        default: break;
      }
      p[i] = v;
    }
    __syncwarp();
  }
  if (threadIdx.x == 0) {
    d.sm(S_COUNT)[b] = fill + 1;
    d.sm(S_LIVE_LEN)[b] = mt::wadd(d.sm(S_LIVE_LEN)[b], op.text_len);
    d.sm(S_MAX_SEQ)[b] = max(d.sm(S_MAX_SEQ)[b], op.seq);
    d.h->count = mt::wadd(d.h->count, 1);
  }
  __syncthreads();
  return false;
}

// Remove mark (is_remove) or annotate over [pos, end) of the current
// frame; the summaries move by shared-memory atomics.
__device__ void mark_or_annotate(const Row& d, const OpV& op,
                                 bool is_remove) {
  const int c = mt::clampi(op.client, 0, 32 * d.W - 1);
  const int bit = (int)(1u << (c & 31));
  int* rem_seq = d.field(mt::REM_SEQ);
  for (int b = sm::warp_id(); b < d.NB; b += MTS_WARPS) {
    const int pre = block_prefix(d, b);
    for (int j = sm::lane_id(); j < d.Bk; j += 32) {
      const int i = b * d.Bk + j;
      const int g = mt::wadd(pre, d.wcum[i]);
      if (!(d.vis[i] > 0 && g >= op.pos && g < op.end)) continue;
      if (!is_remove) {
        if (op.prop_key >= 0 && op.prop_key < d.P)
          d.field(mt::NUM_PLANES + op.prop_key)[i] = op.prop_val;
      } else if (rem_seq[i] == MT_NONE_SEQ) {
        rem_seq[i] = op.seq;
        d.field(mt::REM_CLIENT)[i] = op.client;
        atomicAdd(&d.sm(S_LIVE_LEN)[b],
                  (int)(0u - (unsigned)d.field(mt::LENGTH)[i]));
        atomicAdd(&d.sm(S_TOMB)[b], 1);
        atomicMax(&d.sm(S_MAX_SEQ)[b], op.seq);
      } else {
        d.field(mt::NUM_PLANES + d.P + (c >> 5))[i] |= bit;
      }
    }
  }
  __syncthreads();
}

// Undo the op's splits, newest first: each shifts its block back, restores
// the dropped last slot and the head's length, then its summaries.
__device__ void revert(const Row& d, int n_rec, int count0) {
  const int lane = sm::lane_id();
  for (int q = n_rec - 1; q >= 0; --q) {
    const int b = d.h->rec_b[q], i = d.h->rec_i[q];
    for (int f = sm::warp_id(); f < d.F; f += MTS_WARPS) {
      int* p = d.field(f) + b * d.Bk;
      sm::warp_shift_left(p, i + 1, d.Bk - 1);
      if (lane == 0) {
        p[d.Bk - 1] = d.last_slot[q * d.F + f];
        if (f == mt::LENGTH) p[i] = d.h->rec_len[q];
      }
      __syncwarp();
    }
  }
  if (threadIdx.x == 0) {
    for (int q = n_rec - 1; q >= 0; --q) {
      d.sm(S_COUNT)[d.h->rec_b[q]] = d.h->rec_fill[q];
      d.sm(S_TOMB)[d.h->rec_b[q]] = d.h->rec_tomb[q];
    }
    d.h->count = count0;
  }
  __syncthreads();
}

// One valid op on an un-overflowed document. Returns whether it
// overflowed (and was reverted).
__device__ bool block_apply(const Row& d, const OpV& op, int& par) {
  const bool is_ins = op.kind == MT_INSERT, is_rem = op.kind == MT_REMOVE;
  const int count0 = d.h->count;  // read by thread 0 alone
  int n_rec = 0;
  bool ofs = split_at(d, op.pos, op.ref, op.client, n_rec, par) == 2;
  if (!ofs)
    ofs = split_at(d, is_ins ? -1 : op.end, op.ref, op.client, n_rec,
                   par) == 2;
  if (!ofs) {
    frame(d, op.ref, op.client);
    if (is_ins) ofs = place(d, op, par);
    else mark_or_annotate(d, op, is_rem);
  }
  if (ofs) revert(d, n_rec, count0);
  return ofs;
}

__host__ __device__ __forceinline__ size_t smem_ints(int NB, int Bk, int P,
                                                     int W, int K) {
  const size_t S = (size_t)NB * Bk, F = mt::NUM_PLANES + P + W;
  return MTS_HEADER_INTS + F * S + S_NUM * (size_t)NB + 2 * S + NB + 2 * F +
         (size_t)MTS_OP_FIELDS * K;
}

__global__ void __launch_bounds__(MTS_THREADS)
mergetree_blocks_smem_kernel(SmemBlockArgs a) {
  extern __shared__ int4 mts_dyn[];
  int* base = reinterpret_cast<int*>(mts_dyn);
  const int doc = blockIdx.x;
  Row d;
  d.NB = a.NB;
  d.Bk = a.Bk;
  d.P = a.P;
  d.W = a.W;
  d.S = a.NB * a.Bk;
  d.F = mt::NUM_PLANES + a.P + a.W;
  d.h = reinterpret_cast<Header*>(base);
  d.pl = base + MTS_HEADER_INTS;
  d.summ = d.pl + (size_t)d.F * d.S;
  d.vis = d.summ + S_NUM * d.NB;
  d.wcum = d.vis + d.S;
  d.bsum = d.wcum + d.S;
  d.last_slot = d.bsum + d.NB;
  d.ops = d.last_slot + 2 * d.F;
  const int S = d.S;
  const size_t row = (size_t)doc * S, srow = (size_t)doc * a.NB;
  const size_t ops = (size_t)doc * a.K;

  const int32_t* in[mt::NUM_PLANES] = {a.length, a.ins_seq, a.ins_client,
                                       a.rem_seq, a.rem_client, a.pool_start};
  for (int f = 0; f < mt::NUM_PLANES; ++f)
    sm::copy_ints(d.field(f), in[f] + row, S);
  sm::split_fields(d.field(mt::NUM_PLANES), S, a.prop_val + row * a.P, S,
                   a.P);
  sm::split_fields(d.field(mt::NUM_PLANES + a.P), S,
                   a.rem_overlap + row * a.W, S, a.W);
  const int32_t* isumm[S_NUM] = {a.blk_count, a.blk_live_len, a.blk_max_seq,
                                 a.blk_tomb};
  for (int f = 0; f < S_NUM; ++f) sm::copy_ints(d.sm(f), isumm[f] + srow, a.NB);
  for (int k = threadIdx.x; k < a.K; k += blockDim.x) {
    int* o = d.ops + k * MTS_OP_FIELDS;
    o[0] = a.op_valid[ops + k];
    o[1] = a.op_kind[ops + k];
    o[2] = a.op_pos[ops + k];
    o[3] = a.op_end[ops + k];
    o[4] = a.op_seq[ops + k];
    o[5] = a.op_ref_seq[ops + k];
    o[6] = a.op_client[ops + k];
    o[7] = a.op_pool_start[ops + k];
    o[8] = a.op_text_len[ops + k];
    o[9] = a.op_prop_key[ops + k];
    o[10] = a.op_prop_val[ops + k];
  }
  if (threadIdx.x == 0) {
    d.h->count = a.count[doc];
    d.h->last = 0;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < a.K; k += blockDim.x)
    if (d.ops[k * MTS_OP_FIELDS]) atomicMax(&d.h->last, k + 1);
  __syncthreads();
  const int last = d.h->last;
  int par = 0, ovf = MTS_OVF_NONE;
  for (int k = 0; k < last; ++k) {
    const int* o = d.ops + k * MTS_OP_FIELDS;
    if (!o[0]) continue;
    const OpV op = {o[1], o[2], o[3], o[4], o[5],
                    o[6], o[7], o[8], o[9], o[10]};
    if (block_apply(d, op, par)) {
      ovf = k;  // sticky: every later op of the document is inert
      break;
    }
  }
  __syncthreads();

  int32_t* out[mt::NUM_PLANES] = {a.o_length, a.o_ins_seq, a.o_ins_client,
                                  a.o_rem_seq, a.o_rem_client,
                                  a.o_pool_start};
  for (int f = 0; f < mt::NUM_PLANES; ++f)
    sm::copy_ints(out[f] + row, d.field(f), S);
  sm::join_fields(a.o_prop_val + row * a.P, d.field(mt::NUM_PLANES), S, S,
                  a.P);
  sm::join_fields(a.o_rem_overlap + row * a.W,
                  d.field(mt::NUM_PLANES + a.P), S, S, a.W);
  int32_t* osumm[S_NUM] = {a.o_blk_count, a.o_blk_live_len, a.o_blk_max_seq,
                           a.o_blk_tomb};
  for (int f = 0; f < S_NUM; ++f)
    sm::copy_ints(osumm[f] + srow, d.sm(f), a.NB);
  if (threadIdx.x == 0) {
    a.o_count[doc] = d.h->count;
    a.o_ovf[doc] = ovf;
  }
}

// The order in which mergetree_blocks_smem_launch reads its pointer array:
// the BlockMergeState fields, the MergeOpBatch fields (op_), the output
// BlockMergeState fields (o_) and the overflow output. The binding checks
// it before the first launch.
extern "C" const char* mergetree_blocks_smem_layout() {
  return "length,ins_seq,ins_client,rem_seq,rem_client,rem_overlap,"
         "pool_start,prop_val,blk_count,blk_live_len,blk_max_seq,blk_tomb,"
         "count,"
         "op_valid,op_kind,op_pos,op_end,op_seq,op_ref_seq,op_client,"
         "op_pool_start,op_text_len,op_prop_key,op_prop_val,"
         "o_length,o_ins_seq,o_ins_client,o_rem_seq,o_rem_client,"
         "o_rem_overlap,o_pool_start,o_prop_val,o_blk_count,o_blk_live_len,"
         "o_blk_max_seq,o_blk_tomb,o_count,"
         "o_ovf";
}

// The current device's per-block shared-memory limit with opt-in, or -1.
extern "C" int mergetree_blocks_smem_optin() {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  return v;
}

extern "C" int mergetree_blocks_smem_launch(void** p, int B, int NB, int Bk,
                                            int P, int W, int K,
                                            int smem_bytes, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  // The binding computes the same bytes from the shape and passes them.
  if ((size_t)smem_bytes != 4 * smem_ints(NB, Bk, P, W, K))
    return (int)cudaErrorInvalidValue;
  SmemBlockArgs a;
  a.B = B;
  a.NB = NB;
  a.Bk = Bk;
  a.P = P;
  a.W = W;
  a.K = K;
  a.length = (const int32_t*)p[0];
  a.ins_seq = (const int32_t*)p[1];
  a.ins_client = (const int32_t*)p[2];
  a.rem_seq = (const int32_t*)p[3];
  a.rem_client = (const int32_t*)p[4];
  a.rem_overlap = (const int32_t*)p[5];
  a.pool_start = (const int32_t*)p[6];
  a.prop_val = (const int32_t*)p[7];
  a.blk_count = (const int32_t*)p[8];
  a.blk_live_len = (const int32_t*)p[9];
  a.blk_max_seq = (const int32_t*)p[10];
  a.blk_tomb = (const int32_t*)p[11];
  a.count = (const int32_t*)p[12];
  a.op_valid = (const uint8_t*)p[13];
  a.op_kind = (const int32_t*)p[14];
  a.op_pos = (const int32_t*)p[15];
  a.op_end = (const int32_t*)p[16];
  a.op_seq = (const int32_t*)p[17];
  a.op_ref_seq = (const int32_t*)p[18];
  a.op_client = (const int32_t*)p[19];
  a.op_pool_start = (const int32_t*)p[20];
  a.op_text_len = (const int32_t*)p[21];
  a.op_prop_key = (const int32_t*)p[22];
  a.op_prop_val = (const int32_t*)p[23];
  a.o_length = (int32_t*)p[24];
  a.o_ins_seq = (int32_t*)p[25];
  a.o_ins_client = (int32_t*)p[26];
  a.o_rem_seq = (int32_t*)p[27];
  a.o_rem_client = (int32_t*)p[28];
  a.o_rem_overlap = (int32_t*)p[29];
  a.o_pool_start = (int32_t*)p[30];
  a.o_prop_val = (int32_t*)p[31];
  a.o_blk_count = (int32_t*)p[32];
  a.o_blk_live_len = (int32_t*)p[33];
  a.o_blk_max_seq = (int32_t*)p[34];
  a.o_blk_tomb = (int32_t*)p[35];
  a.o_count = (int32_t*)p[36];
  a.o_ovf = (int32_t*)p[37];
  const cudaError_t err = cudaFuncSetAttribute(
      mergetree_blocks_smem_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  mergetree_blocks_smem_kernel<<<B, MTS_THREADS, smem_bytes,
                                 (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
