// Block merge-tree tick — one thread block per document walks its K ops
// over the [NB, Bk] block table.
//
// Replaces the TPU kernel fluidframework_tpu/ops/mergetree_blocks_pallas.py:
// _tick_kernel (pallas_call at mergetree_blocks_pallas.py:153, per-op body
// mergetree_blocks.block_apply_doc at mergetree_blocks.py:406, wrapper
// apply_tick_blocks_pallas). Same function as the plain
// ops/mergetree_blocks.py:apply_tick_blocks: per op, split at pos, split at
// end, then place (insert), mark (remove) or annotate, each structural
// phase shifting ONE block; positions come from the two-level frame (cold
// blocks, blk_max_seq <= ref, contribute blk_live_len verbatim); an op
// whose target block is full reverts entirely — a first split that
// already succeeded included — records its index in the sticky per-doc
// ovf, and every later op of the document is inert.
//
// Design: out of place — the block first copies its document's row (six
// [NB, Bk] planes, the [NB, Bk, P] prop and [NB, Bk, W] overlap planes,
// four [NB] summaries, the count) to the outputs and then works in place
// on the outputs in global memory, so any NB and Bk work. Each frame
// computes every slot's visible length and within-block prefix (stored
// in a [S] scratch pair) and the [NB] block prefix (shared memory); the
// reductions over slots (first hit, the sum of gcum over hits, the
// head's tombstone flag) run over the whole table, exactly as the plain
// version's, so inexact summaries give the same result on both. A split
// saves the block it is about to shift (and the document's summaries and
// count) to a per-document scratch before it writes; a later overflow of
// the same op restores them. Layouts are the JAX package's.
//
// Bound on H100: bytes for a tick that reads the table once and writes it
// once (B * NB * Bk * (6 + P + W) * 4 * 2 + B * NB * 16 * 2 + the op
// planes). This version recomputes three frames per op over the whole
// row from L2/L1, so it runs well above that bound; touching only the hot
// blocks is the next step, not done here.
//
// Plain C interface for ctypes; the launcher returns cudaGetLastError().

#include "merge_apply.cuh"

#define MT_BLOCK_THREADS 128
#define MT_OVF_NONE 0x7fffffff

enum { BLK_COUNT = 0, BLK_LIVE_LEN, BLK_MAX_SEQ, BLK_TOMB, NUM_SUMM };

struct BlockArgs {
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
  int32_t* scratch_vis;   // [B, NB * Bk]
  int32_t* scratch_wcum;  // [B, NB * Bk]
  int32_t* scratch_save;  // [B, 2, Bk, 6 + P + W]
};

// One document's block table (output planes) and its scratch.
struct BlockDoc {
  int NB, Bk, P, W, S;
  int32_t* plane[mt::NUM_PLANES];
  int32_t* prop;
  int32_t* overlap;
  int32_t* summ[NUM_SUMM];
  int32_t* vis;
  int32_t* wcum;
  int32_t* save;
  int* bcum;  // shared [NB]: exclusive prefix of per-block visible length
  int* acc;   // shared [2 * NB]: per-block accumulators of the mark
};

struct BlockShared {
  mt::Shared sh;
  int count;
  int n_saved;
  int saved_blk[2];
  int saved_summ[2][NUM_SUMM];
  int saved_count;
};

__device__ __forceinline__ int nfields(const BlockDoc& d) {
  return mt::NUM_PLANES + d.P + d.W;
}

// Field f of slot j of block b: the six planes, then P props, then W
// overlap words.
__device__ __forceinline__ int32_t* field_ptr(const BlockDoc& d, int f,
                                              int b, int j) {
  const size_t slot = (size_t)b * d.Bk + j;
  if (f < mt::NUM_PLANES) return d.plane[f] + slot;
  if (f < mt::NUM_PLANES + d.P) return d.prop + slot * d.P + (f - mt::NUM_PLANES);
  return d.overlap + slot * d.W + (f - mt::NUM_PLANES - d.P);
}

__device__ __forceinline__ int slot_vis(const BlockDoc& d, int b, int j,
                                        int ref, int client) {
  if (j >= d.summ[BLK_COUNT][b]) return 0;
  const size_t i = (size_t)b * d.Bk + j;
  const bool ins_vis = d.plane[mt::INS_SEQ][i] <= ref ||
                       d.plane[mt::INS_CLIENT][i] == client;
  const int rem = d.plane[mt::REM_SEQ][i];
  bool removed_vis = false;
  if (rem != MT_NONE_SEQ) {
    const int c = mt::clampi(client, 0, 32 * d.W - 1);
    const unsigned word = (unsigned)d.overlap[i * d.W + (c >> 5)];
    removed_vis = rem <= ref || d.plane[mt::REM_CLIENT][i] == client ||
                  ((word >> (c & 31)) & 1u);
  }
  return (ins_vis && !removed_vis) ? d.plane[mt::LENGTH][i] : 0;
}

// The (ref, client) frame: vis and the within-block prefix into the
// scratch, the block prefix into d.bcum. Slot i's position is
// d.bcum[i / Bk] + d.wcum[i].
__device__ void frame(const BlockDoc& d, int ref, int client,
                      BlockShared& s) {
  for (int b = 0; b < d.NB; ++b) {
    const size_t base = (size_t)b * d.Bk;
    const int total = mt::block_scan(
        d.Bk, [&](int j) { return slot_vis(d, b, j, ref, client); },
        [&](int j, int excl, int v) {
          d.vis[base + j] = v;
          d.wcum[base + j] = excl;
        },
        s.sh);
    if (threadIdx.x == 0)
      d.bcum[b] = d.summ[BLK_MAX_SEQ][b] > ref ? total
                                                : d.summ[BLK_LIVE_LEN][b];
  }
  __syncthreads();
  // In place: bcum holds each block's visible length, then its prefix.
  mt::block_scan(
      d.NB, [&](int b) { return d.bcum[b]; },
      [&](int b, int excl, int) { d.acc[b] = excl; }, s.sh);
  for (int b = threadIdx.x; b < d.NB; b += blockDim.x) d.bcum[b] = d.acc[b];
  __syncthreads();
}

__device__ __forceinline__ int gcum_at(const BlockDoc& d, int i) {
  return mt::wadd(d.bcum[i / d.Bk], d.wcum[i]);
}

__device__ int block_sum(int v, BlockShared& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  for (int o = 16; o > 0; o >>= 1)
    v = mt::wadd(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (lane == 0) s.sh.warp_int[warp] = v;
  __syncthreads();
  v = 0;
  for (int w = 0; w < nwarps; ++w) v = mt::wadd(v, s.sh.warp_int[w]);
  __syncthreads();
  return v;
}

// Save block b's slots and the document's summaries of b and count
// before the op first shifts it (at most two blocks per op).
__device__ void save_block(const BlockDoc& d, int b, BlockShared& s) {
  for (int q = 0; q < s.n_saved; ++q)
    if (s.saved_blk[q] == b) return;
  const int q = s.n_saved;
  const int nf = nfields(d);
  int32_t* dst = d.save + (size_t)q * d.Bk * nf;
  for (int t = threadIdx.x; t < d.Bk * nf; t += blockDim.x)
    dst[t] = *field_ptr(d, t % nf, b, t / nf);
  __syncthreads();
  if (threadIdx.x == 0) {
    s.saved_blk[q] = b;
    for (int f = 0; f < NUM_SUMM; ++f) s.saved_summ[q][f] = d.summ[f][b];
    s.n_saved = q + 1;
  }
  __syncthreads();
}

__device__ void restore_saved(const BlockDoc& d, BlockShared& s) {
  const int nf = nfields(d);
  for (int q = s.n_saved - 1; q >= 0; --q) {
    const int b = s.saved_blk[q];
    const int32_t* src = d.save + (size_t)q * d.Bk * nf;
    for (int t = threadIdx.x; t < d.Bk * nf; t += blockDim.x)
      *field_ptr(d, t % nf, b, t / nf) = src[t];
    __syncthreads();
    if (threadIdx.x == 0)
      for (int f = 0; f < NUM_SUMM; ++f) d.summ[f][b] = s.saved_summ[q][f];
    __syncthreads();
  }
  if (threadIdx.x == 0) s.count = s.saved_count;
  __syncthreads();
}

// Shift slots [i + 1, Bk) of block b right by one (slot j takes j - 1),
// then write(f, j, v) decides each slot's final value from the shifted
// one. In place, in descending tiles: each field is read before a
// barrier and written after it.
template <class Write>
__device__ void shift_block(const BlockDoc& d, int b, int i, Write write) {
  const int nf = nfields(d);
  for (int base = ((d.Bk - 1) / (int)blockDim.x) * (int)blockDim.x;
       base >= 0; base -= blockDim.x) {
    const int j = base + threadIdx.x;
    const bool on = j < d.Bk;
    const int src = j >= i + 1 ? j - 1 : j;
    for (int f = 0; f < nf; ++f) {
      const int v = on ? *field_ptr(d, f, b, src) : 0;
      __syncthreads();
      if (on) *field_ptr(d, f, b, j) = write(f, j, v);
    }
  }
  __syncthreads();
}

// Interior split at visible position pos. Returns overflow.
__device__ bool split_at(const BlockDoc& d, int pos, int ref, int client,
                         bool act, BlockShared& s) {
  if (!act) return false;  // an inert split changes nothing
  frame(d, ref, client, s);
  unsigned long long kmin = MT_NOKEY;
  int sum_gcum = 0, removed = 0;
  for (int i = threadIdx.x; i < d.S; i += blockDim.x) {
    const int g = gcum_at(d, i), v = d.vis[i];
    if (g < pos && pos < mt::wadd(g, v)) {
      kmin = kmin < (unsigned long long)i ? kmin : (unsigned long long)i;
      sum_gcum = mt::wadd(sum_gcum, g);
      removed += d.plane[mt::REM_SEQ][i] != MT_NONE_SEQ;
    }
  }
  kmin = mt::block_min(kmin, s.sh);
  sum_gcum = block_sum(sum_gcum, s);
  removed = block_sum(removed, s);
  if (kmin == MT_NOKEY) return false;
  const int f = (int)kmin, b = f / d.Bk, i = f - b * d.Bk;
  if (d.summ[BLK_COUNT][b] >= d.Bk) return true;  // no room: overflow
  const int off = mt::wsub(pos, sum_gcum);
  save_block(d, b, s);
  shift_block(d, b, i, [&](int fld, int j, int v) {
    if (fld == mt::LENGTH) {
      if (j == i) return off;
      if (j == i + 1) return mt::wsub(v, off);
    } else if (fld == mt::POOL_START && j == i + 1) {
      return mt::wadd(v, off);
    }
    return v;
  });
  if (threadIdx.x == 0) {
    d.summ[BLK_COUNT][b] += 1;
    d.summ[BLK_TOMB][b] = mt::wadd(d.summ[BLK_TOMB][b], removed);
    s.count = mt::wadd(s.count, 1);
  }
  __syncthreads();
  return false;
}

// Insert placement at an existing boundary (frame already computed).
// Returns overflow.
__device__ bool place(const BlockDoc& d, const mt::Op& op, BlockShared& s) {
  unsigned long long kmin = MT_NOKEY;
  int last = 0;
  for (int i = threadIdx.x; i < d.S; i += blockDim.x) {
    const int b = i / d.Bk, j = i - b * d.Bk;
    const int rem = d.plane[mt::REM_SEQ][i];
    const bool occ = j < d.summ[BLK_COUNT][b];
    const bool dead = rem != MT_NONE_SEQ && rem <= op.ref_seq;
    if (occ && !dead && gcum_at(d, i) == op.pos)
      kmin = kmin < (unsigned long long)i ? kmin : (unsigned long long)i;
  }
  for (int b = threadIdx.x; b < d.NB; b += blockDim.x)
    if (d.summ[BLK_COUNT][b] > 0) last = max(last, b);
  kmin = mt::block_min(kmin, s.sh);
  last = (int)(MT_NOKEY - mt::block_min(MT_NOKEY - (unsigned)last, s.sh));
  const bool hasc = kmin != MT_NOKEY;
  int b, i;
  bool no_spill = false;
  if (hasc) {
    b = (int)kmin / d.Bk;
    i = (int)kmin - b * d.Bk;
  } else {
    const int last_fill = d.summ[BLK_COUNT][last];
    const bool full = last_fill >= d.Bk;
    b = full ? last + 1 : last;
    i = full ? 0 : last_fill;
    no_spill = full && last + 1 >= d.NB;
  }
  const bool room = b < d.NB && d.summ[BLK_COUNT][b] < d.Bk;
  if (!room || (!hasc && no_spill)) return true;
  shift_block(d, b, i, [&](int fld, int j, int v) {
    if (j != i) return v;
    switch (fld) {
      case mt::LENGTH: return op.text_len;
      case mt::INS_SEQ: return op.seq;
      case mt::INS_CLIENT: return op.client;
      case mt::REM_SEQ: return (int)MT_NONE_SEQ;
      case mt::REM_CLIENT: return -1;
      case mt::POOL_START: return op.pool_start;
      default: return 0;  // props and overlap words
    }
  });
  if (threadIdx.x == 0) {
    d.summ[BLK_COUNT][b] += 1;
    d.summ[BLK_LIVE_LEN][b] = mt::wadd(d.summ[BLK_LIVE_LEN][b], op.text_len);
    d.summ[BLK_MAX_SEQ][b] = max(d.summ[BLK_MAX_SEQ][b], op.seq);
    s.count = mt::wadd(s.count, 1);
  }
  __syncthreads();
  return false;
}

// Remove mark (is_remove) or annotate over [pos, end) of the frame.
__device__ void mark_or_annotate(const BlockDoc& d, const mt::Op& op,
                                 bool is_remove, BlockShared& s) {
  const int c = mt::clampi(op.client, 0, 32 * d.W - 1);
  const int bit = (int)(1u << (c & 31));
  for (int b = threadIdx.x; b < 2 * d.NB; b += blockDim.x) d.acc[b] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < d.S; i += blockDim.x) {
    const int g = gcum_at(d, i);
    if (!(d.vis[i] > 0 && g >= op.pos && g < op.end)) continue;
    if (!is_remove) {
      if (op.prop_key >= 0 && op.prop_key < d.P)
        d.prop[(size_t)i * d.P + op.prop_key] = op.prop_val;
    } else if (d.plane[mt::REM_SEQ][i] == MT_NONE_SEQ) {
      d.plane[mt::REM_SEQ][i] = op.seq;
      d.plane[mt::REM_CLIENT][i] = op.client;
      const int b = i / d.Bk;
      atomicAdd(&d.acc[b], d.plane[mt::LENGTH][i]);
      atomicAdd(&d.acc[d.NB + b], 1);
    } else {
      d.overlap[(size_t)i * d.W + (c >> 5)] |= bit;
    }
  }
  __syncthreads();
  if (is_remove) {
    for (int b = threadIdx.x; b < d.NB; b += blockDim.x) {
      const int n = d.acc[d.NB + b];
      d.summ[BLK_LIVE_LEN][b] = mt::wsub(d.summ[BLK_LIVE_LEN][b], d.acc[b]);
      d.summ[BLK_TOMB][b] = mt::wadd(d.summ[BLK_TOMB][b], n);
      if (n > 0) d.summ[BLK_MAX_SEQ][b] = max(d.summ[BLK_MAX_SEQ][b], op.seq);
    }
  }
  __syncthreads();
}

// One valid op on an un-overflowed document. Returns whether it
// overflowed (and was reverted).
__device__ bool block_apply(const BlockDoc& d, const mt::Op& op,
                            BlockShared& s) {
  const bool is_ins = op.kind == MT_INSERT, is_rem = op.kind == MT_REMOVE;
  if (threadIdx.x == 0) {
    s.n_saved = 0;
    s.saved_count = s.count;
  }
  __syncthreads();
  bool ofs = split_at(d, op.pos, op.ref_seq, op.client, true, s);
  ofs = ofs || split_at(d, is_ins ? -1 : op.end, op.ref_seq, op.client, true,
                        s);
  if (!ofs) {
    frame(d, op.ref_seq, op.client, s);
    if (is_ins) ofs = place(d, op, s);
    else mark_or_annotate(d, op, is_rem, s);
  }
  if (ofs) restore_saved(d, s);
  return ofs;
}

__global__ void __launch_bounds__(MT_BLOCK_THREADS)
mergetree_blocks_kernel(BlockArgs a) {
  extern __shared__ int dyn[];
  __shared__ BlockShared s;
  __shared__ int last;
  const int doc = blockIdx.x;
  const int S = a.NB * a.Bk;
  const size_t row = (size_t)doc * S;
  const size_t srow = (size_t)doc * a.NB;
  BlockDoc d;
  d.NB = a.NB;
  d.Bk = a.Bk;
  d.P = a.P;
  d.W = a.W;
  d.S = S;
  int32_t* out[mt::NUM_PLANES] = {a.o_length, a.o_ins_seq, a.o_ins_client,
                                  a.o_rem_seq, a.o_rem_client,
                                  a.o_pool_start};
  const int32_t* in[mt::NUM_PLANES] = {a.length, a.ins_seq, a.ins_client,
                                       a.rem_seq, a.rem_client, a.pool_start};
  for (int f = 0; f < mt::NUM_PLANES; ++f) d.plane[f] = out[f] + row;
  d.prop = a.o_prop_val + row * a.P;
  d.overlap = a.o_rem_overlap + row * a.W;
  int32_t* osumm[NUM_SUMM] = {a.o_blk_count, a.o_blk_live_len,
                              a.o_blk_max_seq, a.o_blk_tomb};
  const int32_t* isumm[NUM_SUMM] = {a.blk_count, a.blk_live_len,
                                    a.blk_max_seq, a.blk_tomb};
  for (int f = 0; f < NUM_SUMM; ++f) d.summ[f] = osumm[f] + srow;
  d.vis = a.scratch_vis + row;
  d.wcum = a.scratch_wcum + row;
  d.save = a.scratch_save + (size_t)doc * 2 * a.Bk * nfields(d);
  d.bcum = dyn;
  d.acc = dyn + a.NB;

  for (int i = threadIdx.x; i < S; i += blockDim.x)
    for (int f = 0; f < mt::NUM_PLANES; ++f) d.plane[f][i] = in[f][row + i];
  for (int i = threadIdx.x; i < S * a.P; i += blockDim.x)
    d.prop[i] = a.prop_val[row * a.P + i];
  for (int i = threadIdx.x; i < S * a.W; i += blockDim.x)
    d.overlap[i] = a.rem_overlap[row * a.W + i];
  for (int b = threadIdx.x; b < a.NB; b += blockDim.x)
    for (int f = 0; f < NUM_SUMM; ++f) d.summ[f][b] = isumm[f][srow + b];
  const size_t ops = (size_t)doc * a.K;
  if (threadIdx.x == 0) {
    s.count = a.count[doc];
    last = 0;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < a.K; k += blockDim.x)
    if (a.op_valid[ops + k]) atomicMax(&last, k + 1);
  __syncthreads();
  int ovf = MT_OVF_NONE;
  for (int k = 0; k < last; ++k) {
    if (!a.op_valid[ops + k]) continue;
    mt::Op op;
    op.valid = 1;
    op.kind = a.op_kind[ops + k];
    op.pos = a.op_pos[ops + k];
    op.end = a.op_end[ops + k];
    op.seq = a.op_seq[ops + k];
    op.ref_seq = a.op_ref_seq[ops + k];
    op.client = a.op_client[ops + k];
    op.pool_start = a.op_pool_start[ops + k];
    op.text_len = a.op_text_len[ops + k];
    op.prop_key = a.op_prop_key[ops + k];
    op.prop_val = a.op_prop_val[ops + k];
    if (block_apply(d, op, s)) {
      ovf = k;  // sticky: every later op of the document is inert
      break;
    }
  }
  if (threadIdx.x == 0) {
    a.o_count[doc] = s.count;
    a.o_ovf[doc] = ovf;
  }
}

// The order in which mergetree_blocks_launch reads its pointer array: the
// BlockMergeState fields, the MergeOpBatch fields (op_), the output
// BlockMergeState fields (o_), the overflow output and three scratch
// planes. The binding checks it before the first launch.
extern "C" const char* mergetree_blocks_layout() {
  return "length,ins_seq,ins_client,rem_seq,rem_client,rem_overlap,"
         "pool_start,prop_val,blk_count,blk_live_len,blk_max_seq,blk_tomb,"
         "count,"
         "op_valid,op_kind,op_pos,op_end,op_seq,op_ref_seq,op_client,"
         "op_pool_start,op_text_len,op_prop_key,op_prop_val,"
         "o_length,o_ins_seq,o_ins_client,o_rem_seq,o_rem_client,"
         "o_rem_overlap,o_pool_start,o_prop_val,o_blk_count,o_blk_live_len,"
         "o_blk_max_seq,o_blk_tomb,o_count,"
         "o_ovf,scratch_vis,scratch_wcum,scratch_save";
}

extern "C" int mergetree_blocks_launch(void** p, int B, int NB, int Bk,
                                       int P, int W, int K, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  BlockArgs a;
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
  a.scratch_vis = (int32_t*)p[38];
  a.scratch_wcum = (int32_t*)p[39];
  a.scratch_save = (int32_t*)p[40];
  const size_t smem = 3 * (size_t)NB * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mergetree_blocks_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  mergetree_blocks_kernel<<<B, MT_BLOCK_THREADS, smem,
                            (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
