// Device functions shared by the two SharedMatrix ticks (matrix_tick.cu,
// matrix_steps.cu): one thread block owns one document's matrix — two
// permutation-vector axes (flat merge tables) and an LWW cell table.
//
// Same functions as ops/matrix_kernel.py (the reference's
// fluidframework_tpu/ops/matrix_kernel.py and its Pallas twin
// matrix_pallas.py):
//   * the axis walk: the flat per-op step of merge_apply.cuh on the
//     targeted axis (``_axis_walk``); the other axis is not touched;
//   * the visibility frame of an axis at (ref, client), an exclusive
//     block scan of visible lengths, and the handle at a visible
//     position: the first slot holding it, ``pool_start + pos - cum``
//     there, or -1 (``_handle_lookup``);
//   * the LWW cell write: the LAST used entry with the (row handle, col
//     handle) key, else the append slot ``min(cell_count, C - 1)``; the
//     count grows even past C (``_cell_write``).
//
// Every function here is called by every thread of the block; results
// that matter to all threads are returned to all of them.

#pragma once

#include "merge_apply.cuh"

#define MX_ROWS 0
#define MX_COLS 1
#define MX_CELL 2

namespace mx {

// The input planes of one axis (a MergeState), whole batch.
struct AxisSrc {
  const uint8_t* valid;
  const int32_t* plane[mt::NUM_PLANES];
  const int32_t* prop;
  const int32_t* overlap;
  const int32_t* count;
};

// One document's cell table.
struct CellDoc {
  int32_t* rh;
  int32_t* ch;
  int32_t* val;
  int32_t* seq;
  uint8_t* used;
  int C;
};

// The output axis of document ``doc`` as a FlatDoc over the output planes.
__device__ __forceinline__ mt::FlatDoc axis_doc(
    uint8_t* valid, int32_t* length, int32_t* ins_seq, int32_t* ins_client,
    int32_t* rem_seq, int32_t* rem_client, int32_t* pool_start,
    int32_t* prop, int32_t* overlap, int doc, int S, int P, int W) {
  const size_t row = (size_t)doc * S;
  mt::FlatDoc d;
  d.S = S;
  d.P = P;
  d.W = W;
  d.valid = valid + row;
  d.plane[mt::LENGTH] = length + row;
  d.plane[mt::INS_SEQ] = ins_seq + row;
  d.plane[mt::INS_CLIENT] = ins_client + row;
  d.plane[mt::REM_SEQ] = rem_seq + row;
  d.plane[mt::REM_CLIENT] = rem_client + row;
  d.plane[mt::POOL_START] = pool_start + row;
  d.prop = prop + row * P;
  d.overlap = overlap + row * W;
  return d;
}

// Copy document ``doc``'s row of an axis from ``src`` into ``d``.
__device__ void copy_axis(const AxisSrc& src, const mt::FlatDoc& d, int doc) {
  const size_t row = (size_t)doc * d.S;
  for (int i = threadIdx.x; i < d.S; i += blockDim.x) {
    d.valid[i] = src.valid[row + i];
    for (int f = 0; f < mt::NUM_PLANES; ++f) d.plane[f][i] = src.plane[f][row + i];
  }
  for (int i = threadIdx.x; i < d.S * d.P; i += blockDim.x)
    d.prop[i] = src.prop[row * d.P + i];
  for (int i = threadIdx.x; i < d.S * d.W; i += blockDim.x)
    d.overlap[i] = src.overlap[row * d.W + i];
}

// Apply one valid vector op to axis ``d`` whose live-slot count is
// ``*count`` (shared memory; updated).
__device__ void axis_walk(const mt::FlatDoc& d, const mt::Op& op, int* count,
                          mt::Shared& sh, int* saved) {
  if (threadIdx.x == 0) sh.count = *count;
  __syncthreads();
  mt::apply_op(d, op, sh, saved);
  if (threadIdx.x == 0) *count = sh.count;
  __syncthreads();
}

// The handle at visible position ``pos`` of slot key ``k`` (the block min
// of key_of(slot, cum) over the slots holding it), or -1.
__device__ __forceinline__ int handle_of(const mt::FlatDoc& d,
                                         unsigned long long k, int pos) {
  if (k == MT_NOKEY) return -1;
  const int i = (int)(k >> 32), cum = (int)(unsigned)k;
  return mt::wsub(mt::wadd(d.plane[mt::POOL_START][i], pos), cum);
}

// Storage handle at visible position ``pos`` in the (ref, client) frame
// of axis ``d``, or -1 (PermutationVector.handle_at).
__device__ int handle_at(const mt::FlatDoc& d, int pos, int ref, int client,
                         mt::Shared& sh) {
  unsigned long long k = MT_NOKEY;
  mt::block_scan(
      d.S, [&](int i) { return mt::vis_len(d, i, ref, client); },
      [&](int i, int cum, int vis) {
        if (cum <= pos && pos < mt::wadd(cum, vis)) {
          const unsigned long long key = mt::key_of(i, cum);
          k = key < k ? key : k;
        }
      },
      sh);
  return handle_of(d, mt::block_min(k, sh), pos);
}

// The (ref, client) frame of axis ``d``: vis[i] and its exclusive prefix
// cum[i] for every slot (per-document scratch in global memory).
__device__ void build_frame(const mt::FlatDoc& d, int ref, int client,
                            int* vis, int* cum, mt::Shared& sh) {
  mt::block_scan(
      d.S, [&](int i) { return mt::vis_len(d, i, ref, client); },
      [&](int i, int c, int v) {
        vis[i] = v;
        cum[i] = c;
      },
      sh);
}

// Storage handle at visible position ``pos`` in a frame built by
// build_frame, or -1.
__device__ int frame_lookup(const mt::FlatDoc& d, const int* vis,
                            const int* cum, int pos, mt::Shared& sh) {
  unsigned long long k = MT_NOKEY;
  for (int i = threadIdx.x; i < d.S; i += blockDim.x) {
    const int c = cum[i];
    if (c <= pos && pos < mt::wadd(c, vis[i])) {
      const unsigned long long key = mt::key_of(i, c);
      k = key < k ? key : k;
    }
  }
  return handle_of(d, mt::block_min(k, sh), pos);
}

// LWW write of (rh, ch) <- (value, seq): the LAST used entry with that
// key, else the append slot min(*count, C - 1); a new key adds one to
// *count (shared memory) even past C. Call only where the write happens
// (rh >= 0 and ch >= 0).
__device__ void cell_write(const CellDoc& c, int rh, int ch, int value,
                           int seq, int* count, mt::Shared& sh) {
  unsigned long long k = MT_NOKEY;
  for (int i = threadIdx.x; i < c.C; i += blockDim.x) {
    if (c.used[i] && c.rh[i] == rh && c.ch[i] == ch) {
      const unsigned long long key = (unsigned long long)(c.C - 1 - i);
      k = key < k ? key : k;
    }
  }
  k = mt::block_min(k, sh);
  if (threadIdx.x == 0) {
    const bool exists = k != MT_NOKEY;
    const int n = *count;
    const int idx = exists ? c.C - 1 - (int)k : (n < c.C - 1 ? n : c.C - 1);
    if (idx >= 0) {
      c.rh[idx] = rh;
      c.ch[idx] = ch;
      c.val[idx] = value;
      c.seq[idx] = seq;
      c.used[idx] = 1;
    }
    if (!exists) *count = mt::wadd(n, 1);
  }
  __syncthreads();
}

// Copy document ``doc``'s cell row (C slots) into ``c``.
__device__ void copy_cells(const int32_t* rh, const int32_t* ch,
                           const int32_t* val, const int32_t* seq,
                           const uint8_t* used, const CellDoc& c, int doc) {
  const size_t row = (size_t)doc * c.C;
  for (int i = threadIdx.x; i < c.C; i += blockDim.x) {
    c.rh[i] = rh[row + i];
    c.ch[i] = ch[row + i];
    c.val[i] = val[row + i];
    c.seq[i] = seq[row + i];
    c.used[i] = used[row + i];
  }
}

// One document's matrix in the OUTPUT planes of a launch's arguments
// ``a`` (the tick's and the step tick's argument structs name the state
// planes alike): copy the document's input row there, and load the
// axis and cell counts into ``axis_count[2]`` / ``*cell_count`` (shared
// memory). Ends with a barrier.
template <class A>
__device__ void load_doc(const A& a, int doc, mt::FlatDoc axis[2],
                         CellDoc& cells, int* axis_count, int* cell_count) {
  axis[0] = axis_doc(a.o_rows_valid, a.o_rows_length, a.o_rows_ins_seq,
                     a.o_rows_ins_client, a.o_rows_rem_seq,
                     a.o_rows_rem_client, a.o_rows_pool_start,
                     a.o_rows_prop_val, a.o_rows_rem_overlap, doc, a.S, a.P,
                     a.W);
  axis[1] = axis_doc(a.o_cols_valid, a.o_cols_length, a.o_cols_ins_seq,
                     a.o_cols_ins_client, a.o_cols_rem_seq,
                     a.o_cols_rem_client, a.o_cols_pool_start,
                     a.o_cols_prop_val, a.o_cols_rem_overlap, doc, a.S, a.P,
                     a.W);
  const AxisSrc src[2] = {
      {a.rows_valid,
       {a.rows_length, a.rows_ins_seq, a.rows_ins_client, a.rows_rem_seq,
        a.rows_rem_client, a.rows_pool_start},
       a.rows_prop_val, a.rows_rem_overlap, a.rows_count},
      {a.cols_valid,
       {a.cols_length, a.cols_ins_seq, a.cols_ins_client, a.cols_rem_seq,
        a.cols_rem_client, a.cols_pool_start},
       a.cols_prop_val, a.cols_rem_overlap, a.cols_count}};
  const size_t crow = (size_t)doc * a.C;
  cells = {a.o_cell_rh + crow,  a.o_cell_ch + crow, a.o_cell_val + crow,
           a.o_cell_seq + crow, a.o_cell_used + crow, a.C};
  copy_axis(src[0], axis[0], doc);
  copy_axis(src[1], axis[1], doc);
  copy_cells(a.cell_rh, a.cell_ch, a.cell_val, a.cell_seq, a.cell_used,
             cells, doc);
  if (threadIdx.x == 0) {
    axis_count[0] = a.rows_count[doc];
    axis_count[1] = a.cols_count[doc];
    *cell_count = a.cell_count[doc];
  }
  __syncthreads();
}

// Write the counts that load_doc loaded (and the ops moved) to the
// output planes.
template <class A>
__device__ void store_counts(const A& a, int doc, const int* axis_count,
                             const int* cell_count) {
  if (threadIdx.x == 0) {
    a.o_rows_count[doc] = axis_count[0];
    a.o_cols_count[doc] = axis_count[1];
    a.o_cell_count[doc] = *cell_count;
  }
}

// A valid vector op of a tick or step as the flat merge step takes it:
// one prop plane, the run's first handle as pool_start, its count as
// text_len, no property.
__device__ __forceinline__ mt::Op vec_op(int kind, int pos, int end,
                                         int count, int handle_base, int seq,
                                         int ref_seq, int client) {
  mt::Op op;
  op.valid = 1;
  op.kind = kind;
  op.pos = pos;
  op.end = end;
  op.seq = seq;
  op.ref_seq = ref_seq;
  op.client = client;
  op.pool_start = handle_base;
  op.text_len = count;
  op.prop_key = 0;
  op.prop_val = 0;
  return op;
}

}  // namespace mx
