// Building blocks of the shared-memory SharedMatrix kernels (the step tick
// matrix_steps_smem.cu and the op tick matrix_tick_smem.cu): one thread
// block stages one document's matrix in dynamic shared memory and writes
// it back once.
//
//   * Each axis (a flat merge table) lies FIELD-MAJOR and a vector op
//     runs the shared-memory flat merge step on it (Axis, axis_vis, walk,
//     load_axis and store_axis: flat_smem.cuh, shared with the flat merge
//     tick's shared-memory variant).
//   * The cell log is five planes of C ints (C_RH .. C_USED).
//     last_match is a ballot scan of the log from the top down;
//     write_run makes a run of LWW writes in order, by one warp, from
//     each write's handles and its last match as the run found it.
//   * stage_doc / store_doc copy a document's two axes and cell log in
//     and out (the launch argument structs of both kernels name their
//     planes alike).
//
// Integer sums wrap as int32 (mt::wadd), as the plain versions' do.

#pragma once

#include "flat_smem.cuh"
#include "matrix_apply.cuh"

#define MXS_THREADS 256
// Four blocks an SM: caps registers at 64 a thread. Uncapped (about 150)
// one block fits an SM and the step tick runs three times slower.
#define MXS_MIN_BLOCKS 4
#define MXS_WARPS (MXS_THREADS / 32)
#define MXS_HALF_WARPS (MXS_WARPS / 2)
#define MXS_HEADER_INTS 256

// The cell log's planes in shared memory.
enum { C_RH = 0, C_CH, C_VAL, C_SEQ, C_USED, C_NUM };

// The first MXS_HEADER_INTS ints of shared memory.
struct Header {
  int axis_count[2];  // live-slot counts (thread 0 alone writes them)
  int cell_count;     // the input's; warp 0 then keeps it in registers
  int hw;             // one past the highest used cell entry (warp 0)
  int last;           // one past the document's last live op or step
  int part[2][32];    // block and half-block scan partials
  unsigned keys[2][2][32];  // block_min2 partials
};
static_assert(sizeof(Header) <= MXS_HEADER_INTS * 4, "header too large");


// The highest entry below ``top`` that is used and holds (rh, ch), or -1:
// a ballot scan of 32 entries at a time, from the top down. Every lane
// of the calling warp gets the result.
__device__ int last_match(int* const* cell, int top, int rh, int ch) {
  for (int hi = top - 1; hi >= 0; hi -= 32) {
    const int i = hi - sm::lane_id();
    const bool hit = i >= 0 && cell[C_USED][i] && cell[C_RH][i] == rh &&
                     cell[C_CH][i] == ch;
    const unsigned bal = __ballot_sync(SM_FULL, hit);
    if (bal) return hi - (__ffs(bal) - 1);
  }
  return -1;
}

__device__ __forceinline__ bool holds(int* const* cell, int i, int rh,
                                      int ch) {
  return cell[C_USED][i] && cell[C_RH][i] == rh && cell[C_CH][i] == ch;
}

// A run's R LWW writes in order, by one warp (every lane the same
// registers ``n_cells`` and ``hw``); write j stores ``value[j]`` and
// ``seq[j]``. ``res`` holds each write's row and col handle and its last
// match in the log as the run found it (-2 where the write does not
// happen). The last match NOW is the larger of that entry, if no earlier
// write of the run replaced its key, and the entries the run's earlier
// writes of the same key left; if an earlier append landed on the found
// entry and replaced its key (a clamped one at C - 1 does), the log is
// scanned again. A miss appends at min(count, C - 1); an append at a
// negative index (a negative count) is dropped; the count grows even past
// C. ``res[3 * R + j]`` records the entry write j made (-1: none).
__device__ void write_run(int* const* cell, int* res, const int* value,
                          const int* seq, int R, int C, int& n_cells,
                          int& hw) {
  const int lane = sm::lane_id();
  for (int j = 0; j < R; ++j) {
    const int pre = res[2 * R + j];
    int idx = -1;
    if (pre != -2) {
      const int rh = res[j], ch = res[R + j];
      int last = -1;
      bool again = false;
      if (pre >= 0) {
        if (holds(cell, pre, rh, ch)) last = pre;
        else again = true;
      }
      int mine = -1;
      for (int q = lane; q < j; q += 32) {
        const int w = res[3 * R + q];
        if (w >= 0 && res[q] == rh && res[R + q] == ch &&
            holds(cell, w, rh, ch))
          mine = w > mine ? w : mine;
      }
      mine = sm::warp_max(mine);
      last = mine > last ? mine : last;
      if (again) last = last_match(cell, hw, rh, ch);
      idx = last >= 0 ? last : (n_cells < C - 1 ? n_cells : C - 1);
      if (lane == 0 && idx >= 0) {
        cell[C_RH][idx] = rh;
        cell[C_CH][idx] = ch;
        cell[C_VAL][idx] = value[j];
        cell[C_SEQ][idx] = seq[j];
        cell[C_USED][idx] = 1;
      }
      if (idx + 1 > hw) hw = idx + 1;
      if (last < 0) n_cells = mt::wadd(n_cells, 1);
    }
    if (lane == 0) res[3 * R + j] = idx;
    __syncwarp();
  }
}


// Stage document ``doc``'s two axes and cell log of the launch arguments
// ``a`` in shared memory, and its counts in the header (thread 0, which
// also zeroes hw and last). No barrier.
template <class A>
__device__ void stage_doc(const A& a, int doc, const Axis* axis,
                          int* const* cell, Header* h) {
  const size_t row = (size_t)doc * a.S, crow = (size_t)doc * a.C;
  const int32_t* rows[mt::NUM_PLANES] = {
      a.rows_length, a.rows_ins_seq, a.rows_ins_client, a.rows_rem_seq,
      a.rows_rem_client, a.rows_pool_start};
  const int32_t* cols[mt::NUM_PLANES] = {
      a.cols_length, a.cols_ins_seq, a.cols_ins_client, a.cols_rem_seq,
      a.cols_rem_client, a.cols_pool_start};
  load_axis(axis[0], a.rows_valid, rows, a.rows_prop_val, a.rows_rem_overlap,
            row);
  load_axis(axis[1], a.cols_valid, cols, a.cols_prop_val, a.cols_rem_overlap,
            row);
  const int32_t* icell[4] = {a.cell_rh, a.cell_ch, a.cell_val, a.cell_seq};
  for (int q = 0; q < 4; ++q) sm::copy_ints(cell[q], icell[q] + crow, a.C);
  sm::bytes_to_ints(cell[C_USED], a.cell_used + crow, a.C);
  if (threadIdx.x == 0) {
    h->axis_count[0] = a.rows_count[doc];
    h->axis_count[1] = a.cols_count[doc];
    h->cell_count = a.cell_count[doc];
    h->hw = 0;
    h->last = 0;
  }
}

// Write document ``doc``'s staged axes and cell log to the output planes
// of ``a``, with the axes' counts from the header and the cell count
// ``n_cells`` (thread 0's).
template <class A>
__device__ void store_doc(const A& a, int doc, const Axis* axis,
                          int* const* cell, const Header* h, int n_cells) {
  const size_t row = (size_t)doc * a.S, crow = (size_t)doc * a.C;
  int32_t* orows[mt::NUM_PLANES] = {
      a.o_rows_length, a.o_rows_ins_seq, a.o_rows_ins_client,
      a.o_rows_rem_seq, a.o_rows_rem_client, a.o_rows_pool_start};
  int32_t* ocols[mt::NUM_PLANES] = {
      a.o_cols_length, a.o_cols_ins_seq, a.o_cols_ins_client,
      a.o_cols_rem_seq, a.o_cols_rem_client, a.o_cols_pool_start};
  store_axis(axis[0], a.o_rows_valid, orows, a.o_rows_prop_val,
             a.o_rows_rem_overlap, row);
  store_axis(axis[1], a.o_cols_valid, ocols, a.o_cols_prop_val,
             a.o_cols_rem_overlap, row);
  int32_t* ocell[4] = {a.o_cell_rh, a.o_cell_ch, a.o_cell_val, a.o_cell_seq};
  for (int q = 0; q < 4; ++q) sm::copy_ints(ocell[q] + crow, cell[q], a.C);
  sm::ints_to_bytes(a.o_cell_used + crow, cell[C_USED], a.C);
  if (threadIdx.x == 0) {
    a.o_rows_count[doc] = h->axis_count[0];
    a.o_cols_count[doc] = h->axis_count[1];
    a.o_cell_count[doc] = n_cells;
  }
}
