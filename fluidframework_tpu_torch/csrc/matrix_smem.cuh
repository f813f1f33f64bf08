// Building blocks of the shared-memory SharedMatrix kernels (the step tick
// matrix_steps_smem.cu and the op tick matrix_tick_smem.cu): one thread
// block stages one document's matrix in dynamic shared memory and writes
// it back once.
//
//   * An axis (a flat merge table) lies FIELD-MAJOR: the six slot planes,
//     valid, the P prop planes and the W overlap words, each its own
//     plane of S ints (Axis, axis_vis).
//   * walk: one valid vector op on an axis, the flat merge step of
//     merge_apply.cuh rewritten for shared memory. Each thread owns a
//     contiguous run of slots, so a scan is a warp scan and one barrier,
//     and the shift moves whole fields, one warp per field (smem_doc.cuh).
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

#include "matrix_apply.cuh"
#include "smem_doc.cuh"

#define MXS_THREADS 256
// Four blocks an SM: caps registers at 64 a thread. Uncapped (about 150)
// one block fits an SM and the step tick runs three times slower.
#define MXS_MIN_BLOCKS 4
#define MXS_WARPS (MXS_THREADS / 32)
#define MXS_HALF_WARPS (MXS_WARPS / 2)
#define MXS_HEADER_INTS 256
#define MXS_NOSLOT 0xffffffffu

// Field planes of an axis in shared memory.
enum { A_VALID = mt::NUM_PLANES, A_PROP };
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

// One axis in shared memory: field f of slot i is pl[f * S + i].
struct Axis {
  int* pl;
  int S, P, W;
  int* count;
  __device__ __forceinline__ int* f(int field) const {
    return pl + (size_t)field * S;
  }
};

__device__ __forceinline__ int axis_vis(const Axis& x, int i, int ref,
                                        int client) {
  if (!x.f(A_VALID)[i]) return 0;
  const bool ins_vis = x.f(mt::INS_SEQ)[i] <= ref ||
                       x.f(mt::INS_CLIENT)[i] == client;
  const int rem = x.f(mt::REM_SEQ)[i];
  bool removed_vis = false;
  if (rem != MT_NONE_SEQ) {
    const int c = mt::clampi(client, 0, 32 * x.W - 1);
    const unsigned word = (unsigned)x.f(A_PROP + x.P + (c >> 5))[i];
    removed_vis = rem <= ref || x.f(mt::REM_CLIENT)[i] == client ||
                  ((word >> (c & 31)) & 1u);
  }
  return (ins_vis && !removed_vis) ? x.f(mt::LENGTH)[i] : 0;
}

// One valid vector op on axis x: the flat merge step (mt::apply_op) on
// shared memory, by a block of THREADS threads. Thread t owns slots
// [t * m, t * m + m). ``tvis`` and ``tcum`` are [S] scratch. Ends with a
// barrier after the last write of the planes; *x.count is written after
// it by thread 0.
template <int THREADS = MXS_THREADS>
__device__ void walk(const Axis& x, const mt::Op& op, Header* h, int& par,
                     int* tvis, int* tcum) {
  const int S = x.S;
  const int ref = op.ref_seq, client = op.client;
  const bool is_insert = op.kind == MT_INSERT;
  const bool is_remove = op.kind == MT_REMOVE;
  const int p1 = op.pos;
  const int p2 = is_insert ? -1 : op.end;
  const int m = (S + THREADS - 1) / THREADS;
  const int lo = threadIdx.x * m;
  const int hi = min(S, lo + m);
  int total;

  // 1. The visible prefix; the slots the two split points fall inside.
  int local = 0;
  for (int i = lo; i < hi; ++i) {
    const int v = axis_vis(x, i, ref, client);
    tvis[i] = v;
    local = mt::wadd(local, v);
  }
  int c = sm::block_excl_scan(local, h->part[0], par, &total);
  unsigned k1 = MXS_NOSLOT, k2 = MXS_NOSLOT;
  for (int i = lo; i < hi; ++i) {
    const int v = tvis[i], end = mt::wadd(c, v);
    if (c < p1 && p1 < end) k1 = k1 < (unsigned)i ? k1 : (unsigned)i;
    if (c < p2 && p2 < end && p2 != p1) k2 = k2 < (unsigned)i ? k2 : i;
    tcum[i] = c;
    c = end;
  }
  sm::block_min2(k1, k2, h->keys[0][0], par);
  const bool has1 = k1 != MXS_NOSLOT, has2 = k2 != MXS_NOSLOT;
  const int i1 = has1 ? (int)k1 : 0, i2 = has2 ? (int)k2 : 0;
  const int o1 = mt::wsub(p1, has1 ? tcum[i1] : 0);
  const int o2 = mt::wsub(p2, has2 ? tcum[i2] : 0);
  const bool same = has1 && has2 && i1 == i2;
  const int t1 = i1 + 1;
  const int t2 = i2 + 1 + ((has1 && i1 <= i2) ? 1 : 0);
  const int vis_i1 = tvis[i1];

  // 2. Placement on the post-first-split frame: the first slot at p1 that
  // is not skipped (invalid, or removed at/below ref); else the count.
  auto src1 = [&](int i) { return (has1 && i >= t1) ? (i - 1 + S) % S : i; };
  auto vis_post = [&](int i) {
    if (has1 && i == i1) return o1;
    if (has1 && i == t1) return mt::wsub(vis_i1, o1);
    return tvis[src1(i)];
  };
  local = 0;
  for (int i = lo; i < hi; ++i) local = mt::wadd(local, vis_post(i));
  c = sm::block_excl_scan(local, h->part[0], par, &total);
  unsigned kc = MXS_NOSLOT, unused = MXS_NOSLOT;
  for (int i = lo; i < hi; ++i) {
    const int j = src1(i);
    const int rem = x.f(mt::REM_SEQ)[j];
    const bool skip = !x.f(A_VALID)[j] || (rem != MT_NONE_SEQ && rem <= ref);
    if (c == p1 && !skip) kc = kc < (unsigned)i ? kc : (unsigned)i;
    c = mt::wadd(c, vis_post(i));
  }
  sm::block_min2(kc, unused, h->keys[0][0], par);
  const int count = *x.count;
  const int tp = kc != MXS_NOSLOT ? (int)kc : mt::wadd(count, has1 ? 1 : 0);

  // 3. The fused shift of 0/1/2 slots with the split and placement
  // overrides, in place: slot i of field f takes field f of slot
  // i - shift(i). Each field is one warp's, moved 32 slots at a time from
  // the top, reads and writes split by __syncwarp; the wrapped reads (slot
  // i < 2 reads slot S - 2 + i, the roll's) come from the field's top two
  // slots, read before it moves.
  const int t1f = (is_insert && tp <= t1) ? t1 + 1 : t1;
  const int point_b = is_insert ? tp : t2;
  const bool gate_b = is_insert || has2;
  const int head2 = i2 + ((has1 && i1 < i2) ? 1 : 0);
  auto source = [&](int i) {
    const int shift = ((has1 && i >= t1f) ? 1 : 0) +
                      ((gate_b && i >= point_b) ? 1 : 0);
    return i - shift;
  };
  auto moved = [&](int f, int i, int v) {
    const bool tail1 = has1 && i == t1f;
    const bool tail2 = !is_insert && has2 && i == point_b;
    const bool head1 = has1 && i == i1;
    const bool head2b = !is_insert && has2 && !same && i == head2;
    const bool placed = is_insert && i == tp;
    const int start_off = tail2 ? o2 : (tail1 ? o1 : 0);
    if (f == mt::LENGTH) {
      const int end_off = head1 ? o1
                          : (same && tail1) ? o2
                          : head2b ? o2 : v;
      return placed ? op.text_len : mt::wsub(end_off, start_off);
    }
    if (f == mt::INS_SEQ) return placed ? op.seq : v;
    if (f == mt::INS_CLIENT) return placed ? op.client : v;
    if (f == mt::REM_SEQ) return placed ? (int)MT_NONE_SEQ : v;
    if (f == mt::REM_CLIENT) return placed ? -1 : v;
    if (f == mt::POOL_START)
      return placed ? op.pool_start : mt::wadd(v, start_off);
    if (f == A_VALID) return placed ? 1 : v;
    return placed ? 0 : v;  // props and overlap words
  };
  if (has1 || gate_b) {
    const int lane = sm::lane_id();
    const int nf = A_PROP + x.P + x.W;
    for (int f = sm::warp_id(); f < nf; f += THREADS / 32) {
      int* p = x.f(f);
      const int top0 = p[((S - 2) % S + S) % S];
      const int top1 = p[((S - 1) % S + S) % S];
      __syncwarp();
      for (int base = ((S - 1) >> 5) << 5; base >= 0; base -= 32) {
        const int i = base + lane;
        const int src = source(i);
        const int v = i >= S ? 0 : src >= 0 ? p[src]
                                   : (src == -2 ? top0 : top1);
        __syncwarp();
        if (i < S) p[i] = moved(f, i, v);
        __syncwarp();
      }
    }
  }
  __syncthreads();
  if (threadIdx.x == 0)
    *x.count = mt::wadd(mt::wadd(count, has1 ? 1 : 0),
                        is_insert ? 1 : (has2 ? 1 : 0));

  // 4. Remove mark or annotate over the moved table's [pos, end).
  if (!is_insert) {
    const int cl = mt::clampi(client, 0, 32 * x.W - 1);
    const int bit = (int)(1u << (cl & 31));
    local = 0;
    for (int i = lo; i < hi; ++i) {
      const int v = axis_vis(x, i, ref, client);
      tvis[i] = v;
      local = mt::wadd(local, v);
    }
    c = sm::block_excl_scan(local, h->part[0], par, &total);
    for (int i = lo; i < hi; ++i) {
      const int v = tvis[i];
      if (v > 0 && c >= op.pos && c < op.end) {
        if (is_remove) {
          if (x.f(mt::REM_SEQ)[i] == MT_NONE_SEQ) {
            x.f(mt::REM_SEQ)[i] = op.seq;
            x.f(mt::REM_CLIENT)[i] = client;
          } else {
            x.f(A_PROP + x.P + (cl >> 5))[i] |= bit;
          }
        } else if (op.prop_key >= 0 && op.prop_key < x.P) {
          x.f(A_PROP + op.prop_key)[i] = op.prop_val;
        }
      }
      c = mt::wadd(c, v);
    }
    __syncthreads();
  }
}

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

__device__ void load_axis(const Axis& x, const uint8_t* valid,
                          const int32_t* const* planes, const int32_t* prop,
                          const int32_t* overlap, size_t row) {
  for (int f = 0; f < mt::NUM_PLANES; ++f)
    sm::copy_ints(x.f(f), planes[f] + row, x.S);
  sm::bytes_to_ints(x.f(A_VALID), valid + row, x.S);
  sm::split_fields(x.f(A_PROP), x.S, prop + row * x.P, x.S, x.P);
  sm::split_fields(x.f(A_PROP + x.P), x.S, overlap + row * x.W, x.S, x.W);
}

__device__ void store_axis(const Axis& x, uint8_t* valid,
                           int32_t* const* planes, int32_t* prop,
                           int32_t* overlap, size_t row) {
  for (int f = 0; f < mt::NUM_PLANES; ++f)
    sm::copy_ints(planes[f] + row, x.f(f), x.S);
  sm::ints_to_bytes(valid + row, x.f(A_VALID), x.S);
  sm::join_fields(prop + row * x.P, x.f(A_PROP), x.S, x.S, x.P);
  sm::join_fields(overlap + row * x.W, x.f(A_PROP + x.P), x.S, x.S, x.W);
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
