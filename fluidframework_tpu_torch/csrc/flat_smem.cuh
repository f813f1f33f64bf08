// The flat merge step on shared memory: one document's flat segment
// table (one merge-tree axis) staged FIELD-MAJOR in dynamic shared
// memory, and one valid op applied to it by a thread block. Used by the
// flat merge tick's shared-memory variant (mergetree_flat_smem.cu) and,
// through matrix_smem.cuh, by both shared-memory SharedMatrix kernels.
//
//   * Axis: the six slot planes, valid, the P prop planes and the W
//     overlap words, each its own plane of S ints; axis_vis is a slot's
//     visible length in a (ref, client) frame.
//   * walk: one valid op, the flat merge step of merge_apply.cuh
//     rewritten for shared memory. Each thread owns a contiguous run of
//     slots, so a scan is a warp scan and one barrier; the placement's
//     prefix on the post-split frame comes from the first scan's (no
//     second scan); the shift moves only the slots from the lowest one the
//     op changes up, each thread its own slots through registers, a round
//     of fields a barrier (shift_owned), or, past four slots a thread,
//     whole fields, one warp per field (smem_doc.cuh).
//   * load_axis / store_axis copy an axis between its [B, S], [B, S, P]
//     and [B, S, W] global planes and shared memory.
//
// Integer sums wrap as int32 (mt::wadd), as the plain versions' do.

#pragma once

#include "merge_apply.cuh"
#include "smem_doc.cuh"

#define FS_NOSLOT 0xffffffffu

// Field planes of an axis in shared memory.
enum { A_VALID = mt::NUM_PLANES, A_PROP };

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

// The shift of walk (step 3) when each thread owns at most MT slots:
// slot i of field f takes field f of slot source(i) (the roll's wrapped
// reads included), rewritten by moved(f, i, v), for the owned slots at or
// above ``low``. The sources of a round of G fields are read into
// registers, then one barrier, then written: a field never straddles two
// rounds, so no read sees a value this shift wrote. A round holds eight
// values a thread (four fields where a thread owns four slots): larger
// rounds spilled under the kernels' 64-register cap and ran slower on an
// NVIDIA H100 80GB HBM3 at 700 W.
template <int MT, class Source, class Moved>
__device__ __forceinline__ void shift_owned(const Axis& x, int lo, int hi,
                                            int low, Source source,
                                            Moved moved) {
  constexpr int G = 8 / MT < 4 ? 4 : 8 / MT;
  const int S = x.S, nf = A_PROP + x.P + x.W;
  int src[MT];
  bool on[MT];
#pragma unroll
  for (int j = 0; j < MT; ++j) {
    const int i = lo + j;
    on[j] = i < hi && i >= low;
    const int s = source(i);
    src[j] = s >= 0 ? s : (s % S + S) % S;
  }
  auto round = [&](int f0) {
    int v[G][MT];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int j = 0; j < MT; ++j)
        if (f0 + g < nf && on[j]) v[g][j] = x.f(f0 + g)[src[j]];
    __syncthreads();
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int j = 0; j < MT; ++j)
        if (f0 + g < nf && on[j])
          x.f(f0 + g)[lo + j] = moved(f0 + g, lo + j, v[g][j]);
  };
  round(0);
  for (int f0 = G; f0 < nf; f0 += G) round(f0);
}

// One valid op on axis x: the flat merge step (mt::apply_op) on shared
// memory, by a block of THREADS threads. Thread t owns slots
// [t * m, t * m + m). ``h`` is the caller's shared header: its ``part``
// ([2][32] ints) and ``keys`` ([2][2][32] unsigned) hold the scans' and
// reductions' partials. ``tvis`` and ``tcum`` are [S] scratch. Ends with
// a barrier after the last write of the planes; *x.count is written after
// it by thread 0.
template <int THREADS, class H>
__device__ void walk(const Axis& x, const mt::Op& op, H* h, int& par,
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
  unsigned k1 = FS_NOSLOT, k2 = FS_NOSLOT;
  for (int i = lo; i < hi; ++i) {
    const int v = tvis[i], end = mt::wadd(c, v);
    if (c < p1 && p1 < end) k1 = k1 < (unsigned)i ? k1 : (unsigned)i;
    if (c < p2 && p2 < end && p2 != p1) k2 = k2 < (unsigned)i ? k2 : i;
    tcum[i] = c;
    c = end;
  }
  sm::block_min2(k1, k2, h->keys[0][0], par);
  const bool has1 = k1 != FS_NOSLOT, has2 = k2 != FS_NOSLOT;
  const int i1 = has1 ? (int)k1 : 0, i2 = has2 ? (int)k2 : 0;
  const int o1 = mt::wsub(p1, has1 ? tcum[i1] : 0);
  const int o2 = mt::wsub(p2, has2 ? tcum[i2] : 0);
  const bool same = has1 && has2 && i1 == i2;
  const int t1 = i1 + 1;
  const int t2 = i2 + 1 + ((has1 && i1 <= i2) ? 1 : 0);

  // 2. Placement on the post-first-split frame: the first slot at p1 that
  // is not skipped (invalid, or removed at/below ref); else the count.
  // That frame's exclusive prefix needs no scan: slots up to i1 keep
  // theirs, the split's tail t1 = i1 + 1 starts o1 further on, and every
  // later slot i holds slot i - 1 and its prefix (the head and tail
  // lengths o1 and vis - o1 add back to the split slot's, sums wrapping
  // as the scan's would).
  unsigned kc = FS_NOSLOT, unused = FS_NOSLOT;
  for (int i = lo; i < hi; ++i) {
    const bool moved1 = has1 && i > i1;  // i >= t1: slot i holds i - 1
    const int j = moved1 ? i - 1 : i;
    const int cum = !moved1 ? tcum[i]
                    : i == t1 ? mt::wadd(tcum[i1], o1) : tcum[i - 1];
    const int rem = x.f(mt::REM_SEQ)[j];
    const bool skip = !x.f(A_VALID)[j] || (rem != MT_NONE_SEQ && rem <= ref);
    if (cum == p1 && !skip) kc = kc < (unsigned)i ? kc : (unsigned)i;
  }
  sm::block_min2(kc, unused, h->keys[0][0], par);
  const int count = *x.count;
  const int tp = kc != FS_NOSLOT ? (int)kc : mt::wadd(count, has1 ? 1 : 0);

  // 3. The fused shift of 0/1/2 slots with the split and placement
  // overrides, in place: slot i of field f takes field f of slot
  // i - shift(i) (slot i < 2 may read slot S - 2 + i, the roll's). Slots
  // below the lowest one the op splits, places or shifts keep their
  // values (no shift and no override reaches them) and are not moved.
  // Where a thread owns at most four slots, it moves its own slots of a
  // round of fields through registers with one barrier a round
  // (shift_owned); otherwise each field is one warp's, moved 32 slots at
  // a time from the top, reads and writes split by __syncwarp, the
  // wrapped reads from the field's top two slots, read before it moves.
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
    int low = gate_b ? point_b : S;
    if (has1) low = min(low, i1);
    if (!is_insert && has2) low = min(low, head2);
    if (m == 1) {
      shift_owned<1>(x, lo, hi, low, source, moved);
    } else if (m == 2) {
      shift_owned<2>(x, lo, hi, low, source, moved);
    } else if (m <= 4) {
      shift_owned<4>(x, lo, hi, low, source, moved);
    } else {
      const int lane = sm::lane_id();
      const int nf = A_PROP + x.P + x.W;
      const int bottom = max(low, 0) & ~31;
      for (int f = sm::warp_id(); f < nf; f += THREADS / 32) {
        int* p = x.f(f);
        const int top0 = p[((S - 2) % S + S) % S];
        const int top1 = p[((S - 1) % S + S) % S];
        __syncwarp();
        for (int base = ((S - 1) >> 5) << 5; base >= bottom; base -= 32) {
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
