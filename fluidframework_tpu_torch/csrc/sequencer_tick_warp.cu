// Per-op deli ticket machine over one tick, warp variant — one warp per
// document, its client lanes in shared memory.
//
// Replaces the TPU kernel fluidframework_tpu/ops/sequencer_pallas.py:217
// _tick_kernel + _ticket_step_vec (:46; pallas_call at
// sequencer_pallas.py:279, wrapper process_batch_pallas), as
// sequencer_tick.cu does; the same function as the plain
// ops/sequencer.py:process_batch, bit for bit: dup/gap/invalid-type/
// nonexistent/refSeq<MSN/summarize nacks with their precedence,
// nack_future, join/leave with the dup-join upsert, no-op consolidation,
// rev1/rev2, the MSN recompute (INT32_MAX min over active cref, the seq
// when no client is active), the send type, last_sent_msn moving only on
// SEND_IMMEDIATE, and the reference's touched masks (every lane write sits
// under the refseq mark, the join or the sequenced upsert).
//
// Bound on H100: bytes (11 op planes in, 5 ticket planes out, the state in
// and out once). sequencer_tick.cu walks a document's ops in one thread:
// per sequenced op it reads all C lanes in a row for the MSN (about 66k
// dependent loads a launch at C = 257, K = 256), and its op loads are K
// apart across a warp.
//
// Design: a warp owns a document. Its seven client planes are staged in
// dynamic shared memory (cseq, cref, clu as ints, the four flags as
// bytes); lane l owns clients l, l + 32, ... The ops come in 32 at a time,
// lane l loading op base + l of every plane (coalesced), the next chunk
// prefetched while this one runs; op j of a chunk is broadcast from lane j
// by shuffles. Every lane evaluates an op's decisions from broadcast reads
// of the slot's and the target's lanes; the lane owning a client makes its
// writes, then recomputes its own min over its active cref. The MSN is
// __reduce_min_sync of those minima, and __any_sync says whether any
// client is active. Lane j keeps op j's ticket and the chunk's tickets go
// out coalesced. Two __syncwarp an op (reads before writes, writes before
// the next op's reads), no block barrier. The choice against
// sequencer_tick.cu is by shape (ops/sequencer_cuda.py): a C past the
// card's shared memory runs the one-thread kernel.
//
// Plain C interface for ctypes; the launcher returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

// protocol/messages.py MessageType (stable wire constants).
#define MT_NOOP 0
#define MT_CLIENT_JOIN 1
#define MT_CLIENT_LEAVE 2
#define MT_SUMMARIZE 5
#define MT_SUMMARY_ACK 6
#define MT_SUMMARY_NACK 7
#define MT_NO_CLIENT 11
#define MT_CONTROL 13
// ops/opcodes.py ticket outcome, send type and nack codes.
#define OUT_IGNORED 0
#define OUT_SEQUENCED 1
#define OUT_NACK 2
#define SEND_IMMEDIATE 0
#define SEND_LATER 1
#define SEND_NEVER 2
#define NACK_NONE 0
#define NACK_GAP 1
#define NACK_REFSEQ_BELOW_MSN 2
#define NACK_NONEXISTENT_CLIENT 3
#define NACK_NO_SUMMARY_SCOPE 4
#define NACK_FUTURE 5
#define NACK_INVALID_TYPE 6
#define INT32_MAX_ 2147483647


// Documents a block, one warp each.
#define DELI_WARPS 4
#define DELI_THREADS (32 * DELI_WARPS)
// Shared memory a document takes per client: cseq, cref, clu as ints and
// active, csum, cnack, cevict as bytes.
#define DELI_CLIENT_BYTES 16
#define DELI_FULL 0xffffffffu

struct SeqArgs {
  int B, C, K;
  // state in
  const int32_t *seq, *msn, *last_sent_msn;
  const uint8_t *nack_future, *active;
  const int32_t *cseq, *cref, *clu;
  const uint8_t *csum, *cnack, *cevict;
  // ops [B, K]
  const uint8_t *valid;
  const int32_t *kind, *slot, *target, *client_seq, *ref_seq, *timestamp;
  const uint8_t *has_contents, *can_summarize, *can_evict, *is_nack_future;
  // state out
  int32_t *o_seq, *o_msn, *o_last_sent_msn;
  uint8_t *o_nack_future, *o_active;
  int32_t *o_cseq, *o_cref, *o_clu;
  uint8_t *o_csum, *o_cnack, *o_cevict;
  // tickets [B, K]
  int32_t *t_kind, *t_seq, *t_msn, *t_send, *t_nack_code;
};

// Flag bits of an op, broadcast as one int.
enum { F_VALID = 1, F_HAS_CONTENTS = 2, F_CAN_SUMMARIZE = 4, F_CAN_EVICT = 8,
       F_NACK_FUTURE = 16 };

// One op of a chunk in a lane's registers.
struct OpRegs {
  int flags, kind, slot, target, cs, ref, ts;
};

__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

__device__ __forceinline__ OpRegs load_op(const SeqArgs& a, size_t row,
                                          int k) {
  OpRegs r = {0, 0, 0, 0, 0, 0, 0};
  if (k < a.K) {
    const size_t o = row + k;
    r.flags = (a.valid[o] ? F_VALID : 0) |
              (a.has_contents[o] ? F_HAS_CONTENTS : 0) |
              (a.can_summarize[o] ? F_CAN_SUMMARIZE : 0) |
              (a.can_evict[o] ? F_CAN_EVICT : 0) |
              (a.is_nack_future[o] ? F_NACK_FUTURE : 0);
    r.kind = a.kind[o];
    r.slot = a.slot[o];
    r.target = a.target[o];
    r.cs = a.client_seq[o];
    r.ref = a.ref_seq[o];
    r.ts = a.timestamp[o];
  }
  return r;
}

__global__ void __launch_bounds__(DELI_THREADS)
sequencer_tick_warp_kernel(const SeqArgs a) {
  extern __shared__ int4 deli_dyn[];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int d = blockIdx.x * DELI_WARPS + w;
  if (d >= a.B) return;  // the whole warp
  const int C = a.C, K = a.K;
  char* mine = reinterpret_cast<char*>(deli_dyn) +
               (size_t)w * DELI_CLIENT_BYTES * C;
  int32_t* cseq = reinterpret_cast<int32_t*>(mine);
  int32_t* cref = cseq + C;
  int32_t* clu = cref + C;
  uint8_t* active = reinterpret_cast<uint8_t*>(clu + C);
  uint8_t* csum = active + C;
  uint8_t* cnack = csum + C;
  uint8_t* cevict = cnack + C;
  const size_t r = (size_t)d * C;
  for (int c = lane; c < C; c += 32) {
    active[c] = a.active[r + c];
    cseq[c] = a.cseq[r + c];
    cref[c] = a.cref[r + c];
    clu[c] = a.clu[r + c];
    csum[c] = a.csum[r + c];
    cnack[c] = a.cnack[r + c];
    cevict[c] = a.cevict[r + c];
  }
  // This lane's min over the active cref of its own clients, and whether
  // any of them is active (it reads only what it wrote itself).
  int lane_min = INT32_MAX_;
  bool lane_any = false;
  auto rescan = [&]() {
    lane_min = INT32_MAX_;
    lane_any = false;
    for (int c = lane; c < C; c += 32) {
      if (active[c]) {
        lane_any = true;
        lane_min = min(lane_min, cref[c]);
      }
    }
  };
  rescan();
  __syncwarp();
  int32_t seq = a.seq[d], msn = a.msn[d], last_sent = a.last_sent_msn[d];
  bool nf = a.nack_future[d] != 0;

  const size_t row = (size_t)d * K;
  OpRegs next = load_op(a, row, lane);
  for (int base = 0; base < K; base += 32) {
    const OpRegs cur = next;
    next = load_op(a, row, base + 32 + lane);
    const int n = min(32, K - base);
    int my_kind = 0, my_seq = 0, my_msn = 0, my_send = 0, my_code = 0;
    for (int j = 0; j < n; ++j) {
      const int flags = __shfl_sync(DELI_FULL, cur.flags, j);
      const int kind = __shfl_sync(DELI_FULL, cur.kind, j);
      const int oslot = __shfl_sync(DELI_FULL, cur.slot, j);
      const int otarget = __shfl_sync(DELI_FULL, cur.target, j);
      const int cs = __shfl_sync(DELI_FULL, cur.cs, j);
      const int ref = __shfl_sync(DELI_FULL, cur.ref, j);
      const int ts = __shfl_sync(DELI_FULL, cur.ts, j);
      const bool valid = flags & F_VALID;
      const bool is_client = oslot >= 0;
      const int slot = min(max(oslot, 0), C - 1);
      const int target = min(max(otarget, 0), C - 1);

      // Broadcast reads of the slot's and the target's lanes.
      const bool at_slot_active = active[slot] != 0;
      const bool at_target_active = active[target] != 0;
      const int expected = wadd(cseq[slot], 1);
      const bool slot_nacked = cnack[slot] != 0;
      const bool slot_can_summarize = csum[slot] != 0;
      __syncwarp();

      const bool exists = is_client && at_slot_active;
      const bool gap = exists && cs > expected;
      const bool dup = exists && cs < expected;
      const bool is_join = kind == MT_CLIENT_JOIN;
      const bool is_leave = kind == MT_CLIENT_LEAVE;
      const bool join_dup = !is_client && is_join && at_target_active;
      const bool leave_dup = !is_client && is_leave && !at_target_active;
      const bool service_only =
          kind == MT_CLIENT_JOIN || kind == MT_CLIENT_LEAVE ||
          kind == MT_NO_CLIENT || kind == MT_CONTROL ||
          kind == MT_SUMMARY_ACK || kind == MT_SUMMARY_NACK;
      const bool invalid_type = is_client && !gap && !dup && service_only;
      const bool nonexistent = is_client && !gap && !dup && !invalid_type &&
                               (!at_slot_active || slot_nacked);
      const bool refseq_nack = is_client && !gap && !dup && !invalid_type &&
                               !nonexistent && ref != -1 && ref < msn;
      const bool summarize_nack = is_client && !gap && !dup &&
                                  !invalid_type && !nonexistent &&
                                  !refseq_nack && kind == MT_SUMMARIZE &&
                                  !slot_can_summarize;
      const bool nacked = valid && (nf || gap || invalid_type ||
                                    nonexistent || refseq_nack ||
                                    summarize_nack);
      const bool ignored = valid && !nf && (dup || join_dup || leave_dup);
      const bool sequenced = valid && !nacked && !ignored;
      const int nack_code =
          nf ? NACK_FUTURE
             : gap ? NACK_GAP
                   : invalid_type ? NACK_INVALID_TYPE
                                  : nonexistent ? NACK_NONEXISTENT_CLIENT
                                                : refseq_nack
                                                      ? NACK_REFSEQ_BELOW_MSN
                                                      : summarize_nack
                                                            ? NACK_NO_SUMMARY_SCOPE
                                                            : NACK_NONE;

      const bool is_noop = kind == MT_NOOP;
      const bool is_noclient = kind == MT_NO_CLIENT;
      const bool is_control = kind == MT_CONTROL;
      const bool rev1 =
          sequenced && (is_client ? !is_noop
                                  : !(is_noop || is_noclient || is_control));
      const int seq1 = wadd(seq, rev1 ? 1 : 0);

      // The owning lanes write: the refseq mark (client at refSeq = MSN),
      // the join upsert (scopes only on a fresh join) or the leave, and
      // the sequenced client's upsert.
      const bool own_slot = lane == (slot & 31);
      const bool own_target = lane == (target & 31);
      const bool do_mark = valid && !nf && refseq_nack;
      const bool do_join = valid && !nf && is_join && !is_client;
      const bool do_leave = sequenced && is_leave && !is_client;
      const bool do_up = sequenced && is_client;
      bool wrote = false;
      if (own_slot && do_mark) {
        cseq[slot] = cs;
        cref[slot] = msn;
        clu[slot] = ts;
        cnack[slot] = 1;
        wrote = true;
      }
      if (own_target && do_join) {
        active[target] = 1;
        cseq[target] = 0;
        cref[target] = msn;
        clu[target] = ts;
        if (!at_target_active) {
          csum[target] = (flags & F_CAN_SUMMARIZE) ? 1 : 0;
          cevict[target] = (flags & F_CAN_EVICT) ? 1 : 0;
        }
        cnack[target] = 0;
        wrote = true;
      } else if (own_target && do_leave) {
        active[target] = 0;
        wrote = true;
      }
      if (own_slot && do_up) {
        cseq[slot] = cs;
        cref[slot] = (ref == -1) ? seq1 : ref;
        clu[slot] = ts;
        cnack[slot] = 0;
        wrote = true;
      }
      if (wrote) rescan();

      int t_kind = nacked ? OUT_NACK : sequenced ? OUT_SEQUENCED : OUT_IGNORED;
      int t_seq = nacked ? seq : -1;
      int t_msn = nacked ? msn : -1;
      int t_send = SEND_IMMEDIATE;
      if (sequenced) {
        const int min_ref = __reduce_min_sync(DELI_FULL, lane_min);
        const bool no_clients = !__any_sync(DELI_FULL, lane_any);
        const int msn1 = no_clients ? seq1 : min_ref;
        const bool stale = msn1 <= last_sent;
        const bool has_contents = flags & F_HAS_CONTENTS;
        const bool client_noop = is_noop && is_client;
        const bool server_noop = is_noop && !is_client;
        const bool noclient = is_noclient && !is_client;
        const bool control = is_control && !is_client;
        int send = SEND_IMMEDIATE;
        if (client_noop && (!has_contents || stale)) send = SEND_LATER;
        if (server_noop && stale) send = SEND_NEVER;
        if (noclient && !no_clients) send = SEND_NEVER;
        if (control) send = SEND_NEVER;
        const bool rev2 = (client_noop && has_contents && !stale) ||
                          (server_noop && !stale) || (noclient && no_clients);
        const int seq2 = wadd(seq1, rev2 ? 1 : 0);
        const int msn2 = (noclient && no_clients) ? seq2 : msn1;
        seq = seq2;
        msn = msn2;
        if (send == SEND_IMMEDIATE) last_sent = msn2;
        nf = nf || (control && (flags & F_NACK_FUTURE));
        t_seq = seq2;
        t_msn = msn2;
        t_send = send;
      }
      if (lane == j) {
        my_kind = t_kind;
        my_seq = t_seq;
        my_msn = t_msn;
        my_send = t_send;
        my_code = nacked ? nack_code : NACK_NONE;
      }
      __syncwarp();
    }
    if (lane < n) {
      const size_t o = row + base + lane;
      a.t_kind[o] = my_kind;
      a.t_seq[o] = my_seq;
      a.t_msn[o] = my_msn;
      a.t_send[o] = my_send;
      a.t_nack_code[o] = my_code;
    }
  }
  for (int c = lane; c < C; c += 32) {
    a.o_active[r + c] = active[c];
    a.o_cseq[r + c] = cseq[c];
    a.o_cref[r + c] = cref[c];
    a.o_clu[r + c] = clu[c];
    a.o_csum[r + c] = csum[c];
    a.o_cnack[r + c] = cnack[c];
    a.o_cevict[r + c] = cevict[c];
  }
  if (lane == 0) {
    a.o_seq[d] = seq;
    a.o_msn[d] = msn;
    a.o_last_sent_msn[d] = last_sent;
    a.o_nack_future[d] = nf ? 1 : 0;
  }
}

// The order of the pointers sequencer_tick_warp_launch reads, one name each:
// 11 state inputs, 11 op planes, 11 state outputs (o_), 5 ticket planes
// (t_). The binding checks it against the SequencerState / OpBatch /
// TicketBatch field order before the first launch.
extern "C" const char* sequencer_tick_warp_layout() {
  return "seq,msn,last_sent_msn,nack_future,active,cseq,cref,clu,csum,cnack,"
         "cevict,"
         "valid,kind,slot,target,client_seq,ref_seq,timestamp,has_contents,"
         "can_summarize,can_evict,is_nack_future,"
         "o_seq,o_msn,o_last_sent_msn,o_nack_future,o_active,o_cseq,o_cref,"
         "o_clu,o_csum,o_cnack,o_cevict,"
         "t_kind,t_seq,t_msn,t_send,t_nack_code";
}


// The current device's per-block shared-memory limit with opt-in, or -1.
extern "C" int sequencer_tick_warp_optin() {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  return v;
}

extern "C" int sequencer_tick_warp_launch(void** p, int B, int C, int K,
                                          int smem_bytes, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  // The binding computes the same bytes from C and passes them.
  if ((size_t)smem_bytes != (size_t)DELI_WARPS * DELI_CLIENT_BYTES * C)
    return (int)cudaErrorInvalidValue;
  SeqArgs a;
  a.B = B;
  a.C = C;
  a.K = K;
  a.seq = (const int32_t*)p[0];
  a.msn = (const int32_t*)p[1];
  a.last_sent_msn = (const int32_t*)p[2];
  a.nack_future = (const uint8_t*)p[3];
  a.active = (const uint8_t*)p[4];
  a.cseq = (const int32_t*)p[5];
  a.cref = (const int32_t*)p[6];
  a.clu = (const int32_t*)p[7];
  a.csum = (const uint8_t*)p[8];
  a.cnack = (const uint8_t*)p[9];
  a.cevict = (const uint8_t*)p[10];
  a.valid = (const uint8_t*)p[11];
  a.kind = (const int32_t*)p[12];
  a.slot = (const int32_t*)p[13];
  a.target = (const int32_t*)p[14];
  a.client_seq = (const int32_t*)p[15];
  a.ref_seq = (const int32_t*)p[16];
  a.timestamp = (const int32_t*)p[17];
  a.has_contents = (const uint8_t*)p[18];
  a.can_summarize = (const uint8_t*)p[19];
  a.can_evict = (const uint8_t*)p[20];
  a.is_nack_future = (const uint8_t*)p[21];
  a.o_seq = (int32_t*)p[22];
  a.o_msn = (int32_t*)p[23];
  a.o_last_sent_msn = (int32_t*)p[24];
  a.o_nack_future = (uint8_t*)p[25];
  a.o_active = (uint8_t*)p[26];
  a.o_cseq = (int32_t*)p[27];
  a.o_cref = (int32_t*)p[28];
  a.o_clu = (int32_t*)p[29];
  a.o_csum = (uint8_t*)p[30];
  a.o_cnack = (uint8_t*)p[31];
  a.o_cevict = (uint8_t*)p[32];
  a.t_kind = (int32_t*)p[33];
  a.t_seq = (int32_t*)p[34];
  a.t_msn = (int32_t*)p[35];
  a.t_send = (int32_t*)p[36];
  a.t_nack_code = (int32_t*)p[37];
  const cudaError_t err = cudaFuncSetAttribute(
      sequencer_tick_warp_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const int grid = (B + DELI_WARPS - 1) / DELI_WARPS;
  sequencer_tick_warp_kernel<<<grid, DELI_THREADS, smem_bytes,
                               (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
