// Per-op deli ticket machine over one tick — one thread per document.
//
// Replaces the TPU kernel fluidframework_tpu/ops/sequencer_pallas.py:
// _tick_kernel + _ticket_step_vec (pallas_call at sequencer_pallas.py:279,
// wrapper process_batch_pallas). Same function as the plain
// ops/sequencer.py:process_batch: dup/gap/invalid-type/nonexistent/
// refSeq<MSN/summarize nacks, nack_future, join/leave with dup-join
// upsert, no-op consolidation, the MSN recompute and the send type, with
// the nack-code precedence, rev1/rev2, the INT32_MAX min over active cref,
// last_sent_msn moving only on SEND_IMMEDIATE, and the touched masks kept
// exactly as the reference has them.
//
// Design: the K ops of a document are sequential, documents are
// independent, so one thread walks its document's ops in order. The state
// is out of place: the thread first copies its row (4 scalars, 7 client
// lanes x C) to the outputs and then updates the outputs in global memory
// (L1-resident for the small C of real documents); C is a runtime value
// because the host grows the lane axis by doubling. Layout is row-major
// [B, K] / [B, C]; bool planes travel as uint8 (torch.bool storage).
//
// Bound on H100: bytes (11 op planes in, 5 ticket planes out, the state
// in and out once); integer work is a few dozen ops per op. Neighbouring
// threads read addresses K apart, so a warp's loads are not coalesced —
// the first thing a faster version would change (stage ops through
// shared memory), not done here.
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

#define SEQ_TICK_THREADS 128

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

__global__ void __launch_bounds__(SEQ_TICK_THREADS)
sequencer_tick_kernel(const SeqArgs a) {
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= a.B) return;
  const int C = a.C;
  const size_t r = (size_t)d * C;
  uint8_t* active = a.o_active + r;
  int32_t* cseq = a.o_cseq + r;
  int32_t* cref = a.o_cref + r;
  int32_t* clu = a.o_clu + r;
  uint8_t* csum = a.o_csum + r;
  uint8_t* cnack = a.o_cnack + r;
  uint8_t* cevict = a.o_cevict + r;
  for (int c = 0; c < C; ++c) {
    active[c] = a.active[r + c];
    cseq[c] = a.cseq[r + c];
    cref[c] = a.cref[r + c];
    clu[c] = a.clu[r + c];
    csum[c] = a.csum[r + c];
    cnack[c] = a.cnack[r + c];
    cevict[c] = a.cevict[r + c];
  }
  int32_t seq = a.seq[d], msn = a.msn[d], last_sent = a.last_sent_msn[d];
  bool nf = a.nack_future[d] != 0;

  for (int k = 0; k < a.K; ++k) {
    const size_t o = (size_t)d * a.K + k;
    const bool valid = a.valid[o] != 0;
    const int kind = a.kind[o];
    const int oslot = a.slot[o];
    const int cs = a.client_seq[o];
    const int ref = a.ref_seq[o];
    const int ts = a.timestamp[o];
    const bool is_client = oslot >= 0;
    const int slot = min(max(oslot, 0), C - 1);
    const int target = min(max(a.target[o], 0), C - 1);

    const bool at_slot_active = active[slot] != 0;
    const bool at_target_active = active[target] != 0;
    const bool exists = is_client && at_slot_active;
    const int expected = cseq[slot] + 1;
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
                             (!at_slot_active || cnack[slot] != 0);
    const bool refseq_nack = is_client && !gap && !dup && !invalid_type &&
                             !nonexistent && ref != -1 && ref < msn;
    const bool summarize_nack = is_client && !gap && !dup && !invalid_type &&
                                !nonexistent && !refseq_nack &&
                                kind == MT_SUMMARIZE && csum[slot] == 0;

    const bool nacked = valid && (nf || gap || invalid_type || nonexistent ||
                                  refseq_nack || summarize_nack);
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

    // Every lane write below sits under one of the reference's touched
    // masks (refseq mark, join, sequenced), so untouched ops change nothing.
    // Refseq nack side effect: mark the client at refSeq = MSN.
    if (valid && !nf && refseq_nack) {
      cseq[slot] = cs;
      cref[slot] = msn;
      clu[slot] = ts;
      cnack[slot] = 1;
    }
    // Membership: a dup join still upserts (clientSeq 0, refSeq msn);
    // scopes are set only on a fresh join.
    const bool do_join = valid && !nf && is_join && !is_client;
    const bool do_leave = sequenced && is_leave && !is_client;
    if (do_join) {
      active[target] = 1;
      cseq[target] = 0;
      cref[target] = msn;
      clu[target] = ts;
      if (!at_target_active) {
        csum[target] = a.can_summarize[o];
        cevict[target] = a.can_evict[o];
      }
      cnack[target] = 0;
    } else if (do_leave) {
      active[target] = 0;
    }

    const bool is_noop = kind == MT_NOOP;
    const bool is_noclient = kind == MT_NO_CLIENT;
    const bool is_control = kind == MT_CONTROL;
    const bool rev1 =
        sequenced && (is_client ? !is_noop
                                : !(is_noop || is_noclient || is_control));
    const int seq1 = seq + (rev1 ? 1 : 0);

    int t_kind = nacked ? OUT_NACK : sequenced ? OUT_SEQUENCED : OUT_IGNORED;
    int t_seq = nacked ? seq : -1;
    int t_msn = nacked ? msn : -1;
    int t_send = SEND_IMMEDIATE;

    if (sequenced) {
      if (is_client) {
        cseq[slot] = cs;
        cref[slot] = (ref == -1) ? seq1 : ref;
        clu[slot] = ts;
        cnack[slot] = 0;
      }
      int min_ref = INT32_MAX_;
      bool any = false;
      for (int c = 0; c < C; ++c) {
        if (active[c]) {
          any = true;
          min_ref = min(min_ref, cref[c]);
        }
      }
      const bool no_clients = !any;
      const int msn1 = no_clients ? seq1 : min_ref;
      const bool stale = msn1 <= last_sent;
      const bool has_contents = a.has_contents[o] != 0;
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
      const int seq2 = seq1 + (rev2 ? 1 : 0);
      const int msn2 = (noclient && no_clients) ? seq2 : msn1;
      seq = seq2;
      msn = msn2;
      if (send == SEND_IMMEDIATE) last_sent = msn2;
      nf = nf || (control && a.is_nack_future[o] != 0);
      t_seq = seq2;
      t_msn = msn2;
      t_send = send;
    }
    a.t_kind[o] = t_kind;
    a.t_seq[o] = t_seq;
    a.t_msn[o] = t_msn;
    a.t_send[o] = t_send;
    a.t_nack_code[o] = nacked ? nack_code : NACK_NONE;
  }
  a.o_seq[d] = seq;
  a.o_msn[d] = msn;
  a.o_last_sent_msn[d] = last_sent;
  a.o_nack_future[d] = nf ? 1 : 0;
}

// The order of the pointers sequencer_tick_launch reads, one name each:
// 11 state inputs, 11 op planes, 11 state outputs (o_), 5 ticket planes
// (t_). The binding checks it against the SequencerState / OpBatch /
// TicketBatch field order before the first launch.
extern "C" const char* sequencer_tick_layout() {
  return "seq,msn,last_sent_msn,nack_future,active,cseq,cref,clu,csum,cnack,"
         "cevict,"
         "valid,kind,slot,target,client_seq,ref_seq,timestamp,has_contents,"
         "can_summarize,can_evict,is_nack_future,"
         "o_seq,o_msn,o_last_sent_msn,o_nack_future,o_active,o_cseq,o_cref,"
         "o_clu,o_csum,o_cnack,o_cevict,"
         "t_kind,t_seq,t_msn,t_send,t_nack_code";
}

extern "C" int sequencer_tick_launch(void** p, int B, int C, int K,
                                     void* stream) {
  if (B <= 0) return (int)cudaSuccess;
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
  const int grid = (B + SEQ_TICK_THREADS - 1) / SEQ_TICK_THREADS;
  sequencer_tick_kernel<<<grid, SEQ_TICK_THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
