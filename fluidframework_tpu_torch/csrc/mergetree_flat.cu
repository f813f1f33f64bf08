// Flat merge-tree tick — one thread block per document walks its K ops.
//
// Replaces the TPU kernel fluidframework_tpu/ops/mergetree_pallas.py:
// _tick_kernel (pallas_call at mergetree_pallas.py:362, per-op body
// merge_apply_vec at :141, wrapper apply_tick_pallas). Same function as
// the plain ops/mergetree_kernel.py:apply_tick: each valid op of a
// document applies in order (visibility, exclusive prefix, <= 2 splits,
// tie-broken placement, one 0/1/2 shift, remove mark with the overlap
// bitmask or annotate); invalid ops are no-ops and ops past the
// document's last valid one are skipped.
//
// Design: out of place — the block first copies its document's row (the
// valid plane, six int32 planes, the [S, P] prop and [S, W] overlap
// planes, the count) to the outputs, then applies the ops in place on the
// outputs with the per-op step of merge_apply.cuh. The planes stay in
// global memory because S grows with the document; the layouts are the
// JAX package's ([B, S], [B, S, P], [B, S, W]), so no transposes.
//
// Bound on H100: bytes for a tick that reads the table once and writes it
// once (B * S * (7 + P + W) * 4 * 2 plus the ops). This version re-reads
// the row from L2/L1 three times per op (two prefix scans and the shift),
// so it runs well above that bound; staging the row in shared memory is
// the next step, not done here.
//
// Plain C interface for ctypes; the launcher returns cudaGetLastError().

#include "merge_apply.cuh"

#define MT_FLAT_THREADS 256

struct FlatArgs {
  int B, S, P, W, K;
  const uint8_t* valid;
  const int32_t* length;
  const int32_t* ins_seq;
  const int32_t* ins_client;
  const int32_t* rem_seq;
  const int32_t* rem_client;
  const int32_t* rem_overlap;
  const int32_t* pool_start;
  const int32_t* prop_val;
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
  uint8_t* o_valid;
  int32_t* o_length;
  int32_t* o_ins_seq;
  int32_t* o_ins_client;
  int32_t* o_rem_seq;
  int32_t* o_rem_client;
  int32_t* o_rem_overlap;
  int32_t* o_pool_start;
  int32_t* o_prop_val;
  int32_t* o_count;
};

__global__ void __launch_bounds__(MT_FLAT_THREADS)
mergetree_flat_kernel(FlatArgs a) {
  extern __shared__ int saved[];
  __shared__ mt::Shared sh;
  __shared__ int last;
  const int doc = blockIdx.x;
  const size_t row = (size_t)doc * a.S;
  mt::FlatDoc d;
  d.S = a.S;
  d.P = a.P;
  d.W = a.W;
  d.valid = a.o_valid + row;
  d.plane[mt::LENGTH] = a.o_length + row;
  d.plane[mt::INS_SEQ] = a.o_ins_seq + row;
  d.plane[mt::INS_CLIENT] = a.o_ins_client + row;
  d.plane[mt::REM_SEQ] = a.o_rem_seq + row;
  d.plane[mt::REM_CLIENT] = a.o_rem_client + row;
  d.plane[mt::POOL_START] = a.o_pool_start + row;
  d.prop = a.o_prop_val + row * a.P;
  d.overlap = a.o_rem_overlap + row * a.W;
  const int32_t* src[mt::NUM_PLANES] = {a.length, a.ins_seq, a.ins_client,
                                        a.rem_seq, a.rem_client,
                                        a.pool_start};
  for (int i = threadIdx.x; i < a.S; i += blockDim.x) {
    d.valid[i] = a.valid[row + i];
    for (int f = 0; f < mt::NUM_PLANES; ++f) d.plane[f][i] = src[f][row + i];
  }
  for (int i = threadIdx.x; i < a.S * a.P; i += blockDim.x)
    d.prop[i] = a.prop_val[row * a.P + i];
  for (int i = threadIdx.x; i < a.S * a.W; i += blockDim.x)
    d.overlap[i] = a.rem_overlap[row * a.W + i];
  // Trip count: one past the document's last valid op.
  const size_t ops = (size_t)doc * a.K;
  if (threadIdx.x == 0) {
    sh.count = a.count[doc];
    last = 0;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < a.K; k += blockDim.x)
    if (a.op_valid[ops + k]) atomicMax(&last, k + 1);
  __syncthreads();
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
    mt::apply_op(d, op, sh, saved);
  }
  if (threadIdx.x == 0) a.o_count[doc] = sh.count;
}

// The order in which mergetree_flat_launch reads its pointer array: the
// MergeState fields, the MergeOpBatch fields (op_), the output MergeState
// fields (o_). The binding checks it before the first launch.
extern "C" const char* mergetree_flat_layout() {
  return "valid,length,ins_seq,ins_client,rem_seq,rem_client,rem_overlap,"
         "pool_start,prop_val,count,"
         "op_valid,op_kind,op_pos,op_end,op_seq,op_ref_seq,op_client,"
         "op_pool_start,op_text_len,op_prop_key,op_prop_val,"
         "o_valid,o_length,o_ins_seq,o_ins_client,o_rem_seq,o_rem_client,"
         "o_rem_overlap,o_pool_start,o_prop_val,o_count";
}

extern "C" int mergetree_flat_launch(void** p, int B, int S, int P, int W,
                                     int K, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  FlatArgs a;
  a.B = B;
  a.S = S;
  a.P = P;
  a.W = W;
  a.K = K;
  a.valid = (const uint8_t*)p[0];
  a.length = (const int32_t*)p[1];
  a.ins_seq = (const int32_t*)p[2];
  a.ins_client = (const int32_t*)p[3];
  a.rem_seq = (const int32_t*)p[4];
  a.rem_client = (const int32_t*)p[5];
  a.rem_overlap = (const int32_t*)p[6];
  a.pool_start = (const int32_t*)p[7];
  a.prop_val = (const int32_t*)p[8];
  a.count = (const int32_t*)p[9];
  a.op_valid = (const uint8_t*)p[10];
  a.op_kind = (const int32_t*)p[11];
  a.op_pos = (const int32_t*)p[12];
  a.op_end = (const int32_t*)p[13];
  a.op_seq = (const int32_t*)p[14];
  a.op_ref_seq = (const int32_t*)p[15];
  a.op_client = (const int32_t*)p[16];
  a.op_pool_start = (const int32_t*)p[17];
  a.op_text_len = (const int32_t*)p[18];
  a.op_prop_key = (const int32_t*)p[19];
  a.op_prop_val = (const int32_t*)p[20];
  a.o_valid = (uint8_t*)p[21];
  a.o_length = (int32_t*)p[22];
  a.o_ins_seq = (int32_t*)p[23];
  a.o_ins_client = (int32_t*)p[24];
  a.o_rem_seq = (int32_t*)p[25];
  a.o_rem_client = (int32_t*)p[26];
  a.o_rem_overlap = (int32_t*)p[27];
  a.o_pool_start = (int32_t*)p[28];
  a.o_prop_val = (int32_t*)p[29];
  a.o_count = (int32_t*)p[30];
  const size_t smem = 2 * (mt::NUM_PLANES + 1 + P + W) * sizeof(int);
  mergetree_flat_kernel<<<B, MT_FLAT_THREADS, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
