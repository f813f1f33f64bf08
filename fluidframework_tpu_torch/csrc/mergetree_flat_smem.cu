// Flat merge-tree tick, shared-memory variant — one thread block per
// document applies its K ops with the document's row and ops held in
// shared memory.
//
// Replaces the TPU kernel fluidframework_tpu/ops/mergetree_pallas.py:
// _tick_kernel (pallas_call at mergetree_pallas.py:362, per-op body
// merge_apply_vec at :141), as mergetree_flat.cu does; the same function
// as the plain ops/mergetree_kernel.py:apply_tick, bit for bit: each valid
// op of a document applies in order (visibility, exclusive prefix, <= 2
// splits, tie-broken placement, one 0/1/2 shift, remove mark with the
// overlap bitmask or annotate); invalid ops are no-ops and ops past the
// document's last valid one are skipped.
//
// Bound on H100: not the bytes (the [B, S] table in and out once and the
// op planes in: about 0.15 ms for 8,192 documents at S = 512, P = W = 4)
// but the latency of one document's op chain. mergetree_flat.cu keeps the
// row in global memory and pays, per op, three block scans of three
// barriers a 256-slot tile, each followed by block reductions, and a
// barrier per field per tile of the shift, over planes read through L1/L2
// (the [S, P] and [S, W] ones with a stride). The paths launch it at
// B = 1 (one document's overflow replay), so one SM runs that chain alone.
//
// Design: the row is staged FIELD-MAJOR in dynamic shared memory (the six
// slot planes, valid, the P prop planes and the W overlap words, each a
// plane of S ints; the [S, P] and [S, W] planes transposed on the way in),
// with the K ops' 11 planes beside it, a thread issuing every load of its
// slot and op before its stores. Each valid op runs walk (flat_smem.cuh,
// the step the shared-memory SharedMatrix kernels run on their axes): a
// warp scan and one barrier for the visible prefix, the placement read off
// that prefix, a shift of only the slots the op moves, each thread its own
// slots through registers, and a scan for the remove mark or annotate:
// five to seven block barriers an op. The row and the count are written to
// the outputs once; the inputs are never modified. Registers are capped at
// 64 a thread: a block of 256 threads, four an SM, or, for rows of at most
// MFS_NARROW_S slots, a block of 128, eight an SM. The variant is picked
// by shape (ops/mergetree_cuda.py): rows that do not fit the card's
// per-block shared memory run mergetree_flat.cu.
//
// Plain C interface for ctypes; the launcher returns cudaGetLastError().

#include "flat_smem.cuh"

#define MFS_HEADER_INTS 256
#define MFS_OP_FIELDS 11
// Props and overlap words a slot's staging loads before its stores.
#define MFS_STAGE_WORDS 8
// Rows of at most this many slots run blocks of 128 threads, else 256.
#define MFS_NARROW_S 128

// The op planes in shared memory, in MergeOpBatch order.
enum { Q_VALID = 0, Q_KIND, Q_POS, Q_END, Q_SEQ, Q_REF_SEQ, Q_CLIENT,
       Q_POOL_START, Q_TEXT_LEN, Q_PROP_KEY, Q_PROP_VAL };

// The first MFS_HEADER_INTS ints of shared memory.
struct FlatHeader {
  int count;                // the row's live-slot count (thread 0 writes)
  int last;                 // one past the document's last valid op
  int part[2][32];          // scan partials (walk)
  unsigned keys[2][2][32];  // block_min2 partials (walk)
};
static_assert(sizeof(FlatHeader) <= MFS_HEADER_INTS * 4,
              "header too large");

struct FlatSmemArgs {
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

__host__ __device__ __forceinline__ size_t smem_ints(int S, int P, int W,
                                                     int K) {
  return MFS_HEADER_INTS + (size_t)(A_PROP + P + W) * S + 2 * (size_t)S +
         MFS_OP_FIELDS * (size_t)K;
}

// Stage document ``doc``'s row and op planes in shared memory, its count
// in the header and one past its last valid op in h->last (zeroed
// before). A thread issues every load of its slot (the seven slot planes,
// its first MFS_STAGE_WORDS props and overlap words) and of its op before
// any store, so a document costs one round trip to device memory, not one
// a plane; props and overlap words past that many a slot, and slots and
// ops past the block's threads, take further trips.
__device__ void stage(const FlatSmemArgs& a, int doc, const Axis& x,
                      int* const* op, FlatHeader* h) {
  const size_t row = (size_t)doc * a.S, orow = (size_t)doc * a.K;
  const int P = a.P, W = a.W;
  for (int i = threadIdx.x; i < max(a.S, a.K); i += blockDim.x) {
    const bool slot = i < a.S, has_op = i < a.K;
    int v[A_PROP], pw[MFS_STAGE_WORDS], q[MFS_OP_FIELDS];
    if (slot) {
      const size_t g = row + i;
      const int32_t* src[A_PROP - 1] = {a.length, a.ins_seq, a.ins_client,
                                        a.rem_seq, a.rem_client,
                                        a.pool_start};
#pragma unroll
      for (int f = 0; f < A_PROP - 1; ++f) v[f] = src[f][g];
      v[A_VALID] = a.valid[g];
#pragma unroll
      for (int e = 0; e < MFS_STAGE_WORDS; ++e)
        if (e < P) pw[e] = a.prop_val[g * P + e];
        else if (e - P < W) pw[e] = a.rem_overlap[g * W + (e - P)];
    }
    if (has_op) {
      const size_t g = orow + i;
      const int v2[MFS_OP_FIELDS] = {
          a.op_valid[g],      a.op_kind[g],       a.op_pos[g],
          a.op_end[g],        a.op_seq[g],        a.op_ref_seq[g],
          a.op_client[g],     a.op_pool_start[g], a.op_text_len[g],
          a.op_prop_key[g],   a.op_prop_val[g]};
#pragma unroll
      for (int f = 0; f < MFS_OP_FIELDS; ++f) q[f] = v2[f];
    }
    if (slot) {
#pragma unroll
      for (int f = 0; f < A_PROP; ++f) x.f(f)[i] = v[f];
#pragma unroll
      for (int e = 0; e < MFS_STAGE_WORDS; ++e)
        if (e < P + W) x.f(A_PROP + e)[i] = pw[e];
      const size_t g = row + i;
      for (int e = MFS_STAGE_WORDS; e < P + W; ++e)
        x.f(A_PROP + e)[i] = e < P ? a.prop_val[g * P + e]
                                   : a.rem_overlap[g * W + (e - P)];
    }
    if (has_op) {
#pragma unroll
      for (int f = 0; f < MFS_OP_FIELDS; ++f) op[f][i] = q[f];
      if (q[Q_VALID]) atomicMax(&h->last, i + 1);
    }
  }
  if (threadIdx.x == 0) h->count = a.count[doc];
}

template <int THREADS>
__global__ void __launch_bounds__(THREADS, 1024 / THREADS)
mergetree_flat_smem_kernel(FlatSmemArgs a) {
  extern __shared__ int4 mfs_dyn[];
  int* base = reinterpret_cast<int*>(mfs_dyn);
  FlatHeader* h = reinterpret_cast<FlatHeader*>(base);
  const int doc = blockIdx.x;
  const int S = a.S, K = a.K;
  int* cur = base + MFS_HEADER_INTS;
  const Axis x = {cur, S, a.P, a.W, &h->count};
  cur += (size_t)(A_PROP + a.P + a.W) * S;
  int* tvis = cur;
  int* tcum = cur + S;
  cur += 2 * S;
  int* op[MFS_OP_FIELDS];
  for (int q = 0; q < MFS_OP_FIELDS; ++q, cur += K) op[q] = cur;

  if (threadIdx.x == 0) h->last = 0;
  __syncthreads();
  stage(a, doc, x, op, h);
  __syncthreads();
  const int last = h->last;
  int par = 0;
  for (int k = 0; k < last; ++k) {
    if (!op[Q_VALID][k]) continue;
    mt::Op o;
    o.valid = 1;
    o.kind = op[Q_KIND][k];
    o.pos = op[Q_POS][k];
    o.end = op[Q_END][k];
    o.seq = op[Q_SEQ][k];
    o.ref_seq = op[Q_REF_SEQ][k];
    o.client = op[Q_CLIENT][k];
    o.pool_start = op[Q_POOL_START][k];
    o.text_len = op[Q_TEXT_LEN][k];
    o.prop_key = op[Q_PROP_KEY][k];
    o.prop_val = op[Q_PROP_VAL][k];
    walk<THREADS>(x, o, h, par, tvis, tcum);
  }
  __syncthreads();
  int32_t* planes[mt::NUM_PLANES] = {a.o_length, a.o_ins_seq,
                                     a.o_ins_client, a.o_rem_seq,
                                     a.o_rem_client, a.o_pool_start};
  store_axis(x, a.o_valid, planes, a.o_prop_val, a.o_rem_overlap,
             (size_t)doc * S);
  if (threadIdx.x == 0) a.o_count[doc] = h->count;
}

// The order in which mergetree_flat_smem_launch reads its pointer array:
// the MergeState fields, the MergeOpBatch fields (op_), the output
// MergeState fields (o_) — mergetree_flat.cu's order. The binding checks
// it before the first launch.
extern "C" const char* mergetree_flat_smem_layout() {
  return "valid,length,ins_seq,ins_client,rem_seq,rem_client,rem_overlap,"
         "pool_start,prop_val,count,"
         "op_valid,op_kind,op_pos,op_end,op_seq,op_ref_seq,op_client,"
         "op_pool_start,op_text_len,op_prop_key,op_prop_val,"
         "o_valid,o_length,o_ins_seq,o_ins_client,o_rem_seq,o_rem_client,"
         "o_rem_overlap,o_pool_start,o_prop_val,o_count";
}

// The current device's per-block shared-memory limit with opt-in, or -1.
extern "C" int mergetree_flat_smem_optin() {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  return v;
}

extern "C" int mergetree_flat_smem_launch(void** p, int B, int S, int P,
                                          int W, int K, int smem_bytes,
                                          void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  // The binding computes the same bytes from the shape and passes them.
  if ((size_t)smem_bytes != 4 * smem_ints(S, P, W, K))
    return (int)cudaErrorInvalidValue;
  FlatSmemArgs a;
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
  const bool narrow = S <= MFS_NARROW_S;
  void (*kernel)(FlatSmemArgs) = narrow ? mergetree_flat_smem_kernel<128>
                                        : mergetree_flat_smem_kernel<256>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B, narrow ? 128 : 256, smem_bytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
