// SharedMatrix op tick, shared-memory variant — one thread block per
// document applies its K ops with both axes, the cell log and the ops
// held in shared memory.
//
// Replaces the TPU kernel fluidframework_tpu/ops/matrix_pallas.py:158
// _tick_kernel (pallas_call at matrix_pallas.py:323, per-op body
// _matrix_apply_vec at :95), as matrix_tick.cu does; the same function as
// the plain ops/matrix_kernel.py:apply_tick, bit for bit: per valid op of
// a document, in order, a row or col op runs one flat merge step on that
// axis; a cell op resolves (row, col) to handles in its own (ref_seq,
// client) frame of each axis, on the pre-op tables, and when both resolve
// makes the LWW last-match-or-append write; any other target changes
// nothing, and a cell op's kind, pos and count never reach a walk.
// Invalid ops are no-ops; ops past the document's last valid one are
// skipped.
//
// Bound on H100: not the bytes (both axes, the cell log and the ops read
// once and written once: about 0.06 ms for 8,192 documents at S = 100,
// C = 128) but the latency of one document's op chain. matrix_tick.cu
// keeps the document in global memory and pays, per cell op, two block
// scans over S and a pass over C, each ending in block reductions, and
// per vector op three block scans and a barrier per field per tile of the
// shift.
//
// Design: both axes (field-major), the cell log and the document's op
// planes are staged in dynamic shared memory, a few loads in flight a
// thread, and written back once (the walk, the cell writer and the
// write-back are matrix_smem.cuh's, shared with the step tick's
// shared-memory variant). A
// vector op runs the shared-memory walk on its axis. Between two vector
// ops the axes do not change, so the op list splits into stretches of at
// most MXT_STRETCH ops with no valid vector op among them. Each warp takes
// whole cell ops of a stretch: the row handle and then the col handle in
// the op's own frame, by a warp scan over S that stops at the first slot
// holding the position (no block barrier), and the last log entry holding
// that key as the stretch found it. One warp then makes the stretch's
// writes in op order (write_run): a key's last match is that entry or one
// the stretch's earlier writes left, unless an earlier append replaced the
// found entry's key, and then it scans the log again; a miss appends at
// min(count, C - 1), an append at a negative index (a negative count) is
// dropped, and the count grows past C. Two barriers a stretch, none a
// cell op. Registers are capped at 64 a thread: a block of 256 threads,
// four an SM, or, for axes of at most MXT_NARROW_S slots (one slot a
// thread), a block of 128, eight an SM, which keeps twice as many of the
// small documents of the matrix host's batched width in flight (larger
// axes ran slower with it). The variant is picked by shape
// (ops/matrix_cuda.py): documents that do not fit the card's per-block
// shared memory run matrix_tick.cu.
//
// Plain C interface for ctypes; the launcher returns cudaGetLastError().

#include "matrix_smem.cuh"

// The most ops one stretch resolves before its writes.
#define MXT_STRETCH 64
#define MXT_OP_FIELDS 13
// Axes of at most this many slots run blocks of 128 threads, else 256.
#define MXT_NARROW_S 128

// The op planes in shared memory, in MatrixOpBatch order.
enum { O_VALID = 0, O_TARGET, O_KIND, O_POS, O_END, O_COUNT, O_HANDLE_BASE,
       O_ROW, O_COL, O_VALUE, O_SEQ, O_REF_SEQ, O_CLIENT };

struct SmemTickArgs {
  int B, S, P, W, C, K;
  const uint8_t* rows_valid;
  const int32_t* rows_length;
  const int32_t* rows_ins_seq;
  const int32_t* rows_ins_client;
  const int32_t* rows_rem_seq;
  const int32_t* rows_rem_client;
  const int32_t* rows_rem_overlap;
  const int32_t* rows_pool_start;
  const int32_t* rows_prop_val;
  const int32_t* rows_count;
  const uint8_t* cols_valid;
  const int32_t* cols_length;
  const int32_t* cols_ins_seq;
  const int32_t* cols_ins_client;
  const int32_t* cols_rem_seq;
  const int32_t* cols_rem_client;
  const int32_t* cols_rem_overlap;
  const int32_t* cols_pool_start;
  const int32_t* cols_prop_val;
  const int32_t* cols_count;
  const int32_t* cell_rh;
  const int32_t* cell_ch;
  const int32_t* cell_val;
  const int32_t* cell_seq;
  const uint8_t* cell_used;
  const int32_t* cell_count;
  const uint8_t* op_valid;
  const int32_t* op_target;
  const int32_t* op_kind;
  const int32_t* op_pos;
  const int32_t* op_end;
  const int32_t* op_count;
  const int32_t* op_handle_base;
  const int32_t* op_row;
  const int32_t* op_col;
  const int32_t* op_value;
  const int32_t* op_seq;
  const int32_t* op_ref_seq;
  const int32_t* op_client;
  uint8_t* o_rows_valid;
  int32_t* o_rows_length;
  int32_t* o_rows_ins_seq;
  int32_t* o_rows_ins_client;
  int32_t* o_rows_rem_seq;
  int32_t* o_rows_rem_client;
  int32_t* o_rows_rem_overlap;
  int32_t* o_rows_pool_start;
  int32_t* o_rows_prop_val;
  int32_t* o_rows_count;
  uint8_t* o_cols_valid;
  int32_t* o_cols_length;
  int32_t* o_cols_ins_seq;
  int32_t* o_cols_ins_client;
  int32_t* o_cols_rem_seq;
  int32_t* o_cols_rem_client;
  int32_t* o_cols_rem_overlap;
  int32_t* o_cols_pool_start;
  int32_t* o_cols_prop_val;
  int32_t* o_cols_count;
  int32_t* o_cell_rh;
  int32_t* o_cell_ch;
  int32_t* o_cell_val;
  int32_t* o_cell_seq;
  uint8_t* o_cell_used;
  int32_t* o_cell_count;
};

// The storage handle at visible position ``pos`` of axis x in the
// (ref, client) frame, or -1: the first slot with cum <= pos < cum + vis
// (mx::handle_at's rule, sums wrapping as int32), by the calling warp
// alone — a warp scan over S, 32 slots at a time, that stops at the first
// hit. Every lane gets the result.
__device__ int warp_handle_at(const Axis& x, int pos, int ref, int client) {
  const int lane = sm::lane_id();
  int carry = 0;
  for (int base = 0; base < x.S; base += 32) {
    const int i = base + lane;
    const int v = i < x.S ? axis_vis(x, i, ref, client) : 0;
    const int incl = sm::warp_incl_scan(v);
    const int cum = mt::wadd(carry, mt::wsub(incl, v));
    const bool hit = i < x.S && cum <= pos && pos < mt::wadd(cum, v);
    const unsigned bal = __ballot_sync(SM_FULL, hit);
    if (bal) {
      const int src = __ffs(bal) - 1;
      const int c = __shfl_sync(SM_FULL, cum, src);
      return mt::wsub(mt::wadd(x.f(mt::POOL_START)[base + src], pos), c);
    }
    carry = mt::wadd(carry, __shfl_sync(SM_FULL, incl, 31));
  }
  return -1;
}

// Stage document ``doc``'s two axes, cell log and op planes in shared
// memory, and its counts in the header. Each loop issues every load of a
// thread's slot, entry or op before its stores, so a small document costs
// five round trips to device memory (axes, props, overlap words, cells,
// ops), not one a plane as copying plane by plane does; the log's
// high-water mark (h->hw) and the trip count, one past the last valid op
// (h->last), are taken on the way (both zeroed before).
__device__ void stage(const SmemTickArgs& a, int doc, const Axis* axis,
                      int* const* cell, int* const* op, Header* h) {
  const size_t row = (size_t)doc * a.S;
  for (int i = threadIdx.x; i < a.S; i += blockDim.x) {
    const size_t g = row + i;
    const int v[2][A_PROP] = {
        {a.rows_length[g], a.rows_ins_seq[g], a.rows_ins_client[g],
         a.rows_rem_seq[g], a.rows_rem_client[g], a.rows_pool_start[g],
         a.rows_valid[g]},
        {a.cols_length[g], a.cols_ins_seq[g], a.cols_ins_client[g],
         a.cols_rem_seq[g], a.cols_rem_client[g], a.cols_pool_start[g],
         a.cols_valid[g]}};
    for (int ax = 0; ax < 2; ++ax)
      for (int f = 0; f < A_PROP; ++f) axis[ax].f(f)[i] = v[ax][f];
  }
  // The interleaved [S, P] props and [S, W] overlap words, field-major.
  for (int t = threadIdx.x; t < a.S * a.P; t += blockDim.x) {
    const int r = a.rows_prop_val[row * a.P + t];
    const int c = a.cols_prop_val[row * a.P + t];
    axis[0].f(A_PROP + t % a.P)[t / a.P] = r;
    axis[1].f(A_PROP + t % a.P)[t / a.P] = c;
  }
  for (int t = threadIdx.x; t < a.S * a.W; t += blockDim.x) {
    const int r = a.rows_rem_overlap[row * a.W + t];
    const int c = a.cols_rem_overlap[row * a.W + t];
    axis[0].f(A_PROP + a.P + t % a.W)[t / a.W] = r;
    axis[1].f(A_PROP + a.P + t % a.W)[t / a.W] = c;
  }
  const size_t crow = (size_t)doc * a.C;
  for (int i = threadIdx.x; i < a.C; i += blockDim.x) {
    const size_t g = crow + i;
    const int v[C_NUM] = {a.cell_rh[g], a.cell_ch[g], a.cell_val[g],
                          a.cell_seq[g], a.cell_used[g]};
    for (int q = 0; q < C_NUM; ++q) cell[q][i] = v[q];
    if (v[C_USED]) atomicMax(&h->hw, i + 1);
  }
  const size_t orow = (size_t)doc * a.K;
  for (int k = threadIdx.x; k < a.K; k += blockDim.x) {
    const size_t g = orow + k;
    const int v[MXT_OP_FIELDS] = {
        a.op_valid[g], a.op_target[g], a.op_kind[g], a.op_pos[g],
        a.op_end[g], a.op_count[g], a.op_handle_base[g], a.op_row[g],
        a.op_col[g], a.op_value[g], a.op_seq[g], a.op_ref_seq[g],
        a.op_client[g]};
    for (int q = 0; q < MXT_OP_FIELDS; ++q) op[q][k] = v[q];
    if (v[O_VALID]) atomicMax(&h->last, k + 1);
  }
  if (threadIdx.x == 0) {
    h->axis_count[0] = a.rows_count[doc];
    h->axis_count[1] = a.cols_count[doc];
    h->cell_count = a.cell_count[doc];
  }
}

__host__ __device__ __forceinline__ size_t smem_ints(int S, int P, int W,
                                                     int C, int K) {
  const size_t fa = A_PROP + P + W;
  return MXS_HEADER_INTS + 2 * fa * S + C_NUM * (size_t)C + 2 * (size_t)S +
         MXT_OP_FIELDS * (size_t)K + 4 * MXT_STRETCH;
}

template <int THREADS>
__global__ void __launch_bounds__(THREADS, 1024 / THREADS)
matrix_tick_smem_kernel(SmemTickArgs a) {
  constexpr int WARPS = THREADS / 32;
  extern __shared__ int4 mxt_dyn[];
  int* base = reinterpret_cast<int*>(mxt_dyn);
  Header* h = reinterpret_cast<Header*>(base);
  const int doc = blockIdx.x;
  const int S = a.S, C = a.C, K = a.K;
  const int fa = A_PROP + a.P + a.W;
  const int lane = sm::lane_id(), warp = sm::warp_id();
  Axis axis[2];
  int* cur = base + MXS_HEADER_INTS;
  for (int ax = 0; ax < 2; ++ax) {
    axis[ax] = {cur, S, a.P, a.W, &h->axis_count[ax]};
    cur += (size_t)fa * S;
  }
  int* cell[C_NUM];
  for (int q = 0; q < C_NUM; ++q, cur += C) cell[q] = cur;
  int* tvis = cur;
  int* tcum = cur + S;
  cur += 2 * S;
  int* op[MXT_OP_FIELDS];
  for (int q = 0; q < MXT_OP_FIELDS; ++q, cur += K) op[q] = cur;
  int* res = cur;  // [4][n] a stretch's handles, matches and writes

  if (threadIdx.x == 0) {
    h->hw = 0;
    h->last = 0;
  }
  __syncthreads();
  stage(a, doc, axis, cell, op, h);
  __syncthreads();
  const int last = h->last;
  // Warp 0 alone writes cells: it keeps the log's count and high-water
  // mark in registers, the same in every lane (and the mark in h->hw for
  // the other warps' searches).
  int n_cells = h->cell_count, hw = h->hw;
  int par = 0;
  auto is_vec = [&](int k) {
    const int t = op[O_TARGET][k];
    return op[O_VALID][k] && (t == MX_ROWS || t == MX_COLS);
  };
  int k = 0;
  while (k < last) {
    if (is_vec(k)) {
      walk<THREADS>(axis[op[O_TARGET][k]],
           mx::vec_op(op[O_KIND][k], op[O_POS][k], op[O_END][k],
                      op[O_COUNT][k], op[O_HANDLE_BASE][k], op[O_SEQ][k],
                      op[O_REF_SEQ][k], op[O_CLIENT][k]),
           h, par, tvis, tcum);
      ++k;
      continue;
    }
    // A stretch [k, e) with no valid vector op: its cell ops resolve on
    // the same axes, each in its own frame, then write in order.
    int e = k + 1;
    while (e < last && e - k < MXT_STRETCH && !is_vec(e)) ++e;
    const int n = e - k;
    const int top = h->hw;
    for (int j = warp; j < n; j += WARPS) {
      const int o = k + j;
      int rh = -1, ch = -1, pre = -2;  // -2: the op writes nothing
      if (op[O_VALID][o] && op[O_TARGET][o] == MX_CELL) {
        const int ref = op[O_REF_SEQ][o], client = op[O_CLIENT][o];
        rh = warp_handle_at(axis[0], op[O_ROW][o], ref, client);
        if (rh >= 0) ch = warp_handle_at(axis[1], op[O_COL][o], ref, client);
        if (rh >= 0 && ch >= 0) pre = last_match(cell, top, rh, ch);
      }
      if (lane == 0) {
        res[j] = rh;
        res[n + j] = ch;
        res[2 * n + j] = pre;
      }
    }
    __syncthreads();
    if (warp == 0) {
      write_run(cell, res, op[O_VALUE] + k, op[O_SEQ] + k, n, C, n_cells, hw);
      if (lane == 0) h->hw = hw;
    }
    __syncthreads();
    k = e;
  }
  __syncthreads();
  store_doc(a, doc, axis, cell, h, n_cells);
}

// The order in which matrix_tick_smem_launch reads its pointer array: the
// MatrixState planes (rows_, cols_ MergeState fields, then the cell
// planes), the MatrixOpBatch fields (op_), the output MatrixState (o_).
// The binding checks it before the first launch.
extern "C" const char* matrix_tick_smem_layout() {
  return "rows_valid,rows_length,rows_ins_seq,rows_ins_client,rows_rem_seq,"
         "rows_rem_client,rows_rem_overlap,rows_pool_start,rows_prop_val,"
         "rows_count,"
         "cols_valid,cols_length,cols_ins_seq,cols_ins_client,cols_rem_seq,"
         "cols_rem_client,cols_rem_overlap,cols_pool_start,cols_prop_val,"
         "cols_count,"
         "cell_rh,cell_ch,cell_val,cell_seq,cell_used,cell_count,"
         "op_valid,op_target,op_kind,op_pos,op_end,op_count,op_handle_base,"
         "op_row,op_col,op_value,op_seq,op_ref_seq,op_client,"
         "o_rows_valid,o_rows_length,o_rows_ins_seq,o_rows_ins_client,"
         "o_rows_rem_seq,o_rows_rem_client,o_rows_rem_overlap,"
         "o_rows_pool_start,o_rows_prop_val,o_rows_count,"
         "o_cols_valid,o_cols_length,o_cols_ins_seq,o_cols_ins_client,"
         "o_cols_rem_seq,o_cols_rem_client,o_cols_rem_overlap,"
         "o_cols_pool_start,o_cols_prop_val,o_cols_count,"
         "o_cell_rh,o_cell_ch,o_cell_val,o_cell_seq,o_cell_used,"
         "o_cell_count";
}

extern "C" int matrix_tick_smem_launch(void** p, int B, int S, int P, int W,
                                       int C, int K, int smem_bytes,
                                       void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  // The binding computes the same bytes from the shape and passes them.
  if ((size_t)smem_bytes != 4 * smem_ints(S, P, W, C, K))
    return (int)cudaErrorInvalidValue;
  SmemTickArgs a;
  a.B = B;
  a.S = S;
  a.P = P;
  a.W = W;
  a.C = C;
  a.K = K;
  a.rows_valid = (const uint8_t*)p[0];
  a.rows_length = (const int32_t*)p[1];
  a.rows_ins_seq = (const int32_t*)p[2];
  a.rows_ins_client = (const int32_t*)p[3];
  a.rows_rem_seq = (const int32_t*)p[4];
  a.rows_rem_client = (const int32_t*)p[5];
  a.rows_rem_overlap = (const int32_t*)p[6];
  a.rows_pool_start = (const int32_t*)p[7];
  a.rows_prop_val = (const int32_t*)p[8];
  a.rows_count = (const int32_t*)p[9];
  a.cols_valid = (const uint8_t*)p[10];
  a.cols_length = (const int32_t*)p[11];
  a.cols_ins_seq = (const int32_t*)p[12];
  a.cols_ins_client = (const int32_t*)p[13];
  a.cols_rem_seq = (const int32_t*)p[14];
  a.cols_rem_client = (const int32_t*)p[15];
  a.cols_rem_overlap = (const int32_t*)p[16];
  a.cols_pool_start = (const int32_t*)p[17];
  a.cols_prop_val = (const int32_t*)p[18];
  a.cols_count = (const int32_t*)p[19];
  a.cell_rh = (const int32_t*)p[20];
  a.cell_ch = (const int32_t*)p[21];
  a.cell_val = (const int32_t*)p[22];
  a.cell_seq = (const int32_t*)p[23];
  a.cell_used = (const uint8_t*)p[24];
  a.cell_count = (const int32_t*)p[25];
  a.op_valid = (const uint8_t*)p[26];
  a.op_target = (const int32_t*)p[27];
  a.op_kind = (const int32_t*)p[28];
  a.op_pos = (const int32_t*)p[29];
  a.op_end = (const int32_t*)p[30];
  a.op_count = (const int32_t*)p[31];
  a.op_handle_base = (const int32_t*)p[32];
  a.op_row = (const int32_t*)p[33];
  a.op_col = (const int32_t*)p[34];
  a.op_value = (const int32_t*)p[35];
  a.op_seq = (const int32_t*)p[36];
  a.op_ref_seq = (const int32_t*)p[37];
  a.op_client = (const int32_t*)p[38];
  a.o_rows_valid = (uint8_t*)p[39];
  a.o_rows_length = (int32_t*)p[40];
  a.o_rows_ins_seq = (int32_t*)p[41];
  a.o_rows_ins_client = (int32_t*)p[42];
  a.o_rows_rem_seq = (int32_t*)p[43];
  a.o_rows_rem_client = (int32_t*)p[44];
  a.o_rows_rem_overlap = (int32_t*)p[45];
  a.o_rows_pool_start = (int32_t*)p[46];
  a.o_rows_prop_val = (int32_t*)p[47];
  a.o_rows_count = (int32_t*)p[48];
  a.o_cols_valid = (uint8_t*)p[49];
  a.o_cols_length = (int32_t*)p[50];
  a.o_cols_ins_seq = (int32_t*)p[51];
  a.o_cols_ins_client = (int32_t*)p[52];
  a.o_cols_rem_seq = (int32_t*)p[53];
  a.o_cols_rem_client = (int32_t*)p[54];
  a.o_cols_rem_overlap = (int32_t*)p[55];
  a.o_cols_pool_start = (int32_t*)p[56];
  a.o_cols_prop_val = (int32_t*)p[57];
  a.o_cols_count = (int32_t*)p[58];
  a.o_cell_rh = (int32_t*)p[59];
  a.o_cell_ch = (int32_t*)p[60];
  a.o_cell_val = (int32_t*)p[61];
  a.o_cell_seq = (int32_t*)p[62];
  a.o_cell_used = (uint8_t*)p[63];
  a.o_cell_count = (int32_t*)p[64];
  const bool narrow = S <= MXT_NARROW_S;
  void (*kernel)(SmemTickArgs) = narrow ? matrix_tick_smem_kernel<128>
                                        : matrix_tick_smem_kernel<256>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B, narrow ? 128 : 256, smem_bytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
