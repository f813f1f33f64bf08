// SharedMatrix op tick — one thread block per document walks its K ops.
//
// Replaces the TPU kernel fluidframework_tpu/ops/matrix_pallas.py:
// _tick_kernel (pallas_call at matrix_pallas.py:323, per-op body
// _matrix_apply_vec at :95, axis walk _axis_walk at :68, wrapper
// apply_tick_pallas). Same function as the plain
// ops/matrix_kernel.py:apply_tick: per valid op of a document, in order,
//   * a row or col op (target MX_ROWS / MX_COLS) runs ONE flat merge step
//     (merge_apply.cuh) on that axis: P prop planes, pool_start = the
//     op's first handle, text_len = its count, prop key/value 0;
//   * a cell op (MX_CELL) resolves (row, col) to handles in the
//     (ref_seq, client) frame of each axis — on the pre-op tables, which
//     a cell op does not move — and, when both resolve, makes the LWW
//     last-match-or-append write (matrix_apply.cuh);
//   * any other target changes nothing. A cell op's kind/pos/count (0 by
//     default) never reach a walk.
// Invalid ops are no-ops; ops past the document's last valid one are
// skipped.
//
// Design: out of place, as the merge ticks — the block first copies its
// document's two axes (valid, six int32 planes, [S, P] prop, [S, W]
// overlap, count) and its cell row to the outputs, then applies the ops
// in place on the outputs. Planes stay in global memory (S and C grow
// with the document); the layouts are the JAX package's, no transposes.
//
// Bound on H100: bytes, for a tick that reads each plane once and writes
// it once — 2 axes x B x S x (1 + 4 (6 + P + W)) x 2, cells
// B x C x (4 x 4 + 1) x 2, ops B x K x 13 x 4. This version re-reads a
// row from L1/L2 per op (two prefix scans and the shift for a walk, two
// scans and a pass over C for a cell), so it runs well above that bound.
//
// Plain C interface for ctypes; the launcher returns cudaGetLastError().

#include "matrix_apply.cuh"

#define MX_TICK_THREADS 256

struct MatrixTickArgs {
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

__global__ void __launch_bounds__(MX_TICK_THREADS)
matrix_tick_kernel(MatrixTickArgs a) {
  extern __shared__ int saved[];
  __shared__ mt::Shared sh;
  __shared__ int axis_count[2];
  __shared__ int cell_count;
  __shared__ int last;
  const int doc = blockIdx.x;
  mt::FlatDoc axis[2];
  mx::CellDoc cells;
  if (threadIdx.x == 0) last = 0;
  mx::load_doc(a, doc, axis, cells, axis_count, &cell_count);
  // Trip count: one past the document's last valid op.
  const size_t ops = (size_t)doc * a.K;
  for (int k = threadIdx.x; k < a.K; k += blockDim.x)
    if (a.op_valid[ops + k]) atomicMax(&last, k + 1);
  __syncthreads();
  for (int k = 0; k < last; ++k) {
    const size_t o = ops + k;
    if (!a.op_valid[o]) continue;
    const int target = a.op_target[o];
    if (target == MX_ROWS || target == MX_COLS) {
      mx::axis_walk(axis[target],
                    mx::vec_op(a.op_kind[o], a.op_pos[o], a.op_end[o],
                               a.op_count[o], a.op_handle_base[o],
                               a.op_seq[o], a.op_ref_seq[o], a.op_client[o]),
                    &axis_count[target], sh, saved);
    } else if (target == MX_CELL) {
      const int ref = a.op_ref_seq[o], client = a.op_client[o];
      const int rh = mx::handle_at(axis[0], a.op_row[o], ref, client, sh);
      const int ch = mx::handle_at(axis[1], a.op_col[o], ref, client, sh);
      if (rh >= 0 && ch >= 0)
        mx::cell_write(cells, rh, ch, a.op_value[o], a.op_seq[o],
                       &cell_count, sh);
    }
  }
  mx::store_counts(a, doc, axis_count, &cell_count);
}

// The order in which matrix_tick_launch reads its pointer array: the
// MatrixState planes (rows_, cols_ MergeState fields, then the cell
// planes), the MatrixOpBatch fields (op_), the output MatrixState (o_).
// The binding checks it before the first launch.
extern "C" const char* matrix_tick_layout() {
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

extern "C" int matrix_tick_launch(void** p, int B, int S, int P, int W,
                                  int C, int K, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  MatrixTickArgs a;
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
  const size_t smem = 2 * (mt::NUM_PLANES + 1 + P + W) * sizeof(int);
  matrix_tick_kernel<<<B, MX_TICK_THREADS, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
