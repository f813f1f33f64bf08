// SharedMatrix step tick — one thread block per document walks its T steps.
//
// Replaces the TPU kernel fluidframework_tpu/ops/matrix_pallas.py:
// _step_kernel (pallas_call at matrix_pallas.py:529, per-cell lookup
// _handle_lookup_vec at :351, axis walk _axis_walk at :68, wrapper
// apply_tick_steps_pallas). Same function as the plain
// ops/matrix_kernel.py:apply_tick_steps: per step t of a document, in
// order,
//   * where vec_valid and the target is MX_ROWS / MX_COLS, ONE flat merge
//     step (merge_apply.cuh) on that axis, as the op tick's walk;
//   * where any r_valid of the step is set, ONE visibility frame per axis
//     (vis and its exclusive prefix) on the POST-walk tables at
//     (run_ref, run_client), then the run's R cells in order: each valid
//     one looks its (row, col) up in the two frames and, when both
//     resolve, makes the LWW last-match-or-append write
//     (matrix_apply.cuh).
// Steps past the document's last vector op and last run are skipped.
//
// Design: out of place, as the op tick — the block copies its document's
// two axes and cell row to the outputs, then applies the steps in place
// on the outputs. The frames live in a per-document scratch from the
// wrapper ([B, 2, 2, S] int32: axis, vis|cum, slot), since S grows with
// the document; a frame is written and read by the same thread per slot.
//
// Bound on H100: bytes, for a tick that reads each plane once and writes
// it once — 2 axes x B x S x (1 + 4 (6 + P + W)) x 2, cells
// B x C x (4 x 4 + 1) x 2, steps B x T x 12 x 4 + B x T x R x 5 x 4. This
// version re-reads an axis per walk (two prefix scans and the shift),
// per frame (one scan) and per cell (a pass over the frame and one over
// C), so it runs well above that bound.
//
// Plain C interface for ctypes; the launcher returns cudaGetLastError().

#include "matrix_apply.cuh"

#define MX_STEPS_THREADS 256

struct MatrixStepsArgs {
  int B, S, P, W, C, T, R;
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
  const uint8_t* step_vec_valid;
  const int32_t* step_kind;
  const int32_t* step_target;
  const int32_t* step_pos;
  const int32_t* step_end;
  const int32_t* step_count;
  const int32_t* step_handle_base;
  const int32_t* step_seq;
  const int32_t* step_ref_seq;
  const int32_t* step_client;
  const int32_t* step_run_ref;
  const int32_t* step_run_client;
  const uint8_t* step_r_valid;
  const int32_t* step_r_row;
  const int32_t* step_r_col;
  const int32_t* step_r_value;
  const int32_t* step_r_seq;
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
  int32_t* frame;
};

__global__ void __launch_bounds__(MX_STEPS_THREADS)
matrix_steps_kernel(MatrixStepsArgs a) {
  extern __shared__ int saved[];
  __shared__ mt::Shared sh;
  __shared__ int axis_count[2];
  __shared__ int cell_count;
  __shared__ int last;
  const int doc = blockIdx.x;
  const int T = a.T, R = a.R;
  mt::FlatDoc axis[2];
  mx::CellDoc cells;
  if (threadIdx.x == 0) last = 0;
  mx::load_doc(a, doc, axis, cells, axis_count, &cell_count);
  // Trip count: one past the later of the document's last vector op and
  // its last step with a valid cell.
  const size_t steps = (size_t)doc * T;
  for (int t = threadIdx.x; t < T; t += blockDim.x)
    if (a.step_vec_valid[steps + t]) atomicMax(&last, t + 1);
  for (int q = threadIdx.x; q < T * R; q += blockDim.x)
    if (a.step_r_valid[steps * R + q]) atomicMax(&last, q / R + 1);
  __syncthreads();
  int* vis[2];
  int* cum[2];
  for (int ax = 0; ax < 2; ++ax) {
    vis[ax] = a.frame + ((size_t)doc * 4 + 2 * ax) * a.S;
    cum[ax] = vis[ax] + a.S;
  }
  for (int t = 0; t < last; ++t) {
    const size_t st = steps + t;
    const int target = a.step_target[st];
    if (a.step_vec_valid[st] && (target == MX_ROWS || target == MX_COLS)) {
      mx::axis_walk(
          axis[target],
          mx::vec_op(a.step_kind[st], a.step_pos[st], a.step_end[st],
                     a.step_count[st], a.step_handle_base[st], a.step_seq[st],
                     a.step_ref_seq[st], a.step_client[st]),
          &axis_count[target], sh, saved);
    }
    const size_t run = st * R;
    bool any = false;
    for (int j = 0; j < R; ++j) any = any || a.step_r_valid[run + j];
    if (!any) continue;
    for (int ax = 0; ax < 2; ++ax)
      mx::build_frame(axis[ax], a.step_run_ref[st], a.step_run_client[st],
                      vis[ax], cum[ax], sh);
    for (int j = 0; j < R; ++j) {
      if (!a.step_r_valid[run + j]) continue;
      const int rh =
          mx::frame_lookup(axis[0], vis[0], cum[0], a.step_r_row[run + j], sh);
      const int ch =
          mx::frame_lookup(axis[1], vis[1], cum[1], a.step_r_col[run + j], sh);
      if (rh >= 0 && ch >= 0)
        mx::cell_write(cells, rh, ch, a.step_r_value[run + j],
                       a.step_r_seq[run + j], &cell_count, sh);
    }
  }
  mx::store_counts(a, doc, axis_count, &cell_count);
}

// The order in which matrix_steps_launch reads its pointer array: the
// MatrixState planes (rows_, cols_ MergeState fields, then the cell
// planes), the MatrixStepBatch fields (step_), the output MatrixState
// (o_), the frame scratch. The binding checks it before the first launch.
extern "C" const char* matrix_steps_layout() {
  return "rows_valid,rows_length,rows_ins_seq,rows_ins_client,rows_rem_seq,"
         "rows_rem_client,rows_rem_overlap,rows_pool_start,rows_prop_val,"
         "rows_count,"
         "cols_valid,cols_length,cols_ins_seq,cols_ins_client,cols_rem_seq,"
         "cols_rem_client,cols_rem_overlap,cols_pool_start,cols_prop_val,"
         "cols_count,"
         "cell_rh,cell_ch,cell_val,cell_seq,cell_used,cell_count,"
         "step_vec_valid,step_kind,step_target,step_pos,step_end,step_count,"
         "step_handle_base,step_seq,step_ref_seq,step_client,step_run_ref,"
         "step_run_client,step_r_valid,step_r_row,step_r_col,step_r_value,"
         "step_r_seq,"
         "o_rows_valid,o_rows_length,o_rows_ins_seq,o_rows_ins_client,"
         "o_rows_rem_seq,o_rows_rem_client,o_rows_rem_overlap,"
         "o_rows_pool_start,o_rows_prop_val,o_rows_count,"
         "o_cols_valid,o_cols_length,o_cols_ins_seq,o_cols_ins_client,"
         "o_cols_rem_seq,o_cols_rem_client,o_cols_rem_overlap,"
         "o_cols_pool_start,o_cols_prop_val,o_cols_count,"
         "o_cell_rh,o_cell_ch,o_cell_val,o_cell_seq,o_cell_used,"
         "o_cell_count,frame";
}

extern "C" int matrix_steps_launch(void** p, int B, int S, int P, int W,
                                   int C, int T, int R, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  MatrixStepsArgs a;
  a.B = B;
  a.S = S;
  a.P = P;
  a.W = W;
  a.C = C;
  a.T = T;
  a.R = R;
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
  a.step_vec_valid = (const uint8_t*)p[26];
  a.step_kind = (const int32_t*)p[27];
  a.step_target = (const int32_t*)p[28];
  a.step_pos = (const int32_t*)p[29];
  a.step_end = (const int32_t*)p[30];
  a.step_count = (const int32_t*)p[31];
  a.step_handle_base = (const int32_t*)p[32];
  a.step_seq = (const int32_t*)p[33];
  a.step_ref_seq = (const int32_t*)p[34];
  a.step_client = (const int32_t*)p[35];
  a.step_run_ref = (const int32_t*)p[36];
  a.step_run_client = (const int32_t*)p[37];
  a.step_r_valid = (const uint8_t*)p[38];
  a.step_r_row = (const int32_t*)p[39];
  a.step_r_col = (const int32_t*)p[40];
  a.step_r_value = (const int32_t*)p[41];
  a.step_r_seq = (const int32_t*)p[42];
  a.o_rows_valid = (uint8_t*)p[43];
  a.o_rows_length = (int32_t*)p[44];
  a.o_rows_ins_seq = (int32_t*)p[45];
  a.o_rows_ins_client = (int32_t*)p[46];
  a.o_rows_rem_seq = (int32_t*)p[47];
  a.o_rows_rem_client = (int32_t*)p[48];
  a.o_rows_rem_overlap = (int32_t*)p[49];
  a.o_rows_pool_start = (int32_t*)p[50];
  a.o_rows_prop_val = (int32_t*)p[51];
  a.o_rows_count = (int32_t*)p[52];
  a.o_cols_valid = (uint8_t*)p[53];
  a.o_cols_length = (int32_t*)p[54];
  a.o_cols_ins_seq = (int32_t*)p[55];
  a.o_cols_ins_client = (int32_t*)p[56];
  a.o_cols_rem_seq = (int32_t*)p[57];
  a.o_cols_rem_client = (int32_t*)p[58];
  a.o_cols_rem_overlap = (int32_t*)p[59];
  a.o_cols_pool_start = (int32_t*)p[60];
  a.o_cols_prop_val = (int32_t*)p[61];
  a.o_cols_count = (int32_t*)p[62];
  a.o_cell_rh = (int32_t*)p[63];
  a.o_cell_ch = (int32_t*)p[64];
  a.o_cell_val = (int32_t*)p[65];
  a.o_cell_seq = (int32_t*)p[66];
  a.o_cell_used = (uint8_t*)p[67];
  a.o_cell_count = (int32_t*)p[68];
  a.frame = (int32_t*)p[69];
  const size_t smem = 2 * (mt::NUM_PLANES + 1 + P + W) * sizeof(int);
  matrix_steps_kernel<<<B, MX_STEPS_THREADS, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
