// SharedMatrix step tick, shared-memory variant — one thread block per
// document walks its T steps with both axes and the cell log held in
// shared memory.
//
// Replaces the TPU kernel fluidframework_tpu/ops/matrix_pallas.py:362
// _step_kernel (pallas_call at matrix_pallas.py:529, per-cell lookup
// _handle_lookup_vec at :351), as matrix_steps.cu does; the same function
// as the plain ops/matrix_kernel.py:apply_tick_steps, bit for bit: per
// step the masked axis walk (one flat merge step on the targeted axis),
// then, where the step has a valid cell, one visibility frame per axis at
// (run_ref, run_client) on the post-walk tables and the run's cell writes
// in order, each a lookup of (row, col) in those frames and an LWW
// last-match-or-append write.
//
// Bound on H100: not the bytes (both axes and the cell log read once and
// written once, about 0.26 ms for 16,384 docs at S = C = 256) but the
// latency of one document's step chain. matrix_steps.cu keeps everything
// in global memory and pays, per cell write, two passes over S and one
// over C, each ending in a block reduction, and per walk three block
// scans and a barrier per field per tile of the shift.
//
// Design: both axes (field-major: six slot planes, valid, P props, W
// overlap words), the cell log and the two frames are staged in dynamic
// shared memory and written back once; a step's planes are prefetched
// into registers while the step before runs. The walk is the flat merge
// step of merge_apply.cuh rewritten for shared memory (flat_smem.cuh):
// each thread owns a contiguous run of slots, so a scan is a warp scan
// and one barrier, and the shift moves each thread's own slots through
// registers, only those the op changes. The two
// axes' frames are built at once, half the warps each, with two barriers.
// A run's cells are independent until they write (the frame is fixed for
// the run), so each warp takes whole cells: the row and col handles — a
// binary search over the frame's prefix when it is exact and
// non-decreasing (every visible length >= 0 and no partial sum wraps,
// which one barrier-wide OR decides), else a linear pass of 32 slots a
// ballot — and the last log entry holding the key as the run found it (a
// ballot scan down from the highest used entry). One warp then makes the
// ordered writes with no block barrier: a key's last match is that entry
// or one the run's earlier writes left, unless an earlier append landed
// on that entry (a clamped one at C - 1 does) and replaced its key, and
// then it scans the log again; a miss
// appends at min(count, C - 1) and the count grows past C, as in the
// plain version. Registers are capped at four blocks an SM
// (MXS_MIN_BLOCKS). The launcher is picked by shape (ops/matrix_cuda.py):
// documents that do not fit the card's per-block shared memory run
// matrix_steps.cu.
//
// Plain C interface for ctypes; the launcher returns cudaGetLastError().

#include "matrix_smem.cuh"

#define MXS_VEC_FIELDS 12
#define MXS_RUN_FIELDS 5
// The most run cells a step may hold: one thread prefetches each step
// plane.
#define MXS_MAX_RUN ((MXS_THREADS - MXS_VEC_FIELDS) / MXS_RUN_FIELDS)

// A step's planes in its buffer: the vector op, then R of each run plane.
enum { V_VALID = 0, V_KIND, V_TARGET, V_POS, V_END, V_COUNT, V_HANDLE_BASE,
       V_SEQ, V_REF_SEQ, V_CLIENT, V_RUN_REF, V_RUN_CLIENT };
enum { R_VALID = 0, R_ROW, R_COL, R_VALUE, R_SEQ };

struct SmemStepsArgs {
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
};

// The (ref, client) frames of both axes at once, half the warps each:
// vis[ax][i] and its exclusive prefix cum[ax][i]. Returns, to every
// thread, whether either prefix may not be exact and non-decreasing (a
// negative visible length, or a partial sum that wraps).
__device__ bool build_frames(const Axis* axis, int ref, int client,
                             int* const* vis, int* const* cum, Header* h,
                             int& par) {
  const int half = MXS_THREADS / 2;
  const int ax = threadIdx.x / half, th = threadIdx.x - ax * half;
  const int wh = sm::warp_id() - ax * MXS_HALF_WARPS;
  const Axis& x = axis[ax];
  const int m = (x.S + half - 1) / half;
  const int lo = th * m, hi = min(x.S, lo + m);
  int local = 0;
  for (int i = lo; i < hi; ++i) {
    const int v = axis_vis(x, i, ref, client);
    vis[ax][i] = v;
    local = mt::wadd(local, v);
  }
  const int incl = sm::warp_incl_scan(local);
  if (sm::lane_id() == 31) h->part[par][ax * 16 + wh] = incl;
  __syncthreads();
  int c = mt::wsub(incl, local);
  for (int w = 0; w < wh; ++w) c = mt::wadd(c, h->part[par][ax * 16 + w]);
  par ^= 1;
  int flag = 0;
  for (int i = lo; i < hi; ++i) {
    const int v = vis[ax][i], end = mt::wadd(c, v);
    cum[ax][i] = c;
    if (v < 0 || c < 0 || end < c) flag = 1;
    c = end;
  }
  return __syncthreads_or(flag) != 0;
}

// The handle at visible position pos of axis x in its frame, or -1: the
// first slot with cum <= pos < cum + vis. Every lane of the warp calls
// it and gets the result.
__device__ int lookup(const Axis& x, const int* vis, const int* cum, int pos,
                      bool linear) {
  const int S = x.S;
  int idx = -1;
  if (!linear) {
    // cum is exact and non-decreasing: the slot before the first one
    // whose cum passes pos is the only candidate.
    int lo = 0, hi = S;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (cum[mid] > pos) hi = mid;
      else lo = mid + 1;
    }
    const int i = lo - 1;
    if (i >= 0 && pos < cum[i] + vis[i]) idx = i;
  } else {
    for (int base = 0; base < S; base += 32) {
      const int i = base + sm::lane_id();
      const bool hit = i < S && cum[i] <= pos && pos < mt::wadd(cum[i], vis[i]);
      const unsigned bal = __ballot_sync(SM_FULL, hit);
      if (bal) {
        idx = base + __ffs(bal) - 1;
        break;
      }
    }
  }
  return idx < 0 ? -1
                 : mt::wsub(mt::wadd(x.f(mt::POOL_START)[idx], pos), cum[idx]);
}

// Step plane q of a step: q < 12 the vector op's, else run plane
// (q - 12) / R of cell (q - 12) % R. Its base, element size and cell (-1
// for the vector op's), so that a step's prefetch is one load a thread
// with no branch on the plane.
struct StepPlane {
  const char* base;
  int size, cell;
};

__device__ StepPlane step_plane(const SmemStepsArgs& a, int q) {
  const void* vec[MXS_VEC_FIELDS] = {
      a.step_vec_valid, a.step_kind, a.step_target, a.step_pos,
      a.step_end, a.step_count, a.step_handle_base, a.step_seq,
      a.step_ref_seq, a.step_client, a.step_run_ref, a.step_run_client};
  const void* run[MXS_RUN_FIELDS] = {a.step_r_valid, a.step_r_row,
                                     a.step_r_col, a.step_r_value,
                                     a.step_r_seq};
  if (q < MXS_VEC_FIELDS)
    return {(const char*)vec[q], q == V_VALID ? 1 : 4, -1};
  q -= MXS_VEC_FIELDS;
  return {(const char*)run[q / a.R], q / a.R == R_VALID ? 1 : 4, q % a.R};
}

// Plane ``p``'s value at step ``st`` (a flat [B, T] index).
__device__ __forceinline__ int fetch(const StepPlane& p, size_t st, int R) {
  const size_t i = p.cell < 0 ? st : st * R + p.cell;
  return p.size == 1 ? (int)((const uint8_t*)p.base)[i]
                     : ((const int32_t*)p.base)[i];
}

__host__ __device__ __forceinline__ size_t smem_ints(int S, int P, int W,
                                                     int C, int R) {
  const size_t fa = A_PROP + P + W;
  return MXS_HEADER_INTS + 2 * fa * S + C_NUM * (size_t)C + 4 * (size_t)S +
         2 * (size_t)(MXS_VEC_FIELDS + MXS_RUN_FIELDS * R) + 4 * (size_t)R;
}

__global__ void __launch_bounds__(MXS_THREADS, MXS_MIN_BLOCKS)
matrix_steps_smem_kernel(SmemStepsArgs a) {
  extern __shared__ int4 mxs_dyn[];
  int* base = reinterpret_cast<int*>(mxs_dyn);
  Header* h = reinterpret_cast<Header*>(base);
  const int doc = blockIdx.x;
  const int S = a.S, C = a.C, R = a.R, T = a.T;
  const int fa = A_PROP + a.P + a.W;
  const int nq = MXS_VEC_FIELDS + MXS_RUN_FIELDS * R;
  Axis axis[2];
  int* cur = base + MXS_HEADER_INTS;
  for (int ax = 0; ax < 2; ++ax) {
    axis[ax] = {cur, S, a.P, a.W, &h->axis_count[ax]};
    cur += (size_t)fa * S;
  }
  int* cell[C_NUM];
  for (int q = 0; q < C_NUM; ++q, cur += C) cell[q] = cur;
  int* vis[2];
  int* cum[2];
  for (int ax = 0; ax < 2; ++ax) {
    vis[ax] = cur;
    cum[ax] = cur + S;
    cur += 2 * S;
  }
  int* buf[2] = {cur, cur + nq};
  int* res = cur + 2 * nq;  // [4][R] the run's handles, matches, writes

  stage_doc(a, doc, axis, cell, h);
  __syncthreads();
  // Trip count: one past the later of the last vector op and the last
  // step with a valid cell; the log's high-water mark.
  const size_t steps = (size_t)doc * T;
  for (int t = threadIdx.x; t < T; t += blockDim.x)
    if (a.step_vec_valid[steps + t]) atomicMax(&h->last, t + 1);
  for (int q = threadIdx.x; q < T * R; q += blockDim.x)
    if (a.step_r_valid[steps * R + q]) atomicMax(&h->last, q / R + 1);
  for (int i = threadIdx.x; i < C; i += blockDim.x)
    if (cell[C_USED][i]) atomicMax(&h->hw, i + 1);
  StepPlane plane = {nullptr, 4, -1};
  if (threadIdx.x < nq) plane = step_plane(a, threadIdx.x);
  if (threadIdx.x < nq && T > 0) buf[0][threadIdx.x] = fetch(plane, steps, R);
  __syncthreads();
  const int last = h->last;
  // Warp 0 alone writes cells: it keeps the log's count and high-water
  // mark in registers, the same in every lane (and the mark in h->hw for
  // the other warps' searches).
  int n_cells = h->cell_count, hw = h->hw;
  int par = 0;
  for (int t = 0; t < last; ++t) {
    const int* s = buf[t & 1];
    int next = 0;
    if (threadIdx.x < nq && t + 1 < last)
      next = fetch(plane, steps + t + 1, R);
    const int target = s[V_TARGET];
    if (s[V_VALID] && (target == MX_ROWS || target == MX_COLS))
      walk<MXS_THREADS>(
          axis[target],
          mx::vec_op(s[V_KIND], s[V_POS], s[V_END], s[V_COUNT],
                     s[V_HANDLE_BASE], s[V_SEQ], s[V_REF_SEQ], s[V_CLIENT]),
          h, par, vis[0], cum[0]);
    const int* rv = s + MXS_VEC_FIELDS;
    bool any = false;
    for (int j = 0; j < R; ++j) any = any || rv[R_VALID * R + j];
    if (any) {
      const bool linear = build_frames(axis, s[V_RUN_REF], s[V_RUN_CLIENT],
                                       vis, cum, h, par);
      // Each warp takes whole cells: the row and col handles, then the
      // LAST entry of the log as the run found it holding that key.
      const int top = h->hw;
      for (int j = sm::warp_id(); j < R; j += MXS_WARPS) {
        int rh = -1, ch = -1, pre = -2;  // -2: the cell writes nothing
        if (rv[R_VALID * R + j]) {
          rh = lookup(axis[0], vis[0], cum[0], rv[R_ROW * R + j], linear);
          ch = lookup(axis[1], vis[1], cum[1], rv[R_COL * R + j], linear);
          if (rh >= 0 && ch >= 0) pre = last_match(cell, top, rh, ch);
        }
        if (sm::lane_id() == 0) {
          res[j] = rh;
          res[R + j] = ch;
          res[2 * R + j] = pre;
        }
      }
      __syncthreads();
      if (sm::warp_id() == 0) {
        write_run(cell, res, rv + R_VALUE * R, rv + R_SEQ * R, R, C,
                  n_cells, hw);
        if (sm::lane_id() == 0) h->hw = hw;
      }
    }
    if (threadIdx.x < nq) buf[(t + 1) & 1][threadIdx.x] = next;
    __syncthreads();
  }

  store_doc(a, doc, axis, cell, h, n_cells);
}

// The order in which matrix_steps_smem_launch reads its pointer array: the
// MatrixState planes (rows_, cols_ MergeState fields, then the cell
// planes), the MatrixStepBatch fields (step_) and the output MatrixState
// (o_). The binding checks it before the first launch.
extern "C" const char* matrix_steps_smem_layout() {
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
         "o_cell_count";
}

// The current device's per-block shared-memory limit with opt-in, or -1.
extern "C" int matrix_steps_smem_optin() {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  return v;
}

extern "C" int matrix_steps_smem_launch(void** p, int B, int S, int P, int W,
                                        int C, int T, int R, int smem_bytes,
                                        void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  // The binding computes the same bytes from the shape and passes them.
  if ((size_t)smem_bytes != 4 * smem_ints(S, P, W, C, R) || R > MXS_MAX_RUN)
    return (int)cudaErrorInvalidValue;
  SmemStepsArgs a;
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
  const cudaError_t err = cudaFuncSetAttribute(
      matrix_steps_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return (int)err;
  matrix_steps_smem_kernel<<<B, MXS_THREADS, smem_bytes,
                             (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
