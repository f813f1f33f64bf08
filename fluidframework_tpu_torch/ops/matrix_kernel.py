"""Batched SharedMatrix apply — composed from the merge-tree table.

Port of ``fluidframework_tpu/ops/matrix_kernel.py``. Reference parity:
packages/dds/matrix/src/matrix.ts:547 (``processCore``) and
permutationvector.ts:38 — a matrix is two permutation vectors (rows,
cols), each a merge-tree whose segments carry runs of storage handles, plus
an LWW cell table keyed (rowHandle, colHandle):

  * rows / cols = two :class:`~.mergetree_kernel.MergeState` tables. A
    segment's ``pool_start`` holds the FIRST handle of its run (sequenced
    inserts allocate handles in document order — the deterministic
    allocation rule of ``dds/matrix.py``); splits inherit
    ``pool_start + offset`` for free;
  * (row, col) → handle resolution = the masked-prefix-sum position
    lookup of the merge walk, in the (refSeq, client) visibility frame —
    matrix.ts's adjustPosition;
  * cells = a table of (row_handle, col_handle, value, seq) rows with
    last-match-or-append placement; sequenced order makes the LWW fold a
    plain overwrite.

Two plain versions of hand kernels live here: :func:`apply_tick` (the
matrix op tick, ``csrc/matrix_tick.cu``) and :func:`apply_tick_steps` (the
matrix step tick, ``csrc/matrix_steps.cu``), both reached through
:mod:`.matrix_cuda`. Each is a Python loop over a tick's ops (or steps),
every op vectorised over the documents. :func:`apply_cell_run` and
:func:`compact_cell_log` are plain tensor code in the reference too (no
kernel of their own).

All planes are int32 except ``valid``/``cell_used`` (bool).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from . import mergetree_kernel as mtk

I32 = torch.int32

MX_ROWS = 0
MX_COLS = 1
MX_CELL = 2


class MatrixState(NamedTuple):
    """Per-document matrix state. rows/cols axes [B, S]; cells [B, C]."""

    rows: mtk.MergeState
    cols: mtk.MergeState
    cell_rh: torch.Tensor     # i32[B, C] row handle (-1 empty)
    cell_ch: torch.Tensor     # i32[B, C] col handle
    cell_val: torch.Tensor    # i32[B, C] interned value id (0 = cleared)
    cell_seq: torch.Tensor    # i32[B, C] seq of the winning write
    cell_used: torch.Tensor   # bool[B, C]
    cell_count: torch.Tensor  # i32[B]


class MatrixOpBatch(NamedTuple):
    """One tick of sequenced matrix ops, padded to K per doc. Axes [B, K]."""

    valid: torch.Tensor        # bool
    target: torch.Tensor       # i32 MX_*
    kind: torch.Tensor         # i32 MT_INSERT/MT_REMOVE (vector ops)
    pos: torch.Tensor          # i32 vector position / range start
    end: torch.Tensor          # i32 range end (remove)
    count: torch.Tensor        # i32 inserted run length
    handle_base: torch.Tensor  # i32 first handle of an inserted run
    row: torch.Tensor          # i32 (cell)
    col: torch.Tensor          # i32 (cell)
    value: torch.Tensor        # i32 interned value id (cell)
    seq: torch.Tensor          # i32
    ref_seq: torch.Tensor      # i32
    client: torch.Tensor       # i32 client slot


class MatrixStepBatch(NamedTuple):
    """One tick as STEPS: each step is (optional vector op, following CELL
    RUN). Every consecutive cell between two vector ops resolves its
    (row, col) → handle lookup in the SAME visibility frame whenever its
    ref_seq covers the last structural op (the exactness condition
    :func:`group_matrix_steps` checks), so a run pays the two-axis
    visibility scan once.

    Vector-op planes are [B, T] (T = steps); run planes are [B, T, R]
    (R = max cells per run; longer runs split into vector-less steps)."""

    vec_valid: torch.Tensor    # bool[B, T]
    kind: torch.Tensor         # i32[B, T] MT_INSERT/MT_REMOVE
    target: torch.Tensor       # i32[B, T] MX_ROWS/MX_COLS
    pos: torch.Tensor          # i32[B, T]
    end: torch.Tensor          # i32[B, T]
    count: torch.Tensor        # i32[B, T]
    handle_base: torch.Tensor  # i32[B, T]
    seq: torch.Tensor          # i32[B, T]
    ref_seq: torch.Tensor      # i32[B, T]
    client: torch.Tensor       # i32[B, T]
    run_ref: torch.Tensor      # i32[B, T] shared frame ref of the cell run
    run_client: torch.Tensor   # i32[B, T] frame client (exact for 1-cell runs)
    r_valid: torch.Tensor      # bool[B, T, R]
    r_row: torch.Tensor        # i32[B, T, R]
    r_col: torch.Tensor        # i32[B, T, R]
    r_value: torch.Tensor      # i32[B, T, R]
    r_seq: torch.Tensor        # i32[B, T, R]


class CellRunBatch(NamedTuple):
    """One tick that is ALL cell writes, one run per document — the
    BASELINE config-4 storm shape (a settled grid, hundreds of writers, no
    structural op in flight). The run shares one visibility frame per
    document: the host admits this path only when ``last vector seq <=
    min ref of the run``. See :func:`apply_cell_run`."""

    valid: torch.Tensor    # bool[B, R]
    row: torch.Tensor      # i32[B, R]
    col: torch.Tensor      # i32[B, R]
    value: torch.Tensor    # i32[B, R]
    seq: torch.Tensor      # i32[B, R]
    ref_seq: torch.Tensor  # i32[B] shared frame
    client: torch.Tensor   # i32[B]


#: Blank value of each cell plane.
CELL_FILL = dict(cell_rh=-1, cell_ch=-1, cell_val=0, cell_seq=0,
                 cell_used=False)


def init_state(num_docs: int, vec_slots: int = 64, cell_slots: int = 256,
               overlap_words: int = 1,
               device: str | torch.device | None = None) -> MatrixState:
    dev = resolve_device(device)
    b, c = num_docs, cell_slots
    return MatrixState(
        rows=mtk.init_state(b, vec_slots, 1, overlap_words, dev),
        cols=mtk.init_state(b, vec_slots, 1, overlap_words, dev),
        **{f: torch.full((b, c), fill, device=dev,
                         dtype=torch.bool if f == "cell_used" else I32)
           for f, fill in CELL_FILL.items()},
        cell_count=torch.zeros((b,), dtype=I32, device=dev))


def leaves(state) -> list[torch.Tensor]:
    """Every tensor of a (nested) NamedTuple state, in field order."""
    out: list[torch.Tensor] = []
    for t in state:
        out.extend(leaves(t) if isinstance(t, tuple) else [t])
    return out


# -- per-op math (per-doc scalars are [B, 1] columns) -------------------------


def _where_state(mask: torch.Tensor, a: mtk.MergeState,
                 b: mtk.MergeState) -> mtk.MergeState:
    """Per document, ``a``'s planes where ``mask`` ([B, 1]) else ``b``'s."""
    out = []
    for x, y in zip(a, b):
        m = mask[:, 0] if x.ndim == 1 else \
            (mask[:, :, None] if x.ndim == 3 else mask)
        out.append(torch.where(m, x, y))
    return mtk.MergeState(*out)


def _handle_lookup(s: mtk.MergeState, vis, cum, pos):
    """Handle at visible position ``pos`` given a frame (vis, cum): the
    first slot holding it, ``pool_start + pos - cum`` there; -1 when no
    slot does."""
    inside = (cum <= pos) & (pos < cum + vis)
    found = inside.any(dim=1, keepdim=True)
    idx = mtk._first(inside).long()
    return torch.where(found, s.pool_start.gather(1, idx) + pos
                       - cum.gather(1, idx), -1)


def _handle_at(s: mtk.MergeState, pos, ref_seq, client):
    """Storage handle at visible position pos in the (refSeq, client) frame
    (PermutationVector.handle_at / matrix adjustPosition). -1 = none."""
    vis = mtk._vis_len(s, ref_seq, client)
    return _handle_lookup(s, vis, mtk._excl_cumsum(vis), pos)


def _cell_write(s: MatrixState, rh, ch, value, seq, write) -> MatrixState:
    """LWW write of (rh, ch) ← value where ``write`` ([B, 1]): the LAST
    entry with that key, else the append slot ``min(cell_count, C - 1)``
    (the count still grows past C: overflow is the host's to prevent).
    Last match because the cell-run path appends duplicate keys in seq
    order, so the newest one is the one a fold reads."""
    cap = s.cell_used.shape[1]
    iota = torch.arange(cap, dtype=I32, device=rh.device)[None]
    match = s.cell_used & (s.cell_rh == rh) & (s.cell_ch == ch)
    exists = match.any(dim=1, keepdim=True)
    last = torch.where(match, iota, -1).amax(dim=1, keepdim=True)
    idx = torch.where(exists, last,
                      torch.clamp(s.cell_count[:, None], max=cap - 1))
    at = write & (iota == idx)
    return s._replace(
        cell_rh=torch.where(at, rh, s.cell_rh),
        cell_ch=torch.where(at, ch, s.cell_ch),
        cell_val=torch.where(at, value, s.cell_val),
        cell_seq=torch.where(at, seq, s.cell_seq),
        cell_used=s.cell_used | at,
        cell_count=s.cell_count + (write & ~exists)[:, 0].to(I32))


def _axis_walk(s: MatrixState, op: dict, gate) -> MatrixState:
    """ONE merge walk on the targeted axis (rows where target is MX_ROWS,
    else cols), kept where ``gate`` and the target is that axis — an op
    touches one of rows/cols/cell, the other axis keeps its planes."""
    is_rows = op["target"] == MX_ROWS
    is_cols = op["target"] == MX_COLS
    zeros = torch.zeros_like(op["kind"])
    walked = mtk._apply_op(_where_state(is_rows, s.rows, s.cols), dict(
        valid=gate, kind=op["kind"], pos=op["pos"], end=op["end"],
        seq=op["seq"], ref_seq=op["ref_seq"], client=op["client"],
        pool_start=op["handle_base"], text_len=op["count"],
        prop_key=zeros, prop_val=zeros))
    return s._replace(rows=_where_state(gate & is_rows, walked, s.rows),
                      cols=_where_state(gate & is_cols, walked, s.cols))


def _apply_matrix_op(s: MatrixState, op: dict) -> MatrixState:
    # Handles resolve on the PRE-op axis tables; a cell op leaves both
    # axes as they were (its kind/pos/count default to 0, a walk the gate
    # discards).
    rh = _handle_at(s.rows, op["row"], op["ref_seq"], op["client"])
    ch = _handle_at(s.cols, op["col"], op["ref_seq"], op["client"])
    walked = _axis_walk(s, op, op["valid"])
    # A write whose row/col died concurrently resolves to no handle and
    # drops — matrix.ts:547 processCore's None-handle guard.
    write = op["valid"] & (op["target"] == MX_CELL) & (rh >= 0) & (ch >= 0)
    return _cell_write(walked, rh, ch, op["value"], op["seq"], write)


def _fresh(new, old):
    """``new`` with every tensor that is still one of ``old``'s cloned, so
    a tick never hands back its input's storage."""
    return type(new)(*(_fresh(n, o) if isinstance(n, tuple)
                       else (n.clone() if n is o else n)
                       for n, o in zip(new, old)))


def apply_tick(state: MatrixState, ops: MatrixOpBatch) -> MatrixState:
    """Apply one tick of sequenced matrix ops for every document: the plain
    version of the matrix op tick kernel. Ops past the last valid one of
    every document are skipped; invalid ops are no-ops. Returns new
    tensors; the inputs are not modified."""
    s = state
    for k in range(mtk.last_valid(ops)):
        s = _apply_matrix_op(s, {f: getattr(ops, f)[:, k:k + 1]
                                 for f in MatrixOpBatch._fields})
    return _fresh(s, state)


_STEP_VEC = ("kind", "target", "pos", "end", "count", "handle_base", "seq",
             "ref_seq", "client", "run_ref", "run_client")
_STEP_RUN = ("r_row", "r_col", "r_value", "r_seq")


def apply_tick_steps(state: MatrixState,
                     steps: MatrixStepBatch) -> MatrixState:
    """Apply one tick in the step/run layout for every document: the plain
    version of the matrix step tick kernel. Per step: the masked axis walk,
    then ONE visibility frame per axis on the POST-walk tables at
    (run_ref, run_client), then the run's cell writes in order, each a
    lookup in that frame. Same converged state as :func:`apply_tick` on
    the equivalent flat stream."""
    s = state
    live_vec = steps.vec_valid.any(dim=0).cpu().tolist()
    live_run = steps.r_valid.any(dim=0).cpu().tolist()
    trip = max([t + 1 for t in range(len(live_vec))
                if live_vec[t] or any(live_run[t])], default=0)
    for t in range(trip):
        step = {f: getattr(steps, f)[:, t:t + 1] for f in _STEP_VEC}
        if live_vec[t]:
            s = _axis_walk(s, step, steps.vec_valid[:, t:t + 1])
        if not any(live_run[t]):
            continue
        vis_r = mtk._vis_len(s.rows, step["run_ref"], step["run_client"])
        cum_r = mtk._excl_cumsum(vis_r)
        vis_c = mtk._vis_len(s.cols, step["run_ref"], step["run_client"])
        cum_c = mtk._excl_cumsum(vis_c)
        for j, live in enumerate(live_run[t]):
            if not live:
                continue
            cell = {f: getattr(steps, f)[:, t, j:j + 1] for f in _STEP_RUN}
            rh = _handle_lookup(s.rows, vis_r, cum_r, cell["r_row"])
            ch = _handle_lookup(s.cols, vis_c, cum_c, cell["r_col"])
            write = steps.r_valid[:, t, j:j + 1] & (rh >= 0) & (ch >= 0)
            s = _cell_write(s, rh, ch, cell["r_value"], cell["r_seq"], write)
    return _fresh(s, state)


def _resolve_run(vec: mtk.MergeState, pos, ref, client):
    """Handle resolution for each doc's cell run: [B, R] positions against
    the [B, S] vector table in one shared visibility frame per doc."""
    vis = mtk._vis_len(vec, ref[:, None], client[:, None])
    cum = mtk._excl_cumsum(vis)
    p = pos[:, :, None]
    inside = (cum[:, None, :] <= p) & (p < (cum + vis)[:, None, :])
    handle = torch.where(inside, vec.pool_start[:, None, :] + p
                         - cum[:, None, :], 0).sum(dim=2, dtype=I32)
    return torch.where(inside.any(dim=2), handle, -1)


def apply_cell_run(state: MatrixState, run: CellRunBatch) -> MatrixState:
    """Apply one all-cells tick for every document — the config-4 storm
    fast path. Converges to the same materialized grid as
    :func:`apply_tick` on the equivalent stream.

    Appends the whole [B, R] run tile to the cell log in sequenced order
    at a SHARED column offset (``max(cell_count)``), with no dedup:
    duplicate keys coexist in the log carrying their seqs, and a fold
    takes the latest. Cells whose row/col died concurrently keep their
    slot with used=False; documents with shorter runs leave used=False
    padding up to the shared tile. The host checks the margin before the
    tick and drains the log with :func:`compact_cell_log`."""
    num_r = run.row.shape[1]
    capacity = state.cell_used.shape[1]
    rh = _resolve_run(state.rows, run.row, run.ref_seq, run.client)
    ch = _resolve_run(state.cols, run.col, run.ref_seq, run.client)
    write = run.valid & (rh >= 0) & (ch >= 0)
    n_valid = run.valid.sum(dim=1, dtype=I32)
    top = int(state.cell_count.max()) if state.cell_count.numel() else 0
    start = min(max(top, 0), capacity - num_r)

    def place(table, plane):
        out = table.clone()
        out[:, start:start + num_r] = plane.to(table.dtype)
        return out

    return state._replace(
        cell_rh=place(state.cell_rh, rh),
        cell_ch=place(state.cell_ch, ch),
        cell_val=place(state.cell_val, run.value),
        cell_seq=place(state.cell_seq, run.seq),
        cell_used=place(state.cell_used, write),
        # Idle documents keep their count (an inflated count would
        # collapse their reported margin); writers move to the shared
        # tail, preserving every count <= next tick's shared start.
        cell_count=torch.where(n_valid > 0, start + n_valid,
                               state.cell_count))


def compact_cell_log(state: MatrixState) -> MatrixState:
    """Fold each document's cell log to one entry per (rh, ch) — the LAST
    in log (sequenced) order — packed to the front. A stable sort on the
    two keys, as one int64 composite, groups duplicates in log order; the
    dropped entries are superseded writes, so converged state is
    unchanged. Also safe on the unique-keyed per-op table."""
    used = state.cell_used
    cap = used.shape[1]
    big = int(mtk.NONE_SEQ)
    k1 = torch.where(used, state.cell_rh, big)
    k2 = torch.where(used, state.cell_ch, big)
    order = torch.sort(k1.long() * (1 << 32) + (k2.long() + (1 << 31)),
                       dim=1, stable=True).indices
    s1, s2, sv, ss = (p.gather(1, order) for p in
                      (k1, k2, state.cell_val, state.cell_seq))
    su = used.gather(1, order)
    last = torch.arange(cap, device=used.device)[None] == cap - 1
    n1 = torch.where(last, big, torch.roll(s1, -1, 1))
    n2 = torch.where(last, big, torch.roll(s2, -1, 1))
    win = su & ((s1 != n1) | (s2 != n2))
    planes = mtk.pack_keep([s1, s2, sv, ss], win)
    count = win.sum(dim=1, dtype=I32)
    live = torch.arange(cap, dtype=I32, device=used.device)[None] \
        < count[:, None]
    return state._replace(
        cell_rh=torch.where(live, planes[0], -1),
        cell_ch=torch.where(live, planes[1], -1),
        cell_val=torch.where(live, planes[2], 0),
        cell_seq=torch.where(live, planes[3], 0),
        cell_used=live, cell_count=count)


def capacity_margin(state: MatrixState) -> dict[str, np.ndarray]:
    """Free slots per document per table. Vector ops consume up to 2 vector
    slots; a cell set consumes up to 1 cell slot. Overflow is silent — the
    serving host must check and compact/grow/route-to-scalar."""
    return {
        "rows": mtk.capacity_margin(state.rows),
        "cols": mtk.capacity_margin(state.cols),
        "cells": state.cell_used.shape[1] - state.cell_count.cpu().numpy(),
    }


# -- host-side encode / materialize -------------------------------------------


class HandleAllocator:
    """Per-document sequential handle allocation for an axis — mirrors the
    deterministic in-sequence-order rule of ``dds/matrix.py`` so device
    handle runs match every scalar replica."""

    def __init__(self, num_docs: int) -> None:
        self.next = [0] * num_docs

    def alloc(self, doc: int, count: int) -> int:
        base = self.next[doc]
        self.next[doc] += count
        return base


_OP_INT_FIELDS = ("target", "kind", "pos", "end", "count", "handle_base",
                  "row", "col", "value", "seq", "ref_seq", "client")


def _tensors(arrays: dict, dev) -> dict:
    return {n: torch.from_numpy(a).to(dev) for n, a in arrays.items()}


def make_matrix_op_batch(ops_per_doc: list[list[dict]], num_docs: int,
                         k: int, device: str | torch.device | None = None
                         ) -> MatrixOpBatch:
    """Encode per-doc op dicts into padded [B, K] tensors."""
    dev = resolve_device(device)
    fields = {name: np.zeros((num_docs, k), np.int32)
              for name in _OP_INT_FIELDS}
    valid = np.zeros((num_docs, k), np.bool_)
    for d, doc_ops in enumerate(ops_per_doc):
        if len(doc_ops) > k:
            raise ValueError(f"tick overflow: {len(doc_ops)} > {k}")
        for i, op in enumerate(doc_ops):
            valid[d, i] = True
            for name in _OP_INT_FIELDS:
                fields[name][d, i] = op.get(name, 0)
    return MatrixOpBatch(**_tensors(dict(fields, valid=valid), dev))


def make_cell_run_batch(cells_per_doc: list[list[dict]], num_docs: int,
                        r: int, ref_seq, client,
                        device: str | torch.device | None = None
                        ) -> CellRunBatch:
    """Encode per-doc cell-write lists (dicts with row/col/value/seq)."""
    dev = resolve_device(device)
    fields = {name: np.zeros((num_docs, r), np.int32)
              for name in ("row", "col", "value", "seq")}
    valid = np.zeros((num_docs, r), np.bool_)
    for d, cells in enumerate(cells_per_doc):
        if len(cells) > r:
            raise ValueError(f"run overflow: {len(cells)} > {r}")
        for i, cell in enumerate(cells):
            valid[d, i] = True
            for name in fields:
                fields[name][d, i] = cell.get(name, 0)
    return CellRunBatch(**_tensors(dict(
        fields, valid=valid, ref_seq=np.asarray(ref_seq, np.int32),
        client=np.asarray(client, np.int32)), dev))


def group_matrix_steps(doc_ops: list[dict], r_max: int = 8,
                       last_vec_seq: int = 0) -> list[dict]:
    """Group one document's sequenced kernel ops into steps.

    Exactness: only vector ops mutate the axis tables, so every axis
    segment's insert/remove seq is <= v (the last vector-op seq). A cell
    with ref_seq >= v therefore sees EVERY axis segment and removal — its
    visibility frame equals any other such cell's, and the run shares one
    scan. A cell with ref_seq < v (stale concurrent ref) becomes a
    single-cell run carrying its own exact (ref, client) frame.
    ``last_vec_seq`` seeds v for ticks continuing a served document.
    """
    steps: list[dict] = []
    v = last_vec_seq
    cur: dict | None = None
    for op in doc_ops:
        if op["target"] != MX_CELL:
            cur = {"vec": op, "cells": []}
            steps.append(cur)
            v = op["seq"]
            continue
        fresh = op["ref_seq"] >= v
        if cur is None or not fresh or len(cur["cells"]) >= r_max:
            cur = {"vec": None, "cells": []}
            steps.append(cur)
        cur["cells"].append(op)
        if not fresh:
            cur = None  # a stale-ref cell stays alone in its exact run
    return steps


def make_matrix_step_batch(ops_per_doc: list[list[dict]], num_docs: int,
                           r_max: int = 8,
                           last_vec_seq: list[int] | None = None,
                           device: str | torch.device | None = None
                           ) -> MatrixStepBatch:
    """Encode per-doc op lists into the step/run layout (padded [B, T] +
    [B, T, R])."""
    dev = resolve_device(device)
    seeds = last_vec_seq or [0] * num_docs
    grouped = [group_matrix_steps(doc_ops, r_max, seeds[d])
               for d, doc_ops in enumerate(ops_per_doc)]
    t = max((len(g) for g in grouped), default=1) or 1
    r = max((len(s["cells"]) for g in grouped for s in g), default=1) or 1
    vec = {n: np.zeros((num_docs, t), np.int32) for n in _STEP_VEC}
    vec_valid = np.zeros((num_docs, t), np.bool_)
    run = {n: np.zeros((num_docs, t, r), np.int32) for n in _STEP_RUN}
    r_valid = np.zeros((num_docs, t, r), np.bool_)
    for d, g in enumerate(grouped):
        for i, step in enumerate(g):
            op = step["vec"]
            if op is not None:
                vec_valid[d, i] = True
                for n in _STEP_VEC[:9]:
                    vec[n][d, i] = op.get(n, 0)
            cells = step["cells"]
            if cells:
                vec["run_ref"][d, i] = min(c["ref_seq"] for c in cells)
                vec["run_client"][d, i] = cells[0]["client"]
                for j, c in enumerate(cells):
                    r_valid[d, i, j] = True
                    run["r_row"][d, i, j] = c["row"]
                    run["r_col"][d, i, j] = c["col"]
                    run["r_value"][d, i, j] = c["value"]
                    run["r_seq"][d, i, j] = c["seq"]
    return MatrixStepBatch(**_tensors(
        dict(vec, **run, vec_valid=vec_valid, r_valid=r_valid), dev))


def encode_matrix_op(channel_op: dict, base: dict, alloc_rows, alloc_cols,
                     intern) -> list[dict]:
    """ONE wire op → kernel op dicts — the single wire-format decoder
    shared by the replay harness (encode_matrix_log) and the serving host
    (merge_host._ingest_matrix). ``alloc_rows``/``alloc_cols`` are
    count→handle_base callables; ``intern`` maps a cell value to its id
    (0 reserved for None/cleared)."""
    target = channel_op["target"]
    if target in ("rows", "cols"):
        alloc = alloc_rows if target == "rows" else alloc_cols
        tcode = MX_ROWS if target == "rows" else MX_COLS
        if channel_op["type"] == "insert":
            count = channel_op["count"]
            return [dict(base, target=tcode, kind=mtk.MT_INSERT,
                         pos=channel_op["pos"], count=count,
                         handle_base=alloc(count))]
        if channel_op["type"] == "insertGroup":
            # Regenerated split insert: one kernel op per fragment, handles
            # allocated in the fragments' document order (matching the
            # scalar applier).
            return [dict(base, target=tcode, kind=mtk.MT_INSERT,
                         pos=pos, count=count, handle_base=alloc(count))
                    for pos, count in channel_op["ranges"]]
        if channel_op["type"] == "removeGroup":
            return [dict(base, target=tcode, kind=mtk.MT_REMOVE,
                         pos=start, end=end)
                    for start, end in channel_op["ranges"]]
        return [dict(base, target=tcode, kind=mtk.MT_REMOVE,
                     pos=channel_op["start"], end=channel_op["end"])]
    return [dict(base, target=MX_CELL, row=channel_op["row"],
                 col=channel_op["col"], value=intern(channel_op["value"]))]


def encode_matrix_log(messages, doc: int, rows: HandleAllocator,
                      cols: HandleAllocator, client_slots: dict,
                      val_ids: dict) -> list[dict]:
    """Sequenced OPERATION messages of one matrix channel → kernel op dicts.

    ``val_ids`` interns cell values (id 0 reserved for None/cleared); the
    caller keeps the reverse table for materialization.
    """
    from ..protocol.messages import MessageType

    def intern(value):
        return 0 if value is None else val_ids.setdefault(
            repr(value), len(val_ids) + 1)

    out = []
    for m in messages:
        if m.type != MessageType.OPERATION:
            continue
        channel_op = m.contents["contents"]["contents"]
        slot = client_slots.setdefault(m.client_id, len(client_slots))
        base = dict(seq=m.sequence_number,
                    ref_seq=m.reference_sequence_number, client=slot)
        out.extend(encode_matrix_op(
            channel_op, base,
            lambda count: rows.alloc(doc, count),
            lambda count: cols.alloc(doc, count), intern))
    return out


def _axis_handles(s: mtk.MergeState, doc: int) -> list[int]:
    """Live handles of one axis in document order (acked view)."""
    valid = s.valid[doc].cpu().numpy()
    length = s.length[doc].cpu().numpy()
    rem = s.rem_seq[doc].cpu().numpy()
    start = s.pool_start[doc].cpu().numpy()
    handles: list[int] = []
    for i in range(valid.shape[0]):
        if valid[i] and rem[i] == mtk.NONE_SEQ and length[i] > 0:
            handles.extend(range(int(start[i]), int(start[i] + length[i])))
    return handles


def materialize_grid(state: MatrixState, doc: int,
                     val_rev: list) -> list[list]:
    """Converged dense grid of one document (None = unset cell)."""
    row_handles = _axis_handles(state.rows, doc)
    col_handles = _axis_handles(state.cols, doc)
    used = state.cell_used[doc].cpu().numpy()
    rh = state.cell_rh[doc].cpu().numpy()
    ch = state.cell_ch[doc].cpu().numpy()
    val = state.cell_val[doc].cpu().numpy()
    cells = {(int(rh[i]), int(ch[i])): int(val[i])
             for i in range(used.shape[0]) if used[i]}
    return [[val_rev[cells[(r, c)]] if (r, c) in cells else None
             for c in col_handles] for r in row_handles]
