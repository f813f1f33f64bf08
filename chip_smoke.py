#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``fluidframework_tpu_torch``).

Run on a machine with one NVIDIA H100 from the root of a checkout:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``fluidframework_tpu_torch/csrc``
(one ``nvcc`` per source, all started together), holds each kernel
against its plain PyTorch version on the card at full size (exact
equality: every plane is integer), then drives the port's main paths:

* the map-storm serving tick of BASELINE.json config 3 (SharedMap op
  storm: 10,240 docs x 4 clients, 64 key slots, K=1024 set/delete/clear
  words per doc per tick) through ``RouterliciousService`` /
  ``KernelSequencerHost`` / ``KernelMergeHost`` / ``StormController``,
  checked against a plain-version run and a numpy fold;
* the same frames served crash-safe, as the JAX bench deploys config 3:
  a group-commit tick WAL and a git snapshot store in the machine's temp
  dir, no ack before its tick's fsync, a checkpoint after the joins and
  before tick 4; held to the WAL-less run (WAL records == tick blobs,
  planes, acks); then a fresh stack on the card recovers it (the tick-4
  head and the WAL tail replayed through the serving tick), held to the
  live durable stack, and a client joins 64 docs of both; then one kill
  (``wal.pre_fsync``) of a chaos-harness serving process on the card,
  recovered to its twin's digest;
* SharedString text serving: BASELINE.json config 2 (1 doc, 128 clients
  joined through the service, rounds of concurrent inserts and removes
  through their connections, the merger lambda feeding
  ``KernelMergeHost``), and the host at batched width (8,192 docs x 128
  writers, six flushes of K=32 ops, 64 docs bursting past a block),
  checked against a scalar ``MergeEngine`` replay and a plain-version run;
* SharedMatrix serving: BASELINE.json config 4 (a 1k x 1k grid, 256
  clients joined through the service writing cells concurrently, with
  rows and cols inserted and removed every fourth round), and the host at
  batched width (8,192 docs x 256 writers, six flushes of K=32 ops),
  checked against a scalar PermutationVector + LWW replay and a
  plain-version run; and the matrix step tick at the reference matrix
  benchmark's step layout (16,384 docs, six ticks of 64 ops), checked
  against the op tick's grids.

It prints each kernel's launch shapes on the main paths and re-checks
every kernel == plain at each of them, on the very inputs the paths gave
them (every call's, kept while the paths ran: the map fold on the map,
durable and recover paths; the deli on those, text path A and matrix
path A), where
they are also timed per launch. Every kernel has two variants, picked by
shape: the map fold's warp variant (one warp a document) at every
shape; the deli's warp variant wherever a document has 16 client lanes
or more and fits shared memory, else its one-thread variant; the four
merge and matrix ticks' shared-memory variant wherever a document fits,
which every path's do. Each variant is held to the plain version, and
timed, on the same inputs (``ms_block``, ``ms_thread``, ``ms_global``),
and each old variant but the map fold's also runs alone at a shape that
forces it. Then it prints the kernels' launch counts, per path, per
variant and in all, and their times.

Phases print one line each. Any failed check exits non-zero before the
last line, which is the JSON device record
``{"ok": true, "device": {"platform": "gpu", ...}}``. Without CUDA, or
outside a checkout of the repository, it exits non-zero and prints no
result. It imports nothing of JAX and nothing of ``fluidframework_tpu``.

    python3 chip_smoke.py --trace

serves the map path's ticks (WAL-less and durable) and the text and
matrix paths once more (matrix path B at two flushes), under
``torch.profiler``, and prints the card's busy time and idle share.
"""

from __future__ import annotations

import contextlib
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

# H100 SXM published peaks: HBM bytes/s
# and the non-tensor-core rate used for integer ALU work.
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12

# BASELINE.json config 3 at its published width.
DOCS = 10_240
CLIENTS = 4
KEY_SLOTS = 64
K_MAP = 1024
TICKS = 8
FRAMES_PER_TICK = 10
K_SEQ = 32

# BASELINE.json config 2 at its published width (1 doc, 128 clients), and
# the host at the batched width bench.py runs that config at (8,192 docs,
# K=32 ops per doc per tick, 6 ticks), with 64 docs whose head-concentrated
# burst (BURST_K ops, 2 * BURST_K + 2 > Bk) overflows a block mid-tick.
TEXT_CLIENTS = 128
TEXT_ROUNDS = 16
TEXT_DOCS = 8_192
TEXT_K = 32
TEXT_FLUSHES = 6
BURST_DOCS = 64
BURST_K = 120
BURST_FLUSH = 3
SAMPLE_DOCS = 256
# The kernel checks' table: S = NB x Bk = 4 x 128, 4 props, 4 overlap words.
TEXT_NB, TEXT_BK, TEXT_P, TEXT_W = 4, 128, 4, 4

# BASELINE.json config 4 at its published width (a 1k x 1k SharedMatrix,
# 256 clients writing cells concurrently) through the service, and the
# matrix host at batched width (8,192 docs, 256 writer ids, K=32 ops per
# doc a flush from a 32 x 32 start, 6 flushes; the cell log starts at 128
# entries so it compacts and grows). The op tick's kernel check runs at
# (B, K, S, C, W) = (8,192, 32, 256, 1,024, 8), plus a 16-entry cell log
# that overflows.
MATRIX_CLIENTS = 256
MATRIX_GRID = 1024
MATRIX_ROUNDS = 16
MATRIX_B = 8_192
MATRIX_K = 32
MATRIX_START = 32
MATRIX_FLUSHES = 6
MATRIX_B_CELLS = 128
MATRIX_S, MATRIX_C, MATRIX_W = 256, 1024, 8
MATRIX_FULL_C = 16
# The step tick at the reference matrix benchmark's shape: 16,384 docs,
# 64 ops per doc a tick in the step layout (r_max 8), S = C = 256, 6
# ticks, 256 seeded streams tiled over the docs.
STEPS_DOCS = 16_384
STEPS_K = 64
STEPS_RMAX = 8
STEPS_S = 256
STEPS_TICKS = 6
STEPS_STREAMS = 256
# A deli lane count past one block's shared memory for the warp variant
# (4 documents x 16 bytes a client > 232,448 bytes on an H100).
DELI_LARGE_C = 4096


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


L2_FLUSH_BYTES = 256 << 20  # well past the H100's 50 MB L2
# A device-side wait (about 1 ms at the H100's clock) between the L2 flush
# and the start event: the host enqueues the timed call during it, so the
# time between the events is the call's device time, not the host's time
# in the wrapper (which took most of a sub-0.2 ms launch's reading
# without it).
PAD_CYCLES = 2_000_000


def cuda_time_ms(fn, reps: int) -> float:
    """Mean device ms of ``fn()`` over ``reps`` calls, each timed alone
    with CUDA events after a write of 256 MB that evicts the L2, so
    every call finds its inputs in device memory as a serving tick does,
    and a device wait that lets the host enqueue the call before its
    start event runs (one warm-up call first)."""
    import torch
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fn()
    pairs = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(PAD_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / reps


def bound(nbytes: float, nops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / ALU_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def leaves(planes) -> list:
    """Every tensor of a (nested) tuple of tensors, in field order."""
    out = []
    for t in planes:
        out.extend(leaves(t) if isinstance(t, tuple) else [t])
    return out


def max_abs_err(a, b) -> int:
    """Largest |a - b| over every plane of two (nested) NamedTuples of
    tensors."""
    worst = 0
    for x, y in zip(leaves(a), leaves(b)):
        d = (x.long() - y.long()).abs().max().item() if x.numel() else 0
        worst = max(worst, int(d))
    return worst


# -- phase 3: kernels against their plain versions -----------------------------


def map_fold_inputs(gen, device, b=DOCS, k=K_MAP, s=KEY_SLOTS):
    """A storm tick's fold inputs: 10% clears, dup windows (lo > 0),
    partial windows (hi < K), empty rows, and a non-trivial prior state."""
    import torch

    from fluidframework_tpu_torch.ops import map_kernel as mk

    def rint(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=device,
                             dtype=torch.int32)
    r = torch.rand((b, k), generator=gen, device=device)
    kind = torch.where(r < 0.1, mk.MAP_CLEAR,
                       torch.where(r < 0.3, mk.MAP_DELETE, mk.MAP_SET))
    words = (kind.to(torch.int32) | (rint(0, s, (b, k)) << 2)
             | (rint(1, 1 << 20, (b, k)) << 12))
    shape = rint(0, 4, (b,))  # 0 full, 1 dup prefix, 2 partial, 3 empty
    lo = torch.where(shape == 1, rint(1, 64, (b,)), 0)
    hi = torch.where(shape == 2, rint(1, k, (b,)), k)
    hi = torch.where(shape == 3, lo, hi)
    base = rint(0, 1 << 20, (b,))
    state = mk.MapState(
        present=torch.rand((b, s), generator=gen, device=device) < 0.5,
        value=rint(0, 1 << 20, (b, s)),
        vseq=rint(0, 1 << 20, (b, s)),
        cleared_seq=rint(-1, 1 << 10, (b,)))
    return state, words.contiguous(), lo, hi, base


def windowed_ops(words, lo, hi) -> int:
    """The ops a fold's windows hold: sum of max(0, min(hi, K) - max(lo,
    0))."""
    window = (hi.clamp(max=words.shape[1]) - lo.clamp(min=0)).clamp(min=0)
    return int(window.sum().item())


def fold_bound(state, words, lo, hi, base) -> tuple[float, str]:
    """Kernel 1's bound on these inputs: each windowed word read once, the
    three [B] window planes and the [B, S] planes in and out once; about
    8 integer ops a word and 12 a slot."""
    b, s = state.present.shape
    n_ops = windowed_ops(words, lo, hi)
    plane_bytes = b * s * (1 + 4 + 4) + 4 * b
    nbytes = 4 * n_ops + 12 * b + 2 * plane_bytes
    return bound(nbytes, 8 * n_ops + 12 * b * s)


def check_map_fold(device, b=DOCS, k=K_MAP, s=KEY_SLOTS) -> dict:
    """Kernel 1 against its plain version on one synthetic storm tick of
    shape (B, K, S), in both variants, each timed (``ms_block``)."""
    import torch

    from fluidframework_tpu_torch.ops import map_fold_cuda as mfc
    from fluidframework_tpu_torch.ops import map_kernel as mk
    gen = torch.Generator(device=device).manual_seed(1)
    state, words, lo, hi, base = map_fold_inputs(gen, device, b, k, s)
    want = mk.fold_words_plain(state, words, lo, hi, base)
    variant = mfc.fold_variant(b, k, s)
    err = 0
    out = {"shape": [b, words.shape[1], s], "variant": variant}
    for v in ("warp", "block"):
        got = mfc.fold_words(state, words, lo, hi, base, v)
        torch.cuda.synchronize()
        err = max(err, max_abs_err(got, want))
        check(err == 0, f"map fold kernel ({v}) != plain version "
              f"(max |err| {err})")
        for f in mk.MapState._fields:
            check(torch.equal(getattr(got, f), getattr(want, f)),
                  f"map fold ({v}) plane {f} differs")
        out[f"ms_{v}"] = cuda_time_ms(
            lambda: mfc.fold_words(state, words, lo, hi, base, v), 20)
    out["ms"] = out[f"ms_{variant}"]
    out["max_abs_err"] = err
    out["windowed_ops"] = windowed_ops(words, lo, hi)
    out["plain_ms"] = cuda_time_ms(
        lambda: mk.fold_words_plain(state, words, lo, hi, base), 3)
    out["bound_ms"], out["bound_by"] = fold_bound(state, words, lo, hi, base)
    print(f"kernel map_fold: {json.dumps(out)}", flush=True)
    return out


def deli_inputs(gen, device, b=DOCS, k=K_SEQ, c=CLIENTS + 1):
    """A deli tick: four live client lanes plus the ghost lane, and a
    random op stream of joins, leaves, client ops with dups and gaps,
    refSeq below MSN, summarize, noops and nack_future controls."""
    import torch

    from fluidframework_tpu_torch.ops import sequencer as seqk
    from fluidframework_tpu_torch.protocol.messages import MessageType as MT

    def rint(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=device,
                             dtype=torch.int32)

    def rbool(p, shape):
        return torch.rand(shape, generator=gen, device=device) < p
    lanes = torch.arange(c, device=device)[None, :]
    active = (lanes < c - 1) & rbool(0.9, (b, c))
    seq = rint(20, 40, (b,))
    cref = torch.minimum(rint(5, 20, (b, c)), seq[:, None])
    msn = torch.where(active, cref, 2**31 - 1).amin(dim=1)
    msn = torch.where(active.any(dim=1), msn, seq).to(torch.int32)
    state = seqk.SequencerState(
        seq=seq, msn=msn, last_sent_msn=msn.clone(),
        nack_future=rbool(0.02, (b,)), active=active,
        cseq=rint(0, 6, (b, c)), cref=cref.to(torch.int32),
        clu=rint(0, 1000, (b, c)), csum=rbool(0.5, (b, c)),
        cnack=rbool(0.05, (b, c)) & active,
        cevict=torch.ones((b, c), dtype=torch.bool, device=device))
    choice = torch.tensor(
        [int(MT.OPERATION)] * 10 + [int(MT.NOOP), int(MT.SUMMARIZE),
                                    int(MT.CLIENT_JOIN),
                                    int(MT.CLIENT_LEAVE),
                                    int(MT.NO_CLIENT), int(MT.CONTROL),
                                    int(MT.SUMMARY_ACK)],
        dtype=torch.int32, device=device)
    kind = choice[rint(0, len(choice), (b, k)).long()]
    system = (kind == int(MT.CLIENT_JOIN)) | (kind == int(MT.CLIENT_LEAVE)) \
        | (kind == int(MT.NO_CLIENT)) | (kind == int(MT.CONTROL))
    slot = torch.where(system & rbool(0.9, (b, k)), -1, rint(0, c, (b, k)))
    iota = torch.arange(k, device=device, dtype=torch.int32)[None, :]
    ops = seqk.OpBatch(
        valid=rbool(0.95, (b, k)), kind=kind, slot=slot,
        target=rint(0, c, (b, k)),
        client_seq=(iota // 4 + rint(0, 4, (b, k))).to(torch.int32),
        ref_seq=torch.where(rbool(0.1, (b, k)), -1, rint(0, 60, (b, k))),
        timestamp=rint(1000, 2000, (b, k)),
        has_contents=rbool(0.5, (b, k)), can_summarize=rbool(0.5, (b, k)),
        can_evict=rbool(0.8, (b, k)), is_nack_future=rbool(0.2, (b, k)))
    return state, seqk.OpBatch(*(t.contiguous() for t in ops))


def check_deli(device, b=DOCS, k=K_SEQ, c=CLIENTS + 1,
               every_outcome: bool = True, time_it: bool = True) -> dict:
    """Kernel 2 against its plain version on one deli tick of shape
    (B, K, C), in the variant the shape picks and in the other one where
    it fits; ``every_outcome`` also requires the inputs to reach every
    nack code and every outcome (true of the K = 32 tick)."""
    import torch

    from fluidframework_tpu_torch.ops import sequencer as seqk
    from fluidframework_tpu_torch.ops import sequencer_cuda as seqc
    gen = torch.Generator(device=device).manual_seed(2)
    state, ops = deli_inputs(gen, device, b, k, c)
    limit = seqc.smem_limit(device)
    variant = seqc.deli_variant(b, k, c, limit)
    runs = ("warp", "thread") if seqc.warp_smem_bytes(c) <= limit \
        else ("thread",)
    want_s, want_t = seqk.process_batch(state, ops)
    err = 0
    for v in runs:
        got_s, got_t = seqc.process_batch_best(state, ops, v)
        torch.cuda.synchronize()
        err = max(err, max_abs_err(got_s, want_s), max_abs_err(got_t, want_t))
        check(err == 0, f"deli kernel ({v}) != plain version at {(b, k, c)} "
              f"(max |err| {err})")
        for name, x, y in zip(seqk.SequencerState._fields, got_s, want_s):
            check(torch.equal(x, y), f"deli ({v}) state plane {name} differs")
        for name, x, y in zip(seqk.TicketBatch._fields, got_t, want_t):
            check(torch.equal(x, y), f"deli ({v}) ticket plane {name} differs")
    codes = torch.bincount(want_t.nack_code.flatten().long(), minlength=7)
    outs = torch.bincount(want_t.kind.flatten().long(), minlength=3)
    check(not every_outcome
          or (bool((codes[1:] > 0).all()) and bool((outs > 0).all())),
          f"deli inputs miss an outcome: nack codes {codes.tolist()} "
          f"outcomes {outs.tolist()}")
    out = {"shape": [b, k, c], "variant": variant, "max_abs_err": err,
           "nack_codes": codes.tolist(), "outcomes": outs.tolist()}
    if time_it:
        for v in runs:
            out[f"ms_{v}"] = cuda_time_ms(
                lambda: seqc.process_batch_best(state, ops, v), 20)
        out["ms"] = out[f"ms_{variant}"]
        out["plain_ms"] = cuda_time_ms(lambda: seqk.process_batch(state, ops),
                                       3)
        out["bound_ms"], out["bound_by"] = deli_bound(state, ops)
    print(f"kernel sequencer_tick: {json.dumps(out)}", flush=True)
    return out


def deli_bound(state, ops) -> tuple[float, str]:
    """Kernel 2's bound on these inputs: the state in and out once, the 11
    op planes read and the 5 ticket planes written once; about 60 integer
    ops an op and 4 a client lane for each MSN."""
    b, c = state.active.shape
    k = ops.kind.shape[1]
    state_bytes = b * (3 * 4 + 1) + b * c * (3 * 4 + 4 * 1)
    nbytes = 2 * state_bytes + b * k * (6 * 4 + 5 * 1) + b * k * 5 * 4
    return bound(nbytes, b * k * (60 + 4 * c))


# -- phase 4: the main path ----------------------------------------------------


def make_script(seed: int, docs: int, ticks: int, k: int, frames: int):
    """The frames the main path serves: per tick, ``frames`` frames that
    together carry one K-word entry per doc, submitted by client
    ``tick % CLIENTS``; then one verbatim resend of tick 0's first frame.
    Returns [(tick, rid, entries, payload bytes)]; entries hold client
    INDICES, resolved to ids at submit time."""
    import numpy as np
    rng = np.random.default_rng(seed)
    per = -(-docs // frames)
    out = []
    for t in range(ticks):
        c = t % CLIENTS
        cseq0 = 1 + (t // CLIENTS) * k  # each client's own counter
        # Every op of every tick sequences, so the doc seq before tick t
        # is 4 joins + t*k: reference what was acked before this tick.
        ref = CLIENTS + t * k
        r = rng.random((docs, k))
        kinds = np.where(r < 0.1, 2, np.where(r < 0.3, 1, 0)).astype(
            np.uint32)
        slots = rng.integers(0, KEY_SLOTS, (docs, k)).astype(np.uint32)
        vals = rng.integers(0, 1 << 20, (docs, k)).astype(np.uint32)
        words = kinds | (slots << 2) | (vals << 12)
        for f in range(frames):
            d0, d1 = f * per, min(docs, (f + 1) * per)
            entries = [(d, c, cseq0, ref, k) for d in range(d0, d1)]
            out.append((t, t * frames + f, entries,
                        words[d0:d1].tobytes()))
    t0, rid0, entries0, payload0 = out[0]
    out.append((ticks, "resend", entries0, payload0))
    return out


def serve(device, script, docs, plain: bool = False,
          ticks_ctx=contextlib.nullcontext, storm_kw=None,
          threshold: int = 10**9, before_tick=None, on_push=None,
          on_submit=None) -> dict:
    """Build the port's service stack on ``device`` and serve ``script``;
    ``plain`` swaps in the kernels' plain versions for the whole run, and
    ``ticks_ctx()`` is entered around the served frames (not the joins).
    ``storm_kw`` adds StormController arguments (the durable path's WAL
    and snapshot store), ``threshold`` is its flush threshold in docs,
    ``before_tick(storm, tick)`` runs before each tick's first frame (and
    once with ``TICKS`` before the resend), and ``on_push(rid, ack)``
    sees every ack as it is pushed, ``on_submit(rid)`` every frame just
    before it is submitted."""
    import numpy as np

    from fluidframework_tpu_torch.ops import map_fold_cuda as mfc
    from fluidframework_tpu_torch.ops import map_kernel as mk
    from fluidframework_tpu_torch.ops import sequencer as seqk
    from fluidframework_tpu_torch.ops import sequencer_cuda as seqc
    from fluidframework_tpu_torch.server import kernel_host as kh
    from fluidframework_tpu_torch.server import storm as st
    from fluidframework_tpu_torch.server.kernel_host import \
        KernelSequencerHost
    from fluidframework_tpu_torch.server.merge_host import KernelMergeHost
    from fluidframework_tpu_torch.server.routerlicious import \
        RouterliciousService
    from fluidframework_tpu_torch.server.storm import StormController

    @contextlib.contextmanager
    def plain_versions():
        saved = kh.seqc, st._map_leg
        kh.seqc = type("Plain", (), {
            "process_batch_best": staticmethod(seqk.process_batch)})
        st._map_leg = lambda s, w, lo, hi, b: mk.fold_words_plain(
            s, w, lo, hi, b)
        try:
            yield
        finally:
            kh.seqc, st._map_leg = saved

    import torch
    with plain_versions() if plain else contextlib.nullcontext():
        seq_host = KernelSequencerHost(num_slots=CLIENTS,
                                       initial_capacity=docs, device=device)
        merge_host = KernelMergeHost(flush_threshold=10**9,
                                     row_capacity=docs, device=device)
        service = RouterliciousService(merge_host=merge_host,
                                       batched_deli_host=seq_host,
                                       auto_pump=False)
        clock = iter(range(1000, 1 << 30, 3))
        service._clock = lambda: next(clock)
        storm = StormController(service, seq_host, merge_host,
                                flush_threshold_docs=threshold,
                                max_key_slots=KEY_SLOTS, pipeline_depth=1,
                                **(storm_kw or {}))
        mfc.launches = 0
        seqc.launches = 0
        mfc.shapes.clear()
        mfc.variants.update(warp=0, block=0)
        seqc.shapes.clear()
        seqc.variants.clear()
        t0 = time.perf_counter()
        names = [f"doc{d}" for d in range(docs)]
        ids = [[service.connect(n, lambda m: None).client_id
                for _ in range(CLIENTS)] for n in names]
        service.pump()
        if device.type == "cuda":
            torch.cuda.synchronize()
        t_join = time.perf_counter() - t0
        acks: dict = {}
        submitted = 0

        def push(p, rid):
            acks.setdefault(rid, []).append(p)
            if on_push is not None:
                on_push(rid, p)
        with ticks_ctx():
            t1 = time.perf_counter()
            at = None
            for tick, rid, entries, payload in script:
                if tick == TICKS and at != TICKS:
                    storm.flush()  # the ticks settle before the resend
                    t_serve = time.perf_counter() - t1
                if before_tick is not None and tick != at:
                    before_tick(storm, tick)
                at = tick
                hdr = {"op": "storm", "rid": rid, "docs": [
                    [names[d], ids[d][c], c0, ref, k]
                    for d, c, c0, ref, k in entries]}
                if on_submit is not None:
                    on_submit(rid)
                storm.submit_frame(lambda p, rid=rid: push(p, rid),
                                   hdr, memoryview(payload))
                submitted += sum(e[4] for e in entries)
            storm.flush()
        if device.type == "cuda":
            torch.cuda.synchronize()
        launches = {"map_fold": mfc.launches,
                    "sequencer_tick": seqc.launches}
        shapes = {"map_fold": dict(mfc.shapes),
                  "sequencer_tick": dict(seqc.shapes)}
        deli_variants = dict(seqc.variants)
        fold_variants = dict(mfc.variants)
    sample = np.linspace(0, docs - 1, 64).astype(int).tolist()
    return {
        "service": service, "storm": storm, "seq_host": seq_host,
        "merge_host": merge_host, "acks": acks, "submitted": submitted,
        "names": names, "launches": launches, "shapes": shapes,
        "deli_variants": deli_variants, "fold_variants": fold_variants,
        "t_join": t_join,
        "t_serve": t_serve,
        "entries": {names[d]: merge_host.map_entries(names[d], "default",
                                                     "root")
                    for d in sample},
    }


def scalar_fold(script, doc_index: int) -> dict:
    """numpy/Python LWW fold of the words one doc was sent, in order,
    skipping the resend (all its ops are dups)."""
    import numpy as np
    entries: dict = {}
    for tick, _rid, ents, payload in script:
        if tick == TICKS:
            continue
        words = np.frombuffer(payload, np.uint32).reshape(len(ents), -1)
        for row, (d, *_rest) in enumerate(ents):
            if d != doc_index:
                continue
            for w in words[row].tolist():
                kind, slot, val = w & 3, (w >> 2) & 0x3FF, w >> 12
                if kind == 2:
                    entries.clear()
                elif kind == 0:
                    entries[f"k{slot}"] = val
                else:
                    entries.pop(f"k{slot}", None)
    return entries


def ack_rows(acks: dict) -> dict:
    import numpy as np
    return {rid: [np.asarray(p.rows) if hasattr(p, "rows") else p
                  for p in ps] for rid, ps in acks.items()}


def main_path(device) -> dict:
    import numpy as np
    import torch

    from fluidframework_tpu_torch.ops import map_fold_cuda as mfc
    from fluidframework_tpu_torch.ops import sequencer_cuda as seqc
    docs = DOCS
    script = make_script(7, docs, TICKS, K_MAP, FRAMES_PER_TICK)
    recorded: dict = {}
    folds: dict = {}
    with recording(seqc, "process_batch_best", recorded), \
            recording(mfc, "fold_words", folds):
        run = serve(device, script, docs)
    storm = run["storm"]
    n_frames = len(script)
    # Every frame acked, none with an error.
    check(len(run["acks"]) == n_frames,
          f"{len(run['acks'])} of {n_frames} frames acked")
    for rid, ps in run["acks"].items():
        check(len(ps) == 1 and "error" not in ps[0],
              f"frame {rid} ack {ps[0] if ps else None}")
    resend = run["acks"]["resend"][0]
    check(not np.asarray(resend.rows)[:, 0].any(),
          "the verbatim resend sequenced ops instead of ignoring them")
    dups = sum(e[4] for t, _r, ents, _p in script if t == TICKS
               for e in ents)
    want = run["submitted"] - dups
    check(storm.stats["sequenced_ops"] == want,
          f"sequenced {storm.stats['sequenced_ops']} != submitted "
          f"{run['submitted']} - dups {dups}")
    for name, n in run["launches"].items():
        check(n > 0, f"kernel {name} was not launched on the main path")
    deli_picks(device, run["shapes"]["sequencer_tick"], run["deli_variants"],
               "the map path")
    picked: dict = {}
    for (b, k, s), n in run["shapes"]["map_fold"].items():
        v = mfc.fold_variant(b, k, s)
        picked[v] = picked.get(v, 0) + n
    check({v: n for v, n in run["fold_variants"].items() if n} == picked,
          f"the map path launched the fold's variants "
          f"{run['fold_variants']}, its shapes pick {picked}")
    # Equal to a second run with the plain versions.
    plain = serve(device, script, docs, plain=True)
    for a, b, what in ((run["seq_host"]._state, plain["seq_host"]._state,
                        "sequencer"),
                       (run["merge_host"]._xstate,
                        plain["merge_host"]._xstate, "map")):
        for f, x, y in zip(a._fields, a, b):
            check(torch.equal(x, y), f"{what} plane {f}: kernel run != "
                  "plain run")
    ra, rb = ack_rows(run["acks"]), ack_rows(plain["acks"])
    check(ra.keys() == rb.keys() and all(
        len(ra[r]) == len(rb[r])
        and all(np.array_equal(x, y) for x, y in zip(ra[r], rb[r]))
        for r in ra), "acks: kernel run != plain run")
    check(storm._tick_blobs == plain["storm"]._tick_blobs,
          "tick blobs: kernel run != plain run")
    # map_entries on 64 sampled docs == numpy fold of the submitted words.
    for name, got in run["entries"].items():
        want_entries = scalar_fold(script, int(name[3:]))
        check(got == want_entries, f"map_entries({name}) != scalar fold")
    led = storm.ledger.records()
    serve_ticks = led[:TICKS]

    def p50(stage):
        xs = sorted(r[stage] for r in serve_ticks)
        return xs[len(xs) // 2] / 1e6
    merged = TICKS * docs * K_MAP
    split = {"scatter_ms": p50("scatter"),
             "dispatch_ms": p50("device_dispatch"),
             "readback_ms": p50("readback"),
             "harvest_ms": p50("ack_pack") + p50("fanout_publish")
             + p50("wal_append")}
    out = {"ticks": TICKS, "docs": docs, "k": K_MAP,
           "join_s": run["t_join"], "serve_s": run["t_serve"],
           "ticks_per_s": TICKS / run["t_serve"],
           "merged_ops_per_s": merged / run["t_serve"], **split,
           "launches": run["launches"]}
    print("main_path: " + json.dumps(out), flush=True)
    # Launches by shape: (B, K, S) for map_fold, (B, K, C) for the deli.
    print("main_path_shapes: " + json.dumps(
        {name: [[*shape, n] for shape, n in sorted(by.items())]
         for name, by in run["shapes"].items()}), flush=True)
    out["shapes"] = run["shapes"]
    out["deli_variants"] = run["deli_variants"]
    out["fold_variants"] = run["fold_variants"]
    out["deli_inputs"] = recorded
    out["fold_inputs"] = folds
    out["walless"] = run
    out["script"] = script
    return out


def deli_picks(device, shapes: dict, variants: dict, where: str) -> None:
    """Fail unless a path's deli launches went to the variant each launch
    shape picks."""
    from fluidframework_tpu_torch.ops import sequencer_cuda as seqc
    limit = seqc.smem_limit(device)
    want: dict = {}
    for (b, k, c), n in shapes.items():
        v = seqc.deli_variant(b, k, c, limit)
        want[v] = want.get(v, 0) + n
    check(variants == want, f"{where} launched the deli's variants "
          f"{variants}, its shapes pick {want}")


# -- phase 4b: the durable path ----------------------------------------------------

#: The durable path checkpoints after the joins (the genesis head) and
#: before this tick; recover() restores the later head.
DURABLE_HEAD_TICK = 4
#: A fresh client joins this many sampled docs of the recovered stack.
DURABLE_JOIN_DOCS = 64


def serve_durable(device, script, root: pathlib.Path, hooks: dict,
                  ticks_ctx=contextlib.nullcontext) -> dict:
    """Serve ``script`` as ``serve`` does, crash-safe: a group-commit WAL
    under ``root/spill``, a git snapshot store under ``root/git``, the
    flush threshold at one tick's docs (each tick runs as soon as its
    frames are in, the group commit of tick N overlapping tick N+1), a
    checkpoint after the joins and one before tick ``DURABLE_HEAD_TICK``.
    ``hooks`` collects each checkpoint's seconds, the fsyncs, and each
    frame's submit and ack times and the watermark at its push."""
    from fluidframework_tpu_torch.server.durable_store import \
        GitSnapshotStore
    hooks.update(checkpoint_s=[], fsyncs=0, sent={}, pushed={})

    def before_tick(storm, tick):
        if tick == 0:
            # Count every fsync of the tick WAL (the writer thread's).
            hooks["wal"] = storm._group_wal
            log = storm._group_wal._log
            real_sync = log.sync

            def counted():
                hooks["fsyncs"] += 1
                real_sync()
            log.sync = counted
        if tick in (0, DURABLE_HEAD_TICK):
            t0 = time.perf_counter()
            storm.checkpoint()
            hooks["checkpoint_s"].append(time.perf_counter() - t0)

    def on_push(rid, ack):
        hooks["pushed"][rid] = (time.perf_counter(),
                                hooks["wal"].durable_len)

    def on_submit(rid):
        hooks["sent"][rid] = time.perf_counter()
    return serve(device, script, DOCS,
                 storm_kw=dict(spill_dir=str(root / "spill"),
                               durability="group",
                               snapshots=GitSnapshotStore(root / "git")),
                 threshold=DOCS, before_tick=before_tick, on_push=on_push,
                 on_submit=on_submit, ticks_ctx=ticks_ctx)


def tick_of(rid) -> int:
    return TICKS if rid == "resend" else rid // FRAMES_PER_TICK


def map_planes_by_doc(merge_host, names, device):
    """The map planes' rows of ``names``, in that order."""
    import torch

    from fluidframework_tpu_torch.server.merge_host import ChannelKey
    rows = torch.tensor([merge_host._map_rows[ChannelKey(
        n, "default", "root")].row for n in names], device=device)
    return [plane.index_select(0, rows) for plane in merge_host._xstate]


def read_blobs_once(storm) -> None:
    """Serve each tick blob's read once for the rest of ``storm``'s life:
    the checks' ``records_overlapping`` parses a whole blob a doc and a
    tick (as the reference does), 42 MB at this width."""
    import functools
    storm._read_blob = functools.lru_cache(maxsize=None)(storm._read_blob)


def record_key(messages) -> list:
    return [(m.sequence_number, m.client_sequence_number, m.client_id,
             m.reference_sequence_number, m.minimum_sequence_number,
             json.dumps(m.contents, sort_keys=True)) for m in messages]


def durable_path(device, walless: dict, script) -> dict:
    """BASELINE config 3 served crash-safe (group-commit WAL, acks after
    fsync, checkpoints), held to the WAL-less run of ``main_path`` in this
    call; then a fresh stack on the card recovers it (the tick-4 head,
    the WAL tail replayed through the serving tick) and is held to the
    live durable stack; then a fresh client joins 64 sampled docs of both
    stacks through the deli."""
    import itertools
    import shutil
    import tempfile

    import numpy as np
    import torch

    from fluidframework_tpu_torch.native import _NativeOpLog
    from fluidframework_tpu_torch.ops import map_fold_cuda as mfc
    from fluidframework_tpu_torch.ops import sequencer_cuda as seqc
    from fluidframework_tpu_torch.server.bus import StateStore
    from fluidframework_tpu_torch.server.durable_store import \
        GitSnapshotStore
    from fluidframework_tpu_torch.server.kernel_host import \
        KernelSequencerHost
    from fluidframework_tpu_torch.server.merge_host import KernelMergeHost
    from fluidframework_tpu_torch.server.routerlicious import \
        RouterliciousService
    from fluidframework_tpu_torch.server.storm import (
        StormController, choose_pipeline_depth, materialize_storm_records)
    root = pathlib.Path(tempfile.mkdtemp(prefix="ff-durable-"))
    try:
        hooks: dict = {}
        deli_in: dict = {}
        fold_in: dict = {}
        with recording(seqc, "process_batch_best", deli_in), \
                recording(mfc, "fold_words", fold_in):
            run = serve_durable(device, script, root, hooks)
        storm, wal = run["storm"], run["storm"]._group_wal
        base = walless["storm"]
        for name, n in run["launches"].items():
            check(n > 0, f"kernel {name} was not launched on the durable "
                  "path")
        deli_picks(device, run["shapes"]["sequencer_tick"],
                   run["deli_variants"], "the durable path")
        n_wal = len(wal)
        check(n_wal == TICKS + 1 and wal.durable_len == n_wal,
              f"the WAL holds {n_wal} records ({wal.durable_len} durable), "
              f"want {TICKS + 1}")
        for i in range(n_wal):
            check(bytes(wal.read(i)) == base._tick_blobs[i],
                  f"WAL record {i} != the WAL-less run's tick blob {i}")
        for a, b, what in ((run["seq_host"]._state,
                            walless["seq_host"]._state, "sequencer"),
                           (run["merge_host"]._xstate,
                            walless["merge_host"]._xstate, "map")):
            for f, x, y in zip(a._fields, a, b):
                check(torch.equal(x, y), f"{what} plane {f}: durable run "
                      "!= WAL-less run")
        ra, rb = ack_rows(run["acks"]), ack_rows(walless["acks"])
        check(ra.keys() == rb.keys() and all(
            len(ra[r]) == 1 and len(rb[r]) == 1
            and np.array_equal(ra[r][0], rb[r][0]) for r in ra),
            "acks: durable run != WAL-less run")
        for rid, (p,) in run["acks"].items():
            tick = tick_of(rid)
            check("error" not in p and p["dw"] > tick,
                  f"frame {rid} of tick {tick} acked with dw {p.get('dw')}")
            check(hooks["pushed"][rid][1] > tick,
                  f"frame {rid} of tick {tick} was acked before its fsync "
                  f"(durable watermark {hooks['pushed'][rid][1]} at push)")
        check(storm.stats == base.stats, "durable stats != WAL-less stats")
        oplog = "native" if isinstance(wal._log, _NativeOpLog) \
            else "python"
        led = storm.ledger.records()[:TICKS]

        def p50(stage):
            xs = sorted(r[stage] for r in led)
            return xs[len(xs) // 2] / 1e6
        lat = sorted(1e3 * (hooks["pushed"][rid][0] - hooks["sent"][rid])
                     for rid in hooks["pushed"])
        att = storm.ledger.attribution()
        commit = att.get("wal_commit_wait", {}).get("total_ms", 0.0)
        dispatch = att.get("device_dispatch", {}).get("total_ms", 0.0)
        serve_s = run["t_serve"] - sum(hooks["checkpoint_s"])
        names = run["names"]
        sample = np.linspace(0, DOCS - 1, 64).astype(int).tolist()
        t_checks = time.perf_counter()
        read_blobs_once(storm)
        live = {
            "cps": run["seq_host"].checkpoint_all(),
            "maps": map_planes_by_doc(run["merge_host"], names, device),
            "counter": run["service"].store.get("client_counter"),
            "recs": {names[d]: storm.records_overlapping(names[d], 0)
                     for d in sample}}
        # One materialization over every sampled doc's records: each
        # tick's blob is read once.
        live["msgs"] = record_key(materialize_storm_records(
            [r for recs in live["recs"].values() for r in recs],
            "default", "root", storm.read_tick_words))
        phase_s = {"serve_checks": time.perf_counter() - t_checks}
        wal_bytes = (root / "spill" / "storm_tick_words.log").stat().st_size
        wal.close()

        # Recover on a fresh stack on the card. The service resumes the
        # client counter the live one reached (what its durable state
        # store would carry across a restart), so new clients get new ids.
        store = StateStore()
        store.put("client_counter", live["counter"])
        seq2 = KernelSequencerHost(num_slots=CLIENTS, initial_capacity=DOCS,
                                   device=device)
        merge2 = KernelMergeHost(flush_threshold=10**9, row_capacity=DOCS,
                                 device=device)
        svc2 = RouterliciousService(merge_host=merge2,
                                    batched_deli_host=seq2, auto_pump=False,
                                    store=store)
        storm2 = StormController(
            svc2, seq2, merge2, flush_threshold_docs=DOCS,
            max_key_slots=KEY_SLOTS, pipeline_depth=1,
            spill_dir=str(root / "spill"), durability="group",
            snapshots=GitSnapshotStore(root / "git"))
        deli_rec: dict = {}
        fold_rec: dict = {}
        mfc.launches = seqc.launches = 0
        mfc.shapes.clear()
        seqc.shapes.clear()
        with recording(seqc, "process_batch_best", deli_rec), \
                recording(mfc, "fold_words", fold_rec):
            t0 = time.perf_counter()
            info = storm2.recover()
            torch.cuda.synchronize()
            recover_s = time.perf_counter() - t0
            joined = [names[d] for d in sample[:DURABLE_JOIN_DOCS]]
            clock = itertools.count(1 << 24, 3)
            svc2._clock = lambda: next(clock)
            for n in joined:
                svc2.connect(n, lambda m: None)
            svc2.pump()
            torch.cuda.synchronize()
        rec_launches = {"map_fold": mfc.launches,
                        "sequencer_tick": seqc.launches}
        rec_shapes = {"map_fold": dict(mfc.shapes),
                      "sequencer_tick": dict(seqc.shapes)}
        check(info["restored_from"] is not None
              and info["replayed_ticks"] == n_wal - DURABLE_HEAD_TICK,
              f"recover() {info}: want the tick-{DURABLE_HEAD_TICK} head and "
              f"{n_wal - DURABLE_HEAD_TICK} replayed ticks")
        for name, n in rec_launches.items():
            check(n > 0, f"kernel {name} was not launched on the recover "
                  "path")
        t_checks = time.perf_counter()
        read_blobs_once(storm2)
        # The recovered planes, per doc (a recovered host lays its rows
        # out in the snapshot's doc order, the live one in join order).
        for f, x, y in zip(merge2._xstate._fields, live["maps"],
                           map_planes_by_doc(merge2, names, device)):
            check(torch.equal(x, y), f"recovered map plane {f} != live")
        got = {n: storm2.records_overlapping(n, 0) for n in live["recs"]}
        for n, recs in live["recs"].items():
            check(got[n] == recs, f"recovered records of {n} != live")
            check(merge2.map_entries(n, "default", "root")
                  == run["merge_host"].map_entries(n, "default", "root"),
                  f"recovered map_entries({n}) != live")
        check(record_key(materialize_storm_records(
            [r for recs in got.values() for r in recs], "default", "root",
            storm2.read_tick_words)) == live["msgs"],
            "recovered messages of the sampled docs != live")
        cps = seq2.checkpoint_all()
        check({n: cp for n, cp in cps.items() if n not in joined}
              == {n: cp for n, cp in live["cps"].items()
                  if n not in joined},
              "recovered sequencer checkpoints != live")
        # The same clients join the live durable stack's docs: the deli
        # on its rows and on the recovered rows must agree.
        clock_live = itertools.count(1 << 24, 3)
        run["service"]._clock = lambda: next(clock_live)
        for n in joined:
            run["service"].connect(n, lambda m: None)
        run["service"].pump()
        live_cps = run["seq_host"].checkpoint_all()
        check(all(cps[n] == live_cps[n] for n in joined)
              and all(len(cps[n].clients) == CLIENTS + 1 for n in joined),
              "sequencer rows after a join: recovered != live")
        phase_s["recover_checks"] = time.perf_counter() - t_checks
        storm2._group_wal.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out = {"ticks": TICKS, "docs": DOCS, "k": K_MAP, "depth": 1,
           "serve_s": serve_s, "ticks_per_s": TICKS / serve_s,
           "merged_ops_per_s": TICKS * DOCS * K_MAP / serve_s,
           "wal_commit_wait_ms": p50("wal_commit_wait"),
           "device_dispatch_ms": p50("device_dispatch"),
           "wal_append_ms": p50("wal_append"),
           "scatter_ms": p50("scatter"), "readback_ms": p50("readback"),
           "harvest_ms": p50("ack_pack") + p50("fanout_publish")
           + p50("wal_append"),
           "ack_latency_ms": {"p50": lat[len(lat) // 2],
                              "p99": lat[min(len(lat) - 1,
                                             int(0.99 * len(lat)))]},
           "wal_bytes": wal_bytes, "fsyncs": hooks["fsyncs"],
           "checkpoint_s": hooks["checkpoint_s"], "recover_s": recover_s,
           "replayed_ticks": info["replayed_ticks"], "oplog": oplog,
           "auto_depth": choose_pipeline_depth(att, 1),
           "commit_over_dispatch": commit / dispatch if dispatch else None,
           "check_s": phase_s,
           "launches": run["launches"], "recover_launches": rec_launches}
    print("durable_path: " + json.dumps(out), flush=True)
    out.update(shapes=run["shapes"], deli_variants=run["deli_variants"],
               fold_variants=run["fold_variants"], deli_inputs=deli_in,
               fold_inputs=fold_in, recover_shapes=rec_shapes,
               recover_deli_inputs=deli_rec, recover_fold_inputs=fold_rec)
    return out


def chaos_smoke(device) -> dict:
    """One kill on the card: the chaos harness's twin and killed lives
    serve on ``device``; the killed run must recover to the twin's
    digest with no acked op lost."""
    import shutil
    import tempfile

    from fluidframework_tpu_torch.tools import chaos
    tmp = tempfile.mkdtemp(prefix="ff-chaos-")
    try:
        t0 = time.perf_counter()
        try:
            report = chaos.run_chaos(tmp, "wal.pre_fsync", kill_hits=2,
                                     device=device.type, seed=0, docs=64,
                                     k=256, ticks=5, cp_every=2,
                                     timeout=300)
        except AssertionError as err:
            fail(f"chaos run on the card: {str(err)[:2000]}")
        seconds = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(report["killed"] and report["lives"] >= 2,
          f"the chaos run did not kill and recover: {report['lives']} "
          "lives")
    out = {key: report[key] for key in (
        "kill_point", "kill_hits", "killed", "lives", "acked_rounds",
        "docs", "k", "ticks", "device")}
    out["seconds"] = seconds
    print("chaos_smoke: " + json.dumps(out), flush=True)
    return out


# -- the text kernels against their plain versions -----------------------------


def merge_ticks(rng, b, k, ticks, clients, head=0.0):
    """Op batches (numpy fields) of ``ticks`` ticks for ``b`` docs:
    inserts, removes and annotates from ``clients`` writers at the tick's
    head ref minus a small lag (so earlier ticks' blocks are cold and this
    tick's are hot), positions inside a tracked visible length; a
    ``head`` fraction of inserts lands at position 0."""
    import numpy as np

    from fluidframework_tpu_torch.ops import mergetree_kernel as mtk
    length = np.zeros(b, np.int64)
    seq = np.zeros(b, np.int64)
    pool = np.zeros(b, np.int64)
    out = []
    for _ in range(ticks):
        f = {n: np.zeros((b, k), np.int32) for n in mtk.MergeOpBatch._fields}
        f["valid"] = rng.random((b, k)) < 0.95
        ref0 = seq.copy()
        for j in range(k):
            seq += 1
            r = rng.random(b)
            kind = np.where((length > 4) & (r < 0.3), mtk.MT_REMOVE,
                            np.where((length > 4) & (r < 0.38),
                                     mtk.MT_ANNOTATE, mtk.MT_INSERT))
            pos = (rng.random(b) * (length + 1)).astype(np.int64)
            pos = np.where((kind == mtk.MT_INSERT)
                           & (rng.random(b) < head), 0, pos)
            end = np.minimum(pos + rng.integers(1, 9, b), length)
            tlen = rng.integers(1, 9, b)
            f["kind"][:, j] = kind
            f["pos"][:, j] = pos
            f["end"][:, j] = end
            f["seq"][:, j] = seq
            f["ref_seq"][:, j] = np.maximum(ref0 - rng.integers(0, 3, b), 0)
            f["client"][:, j] = rng.integers(0, clients, b)
            f["pool_start"][:, j] = pool
            f["text_len"][:, j] = tlen
            f["prop_key"][:, j] = rng.integers(0, 4, b)
            f["prop_val"][:, j] = rng.integers(0, 5, b)
            v = f["valid"][:, j]
            ins = v & (kind == mtk.MT_INSERT)
            rem = v & (kind == mtk.MT_REMOVE)
            length += np.where(ins, tlen, 0) - np.where(rem, end - pos, 0)
            pool += np.where(ins, tlen, 0)
        out.append(f)
    return out


def op_batch(fields, device):
    import torch

    from fluidframework_tpu_torch.ops import mergetree_kernel as mtk
    return mtk.MergeOpBatch(**{n: torch.from_numpy(fields[n]).to(device)
                               for n in mtk.MergeOpBatch._fields})


def check_blocks_tick(device, k=TEXT_K, head=0.0, fill_ticks=2,
                      time_it=True, b=TEXT_DOCS, nb=TEXT_NB,
                      bk=TEXT_BK) -> dict:
    """Kernel 3 against its plain version on one tick of shape (B, K,
    NB, Bk, P, W) = (b, k, nb, bk, TEXT_P, TEXT_W), from a table that
    ``fill_ticks`` plain ticks part filled (hot and cold blocks mix):
    every plane, summary and the overflow index must be equal, in the
    variant the shape picks and, where that is the shared-memory one, in
    the global-memory one too (timed beside it: ``ms_global``)."""
    import numpy as np
    import torch
    p, w = TEXT_P, TEXT_W

    from fluidframework_tpu_torch.ops import mergetree_blocks as mtb
    from fluidframework_tpu_torch.ops import mergetree_blocks_cuda as mtbc
    rng = np.random.default_rng(b + 7 * k + nb * bk + p + w)
    ticks = merge_ticks(rng, b, k, fill_ticks + 1, 32 * w, head)
    state = mtb.init_state(b, nb, bk, p, w, device)
    for f in ticks[:-1]:
        state, _ = mtb.apply_tick_blocks(state, op_batch(f, device))
    ops = op_batch(ticks[-1], device)
    variant = mtbc.choose_variant(nb, bk, p, w, k, mtbc.smem_limit(device))
    want, want_ovf = mtb.apply_tick_blocks(state, ops)
    err = 0
    for v in (variant, "global") if variant == "smem" else (variant,):
        got, got_ovf = mtbc.apply_tick_blocks_best(state, ops, v)
        torch.cuda.synchronize()
        err = max(err, max_abs_err(got, want),
                  max_abs_err([got_ovf], [want_ovf]))
        check(err == 0, f"block merge kernel ({v}) != plain version at "
              f"{(b, k, nb, bk, p, w)} (max |err| {err})")
    overflowed = int((want_ovf != int(mtb.OVF_NONE)).sum())
    out = {"shape": [b, k, nb, bk, p, w], "variant": variant,
           "max_abs_err": err, "overflowed_docs": overflowed}
    if time_it:
        out["ms"] = cuda_time_ms(
            lambda: mtbc.apply_tick_blocks_best(state, ops), 10)
        if variant == "smem":
            out["ms_global"] = cuda_time_ms(
                lambda: mtbc.apply_tick_blocks_best(state, ops, "global"), 10)
        out["plain_ms"] = cuda_time_ms(
            lambda: mtb.apply_tick_blocks(state, ops), 1)
        out["bound_ms"], out["bound_by"] = blocks_bound(state, ops)
    print(f"kernel mergetree_blocks: {json.dumps(out)}", flush=True)
    return out


def blocks_bound(state, ops) -> tuple[float, str]:
    """Kernel 3's bound on these inputs: the table and summaries in and
    out once, the op planes and the overflow index once; 12 integer ops
    per slot per valid op."""
    b, nb, bk = state.length.shape
    p, w, k = state.prop_val.shape[3], state.rem_overlap.shape[3], \
        ops.kind.shape[1]
    state_bytes = b * nb * bk * (6 + p + w) * 4 + b * nb * 4 * 4 + b * 4
    nbytes = 2 * state_bytes + b * k * (10 * 4 + 1) + b * 4
    return bound(nbytes, 12 * int(ops.valid.sum()) * nb * bk)


def flat_bound(state, ops) -> tuple[float, str]:
    """Kernel 4's bound on these inputs: the table in and out once, the op
    planes once; 12 integer ops per slot per valid op."""
    b, s = state.length.shape
    p, w, k = state.prop_val.shape[2], state.rem_overlap.shape[2], \
        ops.kind.shape[1]
    state_bytes = b * s * (1 + (6 + p + w) * 4) + b * 4
    nbytes = 2 * state_bytes + b * k * (10 * 4 + 1)
    return bound(nbytes, 12 * int(ops.valid.sum()) * s)


def check_flat_tick(device, fill_ticks=2, time_it=True, b=TEXT_DOCS,
                    s=TEXT_NB * TEXT_BK) -> dict:
    """Kernel 4 against its plain version on one tick of shape (B, K, S,
    P, W) = (b, TEXT_K, s, TEXT_P, TEXT_W), from a table that
    ``fill_ticks`` plain ticks part filled, in the variant the shape picks
    and, where that is the shared-memory one, in the global-memory one
    too (timed beside it: ``ms_global``)."""
    import numpy as np
    import torch
    k, p, w = TEXT_K, TEXT_P, TEXT_W

    from fluidframework_tpu_torch.ops import mergetree_cuda as mtc
    from fluidframework_tpu_torch.ops import mergetree_kernel as mtk
    rng = np.random.default_rng(3 * b + k + s + p + w)
    ticks = merge_ticks(rng, b, k, fill_ticks + 1, 32 * w)
    state = mtk.init_state(b, s, p, w, device)
    for f in ticks[:-1]:
        state = mtk.apply_tick(state, op_batch(f, device))
    ops = op_batch(ticks[-1], device)
    variant = mtc.choose_variant(s, p, w, k, mtc.smem_limit(device))
    want = mtk.apply_tick(state, ops)
    err = 0
    for v in (variant, "global") if variant == "smem" else (variant,):
        got = mtc.apply_tick_best(state, ops, v)
        torch.cuda.synchronize()
        err = max(err, max_abs_err(got, want))
        check(err == 0, f"flat merge kernel ({v}) != plain version at "
              f"{(b, k, s, p, w)} (max |err| {err})")
    out = {"shape": [b, k, s, p, w], "variant": variant, "max_abs_err": err}
    if time_it:
        out["ms"] = cuda_time_ms(lambda: mtc.apply_tick_best(state, ops), 10)
        if variant == "smem":
            out["ms_global"] = cuda_time_ms(
                lambda: mtc.apply_tick_best(state, ops, "global"), 10)
        out["plain_ms"] = cuda_time_ms(lambda: mtk.apply_tick(state, ops), 1)
        out["bound_ms"], out["bound_by"] = flat_bound(state, ops)
    print(f"kernel mergetree_flat: {json.dumps(out)}", flush=True)
    return out


# -- the text main paths ---------------------------------------------------------


@contextlib.contextmanager
def plain_host_versions():
    """Swap the merge host's and the deli's kernel wrappers for their
    plain versions for the duration (the plain-version comparison run of
    the text and matrix paths)."""
    from fluidframework_tpu_torch.ops import matrix_kernel as mxk
    from fluidframework_tpu_torch.ops import mergetree_blocks as mtb
    from fluidframework_tpu_torch.ops import mergetree_kernel as mtk
    from fluidframework_tpu_torch.ops import sequencer as seqk
    from fluidframework_tpu_torch.server import kernel_host as kh
    from fluidframework_tpu_torch.server import merge_host as mh
    saved = kh.seqc, mh.mtc, mh.mtbc, mh.mxc
    kh.seqc = type("Plain", (), {
        "process_batch_best": staticmethod(seqk.process_batch)})
    mh.mtc = type("Plain", (), {"apply_tick_best": staticmethod(
        mtk.apply_tick)})
    mh.mtbc = type("Plain", (), {"apply_tick_blocks_best": staticmethod(
        mtb.apply_tick_blocks)})
    mh.mxc = type("Plain", (), {"apply_tick_best": staticmethod(
        mxk.apply_tick)})
    try:
        yield
    finally:
        kh.seqc, mh.mtc, mh.mtbc, mh.mxc = saved


@contextlib.contextmanager
def recording(mod, attr: str, kept: dict, counts=None):
    """Wrap the kernel wrapper ``mod.<attr>`` for the duration: each call
    appends a copy of its (tensor or tuple) arguments to ``kept[shape]``,
    the launch shape the wrapper counted it by (``counts.shapes``,
    ``counts`` defaulting to ``mod``). Launches are still counted by the
    wrapper alone."""
    import torch
    inner = getattr(mod, attr)
    counts = mod if counts is None else counts

    def copy(planes):
        if not isinstance(planes, tuple):
            return planes.clone()
        return type(planes)(*(copy(t) for t in planes))

    def wrapped(*args):
        inputs = tuple(copy(a) for a in args)
        seen = dict(counts.shapes)
        out = inner(*args)
        for shape, n in counts.shapes.items():
            if n != seen.get(shape, 0):
                kept.setdefault(shape, []).append(inputs)
        return out
    setattr(mod, attr, wrapped)
    try:
        yield
    finally:
        setattr(mod, attr, inner)
        if torch.cuda.is_available():
            torch.cuda.synchronize()


def union_len(starts, ends) -> int:
    covered = set()
    for a, b in zip(starts, ends):
        covered.update(range(a, b))
    return len(covered)


def text_path_a(device, plain: bool = False) -> dict:
    """BASELINE config 2: 128 clients join one doc through the service
    (the deli kernel sequences the joins), then TEXT_ROUNDS rounds in
    which every client submits one insert or remove at the round's head
    ref (the round's ops are concurrent, one per writer); each round is
    one pump, whose
    merger checkpoint flushes the merge host (one block tick)."""
    import random

    from fluidframework_tpu_torch.protocol.messages import (
        DocumentMessage,
        MessageType,
    )
    from fluidframework_tpu_torch.server.kernel_host import \
        KernelSequencerHost
    from fluidframework_tpu_torch.server.merge_host import KernelMergeHost
    from fluidframework_tpu_torch.server.routerlicious import \
        RouterliciousService
    import torch

    with plain_host_versions() if plain else contextlib.nullcontext():
        seq_host = KernelSequencerHost(num_slots=TEXT_CLIENTS,
                                       initial_capacity=1, device=device)
        merge_host = KernelMergeHost(device=device)
        service = RouterliciousService(merge_host=merge_host,
                                       batched_deli_host=seq_host,
                                       auto_pump=False)
        clock = iter(range(1000, 1 << 30, 3))
        service._clock = lambda: next(clock)
        doc = "config2"
        t0 = time.perf_counter()
        conns = [service.connect(doc, lambda m: None)
                 for _ in range(TEXT_CLIENTS)]
        service.pump()
        head = TEXT_CLIENTS  # the joins are seqs 1..128
        rng = random.Random(2)
        length = 0
        for r in range(TEXT_ROUNDS):
            starts, ends, grown = [], [], 0
            for c in conns:
                if length > 1 and rng.random() < 0.3:
                    a = rng.randrange(length)
                    b = min(length, a + rng.randint(1, 8))
                    op = {"type": "remove", "start": a, "end": b}
                    starts.append(a)
                    ends.append(b)
                else:
                    text = "".join(rng.choice("abcdefghijklmnop")
                                   for _ in range(rng.randint(1, 8)))
                    op = {"type": "insert", "pos": rng.randint(0, length),
                          "text": text}
                    grown += len(text)
                c.submit([DocumentMessage(
                    client_sequence_number=r + 1,
                    reference_sequence_number=head,
                    type=MessageType.OPERATION,
                    contents={"address": "default",
                              "contents": {"address": "text",
                                           "contents": op}})])
            service.pump()
            head += TEXT_CLIENTS
            length += grown - union_len(starts, ends)
        merge_host.flush()
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
    return {"service": service, "merge_host": merge_host,
            "seq_host": seq_host, "doc": doc, "head": head,
            "length": length, "serve_s": serve_s}


def text_path_b(device, plain: bool = False) -> dict:
    """The host at batched width: TEXT_DOCS docs, one string channel each
    and TEXT_CLIENTS writer ids; TEXT_FLUSHES flushes of TEXT_K ops per
    doc (about 70% inserts, 30% removes of 1-8 chars) from distinct
    writers at the doc's head ref, fed through ``KernelMergeHost.ingest`` then ``flush()``. In flush
    BURST_FLUSH the first BURST_DOCS docs get BURST_K inserts at position
    0 instead, so one block overflows mid-tick. Rows start in the 128-slot
    bucket. Returns the host and the sampled docs' sequenced ops."""
    import numpy as np
    import random
    import torch

    from fluidframework_tpu_torch.protocol.messages import (
        MessageType,
        SequencedDocumentMessage,
    )
    from fluidframework_tpu_torch.server.merge_host import KernelMergeHost
    letters = "".join(random.Random(0).choice("abcdefghijklmnop")
                      for _ in range(1 << 16))
    rng = np.random.default_rng(5)
    d_n = TEXT_DOCS
    names = [f"text{d}" for d in range(d_n)]
    sample = set(np.linspace(0, d_n - 1, SAMPLE_DOCS).astype(int).tolist())
    sample.update(range(4))  # burst docs too
    sampled: dict[int, list] = {d: [] for d in sample}
    length = np.zeros(d_n, np.int64)
    seq = np.zeros(d_n, np.int64)
    prev_ref = np.zeros(d_n, np.int64)
    with plain_host_versions() if plain else contextlib.nullcontext():
        host = KernelMergeHost(flush_threshold=10**9, row_capacity=d_n,
                               device=device)
        t0 = time.perf_counter()
        flush_s = 0.0
        for f in range(TEXT_FLUSHES):
            k = BURST_K if f == BURST_FLUSH else TEXT_K
            burst = np.zeros(d_n, bool)
            if f == BURST_FLUSH:
                burst[:BURST_DOCS] = True
            n_ops = np.where(burst, BURST_K, TEXT_K)
            rem = (rng.random((d_n, k)) < 0.3) & (length[:, None] > 1) \
                & ~burst[:, None]
            start = (rng.random((d_n, k)) * length[:, None]).astype(np.int64)
            end = np.minimum(start + rng.integers(1, 9, (d_n, k)),
                             length[:, None])
            pos = (rng.random((d_n, k)) * (length[:, None] + 1)).astype(
                np.int64)
            pos[burst] = 0
            tlen = rng.integers(1, 9, (d_n, k))
            off = rng.integers(0, len(letters) - 8, (d_n, k))
            # Distinct writers within a round: a writer's own earlier op
            # is visible to its later ones, which would break the shared
            # ref frame the tracked length relies on.
            client = np.argsort(rng.random((d_n, TEXT_CLIENTS)),
                                axis=1)[:, :k]
            live = np.arange(k)[None, :] < n_ops[:, None]
            # New head length: every op of a round shares one ref frame.
            lmax = int(length.max()) + 1
            diff = np.zeros((d_n, lmax + 1), np.int64)
            rows = np.broadcast_to(np.arange(d_n)[:, None], (d_n, k))
            m = rem & live
            np.add.at(diff, (rows[m], start[m]), 1)
            np.add.at(diff, (rows[m], end[m]), -1)
            gone = (np.cumsum(diff, axis=1)[:, :lmax] > 0).sum(axis=1)
            grown = np.where(~rem & live, tlen, 0).sum(axis=1)
            cols = [a.tolist() for a in (rem, start, end, pos, tlen, off,
                                         client)]
            for d in range(d_n):
                ref, msn, name = int(seq[d]), int(prev_ref[d]), names[d]
                r_d, s_d, e_d, p_d, t_d, o_d, c_d = (c[d] for c in cols)
                for j in range(int(n_ops[d])):
                    if r_d[j]:
                        op = {"type": "remove", "start": s_d[j],
                              "end": e_d[j]}
                    else:
                        op = {"type": "insert", "pos": p_d[j],
                              "text": letters[o_d[j]:o_d[j] + t_d[j]]}
                    sq = ref + j + 1
                    client_id = f"w{c_d[j]}"
                    host.ingest(name, SequencedDocumentMessage(
                        client_id=client_id, sequence_number=sq,
                        minimum_sequence_number=msn,
                        client_sequence_number=sq,
                        reference_sequence_number=ref,
                        type=MessageType.OPERATION,
                        contents={"address": "default",
                                  "contents": {"address": "text",
                                               "contents": op}}))
                    if d in sampled:
                        sampled[d].append((op, sq, ref, client_id))
            t_flush = time.perf_counter()
            host.flush()
            torch.cuda.synchronize()
            flush_s += time.perf_counter() - t_flush
            prev_ref[:] = seq
            seq += n_ops
            length += grown - gone
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
    return {"merge_host": host, "names": names, "sampled": sampled,
            "length": length, "serve_s": serve_s, "flush_s": flush_s,
            "ops": int(seq.sum())}


def engine_text(ops) -> str:
    from fluidframework_tpu_torch.dds.mergetree import MergeEngine
    engine = MergeEngine(local_client=None)
    for op, sq, ref, client in ops:
        engine.apply_remote(op, sq, ref, client)
    return engine.get_text()


def text_pools_equal(a, b) -> None:
    """Every text plane of two merge hosts equal (the kernel run against
    the plain-version run)."""
    import torch
    check(sorted(a._merge_pools) == sorted(b._merge_pools),
          "text runs grew different buckets")
    for slots, pa in a._merge_pools.items():
        pb = b._merge_pools[slots]
        for f, x, y in zip(pa.state._fields, pa.state, pb.state):
            check(torch.equal(x, y), f"text pool {slots} plane {f}: kernel "
                  "run != plain run")
    check(a.stats == b.stats, f"text stats differ: {a.stats} vs {b.stats}")


def text_main_path(device) -> dict:
    """Both text paths with the kernels (launch counts zeroed just before
    each and read just after), checked against MergeEngine replays and
    against a second run of each on the plain versions."""
    import torch

    from fluidframework_tpu_torch.ops import mergetree_blocks_cuda as mtbc
    from fluidframework_tpu_torch.ops import mergetree_cuda as mtc
    from fluidframework_tpu_torch.ops import sequencer_cuda as seqc
    from fluidframework_tpu_torch.protocol.messages import MessageType
    launches: dict = {}
    shapes: dict = {"mergetree_blocks": {}, "mergetree_flat": {},
                    "sequencer_tick": {}}
    inputs: dict = {"mergetree_blocks": {}, "mergetree_flat": {}}
    deli: dict = {}
    out: dict = {}
    for name, drive in (("a", text_path_a), ("b", text_path_b)):
        for mod in (mtc, mtbc, seqc):
            mod.launches = 0
            mod.shapes.clear()
        mtbc.variants.update(smem=0, **{"global": 0})
        mtc.variants.update(smem=0, **{"global": 0})
        seqc.variants.clear()
        deli[name] = {"inputs": {}}
        with recording(mtbc, "apply_tick_blocks_best",
                       inputs["mergetree_blocks"]), \
                recording(mtc, "apply_tick_best", inputs["mergetree_flat"]), \
                recording(seqc, "process_batch_best", deli[name]["inputs"]):
            run = drive(device)
        torch.cuda.synchronize()
        launches[name] = {"mergetree_blocks": mtbc.launches,
                          "mergetree_flat": mtc.launches,
                          "sequencer_tick": seqc.launches,
                          "mergetree_blocks_variants": dict(mtbc.variants),
                          "mergetree_flat_variants": dict(mtc.variants),
                          "sequencer_tick_variants": dict(seqc.variants)}
        deli[name]["shapes"] = dict(seqc.shapes)
        deli_picks(device, seqc.shapes, seqc.variants, f"text path {name}")
        for key, mod in (("mergetree_blocks", mtbc), ("mergetree_flat", mtc),
                         ("sequencer_tick", seqc)):
            for shape, n in mod.shapes.items():
                shapes[key][shape] = shapes[key].get(shape, 0) + n
        host = run["merge_host"]
        if name == "a":
            msgs = [m for m in run["service"].get_deltas(run["doc"], 0)
                    if m.type == MessageType.OPERATION]
            check(len(msgs) == TEXT_CLIENTS * TEXT_ROUNDS,
                  f"config 2 sequenced {len(msgs)} of "
                  f"{TEXT_CLIENTS * TEXT_ROUNDS} ops")
            want = engine_text([
                (m.contents["contents"]["contents"], m.sequence_number,
                 m.reference_sequence_number, m.client_id) for m in msgs])
            got = host.text(run["doc"], "default", "text")
            check(got == want, "config 2: merge_host.text() != MergeEngine "
                  "replay of get_deltas")
            check(len(got) == run["length"], "config 2: text length "
                  f"{len(got)} != tracked {run['length']}")
            check(launches["a"]["sequencer_tick"] > 0,
                  "the deli kernel did not run on text path A")
        else:
            for d, ops in run["sampled"].items():
                got = host.text(run["names"][d], "default", "text")
                check(got == engine_text(ops), f"text of doc {d} != "
                      "MergeEngine replay")
                check(len(got) == int(run["length"][d]),
                      f"doc {d}: text length != tracked")
            check(host.stats["block_overflow_replays"] > 0,
                  "no block overflowed on text path B")
        check(launches[name]["mergetree_blocks"] > 0,
              f"block merge kernel not launched on text path {name}")
        check(mtbc.variants["smem"] == mtbc.launches,
              f"text path {name} launched the block tick's global variant "
              f"({mtbc.variants}): its rows fit shared memory")
        limit = mtc.smem_limit(device) if mtc.launches else 0
        picked = {"smem": 0, "global": 0}
        for (_b, kk, ss, pp, ww), n in mtc.shapes.items():
            picked[mtc.choose_variant(ss, pp, ww, kk, limit)] += n
        check(mtc.variants == picked,
              f"text path {name} launched the flat tick's variants "
              f"{mtc.variants}, its shapes pick {picked}")
        plain = drive(device, plain=True)
        text_pools_equal(host, plain["merge_host"])
        if name == "a":
            for f, x, y in zip(run["seq_host"]._state._fields,
                               run["seq_host"]._state,
                               plain["seq_host"]._state):
                check(torch.equal(x, y), f"config 2 deli plane {f}: kernel "
                      "run != plain run")
        out[name] = {"serve_s": run["serve_s"],
                     "plain_serve_s": plain["serve_s"],
                     "stats": host.stats, "launches": launches[name]}
        if name == "b":
            out[name].update(ops=run["ops"], flush_s=run["flush_s"],
                             ops_per_s=run["ops"] / run["serve_s"])
    check(launches["b"]["mergetree_flat"] > 0,
          "flat merge kernel not launched (no overflow replay)")
    out["a"]["ops"] = TEXT_CLIENTS * TEXT_ROUNDS
    out["a"]["ops_per_s"] = out["a"]["ops"] / out["a"]["serve_s"]
    print("text_main_path: " + json.dumps(out), flush=True)
    print("text_main_path_shapes: " + json.dumps(
        {name: [[*shape, n] for shape, n in sorted(by.items())]
         for name, by in shapes.items()}), flush=True)
    return {"launches": launches, "shapes": shapes, "inputs": inputs,
            "deli": deli, "paths": out}


def recheck_recorded(name: str, shapes: dict, inputs: dict, kernel, plain,
                     bound_of,
                     ops_of=lambda args: int(args[1].valid.sum()),
                     other=None, other_name: str = "global",
                     time_all: bool = False) -> dict:
    """Hold a kernel against its plain version on the inputs of EVERY call
    the main paths made to it, at every shape, and time it on every call
    (``by_call``: each call's shape and ms, with ``other``'s ms). ms,
    plain ms and bound are means per launch over the calls of the shape
    with the most launches (over every call where ``time_all``); the
    error is the largest over every check. Each call's arguments are
    passed as recorded; ``ops_of`` counts the ops of one call's
    arguments. ``other`` is the kernel's other variant (``other_name``:
    the global-memory one where the paths ran the shared-memory one): it
    is held to the plain version on the same inputs and timed on the
    same calls in this call (``ms_<other_name>``)."""
    import torch
    check(bool(shapes) and {sh: len(c) for sh, c in inputs.items()}
          == shapes, f"{name}: launches by shape {shapes}, inputs kept "
          f"{ {sh: len(c) for sh, c in inputs.items()} }")
    worst = 0
    for shape in sorted(shapes):
        for args in inputs[shape]:
            want = plain(*args)
            for run in (kernel, other) if other else (kernel,):
                got = run(*args)
                torch.cuda.synchronize()
                err = max_abs_err(got, want)
                check(err == 0, f"{name} kernel != plain version on the main "
                      f"path's inputs at {shape} (max |err| {err})")
                worst = max(worst, err)
    top = max(shapes, key=lambda sh: shapes[sh])
    by_call = []
    for shape in sorted(shapes):
        for args in inputs[shape]:
            by_call.append([*shape, cuda_time_ms(lambda: kernel(*args), 3),
                            *([cuda_time_ms(lambda: other(*args), 3)]
                              if other else [])])
    n = len(top)
    summed = [row for row in by_call if time_all or tuple(row[:n]) == top]
    calls = [c for sh in sorted(shapes) for c in inputs[sh]
             if time_all or sh == top]
    ms = [row[n] for row in summed]
    ms_other = [row[n + 1] for row in summed] if other else []
    plain_ms = [cuda_time_ms(lambda: plain(*args), 1) for args in calls]
    bounds = [bound_of(*args) for args in calls]
    by = [b for _, b in bounds]
    key = f"ms_{other_name}"
    out = {"shape": list(top), "max_abs_err": worst,
           "shapes_checked": len(shapes),
           "calls_checked": sum(shapes.values()),
           "calls_timed": len(calls),
           "valid_ops_mean": sum(ops_of(args) for args in calls)
           / len(calls),
           "ms": sum(ms) / len(ms), "ms_min": min(ms), "ms_max": max(ms),
           "plain_ms": sum(plain_ms) / len(plain_ms),
           **({key: sum(ms_other) / len(ms_other),
               f"{key}_min": min(ms_other),
               f"{key}_max": max(ms_other)} if other else {}),
           "bound_ms": sum(b for b, _ in bounds) / len(bounds),
           "bound_by": max(set(by), key=by.count), "by_call": by_call}
    print(f"kernel {name} on the main path's inputs: {json.dumps(out)}",
          flush=True)
    return out


def steps_breakdown(calls) -> dict:
    """Kernel 6's time split on the step path's recorded calls (those the
    re-check timed), both variants: the calls as recorded, with every
    cell run removed (the walks alone: ``walks``) and with every vector op
    removed (the frames, lookups and cell writes alone: ``cells``)."""
    import torch

    from fluidframework_tpu_torch.ops import matrix_cuda as mxc
    out = {}
    for name, edit in (("walks", lambda b: b._replace(
            r_valid=torch.zeros_like(b.r_valid))),
                       ("cells", lambda b: b._replace(
                           vec_valid=torch.zeros_like(b.vec_valid)))):
        cut = [(st, edit(b)) for st, b in calls]
        out[name] = {v: sum(cuda_time_ms(
            lambda: mxc.apply_tick_steps_best(st, b, v), 3)
            for st, b in cut) / len(cut) for v in ("smem", "global")}
    print(f"kernel matrix_steps breakdown: {json.dumps(out)}", flush=True)
    return out


def blocks_planes(tick):
    """A block tick's result as one list of planes: the state, then the
    overflow index."""
    def run(state, ops):
        new, ovf = tick(state, ops)
        return [*new, ovf]
    return run


# -- the matrix kernels against their plain versions ----------------------------


def matrix_ticks(rng, b, k, ticks, clients, lag=3):
    """Matrix op batches (numpy fields) of ``ticks`` ticks for ``b`` docs,
    in the mix of the reference's matrix benchmark (70% cells, 10% row
    inserts, 10% col inserts, 5% row and 5% col removes; an axis with
    fewer than three live entries takes an insert instead), each op at a
    ref up to ``lag`` seqs back; cell rows may fall one past the end."""
    import numpy as np

    from fluidframework_tpu_torch.ops import matrix_kernel as mxk
    from fluidframework_tpu_torch.ops import mergetree_kernel as mtk
    size = np.zeros((2, b), np.int64)  # live rows, cols
    nxt = np.zeros((2, b), np.int64)   # next handle per axis
    seq = np.zeros(b, np.int64)
    out = []
    for _ in range(ticks):
        f = {n: np.zeros((b, k), np.int32) for n in mxk.MatrixOpBatch._fields}
        f["valid"] = rng.random((b, k)) < 0.95
        for j in range(k):
            seq += 1
            r = rng.random(b)
            cell = (r < 0.7) & (size[0] > 0) & (size[1] > 0)
            axis = np.where((r < 0.8) | (size[0] == 0), 0,
                            np.where((r < 0.9) | (size[1] == 0), 1,
                                     np.where(r < 0.95, 0, 1)))
            ax_size = size[axis, np.arange(b)]
            remove = ~cell & (r >= 0.9) & (ax_size >= 3)
            pos = np.where(remove, (rng.random(b) * (ax_size - 1)),
                           rng.random(b) * (ax_size + 1)).astype(np.int64)
            count = rng.integers(1, 3, b)
            f["target"][:, j] = np.where(cell, mxk.MX_CELL, axis)
            f["kind"][:, j] = np.where(remove, mtk.MT_REMOVE, mtk.MT_INSERT)
            f["pos"][:, j] = np.where(cell, 0, pos)
            f["end"][:, j] = np.where(remove, pos + 1, 0)
            f["count"][:, j] = np.where(cell | remove, 0, count)
            f["handle_base"][:, j] = np.where(cell | remove, 0,
                                              nxt[axis, np.arange(b)])
            f["row"][:, j] = np.where(cell, (rng.random(b) * (size[0] + 1)),
                                      0).astype(np.int64)
            f["col"][:, j] = np.where(cell, (rng.random(b) * size[1]),
                                      0).astype(np.int64)
            f["value"][:, j] = np.where(cell, rng.integers(1, 1000, b), 0)
            f["seq"][:, j] = seq
            f["ref_seq"][:, j] = np.maximum(seq - rng.integers(1, lag + 1, b),
                                            0)
            f["client"][:, j] = rng.integers(0, clients, b)
            v = f["valid"][:, j]
            ins = v & ~cell & ~remove
            for a in (0, 1):
                on = axis == a
                size[a] += np.where(ins & on, count, 0) \
                    - np.where(v & remove & on, 1, 0)
                nxt[a] += np.where(ins & on, count, 0)
        out.append(f)
    return out


def matrix_batch(fields, device):
    import torch

    from fluidframework_tpu_torch.ops import matrix_kernel as mxk
    return mxk.MatrixOpBatch(**{n: torch.from_numpy(fields[n]).to(device)
                                for n in mxk.MatrixOpBatch._fields})


def matrix_bound(state, ops) -> tuple[float, str]:
    """Kernel 5's bound on these inputs: both axes and the cell table in
    and out once, the op planes once; 12 integer ops per slot for each
    valid vector op (the walk), and per valid cell op 8 per slot of each
    axis (two frames) plus 4 per cell entry (the key match)."""
    from fluidframework_tpu_torch.ops import matrix_kernel as mxk
    b, s = state.rows.length.shape
    p, w = state.rows.prop_val.shape[2], state.rows.rem_overlap.shape[2]
    c, k = state.cell_rh.shape[1], ops.kind.shape[1]
    state_bytes = 2 * (b * s * (1 + 4 * (6 + p + w)) + 4 * b) \
        + b * c * (4 * 4 + 1) + 4 * b
    nbytes = 2 * state_bytes + b * k * (12 * 4 + 1)
    cells = int((ops.valid & (ops.target == mxk.MX_CELL)).sum())
    vec = int(ops.valid.sum()) - cells
    return bound(nbytes, 12 * vec * s + cells * (2 * 8 * s + 4 * c))


def steps_bound(state, steps) -> tuple[float, str]:
    """Kernel 6's bound on these inputs: both axes and the cell table in
    and out once, the step and run planes once; 12 integer ops per slot
    for each valid vector op, 8 per slot of each axis for each frame (one
    per step with a valid cell), 4 per cell entry for each valid cell."""
    b, s = state.rows.length.shape
    p, w = state.rows.prop_val.shape[2], state.rows.rem_overlap.shape[2]
    c = state.cell_rh.shape[1]
    t, r = steps.r_valid.shape[1:]
    state_bytes = 2 * (b * s * (1 + 4 * (6 + p + w)) + 4 * b) \
        + b * c * (4 * 4 + 1) + 4 * b
    nbytes = 2 * state_bytes + b * t * (11 * 4 + 1) + b * t * r * (4 * 4 + 1)
    frames = int(steps.r_valid.any(dim=2).sum())
    cells = int(steps.r_valid.sum())
    vec = int(steps.vec_valid.sum())
    return bound(nbytes, 12 * vec * s + frames * 2 * 8 * s + cells * 4 * c)


def check_matrix_tick(device, b=MATRIX_B, k=MATRIX_K, s=MATRIX_S,
                      c=MATRIX_C, w=MATRIX_W, fill_ticks=2,
                      time_it=True, negative=False) -> dict:
    """Kernel 5 against its plain version on one tick of shape (B, K, S,
    C, W) from a state that ``fill_ticks`` plain ticks part filled (mixed
    targets, 32 W writers), in the variant the shape picks and, where that
    is the shared-memory one, in the global-memory one too: every plane
    must be equal. ``negative`` sets two docs in three to a cell count of
    -1 or -2, whose appends both variants drop as the plain version
    does."""
    import numpy as np
    import torch

    from fluidframework_tpu_torch.ops import matrix_cuda as mxc
    from fluidframework_tpu_torch.ops import matrix_kernel as mxk
    rng = np.random.default_rng(b + 5 * k + s + c + w)
    ticks = matrix_ticks(rng, b, k, fill_ticks + 1, 32 * w)
    state = mxk.init_state(b, s, c, w, device)
    for f in ticks[:-1]:
        state = mxk.apply_tick(state, matrix_batch(f, device))
    if negative:
        third = torch.arange(b, device=device) % 3
        state = state._replace(cell_count=torch.where(
            third == 0, state.cell_count, -third.to(torch.int32)))
    ops = matrix_batch(ticks[-1], device)
    variant = mxc.tick_variant(s, 1, w, c, k, mxc.smem_limit(device))
    want = mxk.apply_tick(state, ops)
    err = 0
    for v in (variant, "global") if variant == "smem" else (variant,):
        got = mxc.apply_tick_best(state, ops, v)
        torch.cuda.synchronize()
        err = max(err, max_abs_err(got, want))
        check(err == 0, f"matrix op tick kernel ({v}) != plain version at "
              f"{(b, k, s, c, w)} (max |err| {err})")
    full = int((want.cell_count >= c).sum())
    out = {"shape": [b, k, s, c, w], "variant": variant, "max_abs_err": err,
           "docs_with_a_full_cell_log": full,
           "docs_with_a_negative_count": int((state.cell_count < 0).sum()),
           "max_cell_count": int(want.cell_count.max())}
    if time_it:
        out["ms"] = cuda_time_ms(lambda: mxc.apply_tick_best(state, ops), 10)
        if variant == "smem":
            out["ms_global"] = cuda_time_ms(
                lambda: mxc.apply_tick_best(state, ops, "global"), 10)
        out["plain_ms"] = cuda_time_ms(lambda: mxk.apply_tick(state, ops), 1)
        out["bound_ms"], out["bound_by"] = matrix_bound(state, ops)
    print(f"kernel matrix_tick: {json.dumps(out)}", flush=True)
    return out


def matrix_stream(rng, n_ops: int, clients: int, lag: int) -> list[dict]:
    """One document's sequenced matrix ops in the reference benchmark's
    mix (as :func:`matrix_ticks`), each at a ref up to ``lag`` seqs
    back."""
    from fluidframework_tpu_torch.ops import matrix_kernel as mxk
    from fluidframework_tpu_torch.ops import mergetree_kernel as mtk
    ops, size, nxt = [], [0, 0], [0, 0]
    for seq in range(1, n_ops + 1):
        base = dict(seq=seq, ref_seq=max(0, seq - rng.randint(1, lag)),
                    client=rng.randrange(clients))
        r = rng.random()
        if size[0] and size[1] and r < 0.7:
            ops.append(dict(base, target=mxk.MX_CELL,
                            row=rng.randrange(size[0]),
                            col=rng.randrange(size[1]),
                            value=rng.randrange(1, 1000)))
            continue
        a = 0 if (r < 0.8 or not size[0]) else (
            1 if (r < 0.9 or not size[1]) else (0 if r < 0.95 else 1))
        if r >= 0.9 and size[a] >= 3:
            pos = rng.randrange(size[a] - 1)
            ops.append(dict(base, target=a, kind=mtk.MT_REMOVE, pos=pos,
                            end=pos + 1))
            size[a] -= 1
        else:
            n = rng.randint(1, 2)
            ops.append(dict(base, target=a, kind=mtk.MT_INSERT,
                            pos=rng.randint(0, size[a]), count=n,
                            handle_base=nxt[a]))
            size[a] += n
            nxt[a] += n
    return ops


def check_steps_tick(device, b, s, c, w, k=STEPS_K, fill_ticks=1,
                     streams=64) -> dict:
    """Kernel 6 against its plain version on one tick of the step layout
    (r_max STEPS_RMAX) from a state ``fill_ticks`` plain ticks filled,
    ``streams`` seeded streams tiled over ``b`` docs: every plane equal,
    in the variant the shape picks and, where that is the shared-memory
    one, in the global-memory one too."""
    import random

    import torch

    from fluidframework_tpu_torch.ops import matrix_cuda as mxc
    from fluidframework_tpu_torch.ops import matrix_kernel as mxk
    rng = random.Random(b + s + c + w)
    ticks = fill_ticks + 1
    ops = [matrix_stream(rng, k * ticks, 32 * w, 3) for _ in range(streams)]
    state = mxk.init_state(b, s, c, w, device)
    lvs = [0] * streams
    batch = None
    for t in range(ticks):
        chunk = [x[t * k:(t + 1) * k] for x in ops]
        steps = mxk.make_matrix_step_batch(chunk, streams, STEPS_RMAX,
                                           list(lvs), "cpu")
        batch = mxk.MatrixStepBatch(*(
            f.repeat(b // streams, *[1] * (f.dim() - 1)).to(device)
            for f in steps))
        if t < fill_ticks:
            state = mxk.apply_tick_steps(state, batch)
        for d, doc_ops in enumerate(chunk):
            for op in doc_ops:
                if op["target"] != mxk.MX_CELL:
                    lvs[d] = max(lvs[d], op["seq"])
    r = batch.r_valid.shape[2]
    variant = mxc.steps_variant(s, 1, w, c, r, mxc.smem_limit(device))
    want = mxk.apply_tick_steps(state, batch)
    err = 0
    for v in (variant, "global") if variant == "smem" else (variant,):
        got = mxc.apply_tick_steps_best(state, batch, v)
        torch.cuda.synchronize()
        err = max(err, max_abs_err(got, want))
        check(err == 0, f"matrix step kernel ({v}) != plain version at "
              f"{(b, batch.kind.shape[1], r, s, c, w)} (max |err| {err})")
    out = {"shape": [b, int(batch.kind.shape[1]), r, s, c, w],
           "variant": variant, "max_abs_err": err,
           "docs_with_a_full_cell_log": int((want.cell_count >= c).sum()),
           "max_cell_count": int(want.cell_count.max())}
    print(f"kernel matrix_steps: {json.dumps(out)}", flush=True)
    return out


def matrix_steps_path(device) -> dict:
    """Kernel 6 at the reference matrix benchmark's shape: STEPS_DOCS
    docs, STEPS_K ops per doc a tick in the step layout (r_max
    STEPS_RMAX, last_vec_seq carried across ticks), STEPS_TICKS ticks on
    an S = C = STEPS_S table; STEPS_STREAMS seeded streams tiled over the
    docs. Launch counts are zeroed just before the ticks and read just
    after. Then the same ops in the flat layout through kernel 5: the
    grids of 64 sampled docs must be equal."""
    import random

    import numpy as np
    import torch

    from fluidframework_tpu_torch.ops import matrix_cuda as mxc
    from fluidframework_tpu_torch.ops import matrix_kernel as mxk
    rng = random.Random(0)
    n, reps = STEPS_STREAMS, STEPS_DOCS // STEPS_STREAMS
    streams = [matrix_stream(rng, STEPS_K * STEPS_TICKS, 8, 3)
               for _ in range(n)]
    batches, flats, lvs = [], [], [0] * n
    for t in range(STEPS_TICKS):
        chunk = [x[t * STEPS_K:(t + 1) * STEPS_K] for x in streams]
        steps = mxk.make_matrix_step_batch(chunk, n, STEPS_RMAX, list(lvs),
                                           "cpu")
        batches.append(mxk.MatrixStepBatch(*(
            f.repeat(reps, *[1] * (f.dim() - 1)).to(device) for f in steps)))
        flat = mxk.make_matrix_op_batch(chunk, n, STEPS_K, "cpu")
        flats.append(mxk.MatrixOpBatch(*(f.repeat(reps, 1).to(device)
                                         for f in flat)))
        for d, ops in enumerate(chunk):
            for op in ops:
                if op["target"] != mxk.MX_CELL:
                    lvs[d] = max(lvs[d], op["seq"])
    state0 = mxk.init_state(STEPS_DOCS, STEPS_S, STEPS_S, 1, device)
    inputs: dict = {}
    mxc.steps.reset()
    t0 = time.perf_counter()
    with recording(mxc, "apply_tick_steps_best", inputs, mxc.steps):
        state = state0
        for batch in batches:
            state = mxc.apply_tick_steps_best(state, batch)
        torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches, shapes = mxc.steps.launches, dict(mxc.steps.shapes)
    variants = dict(mxc.steps.variants)
    check(launches == STEPS_TICKS, f"matrix step kernel launched {launches} "
          f"times in {STEPS_TICKS} ticks")
    check(variants == {"smem": STEPS_TICKS}, f"the step path launched "
          f"{variants}: its documents fit shared memory")
    flat = state0
    for batch in flats:
        flat = mxc.apply_tick_best(flat, batch)
    torch.cuda.synchronize()
    sample = np.linspace(0, STEPS_DOCS - 1, 64).astype(int).tolist()
    vals = list(range(1000))
    for d in sample:
        check(mxk.materialize_grid(state, d, vals)
              == mxk.materialize_grid(flat, d, vals),
              f"step-layout grid of doc {d} != the op tick's")
        check(mxk.materialize_grid(state, d, vals)
              == mxk.materialize_grid(state, d % n, vals),
              f"doc {d} diverged from its stream's first copy")
    ops = STEPS_DOCS * STEPS_K * STEPS_TICKS
    out = {"docs": STEPS_DOCS, "k": STEPS_K, "ticks": STEPS_TICKS,
           "r_max": STEPS_RMAX, "ops": ops, "serve_s": serve_s,
           "ops_per_s": ops / serve_s, "launches": launches,
           "variant_launches": variants,
           "cells_live_mean": float(state.cell_count.float().mean())}
    print("matrix_steps_path: " + json.dumps(out), flush=True)
    return {"launches": launches, "shapes": shapes, "inputs": inputs,
            "variants": variants, "path": out}


# -- the matrix main paths ----------------------------------------------------------


def replay_grid(ops) -> list[list]:
    """The converged grid of a scalar replay of (channel op, seq, ref,
    client) tuples: two PermutationVectors and an LWW dict, as the merge
    host's scalar route applies them."""
    from fluidframework_tpu_torch.dds.matrix import PermutationVector
    rows, cols, cells = PermutationVector(None), PermutationVector(None), {}
    for op, seq, ref, client in ops:
        if op["target"] in ("rows", "cols"):
            (rows if op["target"] == "rows" else cols).apply_remote(
                op, seq, ref, client)
        else:
            rh = rows.handle_at(op["row"], ref, client)
            ch = cols.handle_at(op["col"], ref, client)
            if rh is not None and ch is not None:
                cells[(rh, ch)] = op["value"]

    def live(vec):
        return [h for seg in vec.engine.segments if seg.removed_seq is None
                for h in seg.content]
    return [[cells.get((r, c)) for c in live(cols)] for r in live(rows)]


def matrix_path_a(device, plain: bool = False) -> dict:
    """BASELINE config 4 at its published width: MATRIX_CLIENTS clients
    join one doc through the service (the deli kernel sequences the
    joins); client 0 lays out a MATRIX_GRID x MATRIX_GRID grid (a flush
    with structural ops: kernel 5); then MATRIX_ROUNDS rounds in which
    every client sends one cell write at the round's head ref (an all-cell
    flush: the cell-run append), except every fourth round, in which 16
    clients instead insert or remove 1-4 rows or cols near the top (a
    mixed flush of MATRIX_CLIENTS ops with concurrent removes: kernel 5).
    Each round is one pump, whose merger checkpoint flushes the host."""
    import random

    import torch

    from fluidframework_tpu_torch.protocol.messages import (
        DocumentMessage,
        MessageType,
    )
    from fluidframework_tpu_torch.server.kernel_host import \
        KernelSequencerHost
    from fluidframework_tpu_torch.server.merge_host import KernelMergeHost
    from fluidframework_tpu_torch.server.routerlicious import \
        RouterliciousService

    with plain_host_versions() if plain else contextlib.nullcontext():
        seq_host = KernelSequencerHost(num_slots=MATRIX_CLIENTS,
                                       initial_capacity=1, device=device)
        merge_host = KernelMergeHost(device=device)
        service = RouterliciousService(merge_host=merge_host,
                                       batched_deli_host=seq_host,
                                       auto_pump=False)
        clock = iter(range(1000, 1 << 30, 3))
        service._clock = lambda: next(clock)
        doc = "config4"
        t0 = time.perf_counter()
        conns = [service.connect(doc, lambda m: None)
                 for _ in range(MATRIX_CLIENTS)]
        service.pump()
        cseq = [0] * MATRIX_CLIENTS

        def send(i, op, ref):
            cseq[i] += 1
            conns[i].submit([DocumentMessage(
                client_sequence_number=cseq[i], reference_sequence_number=ref,
                type=MessageType.OPERATION,
                contents={"address": "default",
                          "contents": {"address": "grid", "contents": op}})])

        head = MATRIX_CLIENTS  # the joins are seqs 1..256
        for axis in ("rows", "cols"):
            send(0, {"type": "insert", "target": axis, "pos": 0,
                     "count": MATRIX_GRID}, head)
        service.pump()
        head += 2
        size = {"rows": MATRIX_GRID, "cols": MATRIX_GRID}
        rng = random.Random(4)
        for r in range(MATRIX_ROUNDS):
            movers = set(rng.sample(range(MATRIX_CLIENTS), 16)) \
                if r % 4 == 3 else set()
            grown = {"rows": 0, "cols": 0}
            gone = {"rows": set(), "cols": set()}
            for i in range(MATRIX_CLIENTS):
                if i in movers:
                    axis = rng.choice(("rows", "cols"))
                    n = rng.randint(1, 4)
                    if rng.random() < 0.5:
                        a = rng.randrange(16)
                        op = {"type": "remove", "target": axis, "start": a,
                              "end": a + n}
                        gone[axis].update(range(a, a + n))
                    else:
                        op = {"type": "insert", "target": axis,
                              "pos": rng.randint(0, size[axis]), "count": n}
                        grown[axis] += n
                else:
                    op = {"type": "set", "target": "cell",
                          "row": rng.randrange(size["rows"]),
                          "col": rng.randrange(size["cols"]),
                          "value": rng.randrange(1 << 20)}
                send(i, op, head)
            service.pump()
            head += MATRIX_CLIENTS
            for axis in size:
                size[axis] += grown[axis] - len(gone[axis])
        merge_host.flush()
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
    return {"service": service, "merge_host": merge_host,
            "seq_host": seq_host, "doc": doc, "size": size,
            "serve_s": serve_s}


def matrix_path_b(device, plain: bool = False,
                  flushes: int | None = None) -> dict:
    """The host at batched width: MATRIX_B docs, one matrix channel each,
    MATRIX_CLIENTS writer ids. Each doc is laid out as a MATRIX_START x
    MATRIX_START grid, then takes ``flushes`` (default MATRIX_FLUSHES)
    flushes of MATRIX_K ops per doc from distinct writers at the doc's
    head ref, in the mix of :func:`matrix_ticks`, fed through
    ``KernelMergeHost.ingest`` then ``flush()``. The cell log starts at
    MATRIX_B_CELLS entries. Returns the host and the sampled docs'
    sequenced ops."""
    import numpy as np
    import torch

    from fluidframework_tpu_torch.protocol.messages import (
        MessageType,
        SequencedDocumentMessage,
    )
    from fluidframework_tpu_torch.server.merge_host import KernelMergeHost
    flushes = MATRIX_FLUSHES if flushes is None else flushes
    rng = np.random.default_rng(6)
    d_n, k = MATRIX_B, MATRIX_K
    names = [f"grid{d}" for d in range(d_n)]
    sample = set(np.linspace(0, d_n - 1, SAMPLE_DOCS).astype(int).tolist())
    sampled: dict[int, list] = {d: [] for d in sample}
    size = np.full((2, d_n), MATRIX_START, np.int64)
    seq = np.zeros(d_n, np.int64)
    prev_ref = np.zeros(d_n, np.int64)
    axes = ("rows", "cols")
    with plain_host_versions() if plain else contextlib.nullcontext():
        host = KernelMergeHost(flush_threshold=10**9, row_capacity=d_n,
                               device=device)
        host._matrix_cell_slots = MATRIX_B_CELLS  # before the lazy state

        def ingest(d, op, sq, ref, msn, client):
            host.ingest(names[d], SequencedDocumentMessage(
                client_id=client, sequence_number=sq,
                minimum_sequence_number=msn, client_sequence_number=sq,
                reference_sequence_number=ref, type=MessageType.OPERATION,
                contents={"address": "default",
                          "contents": {"address": "grid", "contents": op}}))
            if d in sampled:
                sampled[d].append((op, sq, ref, client))

        t0 = time.perf_counter()
        for d in range(d_n):
            for j, axis in enumerate(axes):
                ingest(d, {"type": "insert", "target": axis, "pos": 0,
                           "count": MATRIX_START}, j + 1, j, 0, "w0")
        seq += 2
        prev_ref[:] = 1
        flush_s = 0.0
        t_flush = time.perf_counter()
        host.flush()
        torch.cuda.synchronize()
        flush_s += time.perf_counter() - t_flush
        for _f in range(flushes):
            r = rng.random((d_n, k))
            cell = r < 0.7
            axis = np.where(r < 0.8, 0, np.where(r < 0.9, 1,
                                                 np.where(r < 0.95, 0, 1)))
            ax_size = np.take_along_axis(size.T, axis, axis=1)
            remove = ~cell & (r >= 0.9) & (ax_size >= 3)
            start = (rng.random((d_n, k)) * (ax_size - 1)).astype(np.int64)
            n_rm = rng.integers(1, 3, (d_n, k))
            end = np.minimum(start + n_rm, ax_size)
            pos = (rng.random((d_n, k)) * (ax_size + 1)).astype(np.int64)
            count = rng.integers(1, 4, (d_n, k))
            row = (rng.random((d_n, k)) * size[0][:, None]).astype(np.int64)
            col = (rng.random((d_n, k)) * size[1][:, None]).astype(np.int64)
            value = rng.integers(0, 1 << 20, (d_n, k))
            client = np.argsort(rng.random((d_n, MATRIX_CLIENTS)),
                                axis=1)[:, :k]
            # New sizes: every op of a flush shares one ref frame, so new
            # = old + inserted - |union of removed ranges|, per axis.
            lmax = int(size.max()) + 1
            for a in (0, 1):
                on = ~cell & (axis == a)
                diff = np.zeros((d_n, lmax + 1), np.int64)
                rows_ = np.broadcast_to(np.arange(d_n)[:, None], (d_n, k))
                m = on & remove
                np.add.at(diff, (rows_[m], start[m]), 1)
                np.add.at(diff, (rows_[m], end[m]), -1)
                gone = (np.cumsum(diff, axis=1)[:, :lmax] > 0).sum(axis=1)
                size[a] += np.where(on & ~remove, count, 0).sum(axis=1) - gone
            cols_ = [x.tolist() for x in (cell, axis, remove, start, end, pos,
                                          count, row, col, value, client)]
            for d in range(d_n):
                ref, msn = int(seq[d]), int(prev_ref[d])
                ce, ax, rm, st, en, po, co, ro, cl, va, wr = (
                    c[d] for c in cols_)
                for j in range(k):
                    if ce[j]:
                        op = {"type": "set", "target": "cell", "row": ro[j],
                              "col": cl[j], "value": va[j]}
                    elif rm[j]:
                        op = {"type": "remove", "target": axes[ax[j]],
                              "start": st[j], "end": en[j]}
                    else:
                        op = {"type": "insert", "target": axes[ax[j]],
                              "pos": po[j], "count": co[j]}
                    ingest(d, op, ref + j + 1, ref, msn, f"w{wr[j]}")
            t_flush = time.perf_counter()
            host.flush()
            torch.cuda.synchronize()
            flush_s += time.perf_counter() - t_flush
            prev_ref[:] = seq
            seq += k
        serve_s = time.perf_counter() - t0
    return {"merge_host": host, "names": names, "sampled": sampled,
            "size": size, "serve_s": serve_s, "flush_s": flush_s,
            "ops": int(seq.sum())}


def matrix_states_equal(a, b, what: str) -> None:
    """Every matrix plane and counter of two merge hosts equal (the
    kernel run against the plain-version run)."""
    import torch
    sa, sb = a._matrix_state, b._matrix_state
    for (f, x), y in zip(
            [(f"rows.{g}", t) for g, t in zip(sa.rows._fields, sa.rows)]
            + [(f"cols.{g}", t) for g, t in zip(sa.cols._fields, sa.cols)]
            + list(zip(sa._fields[2:], sa[2:])), leaves(sb)):
        check(torch.equal(x, y), f"{what} matrix plane {f}: kernel run != "
              "plain run")
    check(a.stats == b.stats, f"{what} stats differ: {a.stats} vs {b.stats}")


def matrix_main_path(device) -> dict:
    """Both matrix paths with the kernels (launch counts zeroed just
    before each and read just after), checked against a scalar
    PermutationVector + LWW replay and against a second run of each on
    the plain versions."""
    import torch

    from fluidframework_tpu_torch.ops import matrix_cuda as mxc
    from fluidframework_tpu_torch.ops import sequencer_cuda as seqc
    from fluidframework_tpu_torch.protocol.messages import MessageType
    launches: dict = {}
    shapes: dict = {"matrix_tick": {}, "sequencer_tick": {}}
    inputs: dict = {}
    tick_shapes: dict = {}
    deli: dict = {}
    out: dict = {}
    for name, drive in (("a", matrix_path_a), ("b", matrix_path_b)):
        mxc.tick.reset()
        mxc.steps.reset()
        seqc.launches = 0
        seqc.shapes.clear()
        seqc.variants.clear()
        inputs[name] = {}
        deli[name] = {"inputs": {}}
        with recording(mxc, "apply_tick_best", inputs[name], mxc.tick), \
                recording(seqc, "process_batch_best", deli[name]["inputs"]):
            run = drive(device)
        torch.cuda.synchronize()
        launches[name] = {"matrix_tick": mxc.tick.launches,
                          "matrix_steps": mxc.steps.launches,
                          "sequencer_tick": seqc.launches,
                          "matrix_tick_variants": dict(mxc.tick.variants),
                          "sequencer_tick_variants": dict(seqc.variants)}
        for key, by in (("matrix_tick", mxc.tick.shapes),
                        ("sequencer_tick", seqc.shapes)):
            for shape, n in by.items():
                shapes[key][shape] = shapes[key].get(shape, 0) + n
        tick_shapes[name] = dict(mxc.tick.shapes)
        deli[name]["shapes"] = dict(seqc.shapes)
        check(mxc.tick.variants.get("smem", 0) == mxc.tick.launches,
              f"matrix path {name} launched the op tick's variants "
              f"{mxc.tick.variants}: its documents fit shared memory")
        deli_picks(device, seqc.shapes, seqc.variants, f"matrix path {name}")
        host = run["merge_host"]
        if name == "a":
            msgs = [m for m in run["service"].get_deltas(run["doc"], 0)
                    if m.type == MessageType.OPERATION]
            want_n = 2 + MATRIX_CLIENTS * MATRIX_ROUNDS
            check(len(msgs) == want_n,
                  f"config 4 sequenced {len(msgs)} of {want_n} ops")
            want = replay_grid([
                (m.contents["contents"]["contents"], m.sequence_number,
                 m.reference_sequence_number, m.client_id) for m in msgs])
            got = host.matrix_grid(run["doc"], "default", "grid")
            check(got == want, "config 4: merge_host.matrix_grid() != "
                  "PermutationVector + LWW replay of get_deltas")
            check((len(got), len(got[0])) == (run["size"]["rows"],
                                              run["size"]["cols"]),
                  f"config 4: grid {len(got)} x {len(got[0])} != tracked "
                  f"{run['size']}")
            check(launches["a"]["sequencer_tick"] > 0,
                  "the deli kernel did not run on matrix path A")
            check(host.stats.get("cell_run_ticks", 0) > 0,
                  "no all-cell flush on matrix path A")
            check(32 * host._matrix_overlap_words >= MATRIX_CLIENTS,
                  f"matrix path A overlap words {host._matrix_overlap_words}")
        else:
            for d, ops in run["sampled"].items():
                got = host.matrix_grid(run["names"][d], "default", "grid")
                check(got == replay_grid(ops), f"grid of matrix doc {d} != "
                      "PermutationVector + LWW replay")
                check((len(got), len(got[0]) if got else 0)
                      == (int(run["size"][0][d]), int(run["size"][1][d])),
                      f"matrix doc {d}: grid shape != tracked")
            for stat in ("compactions",):
                check(host.stats[stat] > 0, f"no {stat} on matrix path B")
            check(host._matrix_vec_slots > 64
                  and host._matrix_cell_slots > MATRIX_B_CELLS,
                  f"matrix path B grew no vector or cell slots "
                  f"({host._matrix_vec_slots}, {host._matrix_cell_slots})")
        check(launches[name]["matrix_tick"] > 0,
              f"matrix op tick kernel not launched on matrix path {name}")
        plain = drive(device, plain=True)
        matrix_states_equal(host, plain["merge_host"], f"matrix path {name}")
        if name == "a":
            for f, x, y in zip(run["seq_host"]._state._fields,
                               run["seq_host"]._state,
                               plain["seq_host"]._state):
                check(torch.equal(x, y), f"config 4 deli plane {f}: kernel "
                      "run != plain run")
        out[name] = {"serve_s": run["serve_s"],
                     "plain_serve_s": plain["serve_s"],
                     "stats": host.stats, "launches": launches[name],
                     "vec_slots": host._matrix_vec_slots,
                     "cell_slots": host._matrix_cell_slots,
                     "overlap_words": host._matrix_overlap_words}
        if name == "b":
            out[name].update(ops=run["ops"], flush_s=run["flush_s"],
                             ops_per_s=run["ops"] / run["serve_s"])
    out["a"]["ops"] = 2 + MATRIX_CLIENTS * MATRIX_ROUNDS
    out["a"]["ops_per_s"] = out["a"]["ops"] / out["a"]["serve_s"]
    print("matrix_main_path: " + json.dumps(out), flush=True)
    print("matrix_main_path_shapes: " + json.dumps(
        {name: [[*shape, n] for shape, n in sorted(by.items())]
         for name, by in shapes.items()}), flush=True)
    return {"launches": launches, "shapes": shapes, "inputs": inputs,
            "tick_shapes": tick_shapes, "deli": deli, "paths": out}


def device_busy(prof) -> tuple[float, list]:
    """(busy ms, the six largest events) of a finished profile: the
    summed self time of every CUDA event — kernels and copies, all on
    one stream."""
    busy: dict = {}
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            # Names cut to 60 characters; equal cuts add up.
            busy[e.key[:60]] = busy.get(e.key[:60], 0.0) \
                + e.self_device_time_total / 1e3
    top = sorted(busy.items(), key=lambda kv: -kv[1])[:6]
    return sum(busy.values()), top


def trace_main_path(device) -> dict:
    """The main path's served ticks again under ``torch.profiler``: device
    busy ms against the host's wall ms over the same ticks, and the
    device events that took the most time. The profiler slows the host,
    so the idle share is an upper bound."""
    from torch.profiler import ProfilerActivity, profile

    script = make_script(7, DOCS, TICKS, K_MAP, FRAMES_PER_TICK)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    run = serve(device, script, DOCS, ticks_ctx=lambda: prof)
    busy_ms, top = device_busy(prof)
    serve_ms = run["t_serve"] * 1e3
    out = {"serve_ms": serve_ms, "device_busy_ms": busy_ms,
           "idle_share": 1 - busy_ms / serve_ms if busy_ms else None,
           "top_device_ms": top}
    print("trace: " + json.dumps(out), flush=True)
    return out


def trace_durable_path(device) -> dict:
    """The durable path's serve again under ``torch.profiler`` (its own
    temp dir, deleted after): device busy ms against the host's wall ms
    over the served ticks, the checkpoints included."""
    import shutil
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    script = make_script(7, DOCS, TICKS, K_MAP, FRAMES_PER_TICK)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    root = pathlib.Path(tempfile.mkdtemp(prefix="ff-durable-trace-"))
    try:
        run = serve_durable(device, script, root, {},
                            ticks_ctx=lambda: prof)
        run["storm"]._group_wal.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    busy_ms, top = device_busy(prof)
    serve_ms = run["t_serve"] * 1e3
    out = {"serve_ms": serve_ms, "device_busy_ms": busy_ms,
           "idle_share": 1 - busy_ms / serve_ms if busy_ms else None,
           "top_device_ms": top}
    print("trace_durable: " + json.dumps(out), flush=True)
    return out


def trace_text_paths(device) -> dict:
    """Both text paths again, each whole under ``torch.profiler``: device
    busy ms against the host's wall ms over the path (an upper bound on
    the idle share, as for the map path)."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for name, drive in (("a", text_path_a), ("b", text_path_b)):
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        with prof:
            t0 = time.perf_counter()
            drive(device)
            wall_ms = (time.perf_counter() - t0) * 1e3
        busy_ms, top = device_busy(prof)
        out[name] = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
                     "idle_share": 1 - busy_ms / wall_ms,
                     "top_device_ms": top}
    print("trace_text: " + json.dumps(out), flush=True)
    return out


def trace_matrix_paths(device) -> dict:
    """Both matrix paths again, each whole under ``torch.profiler`` (path
    B at two flushes, for the profiler's post-processing time): device
    busy ms against the host's wall ms over the path."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for name, drive in (("a", matrix_path_a),
                        ("b", lambda dev: matrix_path_b(dev, flushes=2))):
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        with prof:
            t0 = time.perf_counter()
            drive(device)
            wall_ms = (time.perf_counter() - t0) * 1e3
        busy_ms, top = device_busy(prof)
        out[name] = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
                     "idle_share": 1 - busy_ms / wall_ms,
                     "top_device_ms": top}
    print("trace_matrix: " + json.dumps(out), flush=True)
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("CUDA is not available: chip_smoke.py needs an NVIDIA card",
              file=sys.stderr)
        return 2
    if not (ROOT / "fluidframework_tpu_torch" / "csrc").is_dir():
        print("run chip_smoke.py from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    device = torch.device("cuda:0")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"device: {smi}", flush=True)

    from fluidframework_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.build_all(["map_fold", "map_fold_warp", "sequencer_tick",
                      "sequencer_tick_warp", "mergetree_flat",
                      "mergetree_flat_smem", "mergetree_blocks",
                      "mergetree_blocks_smem", "matrix_tick",
                      "matrix_tick_smem", "matrix_steps",
                      "matrix_steps_smem"])
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"({_build.BUILD_DIR})", flush=True)

    fold = check_map_fold(device)
    deli = check_deli(device)
    # A C past one block's shared memory runs the one-thread deli alone.
    deli_large = check_deli(device, b=64, k=K_SEQ, c=DELI_LARGE_C,
                            every_outcome=False, time_it=False)
    check(deli_large["variant"] == "thread",
          f"C = {DELI_LARGE_C} did not run the deli's one-thread variant")
    blocks_full = check_blocks_tick(device)
    burst = check_blocks_tick(device, k=BURST_K, head=0.9, fill_ticks=1,
                              time_it=False)
    check(burst["overflowed_docs"] > 0,
          "the burst tick overflowed no block")
    flat_full = check_flat_tick(device)
    flat_large = check_flat_tick(device, time_it=False, b=16, s=4096)
    check(flat_large["variant"] == "global",
          "4,096-slot rows did not run the flat tick's global variant")
    blocks_large = check_blocks_tick(device, time_it=False, b=256, nb=16,
                                     bk=512)
    check(blocks_large["variant"] == "global",
          "16 x 512-slot rows did not run the block tick's global variant")
    matrix_full = check_matrix_tick(device)
    matrix_clamp = check_matrix_tick(device, c=MATRIX_FULL_C, time_it=False)
    check(matrix_clamp["docs_with_a_full_cell_log"] > 0
          and matrix_clamp["variant"] == "smem",
          "the op tick's clamp check filled no cell log in shared memory")
    matrix_negative = check_matrix_tick(device, b=4096, time_it=False,
                                        negative=True)
    check(matrix_negative["docs_with_a_negative_count"] > 0
          and matrix_negative["variant"] == "smem",
          "the op tick's negative-count check ran no negative count in "
          "shared memory")
    matrix_large = check_matrix_tick(device, b=64, s=4096, c=STEPS_S, w=1,
                                     fill_ticks=1, time_it=False)
    check(matrix_large["variant"] == "global",
          "S = 4,096 did not run the op tick's global variant")
    steps_clamp = check_steps_tick(device, 4096, STEPS_S, MATRIX_FULL_C, 1)
    check(steps_clamp["docs_with_a_full_cell_log"] > 0
          and steps_clamp["variant"] == "smem",
          "the step tick's clamp check filled no cell log in shared memory")
    steps_large = check_steps_tick(device, 64, 4096, STEPS_S, 1)
    check(steps_large["variant"] == "global",
          "S = 4,096 did not run the step tick's global variant")
    path = main_path(device)
    durable = durable_path(device, path.pop("walless"), path.pop("script"))
    chaos_smoke(device)
    text = text_main_path(device)
    matrix = matrix_main_path(device)
    steps = matrix_steps_path(device)
    shapes = path["shapes"]
    from fluidframework_tpu_torch.ops import map_fold_cuda as mfc
    from fluidframework_tpu_torch.ops import map_kernel as mk
    # The fold on every call the map path made, both variants held to the
    # plain version and timed on the same calls.
    fold_main = recheck_recorded(
        "map_fold", shapes["map_fold"], path["fold_inputs"],
        mfc.fold_words, mk.fold_words_plain, fold_bound,
        ops_of=lambda args: windowed_ops(*args[1:4]),
        other=lambda *args: mfc.fold_words(*args, variant="block"),
        other_name="block")
    from fluidframework_tpu_torch.ops import sequencer as seqk
    from fluidframework_tpu_torch.ops import sequencer_cuda as seqc
    # The deli on every path that launches it, on the inputs that path
    # gave it: both variants held to the plain version and timed on the
    # same calls.
    fold_by_path = {
        key: recheck_recorded(
            f"map_fold ({key})", by, kept, mfc.fold_words,
            mk.fold_words_plain, fold_bound,
            ops_of=lambda args: windowed_ops(*args[1:4]),
            other=lambda *args: mfc.fold_words(*args, variant="block"),
            other_name="block")
        for key, by, kept in (
            ("durable", durable["shapes"]["map_fold"],
             durable["fold_inputs"]),
            ("recover", durable["recover_shapes"]["map_fold"],
             durable["recover_fold_inputs"]))}
    deli_paths = {"map": (shapes["sequencer_tick"], path["deli_inputs"]),
                  "durable": (durable["shapes"]["sequencer_tick"],
                              durable["deli_inputs"]),
                  "recover": (durable["recover_shapes"]["sequencer_tick"],
                              durable["recover_deli_inputs"])}
    for key, src in (("text_a", text["deli"]["a"]),
                     ("matrix_a", matrix["deli"]["a"])):
        deli_paths[key] = (src["shapes"], src["inputs"])
    deli_main = {}
    for key, (by, kept) in deli_paths.items():
        got = recheck_recorded(
            f"sequencer_tick ({key})", by, kept,
            lambda st, op: seqc.process_batch_best(st, op, "warp"),
            seqk.process_batch, deli_bound,
            other=lambda st, op: seqc.process_batch_best(st, op, "thread"),
            other_name="thread", time_all=True)
        got["ms_warp"] = got.pop("ms")
        for end in ("min", "max"):
            got[f"ms_warp_{end}"] = got.pop(f"ms_{end}")
        got["variant"] = seqc.deli_variant(*got["shape"],
                                           seqc.smem_limit(device))
        got["ms"] = got[f"ms_{got['variant']}"]
        deli_main[key] = got
    del path["deli_inputs"], path["fold_inputs"], text["deli"], \
        matrix["deli"]
    for key in ("deli_inputs", "fold_inputs", "recover_deli_inputs",
                "recover_fold_inputs"):
        del durable[key]
    from fluidframework_tpu_torch.ops import mergetree_blocks as mtb
    from fluidframework_tpu_torch.ops import mergetree_blocks_cuda as mtbc
    from fluidframework_tpu_torch.ops import mergetree_cuda as mtc
    from fluidframework_tpu_torch.ops import mergetree_kernel as mtk
    blocks_main = recheck_recorded(
        "mergetree_blocks", text["shapes"]["mergetree_blocks"],
        text["inputs"]["mergetree_blocks"],
        blocks_planes(mtbc.apply_tick_blocks_best),
        blocks_planes(mtb.apply_tick_blocks), blocks_bound,
        other=blocks_planes(lambda st, op: mtbc.apply_tick_blocks_best(
            st, op, "global")))
    flat_main = recheck_recorded(
        "mergetree_flat", text["shapes"]["mergetree_flat"],
        text["inputs"]["mergetree_flat"], mtc.apply_tick_best,
        mtk.apply_tick, flat_bound,
        other=lambda st, op: mtc.apply_tick_best(st, op, "global"))
    del text["inputs"]
    from fluidframework_tpu_torch.ops import matrix_cuda as mxc
    from fluidframework_tpu_torch.ops import matrix_kernel as mxk
    # Kernel 5 per matrix path, both variants on the same recorded calls:
    # path B's shape with the most launches, every call of path A.
    tick_main = {
        key: recheck_recorded(
            f"matrix_tick ({key})", matrix["tick_shapes"][name],
            matrix["inputs"][name], mxc.apply_tick_best, mxk.apply_tick,
            matrix_bound,
            other=lambda st, op: mxc.apply_tick_best(st, op, "global"),
            time_all=name == "a")
        for key, name in (("matrix_b", "b"), ("matrix_a", "a"))}
    del matrix["inputs"]
    steps_main = recheck_recorded(
        "matrix_steps", steps["shapes"], steps["inputs"],
        mxc.apply_tick_steps_best, mxk.apply_tick_steps, steps_bound,
        ops_of=lambda args: int(args[1].vec_valid.sum()
                                + args[1].r_valid.sum()),
        other=lambda st, b: mxc.apply_tick_steps_best(st, b, "global"))
    steps_split = steps_breakdown(
        steps["inputs"][max(steps["shapes"], key=steps["shapes"].get)])
    del steps["inputs"]
    if "--trace" in sys.argv[1:]:
        trace_main_path(device)
        trace_durable_path(device)
        trace_text_paths(device)
        trace_matrix_paths(device)
    # Each path's own launches, counted from 0 just before it and read
    # just after; a kernel's "launches" is their sum.
    by_path = {
        name: {"map": path["launches"].get(name, 0),
               "durable": durable["launches"].get(name, 0),
               "recover": durable["recover_launches"].get(name, 0),
               "text_a": text["launches"]["a"].get(name, 0),
               "text_b": text["launches"]["b"].get(name, 0),
               "matrix_a": matrix["launches"]["a"].get(name, 0),
               "matrix_b": matrix["launches"]["b"].get(name, 0),
               "matrix_steps": (steps["launches"]
                                if name == "matrix_steps" else 0)}
        for name in ("map_fold", "sequencer_tick", "mergetree_blocks",
                     "mergetree_flat", "matrix_tick", "matrix_steps")}
    launches = {name: sum(n.values()) for name, n in by_path.items()}
    deli_top = max(deli_main.values(), key=lambda r: r["calls_checked"])
    tick_top = tick_main["matrix_b"]
    kernels = [
        {"name": "map_fold", "route": "cuda",
         "source": "fluidframework_tpu_torch/csrc/map_fold_warp.cu",
         "block_source": "fluidframework_tpu_torch/csrc/map_fold.cu",
         "replaces": "fluidframework_tpu/ops/map_pallas.py:41",
         "launches": launches["map_fold"],
         "launches_by_path": by_path["map_fold"],
         "variant_launches": {"map": path["fold_variants"],
                              "durable": durable["fold_variants"]},
         **fold_main, "variant": mfc.fold_variant(*fold_main["shape"]),
         "max_abs_err": max([fold_main["max_abs_err"]] + [
             r["max_abs_err"] for r in fold_by_path.values()]),
         "by_path": {key: {k: r[k] for k in (
             "shape", "calls_checked", "max_abs_err", "ms", "ms_block",
             "plain_ms", "bound_ms", "bound_by")}
             for key, r in fold_by_path.items()},
         "library_ms": None,
         "at_full_size": {key: fold[key] for key in
                          ("shape", "variant", "ms", "ms_warp", "ms_block",
                           "plain_ms", "bound_ms", "max_abs_err")}},
        {"name": "sequencer_tick", "route": "cuda",
         "source": "fluidframework_tpu_torch/csrc/sequencer_tick_warp.cu",
         "thread_source": "fluidframework_tpu_torch/csrc/sequencer_tick.cu",
         "replaces": "fluidframework_tpu/ops/sequencer_pallas.py:217",
         "launches": launches["sequencer_tick"],
         "launches_by_path": by_path["sequencer_tick"],
         "variant_launches": {
             "map": path["deli_variants"],
             "durable": durable["deli_variants"],
             **{f"{p}_{n}": text["launches"][n]["sequencer_tick_variants"]
                for p, n in (("text", "a"), ("text", "b"))},
             **{f"matrix_{n}": matrix["launches"][n][
                 "sequencer_tick_variants"] for n in ("a", "b")}},
         **{key: deli_top[key] for key in (
             "shape", "variant", "ms", "ms_warp", "ms_thread", "plain_ms",
             "bound_ms", "bound_by")},
         "max_abs_err": max(r["max_abs_err"] for r in deli_main.values()),
         "by_path": deli_main, "library_ms": None,
         "at_K32": {key: deli[key] for key in
                    ("shape", "variant", "ms", "ms_warp", "ms_thread",
                     "plain_ms", "bound_ms", "max_abs_err", "nack_codes")},
         "thread_by_shape": {key: deli_large[key] for key in
                             ("shape", "variant", "max_abs_err")}},
        {"name": "mergetree_blocks", "route": "cuda",
         "source": "fluidframework_tpu_torch/csrc/mergetree_blocks_smem.cu",
         "global_source": "fluidframework_tpu_torch/csrc/mergetree_blocks.cu",
         "replaces": "fluidframework_tpu/ops/mergetree_blocks_pallas.py:73",
         "launches": launches["mergetree_blocks"],
         "launches_by_path": by_path["mergetree_blocks"],
         "variant_launches": {
             name: text["launches"][name]["mergetree_blocks_variants"]
             for name in ("a", "b")},
         **blocks_main, "library_ms": None,
         "at_full_size": {key: blocks_full[key] for key in
                          ("shape", "variant", "ms", "ms_global", "plain_ms",
                           "bound_ms")},
         "global_by_shape": {key: blocks_large[key] for key in
                             ("shape", "variant", "max_abs_err")}},
        {"name": "mergetree_flat", "route": "cuda",
         "source": "fluidframework_tpu_torch/csrc/mergetree_flat_smem.cu",
         "global_source": "fluidframework_tpu_torch/csrc/mergetree_flat.cu",
         "replaces": "fluidframework_tpu/ops/mergetree_pallas.py:274",
         "launches": launches["mergetree_flat"],
         "launches_by_path": by_path["mergetree_flat"],
         "variant_launches": {
             name: text["launches"][name]["mergetree_flat_variants"]
             for name in ("a", "b")},
         **flat_main, "library_ms": None,
         "at_full_size": {key: flat_full[key] for key in
                          ("shape", "variant", "ms", "ms_global", "plain_ms",
                           "bound_ms")},
         "global_by_shape": {key: flat_large[key] for key in
                             ("shape", "variant", "max_abs_err")}},
        {"name": "matrix_tick", "route": "cuda",
         "source": "fluidframework_tpu_torch/csrc/matrix_tick_smem.cu",
         "global_source": "fluidframework_tpu_torch/csrc/matrix_tick.cu",
         "replaces": "fluidframework_tpu/ops/matrix_pallas.py:158",
         "launches": launches["matrix_tick"],
         "launches_by_path": by_path["matrix_tick"],
         "variant_launches": {
             f"matrix_{n}": matrix["launches"][n]["matrix_tick_variants"]
             for n in ("a", "b")},
         **tick_top,
         "max_abs_err": max(r["max_abs_err"] for r in tick_main.values()),
         "by_path": tick_main, "library_ms": None,
         "at_full_size": {key: matrix_full[key] for key in
                          ("shape", "variant", "ms", "ms_global", "plain_ms",
                           "bound_ms")},
         "clamp_shape": {key: matrix_clamp[key] for key in
                         ("shape", "variant", "max_abs_err",
                          "docs_with_a_full_cell_log")},
         "negative_count": {key: matrix_negative[key] for key in
                            ("shape", "variant", "max_abs_err",
                             "docs_with_a_negative_count")},
         "global_by_shape": {key: matrix_large[key] for key in
                             ("shape", "variant", "max_abs_err")}},
        {"name": "matrix_steps", "route": "cuda",
         "source": "fluidframework_tpu_torch/csrc/matrix_steps_smem.cu",
         "global_source": "fluidframework_tpu_torch/csrc/matrix_steps.cu",
         "replaces": "fluidframework_tpu/ops/matrix_pallas.py:362",
         "launches": launches["matrix_steps"],
         "launches_by_path": by_path["matrix_steps"],
         "variant_launches": {"matrix_steps": steps["variants"]},
         **steps_main, "library_ms": None,
         "ms_by_part": steps_split,
         "clamp_shape": {key: steps_clamp[key] for key in
                         ("shape", "variant", "max_abs_err",
                          "docs_with_a_full_cell_log")},
         "global_by_shape": {key: steps_large[key] for key in
                             ("shape", "variant", "max_abs_err")}},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
