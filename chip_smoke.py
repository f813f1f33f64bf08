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
  live durable stack, and a client joins 64 docs of both (one kill,
  ``wal.pre_fsync``, of a chaos-harness serving process on the card,
  recovered to its twin's digest, runs later beside the planes);
* SharedString text serving: BASELINE.json config 2 (1 doc, 128 clients
  joined through the service, rounds of concurrent inserts and removes
  through their connections, the merger lambda feeding
  ``KernelMergeHost``), and the host at batched width (8,192 docs x 128
  writers, three flushes of K=32 ops, 64 docs bursting past a block),
  checked against a scalar ``MergeEngine`` replay and a plain-version run;
* SharedMatrix serving: BASELINE.json config 4 (a 1k x 1k grid, 256
  clients joined through the service writing cells concurrently, with
  rows and cols inserted and removed every fourth round), and the host at
  batched width (8,192 docs x 256 writers, five flushes of K=32 ops),
  checked against a scalar PermutationVector + LWW replay and a
  plain-version run; and the matrix step tick at the reference matrix
  benchmark's step layout (16,384 docs, six ticks of 64 ops), checked
  against the op tick's grids;
* SharedTree serving: BASELINE.json config 5 (subtree insert/move, 1k
  docs: 1,024 docs x 4 clients joined through the service, 6 rounds of
  one concurrent wire edit per client, bursts that exhaust a rank gap
  and two-set_value edits that leave the device), every doc's tree
  checked against a ``Transaction`` replay of its sequenced edits; and
  the tree tick (plain PyTorch: the reference's is XLA, not Pallas) at
  the reference tree benchmark's shape (8,192 docs x 256 slots, six
  ticks of K=32), checked against a scalar replay and a CPU run;
* the multi-device tier: the reference ``bench_mixed_serving``'s mixed
  population at full width (8,192 docs, a quarter each of map, text,
  matrix and tree rows, 8 of its 12 ticks, 212,992 ops a tick) through
  ``ShardedServing`` — the all-family ``_mixed_tick`` (kernels 1, 3 and
  5; kernel 2 for the joins) — on one shard (mixed A: every row held to
  its family's scalar replay and the whole run to a plain-version run;
  the staged device rate and each leg's time) and on a virtual mesh of 4
  shards of the card with 4 simulated hosts (mixed B: every plane and ack
  equal to mixed A's); and the sequence-parallel merge tick on a virtual
  mesh of 4 shards (one 65,536-slot document, held to kernel 4 and the
  flat plain tick) and a merge host whose growing config-2 document
  migrates into its sharded pool;
* the entry point (entry E, ``fluidframework_tpu_torch/entry.py``):
  ``entry()``'s fused tick (kernel 2, kernel 4, the plain map tick) at
  64 docs and at config 3's 10,240, each against its CPU run and each
  leg timed; and ``dryrun_multichip`` on 4 and 8 virtual shards of the
  card (the docs-sharded tick, one document's segment axis sharded, the
  sharded mixed serving loop: kernels 1-5), report for report equal to
  the same dry run on the CPU;
* the device-pool planes: tiered residency at the reference
  ``bench_residency_churn``'s width (a 10,000-slot pool, 10,800 docs
  ever served, 30 churn frames; every doc's map, from its device row or
  its cold snapshot, held to a numpy fold and to a no-residency twin),
  its recovery, and ``bench_residency_storm``'s hydration stampede; the
  mega-doc tier at ``bench_megadoc_writers``' widest arm (one doc, 10,000
  writers, promoted onto 8 lanes, against its single-lane twin, over the
  first 16 of its 157 waves; its text row moved into a 4-shard
  sequence-parallel pool and back) and its recovery; ``MegaDocLanes`` on
  8,192 docs over 4 virtual shards; one storm, one residency, one
  mega-doc, one live-migration and one replication kill of a
  chaos-harness process (the last one's resumed life promotes a
  follower), run beside them;
* the history plane: the reference history benches at their published
  defaults (History H: read latency by depth with and without summaries,
  spill bytes before and after compaction, fork and merge-back with and
  without a residency tier), every read held to a numpy fold and every
  head to the device row; and at config 3's width (History P, on the
  durable path's recovered stack: 16 docs forked past the pool's 10,240
  rows, served, read, compacted, then recovered by a fresh stack that
  imports the snapshot's branches and replays the ``hp`` fork controls);
* the fleet tier: the reference fleet benches (Fleet H: live-migration
  blackouts under writes, a 2 -> 4 host scale-out converged by
  ``PlacementController`` with each host served from its own thread at
  three commit latencies, quorum replication's ack latency with no, one
  and two followers), every doc held to a numpy fold of its acked
  frames; and config 3 on a ``StormCluster`` of 4 quorum-replicated hosts
  (Fleet P: a batch migration of 512 docs with its ``migrating`` and
  ``moved`` sheds, a host failed over to a promoted follower held to the
  dead leader, every doc's map held to a numpy fold);
* the read tier and the front door: the reference viewer benches (Viewer
  V: 1,000, 10,000 and 100,000 viewers on one hot doc through the viewer
  plane and the native fan-out, one encode a tick and every frame
  delivered; 64 viewers re-homed by a live migration); a read replica on
  Fleet P's stack (Read R: 128 of 256 viewer rooms of a host re-homed onto
  a replica of its follower, whose re-broadcast frames equal the leader's
  and whose reads equal numpy folds and the leader's deltas; writes and a
  mega-promoted doc shed to the leader) and the reference replica benches;
  and the front door on the durable path's recovered stack (Front door F:
  every doc's frames for two ticks through one socket of an
  ``AlfredServer``, acked as the WAL-less twin acks them in process, 64
  viewer sockets, a directory-routed viewer answered ``moved``), then
  ``python -m fluidframework_tpu_torch.server.alfred`` started as a user
  starts it and served a writer and a viewer on the card;
* the network tier: the reference ``bench_e2e_storm``'s serving path at
  its published width (Front door B: 10,240 docs, K 512, 32 slots, 8
  client processes, group durability, 4 timed ticks) through the C++
  socket bridge (``BridgeFrontDoor``) over a storm on the card (arm 0)
  and over ``launch_cluster``'s leader with 2 follower processes over
  localhost TCP (arm 1), every frame acked over the wire, every doc held
  to a numpy fold and each follower's WAL to the leader's tick log; then
  ``python -m fluidframework_tpu_torch.server.bridge_host`` started as a
  user starts it, served a writer and a viewer and scraped by
  ``python -m fluidframework_tpu_torch.tools.monitor --once``; and the
  networked fleet (Net N: the netsplit chaos soak with a ``kill -9`` of
  a leader on the card and a promotion over the wire, held to its
  fault-free twin on the card and on the CPU; the reference net benches:
  ack latency in process and over the wire, failover blackouts, parked
  writes after a heal);
* the client tier (Client C): the port's own Containers, DDSes and
  drivers served on the card. C1, BASELINE.json config 1 (clicker: two
  Containers through the tinylicious driver and a localhost socket to an
  in-process ``AlfredServer`` over the batched-cadence default service,
  ticked from one thread; a summary, then a late third client loading
  from it plus the trailing deltas); C2, the service-load-test's full
  profile (``tools/load_test.run_load("full")``: 32 docs x 8 Containers,
  102,400 ops, one deli launch a pump); C3, config 2 through 128
  Containers on a SharedString; C4, config 4 through 256 Containers on a
  1k x 1k SharedMatrix (a structural op in every round's flush). Every
  client's state is held to the merge host's device rows and to a scalar
  replay of ``get_deltas``, and every kernel 2, 3 and 5 call to its plain
  version. C5, on C1's stack, the application tier: the seven example
  apps' own ``main`` over the socket, a port Container on each doc held
  to the example clients and the merge host's rows, the gateway over
  HTTP, the headless agents under the agent scheduler, every doc's
  recording (C3's and C4's too) replayed and stepped through the debug
  tool, and ``apply_tick_runs`` on the card held to kernel 4 and to its
  CPU run (its device ms against kernel 4's).

Each phase prints its seconds (``phase <name>: ...``), and a
``phase_seconds:`` line lists them all before the device lines.

It prints each kernel's launch shapes on the main paths and re-checks
every kernel == plain at each of them, on the very inputs the paths gave
them (every call's, kept while the paths ran: the map fold on the map,
durable and recover paths; the deli on those, text path A, matrix path
A and tree path A), where
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

serves the map path's ticks (WAL-less and durable) and the text,
matrix, tree and mixed paths once more (matrix path B at two flushes,
tree path A, mixed A's front door), then residency A's churn frames and
mega A's promoted waves, History P's forks, ticks, reads and compaction,
and History H's fork and merge-back, under ``torch.profiler``, and prints
the card's busy time and idle share.

    python3 chip_smoke.py --trace-history

runs every phase and check as without flags, and traces the two history
phases only; ``--trace-fleet`` traces Fleet P's first ticks the same way,
``--trace-read`` Viewer V's ticks at 100,000 viewers, Read R's replica
poll and Front door F's last socket tick, and ``--trace-net`` Front door
B's arm 1 timed ticks and Net N's networked F = 1 bench arm (``--trace``
traces them too).
"""

from __future__ import annotations

import contextlib
import json
import os
import pathlib
import subprocess
import sys
import threading
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
# K=32 ops per doc per tick, 3 ticks), with 64 docs whose head-concentrated
# burst (BURST_K ops, 2 * BURST_K + 2 > Bk) overflows a block mid-tick.
TEXT_CLIENTS = 128
TEXT_ROUNDS = 4
TEXT_DOCS = 8_192
TEXT_K = 32
TEXT_FLUSHES = 3
BURST_DOCS = 64
BURST_K = 120
BURST_FLUSH = 2
#: Text path B's plain-version run serves this many of its flushes (the
#: ones before the burst) and is held to the kernel run's pools after the
#: same flush.
TEXT_B_PLAIN_FLUSHES = 2
SAMPLE_DOCS = 256
# The kernel checks' table: S = NB x Bk = 4 x 128, 4 props, 4 overlap words.
TEXT_NB, TEXT_BK, TEXT_P, TEXT_W = 4, 128, 4, 4

# BASELINE.json config 4 at its published width (a 1k x 1k SharedMatrix,
# 256 clients writing cells concurrently) through the service, and the
# matrix host at batched width (8,192 docs, 256 writer ids, K=32 ops per
# doc a flush from a 32 x 32 start, 5 flushes; the cell log starts at 128
# entries so it compacts and grows). The op tick's kernel check runs at
# (B, K, S, C, W) = (8,192, 32, 256, 1,024, 8), plus a 16-entry cell log
# that overflows.
MATRIX_CLIENTS = 256
MATRIX_GRID = 1024
MATRIX_ROUNDS = 4
MATRIX_B = 8_192
MATRIX_K = 32
MATRIX_START = 32
MATRIX_FLUSHES = 5
#: Matrix path B's plain-version run serves this many of its flushes and
#: is held to the kernel run's planes after the same flush.
MATRIX_B_PLAIN_FLUSHES = 2
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
# BASELINE.json config 5 (SharedTree subtree insert/move, 1k docs batched
# rebase) through the service: 1,024 docs with config 3's 4 clients
# joined to each, TREE_ROUNDS rounds of one wire edit per client against
# the tree as the previous round left it; 16 docs also take a burst of
# 24 inserts before one anchor (rank exhaustion: the overflow route) and
# 8 docs a two-set_value edit (an unsupported shape: the scalar route).
TREE_DOCS = 1024
TREE_CLIENTS = 4
TREE_ROUNDS = 6
TREE_BURST_DOCS = 16
TREE_BURST = 24
TREE_BURST_ROUND = 2
TREE_SHAPE_DOCS = 8
TREE_SHAPE_ROUND = 5
TREE_SAMPLE_DOCS = 32
# The tree tick at bench_tree's shape (bench.py:1070): 8,192 docs x 256
# slots, K = 32, 6 ticks of one seeded stream tiled over the docs; the
# same ticks on CPU tensors for TREE_B_CPU_DOCS docs.
TREE_B_DOCS = 8192
TREE_B_SLOTS = 256
TREE_B_K = 32
TREE_B_TICKS = 6
TREE_B_CPU_DOCS = 64
# int32 operations per (op, slot) of the tree tick outside the subtree
# sweep, counted from ops/tree_kernel.py (sibling set 5, count 1, the
# four masked reductions 12, target and seed 2, the five plane updates
# 10); the sweep does 3 per slot a pass.
TREE_OPS_PER_SLOT = 30
TREE_SWEEP_OPS_PER_SLOT = 3
# A deli lane count past one block's shared memory for the warp variant
# (4 documents x 16 bytes a client > 232,448 bytes on an H100).
DELI_LARGE_C = 4096
# bench_mixed_serving's full width (bench.py:602): 8,192 docs, a quarter
# each of map, text, matrix and tree rows, MIXED_TICKS ticks (12 in the
# bench; a depth cut, PERF.md §4) at map K 64, text and matrix K 16, tree
# K 8 (212,992 ops a tick), harvest pipeline depth 4; mixed B serves it
# again on a virtual mesh of 4 shards of the card.
MIXED_DOCS = 8192
MIXED_TICKS = 8
MIXED_K = {"map": 64, "text": 16, "matrix": 16, "tree": 8}
MIXED_DEPTH = 4
MIXED_SHARDS = 4
# The sequence-parallel tier: one document of 65,536 slots (the merge
# host's default sharded_slot_threshold) over a virtual mesh of 4 shards,
# 6 ticks of K = 32 ops from 8 writers; and a merge host with a 4,096-slot
# threshold growing one config-2 document (128 writers, one op each a
# round) into its sharded pool.
SEQPAR_S = 65536
SEQPAR_K = 32
SEQPAR_TICKS = 6
SEQPAR_CLIENTS = 8
SEQPAR_SHARDS = 4
GROW_THRESHOLD = 4096
GROW_CLIENTS = 128
GROW_ROUNDS = 24
# The msn trails the head by this many rounds: the collab window holds the
# last GROW_LAG rounds' segments unmerged (zamboni packs everything below
# it into a few runs), so the table passes 2,048 slots.
GROW_LAG = 16


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


#: Seconds of each phase of this run, in order (``phase_seconds:`` line),
#: from T_START, the start of ``main``.
PHASE_S: dict = {}
T_START = 0.0


@contextlib.contextmanager
def phase(name: str):
    """Time one phase; print its seconds when it ends."""
    t0 = time.perf_counter()
    yield
    PHASE_S[name] = time.perf_counter() - t0
    print(f"phase {name}: {PHASE_S[name]:.1f} s", flush=True)


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


def max_abs_err_t(a, b):
    """Largest |a - b| over every plane of two (nested) NamedTuples of
    tensors, as a 0-dim int64 tensor on their device (no host wait)."""
    import torch
    la, lb = leaves(a), leaves(b)
    errs = [(x.long() - y.long()).abs().max()
            for x, y in zip(la, lb) if x.numel()]
    return torch.stack(errs).max() if errs else \
        torch.zeros((), dtype=torch.long, device=la[0].device)


def max_abs_err(a, b) -> int:
    """Largest |a - b| over every plane of two (nested) NamedTuples of
    tensors."""
    return int(max_abs_err_t(a, b))


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
    """Serve each tick blob's read and its header's parse once for the
    rest of ``storm``'s life: the checks' ``records_overlapping`` reads a
    whole blob (42 MB at this width) and parses its whole header (10,240
    entries) a doc and a tick, as the reference does."""
    import functools
    storm._read_blob = functools.lru_cache(maxsize=None)(storm._read_blob)
    storm._parse_header = functools.lru_cache(maxsize=None)(
        storm._parse_header)


def record_key(messages) -> list:
    return [(m.sequence_number, m.client_sequence_number, m.client_id,
             m.reference_sequence_number, m.minimum_sequence_number,
             json.dumps(m.contents, sort_keys=True)) for m in messages]


def durable_path(device, walless: dict, script, then=None) -> dict:
    """BASELINE config 3 served crash-safe (group-commit WAL, acks after
    fsync, checkpoints), held to the WAL-less run of ``main_path`` in this
    call; then a fresh stack on the card recovers it (the tick-4 head,
    the WAL tail replayed through the serving tick) and is held to the
    live durable stack; then a fresh client joins 64 sampled docs of both
    stacks through the deli. ``then(ctx)``, when given, runs last on the
    recovered stack and its directories (History P), before they go:
    ``ctx`` holds the stack (``storm``), ``make_stack``, which builds
    another like it over the same directories, the WAL-less run's stack
    (``twin``: the same state but the 64 joins), the docs (``names``) and
    the joined ones (``joined``)."""
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
        def make_stack():
            store = StateStore()
            store.put("client_counter", live["counter"])
            seq = KernelSequencerHost(num_slots=CLIENTS,
                                      initial_capacity=DOCS, device=device)
            merge = KernelMergeHost(flush_threshold=10**9,
                                    row_capacity=DOCS, device=device)
            svc = RouterliciousService(merge_host=merge,
                                       batched_deli_host=seq,
                                       auto_pump=False, store=store)
            return StormController(
                svc, seq, merge, flush_threshold_docs=DOCS,
                max_key_slots=KEY_SLOTS, pipeline_depth=1,
                spill_dir=str(root / "spill"), durability="group",
                snapshots=GitSnapshotStore(root / "git"))
        storm2 = make_stack()
        svc2, seq2, merge2 = (storm2.service, storm2.seq_host,
                              storm2.merge_host)
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
        if then is not None:
            then_out = then({"storm": storm2, "make_stack": make_stack,
                             "twin": base, "names": names,
                             "joined": joined})
        else:
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
    if then is not None:
        out["then"] = then_out
    out.update(shapes=run["shapes"], deli_variants=run["deli_variants"],
               fold_variants=run["fold_variants"], deli_inputs=deli_in,
               fold_inputs=fold_in, recover_shapes=rec_shapes,
               recover_deli_inputs=deli_rec, recover_fold_inputs=fold_rec)
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


def clone_args(planes):
    """A copy of a kernel wrapper's argument: a tensor, a (nested) tuple
    of tensors, or host flags (a list, or None)."""
    if planes is None:
        return None
    if isinstance(planes, list):
        return list(planes)
    if not isinstance(planes, tuple):
        return planes.clone()
    return type(planes)(*(clone_args(t) for t in planes))


#: Held by every ``recording`` wrapper around its counters' snapshot, the
#: call and the diff: hosts served from threads of their own launch at
#: once, and each call must see only its own launch.
_RECORD_LOCK = threading.RLock()


@contextlib.contextmanager
def recording(mod, attr: str, kept: dict, counts=None):
    """Wrap the kernel wrapper ``mod.<attr>`` for the duration: each call
    appends a copy of its (tensor or tuple) arguments to ``kept[shape]``,
    the launch shape the wrapper counted it by (``counts.shapes``,
    ``counts`` defaulting to ``mod``). Launches are still counted by the
    wrapper alone. Safe to call from several threads at once."""
    import torch
    inner = getattr(mod, attr)
    counts = mod if counts is None else counts

    def wrapped(*args):
        inputs = tuple(clone_args(a) for a in args)
        with _RECORD_LOCK:
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


def text_path_b(device, plain: bool = False, flushes: int | None = None,
                keep_after: int | None = None) -> dict:
    """The host at batched width: TEXT_DOCS docs, one string channel each
    and TEXT_CLIENTS writer ids; TEXT_FLUSHES flushes of TEXT_K ops per
    doc (about 70% inserts, 30% removes of 1-8 chars) from distinct
    writers at the doc's head ref, fed through ``KernelMergeHost.ingest`` then ``flush()``. In flush
    BURST_FLUSH the first BURST_DOCS docs get BURST_K inserts at position
    0 instead, so one block overflows mid-tick. Rows start in the 128-slot
    bucket. Returns the host and the sampled docs' sequenced ops, and
    (``keep_after``) a copy of the host's text pools and stats after that
    many flushes (``kept``). ``flushes`` serves the first flushes only."""
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
        for f in range(TEXT_FLUSHES if flushes is None else flushes):
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
            if f + 1 == keep_after:
                kept = text_pools(host)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
    return {"merge_host": host, "names": names, "sampled": sampled,
            "length": length, "serve_s": serve_s, "flush_s": flush_s,
            "ops": int(seq.sum()),
            **({"kept": kept} if keep_after is not None else {})}


def text_pools(host) -> tuple:
    """A copy of a merge host's text pools' planes, by bucket, and its
    stats."""
    return ({slots: clone_args(pool.state)
             for slots, pool in host._merge_pools.items()},
            dict(host.stats))


def engine_text(ops) -> str:
    from fluidframework_tpu_torch.dds.mergetree import MergeEngine
    engine = MergeEngine(local_client=None)
    for op, sq, ref, client in ops:
        engine.apply_remote(op, sq, ref, client)
    return engine.get_text()


def text_pools_equal(a, b) -> None:
    """Every text plane of two merge hosts' pools (``text_pools``) equal
    (the kernel run against the plain-version run)."""
    import torch
    (pools_a, stats_a), (pools_b, stats_b) = a, b
    check(sorted(pools_a) == sorted(pools_b),
          "text runs grew different buckets")
    for slots, sa in pools_a.items():
        sb = pools_b[slots]
        for f, x, y in zip(sa._fields, sa, sb):
            check(torch.equal(x, y), f"text pool {slots} plane {f}: kernel "
                  "run != plain run")
    check(stats_a == stats_b, f"text stats differ: {stats_a} vs {stats_b}")


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
            run = drive(device) if name == "a" else drive(
                device, keep_after=TEXT_B_PLAIN_FLUSHES)
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
        if name == "a":
            plain = drive(device, plain=True)
            text_pools_equal(text_pools(host),
                             text_pools(plain["merge_host"]))
        else:
            # The plain-version run at the flushes before the burst, held
            # to the kernel run's pools after them (every kernel call of
            # the run is held to the plain version in the re-checks).
            plain = drive(device, plain=True, flushes=TEXT_B_PLAIN_FLUSHES)
            text_pools_equal(run["kept"], text_pools(plain["merge_host"]))
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
                     time_all: bool = False, time_last: bool = False,
                     ends_only: bool = False) -> dict:
    """Hold a kernel against its plain version on the inputs of EVERY call
    the main paths made to it, at every shape, and time it on every call
    (``by_call``: each call's shape and ms, with ``other``'s ms). ms and
    bound are means per launch over the calls of the shape with the most
    launches (over every call where ``time_all``); the
    error is the largest over every check. Each call's arguments are
    passed as recorded; ``ops_of`` counts the ops of one call's
    arguments. ``other`` is the kernel's other variant (``other_name``:
    the global-memory one where the paths ran the shared-memory one): it
    is held to the plain version on the same inputs and timed on the
    same calls in this call (``ms_<other_name>``). ``time_last`` times
    only the last call of each shape (every call is still held to the
    plain version). Plain ms is timed on the last timed call of each
    timed shape: timing it on every call would double the re-checks'
    time, most of which is the plain versions'. ``ends_only`` holds only
    each shape's first and last call to the plain version (where the
    plain version takes seconds a call), and times the plain version on
    the shape with the most launches only."""
    import torch
    check(bool(shapes) and {sh: len(c) for sh, c in inputs.items()}
          == shapes, f"{name}: launches by shape {shapes}, inputs kept "
          f"{ {sh: len(c) for sh, c in inputs.items()} }")
    # Every call's error stays on the card until its shape is done: one
    # host wait a shape, not one a call.
    worst = 0
    held = {sh: (c[:1] + c[1:][-1:]) if ends_only else c
            for sh, c in inputs.items()}
    for shape in sorted(shapes):
        errs = []
        for args in held[shape]:
            want = plain(*args)
            for run in (kernel, other) if other else (kernel,):
                errs.append(max_abs_err_t(run(*args), want))
        err = int(torch.stack(errs).max())
        check(err == 0, f"{name} kernel != plain version on the main "
              f"path's inputs at {shape} (max |err| {err})")
        worst = max(worst, err)
    top = max(shapes, key=lambda sh: shapes[sh])
    timed = {sh: inputs[sh][-1:] if time_last else inputs[sh]
             for sh in shapes}
    by_call = []
    for shape in sorted(shapes):
        for args in timed[shape]:
            by_call.append([*shape, cuda_time_ms(lambda: kernel(*args), 3),
                            *([cuda_time_ms(lambda: other(*args), 3)]
                              if other else [])])
    n = len(top)
    summed = [row for row in by_call if time_all or tuple(row[:n]) == top]
    calls = [c for sh in sorted(shapes) for c in timed[sh]
             if time_all or sh == top]
    ms = [row[n] for row in summed]
    ms_other = [row[n + 1] for row in summed] if other else []
    plain_ms = [cuda_time_ms(lambda: plain(*args), 1)
                for args in (timed[sh][-1] for sh in sorted(shapes)
                             if (time_all and not ends_only) or sh == top)]
    bounds = [bound_of(*args) for args in calls]
    by = [b for _, b in bounds]
    key = f"ms_{other_name}"
    out = {"shape": list(top), "max_abs_err": worst,
           "shapes_checked": len(shapes),
           "calls_checked": sum(len(c) for c in held.values()),
           "calls_recorded": sum(shapes.values()),
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


def tree_bound(state, ops, steps=None, passes: float = 0
               ) -> tuple[float, str]:
    """The tree tick's bound on these inputs: every plane read once and
    written once, the op batch read and the two flag planes written;
    TREE_OPS_PER_SLOT operations per (valid op, slot), and
    TREE_SWEEP_OPS_PER_SLOT per slot for each of ``passes`` sweep passes
    a document (0 where the caller does not count them: a floor)."""
    b, n = state.exists.shape
    k = ops.valid.shape[1]
    nbytes = 2 * b * n * (1 + 4 * 4) + b * k * (1 + 4 * 5) + 2 * b * k
    nops = n * (TREE_OPS_PER_SLOT * int(ops.valid.sum())
                + TREE_SWEEP_OPS_PER_SLOT * passes * b)
    return bound(nbytes, nops)


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
                  flushes: int | None = None,
                  keep_after: int | None = None) -> dict:
    """The host at batched width: MATRIX_B docs, one matrix channel each,
    MATRIX_CLIENTS writer ids. Each doc is laid out as a MATRIX_START x
    MATRIX_START grid, then takes ``flushes`` (default MATRIX_FLUSHES)
    flushes of MATRIX_K ops per doc from distinct writers at the doc's
    head ref, in the mix of :func:`matrix_ticks`, fed through
    ``KernelMergeHost.ingest`` then ``flush()``. The cell log starts at
    MATRIX_B_CELLS entries. Returns the host and the sampled docs'
    sequenced ops, and (``keep_after``) a copy of the host's matrix
    planes and stats after that many op flushes (``kept``)."""
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
            if _f + 1 == keep_after:
                kept = (clone_args(host._matrix_state), dict(host.stats))
        serve_s = time.perf_counter() - t0
    return {"merge_host": host, "names": names, "sampled": sampled,
            "size": size, "serve_s": serve_s, "flush_s": flush_s,
            "ops": int(seq.sum()),
            **({"kept": kept} if keep_after is not None else {})}


def matrix_states_equal(a, b, what: str) -> None:
    """Every matrix plane and counter of two merge hosts equal (the
    kernel run against the plain-version run)."""
    matrix_planes_equal((a._matrix_state, a.stats),
                        (b._matrix_state, b.stats), what)


def matrix_planes_equal(a, b, what: str) -> None:
    """Two (matrix state, stats) pairs equal, plane by plane."""
    import torch
    (sa, stats_a), (sb, stats_b) = a, b
    for (f, x), y in zip(
            [(f"rows.{g}", t) for g, t in zip(sa.rows._fields, sa.rows)]
            + [(f"cols.{g}", t) for g, t in zip(sa.cols._fields, sa.cols)]
            + list(zip(sa._fields[2:], sa[2:])), leaves(sb)):
        check(torch.equal(x, y), f"{what} matrix plane {f}: kernel run != "
              "plain run")
    check(stats_a == stats_b, f"{what} stats differ: {stats_a} vs {stats_b}")


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
            run = drive(device) if name == "a" else drive(
                device, keep_after=MATRIX_B_PLAIN_FLUSHES)
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
        if name == "a":
            plain = drive(device, plain=True)
            matrix_states_equal(host, plain["merge_host"], "matrix path a")
        else:
            # The plain-version run at the first MATRIX_B_PLAIN_FLUSHES
            # flushes, held to the kernel run's planes after them (every
            # kernel call of the run is held to the plain version in the
            # re-checks).
            plain = drive(device, plain=True,
                          flushes=MATRIX_B_PLAIN_FLUSHES)
            pm = plain["merge_host"]
            matrix_planes_equal(run["kept"], (pm._matrix_state, pm.stats),
                                "matrix path b")
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


# -- the tree paths -----------------------------------------------------------


def tree_node(nid: str, payload=None, **traits) -> dict:
    return {"id": nid, "definition": "n", "payload": payload,
            "traits": {k: list(v) for k, v in traits.items()}}


def tree_range(nid: str) -> dict:
    return {"start": {"referenceSibling": nid, "side": "before"},
            "end": {"referenceSibling": nid, "side": "after"}}


def tree_wire_edit(rng, view, counter, client: str, keep=()) -> dict:
    """One wire edit in the mix of ``tests/test_tree_host.py``'s
    ``random_tree_edit`` against ``view``: subtree inserts 45% (30% with
    1-2 kids; at a trait's end or start, or before or after a sibling),
    set_value 20%, single-node detach 15%, move (detach + insert) 20%.
    Nodes in ``keep`` are never detached or moved."""
    root = "root"
    attached = [nid for nid in view.nodes
                if nid == root or view.nodes[nid].parent is not None]
    non_root = [n for n in attached if n != root]
    movable = [n for n in non_root if n not in keep]
    roll = rng.random()
    if roll < 0.45 or not non_root:
        nid = f"n{next(counter)}"
        spec = tree_node(nid, payload=rng.randrange(100))
        if rng.random() < 0.3:
            spec["traits"]["kids"] = [tree_node(f"{nid}k{i}")
                                      for i in range(rng.randrange(1, 3))]
        anchor = rng.choice(attached)
        if anchor != root and rng.random() < 0.5:
            place = {"referenceSibling": anchor,
                     "side": rng.choice(["before", "after"])}
        else:
            place = {"referenceTrait": {"parent": anchor,
                                        "label": rng.choice(["children",
                                                             "kids"])},
                     "side": rng.choice(["start", "end"])}
        changes = [{"type": "build", "source": [spec],
                    "destination": f"b-{nid}"},
                   {"type": "insert", "source": f"b-{nid}",
                    "destination": place}]
    elif roll < 0.65 or not movable:
        changes = [{"type": "set_value", "node": rng.choice(non_root),
                    "payload": rng.randrange(1000)}]
    elif roll < 0.8:
        changes = [{"type": "detach",
                    "source": tree_range(rng.choice(movable))}]
    else:
        dest = rng.choice(attached)
        if dest != root and rng.random() < 0.5:
            place = {"referenceSibling": dest,
                     "side": rng.choice(["before", "after"])}
        else:
            place = {"referenceTrait": {"parent": dest,
                                        "label": "children"},
                     "side": rng.choice(["start", "end"])}
        mid = f"m-{next(counter)}"
        changes = [{"type": "detach",
                    "source": tree_range(rng.choice(movable)),
                    "destination": mid},
                   {"type": "insert", "source": mid, "destination": place}]
    return {"type": "edit",
            "edit": {"id": f"{client}-e{next(counter)}", "changes": changes}}


@contextlib.contextmanager
def timed_tree_ticks(device, ticks: list):
    """Wrap the tree tick (``tree_cuda.apply_tick_best``, which the merge
    host calls) for the duration: each call appends its CUDA event pair
    (start, end) to ``ticks`` (None off the card)."""
    import torch

    from fluidframework_tpu_torch.ops import tree_cuda as tcc
    inner = tcc.apply_tick_best

    def wrapped(*args):
        if device.type != "cuda":
            ticks.append(None)
            return inner(*args)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = inner(*args)
        end.record()
        ticks.append((start, end))
        return out
    tcc.apply_tick_best = wrapped
    try:
        yield
    finally:
        tcc.apply_tick_best = inner


def tree_path_a(device) -> dict:
    """BASELINE config 5 through the service: TREE_CLIENTS clients join
    each of TREE_DOCS docs (the deli kernel sequences the joins), then
    TREE_ROUNDS rounds in which every client submits one wire edit
    through its connection, picked from the tree as the previous round
    left it, at that round's last seq (so a round's edits are
    concurrent, and some target nodes another client just detached or
    moved). Burst docs take TREE_BURST inserts before one anchor in
    round TREE_BURST_ROUND; shape docs one two-set_value edit in round
    TREE_SHAPE_ROUND. Each round is one pump (the merger checkpoints
    flush the host: a tree tick over every row), then one ``flush()``.
    The harness replays each round's sequenced edits through
    ``Transaction`` into its own views (``replay_s``, inside the wall
    time)."""
    import itertools
    import random

    import torch

    from fluidframework_tpu_torch.dds.tree_core import (
        VALID,
        Transaction,
        TreeSnapshot,
    )
    from fluidframework_tpu_torch.protocol.messages import (
        DocumentMessage,
        MessageType,
    )
    from fluidframework_tpu_torch.server.kernel_host import \
        KernelSequencerHost
    from fluidframework_tpu_torch.server.merge_host import KernelMergeHost
    from fluidframework_tpu_torch.server.routerlicious import \
        RouterliciousService

    seq_host = KernelSequencerHost(num_slots=TREE_CLIENTS,
                                   initial_capacity=TREE_DOCS, device=device)
    merge_host = KernelMergeHost(flush_threshold=1 << 30, device=device)
    service = RouterliciousService(merge_host=merge_host,
                                   batched_deli_host=seq_host,
                                   auto_pump=False)
    clock = iter(range(1000, 1 << 40, 3))
    service._clock = lambda: next(clock)
    inner_flush = merge_host.flush
    flushes = []

    def flush():
        t = time.perf_counter()
        inner_flush()
        flushes.append(time.perf_counter() - t)
    merge_host.flush = flush
    names = [f"tree{d}" for d in range(TREE_DOCS)]
    burst = set(range(0, TREE_DOCS, TREE_DOCS // TREE_BURST_DOCS))
    shape = set(range(1, TREE_DOCS, TREE_DOCS // TREE_SHAPE_DOCS))
    rng = random.Random(8)
    counter = itertools.count()
    views = [TreeSnapshot() for _ in names]
    edits: list[list] = [[] for _ in names]
    ticks: list = []
    replay_s = 0.0
    with timed_tree_ticks(device, ticks):
        t0 = time.perf_counter()
        conns = [[service.connect(name, lambda m: None)
                  for _ in range(TREE_CLIENTS)] for name in names]
        service.pump()
        head = [service.get_deltas(name, 0)[-1].sequence_number
                for name in names]
        cseq = [[0] * TREE_CLIENTS for _ in names]

        def send(d, i, op):
            cseq[d][i] += 1
            conns[d][i].submit([DocumentMessage(
                client_sequence_number=cseq[d][i],
                reference_sequence_number=head[d],
                type=MessageType.OPERATION,
                contents={"address": "default",
                          "contents": {"address": "tree", "contents": op}})])
        for r in range(TREE_ROUNDS):
            for d in range(TREE_DOCS):
                anchor = f"anchor{d}"
                for i, c in enumerate(conns[d]):
                    client = c.client_id
                    if d in burst and r == 0 and i == 0:
                        op = {"type": "edit", "edit": {
                            "id": f"{client}-anchor", "changes": [
                                {"type": "build",
                                 "source": [tree_node(anchor)],
                                 "destination": "b-anchor"},
                                {"type": "insert", "source": "b-anchor",
                                 "destination": {"referenceTrait": {
                                     "parent": "root",
                                     "label": "children"},
                                     "side": "end"}}]}}
                    elif d in shape and r == TREE_SHAPE_ROUND and i == 0:
                        ids = ([n for n in views[d].nodes][:2]
                               + ["root", "root"])[:2]
                        op = {"type": "edit", "edit": {
                            "id": f"{client}-pair", "changes": [
                                {"type": "set_value", "node": n,
                                 "payload": j} for j, n in enumerate(ids)]}}
                    else:
                        op = tree_wire_edit(rng, views[d], counter, client,
                                            keep=(anchor,))
                    send(d, i, op)
                if d in burst and r == TREE_BURST_ROUND:
                    for j in range(TREE_BURST):
                        nid = f"w{d}-{j}"
                        send(d, 0, {"type": "edit", "edit": {
                            "id": f"{conns[d][0].client_id}-w{j}",
                            "changes": [
                                {"type": "build",
                                 "source": [tree_node(nid)],
                                 "destination": f"b-{nid}"},
                                {"type": "insert", "source": f"b-{nid}",
                                 "destination": {"referenceSibling": anchor,
                                                 "side": "before"}}]}})
            service.pump()
            merge_host.flush()
            t = time.perf_counter()
            for d, name in enumerate(names):
                msgs = service.get_deltas(name, head[d])
                for m in msgs:
                    if m.type != MessageType.OPERATION:
                        continue
                    edits[d].append(m)
                    txn = Transaction(views[d])
                    if txn.apply_edit(
                            m.contents["contents"]["contents"]["edit"]) \
                            == VALID:
                        views[d] = txn.snapshot
                if msgs:
                    head[d] = msgs[-1].sequence_number
            replay_s += time.perf_counter() - t
        if device.type == "cuda":
            torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    merge_host.flush = inner_flush
    tick_ms = ([s.elapsed_time(e) for s, e in ticks]
               if device.type == "cuda" else [])
    return {"service": service, "merge_host": merge_host,
            "seq_host": seq_host, "names": names, "views": views,
            "edits": edits, "burst": burst, "shape": shape,
            "wall_s": wall_s, "replay_s": replay_s, "flush_s": sum(flushes),
            "flushes": len(flushes), "tick_ms": tick_ms,
            "tree_ticks": len(ticks)}


def tree_main_path(device) -> dict:
    """Tree path A with every kernel's launch count zeroed just before it
    and read just after (the deli's calls recorded for the re-check),
    checked against a ``Transaction`` replay of every doc's sequenced
    edits."""
    import torch

    from fluidframework_tpu_torch.ops import map_fold_cuda as mfc
    from fluidframework_tpu_torch.ops import matrix_cuda as mxc
    from fluidframework_tpu_torch.ops import mergetree_blocks_cuda as mtbc
    from fluidframework_tpu_torch.ops import mergetree_cuda as mtc
    from fluidframework_tpu_torch.ops import sequencer_cuda as seqc
    from fluidframework_tpu_torch.ops import tree_cuda as tcc
    for mod in (mfc, mtbc, mtc, mxc.tick, mxc.steps):
        mod.launches = 0
    tcc.tick.reset()
    seqc.launches = 0
    seqc.shapes.clear()
    seqc.variants.clear()
    deli = {"inputs": {}}
    with recording(seqc, "process_batch_best", deli["inputs"]):
        run = tree_path_a(device)
    launches = {"map_fold": mfc.launches, "sequencer_tick": seqc.launches,
                "mergetree_blocks": mtbc.launches,
                "mergetree_flat": mtc.launches,
                "matrix_tick": mxc.tick.launches,
                "matrix_steps": mxc.steps.launches,
                "tree_tick": tcc.tick.launches,
                "sequencer_tick_variants": dict(seqc.variants)}
    deli["shapes"] = dict(seqc.shapes)
    check(launches["sequencer_tick"] > 0,
          "the deli kernel did not run on tree path A")
    if device.type == "cuda":
        check(launches["tree_tick"] == run["tree_ticks"] > 0,
              f"tree path A: {launches['tree_tick']} tree kernel launches "
              f"for {run['tree_ticks']} ticks")
    deli_picks(device, seqc.shapes, seqc.variants, "tree path A")
    host = run["merge_host"]
    check(host._tree_state.exists.device.type == device.type,
          f"tree planes on {host._tree_state.exists.device}, not {device}")
    n_edits = sum(len(e) for e in run["edits"])
    want = (TREE_DOCS * TREE_CLIENTS * TREE_ROUNDS
            + TREE_BURST_DOCS * TREE_BURST)
    check(n_edits == want, f"config 5 sequenced {n_edits} of {want} edits")
    for d, name in enumerate(run["names"]):
        got = host.tree_snapshot(name, "default", "tree")
        check(got == run["views"][d].serialize(),
              f"config 5: tree_snapshot({name}) != Transaction replay of "
              "its sequenced edits")
    for d in range(0, TREE_DOCS, TREE_DOCS // TREE_SAMPLE_DOCS):
        name = run["names"][d]
        summary = host.summarize(name)
        check(summary == {
            "datastores": {"default": {"tree": {
                "kind": "tree", "tree": run["views"][d].serialize()}}},
            "sequence_number": run["edits"][d][-1].sequence_number},
            f"config 5: summarize({name}) != the replay")
    routed = {d for d, name in enumerate(run["names"])
              if host._tree_rows[(name, "default", "tree")].scalar
              is not None}
    check(run["burst"] | run["shape"] <= routed,
          "a burst or two-set_value doc stayed on the device")
    check(host.stats["overflow_routed"] == len(routed)
          and host.stats["device_ops"] > 0,
          f"config 5 stats {host.stats}")
    if device.type == "cuda":
        torch.cuda.synchronize()
    serve_s = run["wall_s"] - run["replay_s"]
    ticks = run["tick_ms"]
    out = {"docs": TREE_DOCS, "clients": TREE_CLIENTS,
           "rounds": TREE_ROUNDS, "edits": n_edits,
           "wall_s": run["wall_s"], "replay_s": run["replay_s"],
           "edits_per_s": n_edits / serve_s, "flush_s": run["flush_s"],
           "flushes": run["flushes"], "tree_ticks": run["tree_ticks"],
           "tick_ms_mean": sum(ticks) / len(ticks) if ticks else None,
           "tick_ms_total": sum(ticks) if ticks else None,
           "tree_slots": host._tree_slots,
           "scalar_docs": len(routed),
           "stats": {k: host.stats[k] for k in (
               "device_ops", "scalar_ops", "overflow_routed",
               "compactions", "flushes")},
           "launches": launches}
    print("tree_main_path: " + json.dumps(out), flush=True)
    print("tree_main_path_shapes: " + json.dumps(
        {"sequencer_tick": [[*shape, n] for shape, n in
                            sorted(deli["shapes"].items())]}), flush=True)
    return {"launches": launches, "deli": deli, "path": out}


def tree_b_stream(rng, n_ops: int, num_slots: int) -> list[dict]:
    """``bench.py``'s ``_gen_tree_stream``: inserts under random live
    slots, set_values and single-node detaches."""
    from fluidframework_tpu_torch.ops import tree_kernel as tk

    ops = []
    existing = [0]
    free = list(range(1, num_slots))
    for _ in range(n_ops):
        r = rng.random()
        if free and (r < 0.45 or len(existing) < 3):
            slot = free.pop(0)
            ops.append(dict(kind=tk.TREE_INSERT, node=slot,
                            parent=rng.choice(existing),
                            payload=rng.randrange(1, 1000)))
            existing.append(slot)
        elif r < 0.9:
            ops.append(dict(kind=tk.TREE_SET_VALUE,
                            node=rng.choice(existing),
                            payload=rng.randrange(1, 1000)))
        else:
            victims = [s for s in existing if s != 0]
            if not victims:
                continue
            node = rng.choice(victims)
            ops.append(dict(kind=tk.TREE_DETACH, node=node))
            existing.remove(node)
    return ops


def tree_scalar_apply(snapshot, op_dicts, slot_names):
    """Kernel-shaped ops through the scalar Transaction (a copy of
    ``tests/test_tree_kernel.py``'s ``scalar_apply``, for the three kinds
    the stream holds): (snapshot,
    applied flags, passes), ``passes`` the subtree sweep passes each
    detach needs (its live subtree's height + 1)."""
    from fluidframework_tpu_torch.dds.tree_core import VALID, Transaction
    from fluidframework_tpu_torch.ops import tree_kernel as tk

    def height(nid):
        kids = [c for cs in snapshot.get(nid).traits.values() for c in cs]
        return 1 + max((height(c) for c in kids), default=0)
    applied, passes = [], 0
    for op in op_dicts:
        name = slot_names[op.get("node", 0)]
        kind = op["kind"]
        check(kind in (tk.TREE_SET_VALUE, tk.TREE_DETACH, tk.TREE_INSERT),
              f"tree B stream holds an op of kind {kind}")
        if kind == tk.TREE_SET_VALUE:
            changes = [{"type": "set_value", "node": name,
                        "payload": op["payload"]}]
        elif kind == tk.TREE_DETACH:
            if snapshot.has(name):
                passes += min(height(name), tk.MAX_DEPTH_PASSES)
            changes = [{"type": "detach", "source": tree_range(name)}]
        else:
            place = {"referenceTrait": {"parent": slot_names[op["parent"]],
                                        "label": f"t{op.get('trait', 0)}"},
                     "side": "end"}
            changes = [
                {"type": "build",
                 "source": [{"id": name, "definition": "n",
                             "payload": op["payload"]}],
                 "destination": f"b-{name}-{len(applied)}"},
                {"type": "insert", "source": f"b-{name}-{len(applied)}",
                 "destination": place}]
        txn = Transaction(snapshot)
        ok = txn.apply_edit({"id": "e", "changes": changes}) == VALID
        if ok:
            snapshot = txn.snapshot
        applied.append(ok)
    return snapshot, applied, passes


def tree_state_matches(state, snapshot, slot_names) -> None:
    """Document 0 of ``state`` against ``snapshot``: existence, payload,
    parent and trait of every slot, and every trait's sibling order."""
    from fluidframework_tpu_torch.ops import tree_kernel as tk

    exists = state.exists[0].cpu().numpy()
    payload = state.payload[0].cpu().numpy()
    parent = state.parent[0].cpu().numpy()
    trait = state.trait[0].cpu().numpy()
    for slot in range(exists.shape[0]):
        name = slot_names[slot]
        check(bool(exists[slot]) == snapshot.has(name),
              f"tree B slot {slot}: exists != the replay")
        if exists[slot] and slot != 0:
            node = snapshot.get(name)
            check(node.payload == int(payload[slot])
                  and slot_names[int(parent[slot])] == node.parent[0]
                  and f"t{int(trait[slot])}" == node.parent[1],
                  f"tree B slot {slot}: payload or parent != the replay")
    for slot in range(exists.shape[0]):
        if not exists[slot]:
            continue
        for label, children in snapshot.get(slot_names[slot]).traits.items():
            got = tk.trait_order(state, 0, slot, int(label[1:]))
            check([slot_names[s] for s in got] == children,
                  f"tree B: order under slot {slot} != the replay")


def count_dispatched(fn):
    """(fn(), the aten ops it dispatched, views and host scalars left
    out): each is one launch on the card, by design of the plain
    version's ops (a view launches nothing, nor does the 0-d host tensor
    a Python scalar argument becomes)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    host_scalar = torch.ops.aten.scalar_tensor.default

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not func.is_view and func is not host_scalar:
                Count.n += 1
            return func(*args, **(kwargs or {}))
    with Count():
        out = fn()
    return out, Count.n


def tree_path_b(device) -> dict:
    """The tree tick at ``bench_tree``'s shape on the card: TREE_B_TICKS
    ticks of K ops over TREE_B_DOCS docs of TREE_B_SLOTS slots, one
    seeded stream tiled over the docs, through the tree tick kernel
    (``tree_cuda.apply_tick_best``, one launch a tick). Every doc must
    equal doc 0, doc 0 a scalar ``Transaction`` replay, the first
    TREE_B_CPU_DOCS docs the same ticks on CPU tensors, and each tick
    the plain tick on the same inputs on the card; the kernel and the
    plain tick are both timed there (``cuda_time_ms`` on the last tick's
    inputs). The chained ticks are timed twice with CUDA events, each
    tick's outputs kept: first on a cold allocator pool (``tick_ms_cold``:
    every tick's new outputs grow it), then on the pool that run left
    (``tick_ms``)."""
    import random

    import torch

    from fluidframework_tpu_torch.dds.tree_core import ROOT_ID, TreeSnapshot
    from fluidframework_tpu_torch.ops import tree_cuda as tcc
    from fluidframework_tpu_torch.ops import tree_kernel as tk

    b, n, k = TREE_B_DOCS, TREE_B_SLOTS, TREE_B_K
    stream = tree_b_stream(random.Random(0), k * TREE_B_TICKS, n)
    per_tick = [stream[t * k:(t + 1) * k] for t in range(TREE_B_TICKS)]
    steps = [tk.subtree_steps([ops], k) for ops in per_tick]

    def batch(ops, docs, dev):
        one = tk.make_tree_op_batch([ops], 1, k, dev)
        return tk.TreeOpBatch(*(f.expand(docs, k).contiguous()
                                for f in one))
    batches = [batch(ops, b, device) for ops in per_tick]

    def run(state, bs):
        outs = []
        for bt, st in zip(bs, steps):
            state, out = tcc.apply_tick_best(state, bt, st)
            outs.append(out)
        return state, outs
    def timed():
        state = tk.init_state(b, n, device)
        pairs, inputs, states, outs = [], [], [], []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for bt, st in zip(batches, steps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            inputs.append(state)
            start.record()
            state, out = tcc.apply_tick_best(state, bt, st)
            end.record()
            pairs.append((start, end))
            states.append(state)
            outs.append(out)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0, [s.elapsed_time(e) for s, e in
                                            pairs], inputs, states, outs)
    launched = tcc.tick.launches
    wall_cold_s, ms_cold = timed()[:2]  # its outputs freed: a warm pool
    check(tcc.tick.launches - launched == TREE_B_TICKS,
          f"tree B: {tcc.tick.launches - launched} kernel launches for "
          f"{TREE_B_TICKS} ticks")
    launched = tcc.tick.launches
    wall_s, ms, inputs, states, outs = timed()
    state = states[-1]
    check(tcc.tick.launches - launched == TREE_B_TICKS,
          f"tree B: {tcc.tick.launches - launched} kernel launches for "
          f"{TREE_B_TICKS} ticks")
    # Each tick's kernel result equals the plain tick on its inputs.
    for t, (x, bt, st) in enumerate(zip(inputs, batches, steps)):
        want_s, want_o = tk.apply_tick(x, bt, st)
        for f, p, q in zip((*tk.TreeState._fields, *tk.TreeOpOut._fields),
                           (*states[t], *outs[t]), (*want_s, *want_o)):
            check(torch.equal(p, q), f"tree B tick {t} {f}: kernel != plain")
    # Every document equals document 0.
    for f, plane in zip(state._fields, state):
        check(bool((plane == plane[:1]).all()),
              f"tree B plane {f}: a document differs from document 0")
    for t, out in enumerate(outs):
        for f, flags in zip(out._fields, out):
            check(bool((flags == flags[:1]).all()),
                  f"tree B tick {t} {f}: a document differs from doc 0")
    # Document 0 equals the scalar replay.
    slot_names = {0: ROOT_ID, **{i: f"s{i}" for i in range(1, n)}}
    snap, passes = TreeSnapshot(), 0
    for t, ops in enumerate(per_tick):
        snap, applied, p = tree_scalar_apply(snap, ops, slot_names)
        passes += p
        got = outs[t].applied[0, :len(ops)].cpu().tolist()
        check(got == applied, f"tree B tick {t}: applied != the replay")
    tree_state_matches(state, snap, slot_names)
    # The same ticks on CPU tensors for the first TREE_B_CPU_DOCS docs.
    cpu_state, cpu_outs = run(
        tk.init_state(TREE_B_CPU_DOCS, n, "cpu"),
        [batch(ops, TREE_B_CPU_DOCS, "cpu") for ops in per_tick])
    for f, x, y in zip(state._fields, state, cpu_state):
        check(torch.equal(x[:TREE_B_CPU_DOCS].cpu(), y),
              f"tree B plane {f}: card != CPU")
    for t, (x, y) in enumerate(zip(outs, cpu_outs)):
        for f, p, q in zip(x._fields, x, y):
            check(torch.equal(p[:TREE_B_CPU_DOCS].cpu(), q),
                  f"tree B tick {t} {f}: card != CPU")
    last = (inputs[-1], batches[-1], steps[-1])
    _, dispatched = count_dispatched(lambda: tk.apply_tick(*last))
    torch.cuda.synchronize()
    kernel_ms = cuda_time_ms(lambda: tcc.apply_tick_best(*last), 20)
    plain_ms = cuda_time_ms(lambda: tk.apply_tick(*last), 2)
    # Bound a tick (every tick holds K valid ops a document) with the
    # sweep passes this data needs, taken per tick.
    valid_ops = len(stream)
    bound_ms, bound_by = tree_bound(*last, passes=passes / TREE_B_TICKS)
    out = {"shape": [b, k, n], "ticks": TREE_B_TICKS,
           "ms": kernel_ms, "plain_ms": plain_ms,
           "tick_ms": ms, "tick_ms_cold": ms_cold,
           "ops_per_s": b * valid_ops / wall_s, "wall_s": wall_s,
           "wall_cold_s": wall_cold_s, "plain_launches_per_tick": dispatched,
           "sweep_steps": sum(map(sum, steps)),
           "bound_ms": bound_ms, "bound_by": bound_by,
           "applied": int(sum(int(o.applied[0].sum()) for o in outs)),
           "overflow": int(sum(int(o.overflow[0].sum()) for o in outs))}
    print("tree_b: " + json.dumps(out), flush=True)
    return out


# -- the multi-device tier -------------------------------------------------------


class _Identity:
    """An interning table whose value ids are the values themselves (the
    mixed script writes raw ints into cells)."""

    def __getitem__(self, i):
        return i


def mixed_script() -> dict:
    """``bench_mixed_serving``'s seeded script (bench.py:602): a quarter
    each of map, text, matrix and tree rows (row r is family r % 4), every
    row of a family the same traffic a tick; map K 64 (seeded set words),
    text K 16 (8 inserts of "ab" at the head, 4 one-char removes, 4
    annotates), matrix K 16 (a row and a col insert, 14 seeded cell
    writes), tree K 8 (8 inserts at tick 0, then 8 set_values). Returns
    the per-tick encoded planes, the rows of each family, and the ops of
    each family in replay form."""
    import numpy as np

    from fluidframework_tpu_torch.ops import matrix_kernel as mxk
    from fluidframework_tpu_torch.ops import mergetree_kernel as mtk
    from fluidframework_tpu_torch.ops import tree_kernel as tk
    from fluidframework_tpu_torch.server import storm
    k, docs, ticks = MIXED_K, MIXED_DOCS, MIXED_TICKS
    rng = np.random.default_rng(11)
    families = ("map", "text", "matrix", "tree")
    fam_rows = {f: np.arange(i, docs, 4) for i, f in enumerate(families)}
    pack_fields = {"text": storm.TEXT_PACK, "matrix": storm.MATRIX_PACK,
                   "tree": storm.TREE_PACK}

    def text_ops(t):
        ops = [dict(kind=mtk.MT_INSERT, pos=0, text="ab")
               for _ in range(k["text"] - 8)]
        ops += [dict(kind=mtk.MT_REMOVE, pos=i, end=i + 1)
                for i in range(4)]
        ops += [dict(kind=mtk.MT_ANNOTATE, pos=0, end=2, prop_key=1,
                     prop_val=t + 1) for _ in range(4)]
        return ops

    def matrix_ops(t):
        ops = [dict(target=mxk.MX_ROWS, kind=mtk.MT_INSERT, pos=0, count=1),
               dict(target=mxk.MX_COLS, kind=mtk.MT_INSERT, pos=0, count=1)]
        ops += [dict(target=mxk.MX_CELL, row=int(rng.integers(0, t + 1)),
                     col=int(rng.integers(0, t + 1)),
                     value=int(rng.integers(1, 1 << 16)))
                for _ in range(k["matrix"] - 2)]
        return ops

    def tree_ops(t):
        if t == 0:
            return [dict(kind=tk.TREE_INSERT, node=i + 1, parent=0,
                         trait=1, payload=i) for i in range(k["tree"])]
        return [dict(kind=tk.TREE_SET_VALUE, node=i + 1,
                     payload=t * 100 + i) for i in range(k["tree"])]

    handle, pool = 0, 0
    ticks_out, replay = [], {f: [] for f in families}
    for t in range(ticks):
        words = (rng.integers(0, 1 << 20, k["map"]).astype(np.uint32) << 12
                 | (rng.integers(0, 32, k["map"]).astype(np.uint32) << 2))
        per_fam, blob = {"map": words}, ""
        ref = 1 + t * np.array([k[f] for f in families])
        for fi, fam in enumerate(families[1:], 1):
            ops = {"text": text_ops, "matrix": matrix_ops,
                   "tree": tree_ops}[fam](t)
            planes = {n: np.zeros(k[fam], np.int32)
                      for n in pack_fields[fam][1:]}
            for i, op in enumerate(ops):
                op = dict(op)
                if fam == "text" and op["kind"] == mtk.MT_INSERT:
                    text = op.pop("text")
                    op.update(pool_start=pool + len(blob),
                              text_len=len(text))
                    blob += text
                if fam == "matrix" and op["target"] != mxk.MX_CELL:
                    op["handle_base"] = handle
                    handle += op["count"]
                for n in planes:
                    planes[n][i] = op.get(n, 0)
            if "ref_seq" in planes:
                planes["ref_seq"][:len(ops)] = ref[fi]
            per_fam[fam] = planes
            replay[fam].append(ops)
        replay["map"].append(words)
        pool += len(blob)
        ticks_out.append((per_fam, blob))
    ops_per_tick = sum(len(fam_rows[f]) * k[f] for f in families)
    return {"ticks": ticks_out, "fam_rows": fam_rows, "replay": replay,
            "ops_per_tick": ops_per_tick, "families": families}


def mixed_kwargs() -> dict:
    """``bench_mixed_serving``'s assembly arguments."""
    k, docs, ticks = MIXED_K, MIXED_DOCS, MIXED_TICKS
    return dict(num_docs=docs, k=k["map"], num_clients=2, map_slots=32,
                text_slots=2 * k["text"] * ticks + 64, text_k=k["text"],
                matrix_vec_slots=4 * ticks + 16, matrix_cell_slots=256,
                matrix_k=k["matrix"], tree_slots=2 * k["tree"],
                tree_k=k["tree"])


def play_mixed(serving, script, t: int):
    """Tick ``t`` of the script through the serving front door (submit →
    pack → feed → tick → harvest)."""
    per_fam, blob = script["ticks"][t]
    for fam in script["families"]:
        n = MIXED_K[fam]
        cseq0, ref = t * n + 1, 1 + t * n
        for row in script["fam_rows"][fam].tolist():
            if fam == "map":
                serving.submit(row, per_fam["map"], cseq0, ref)
            else:
                serving.submit_planes(row, fam, per_fam[fam], n, cseq0, ref,
                                      text=blob if fam == "text" else "")
    return serving.tick(now=2 + t)


@contextlib.contextmanager
def plain_mixed_versions():
    """Swap the mixed tick's and the serving assembly's kernel wrappers
    for their plain versions for the duration (the plain-version run of
    the mixed paths)."""
    from fluidframework_tpu_torch.ops import map_kernel as mk
    from fluidframework_tpu_torch.ops import matrix_kernel as mxk
    from fluidframework_tpu_torch.ops import mergetree_blocks as mtb
    from fluidframework_tpu_torch.ops import sequencer as seqk
    from fluidframework_tpu_torch.ops import tree_kernel as tk
    from fluidframework_tpu_torch.parallel import serving as sv
    from fluidframework_tpu_torch.server import storm
    saved = storm.mfc, storm.mtbc, storm.mxc, storm.tcc, sv.seqc
    storm.mfc = type("Plain", (), {"fold_words": staticmethod(
        mk.fold_words_plain)})
    storm.mtbc = type("Plain", (), {"apply_tick_blocks_best": staticmethod(
        mtb.apply_tick_blocks)})
    storm.mxc = type("Plain", (), {"apply_tick_best": staticmethod(
        mxk.apply_tick)})
    storm.tcc = type("Plain", (), {"apply_tick_best": staticmethod(
        tk.apply_tick)})
    sv.seqc = type("Plain", (), {"process_batch_best": staticmethod(
        seqk.process_batch)})
    try:
        yield
    finally:
        storm.mfc, storm.mtbc, storm.mxc, storm.tcc, sv.seqc = saved


@contextlib.contextmanager
def last_call(mod, attr: str, kept: dict, key: str):
    """Wrap the kernel wrapper ``mod.<attr>`` for the duration, keeping a
    copy of the arguments of its LAST call in ``kept[key]`` (the shape the
    path gives the kernel, re-checked and timed after the path)."""
    inner = getattr(mod, attr)

    def wrapped(*args):
        kept[key] = tuple(clone_args(a) for a in args)
        return inner(*args)
    setattr(mod, attr, wrapped)
    try:
        yield
    finally:
        setattr(mod, attr, inner)


def launch_counts_reset() -> None:
    """Zero the launch counters of kernels 1-5 and the tree tick kernel
    (the mixed and plane paths)."""
    from fluidframework_tpu_torch.ops import map_fold_cuda as mfc
    from fluidframework_tpu_torch.ops import matrix_cuda as mxc
    from fluidframework_tpu_torch.ops import mergetree_blocks_cuda as mtbc
    from fluidframework_tpu_torch.ops import mergetree_cuda as mtc
    from fluidframework_tpu_torch.ops import sequencer_cuda as seqc
    from fluidframework_tpu_torch.ops import tree_cuda as tcc
    for mod in (mfc, mtbc, mtc, seqc):
        mod.launches = 0
        mod.shapes.clear()
    mfc.variants.update(warp=0, block=0)
    mtbc.variants.update(smem=0, **{"global": 0})
    mtc.variants.update(smem=0, **{"global": 0})
    seqc.variants.clear()
    mxc.tick.reset()
    tcc.tick.reset()


def launch_counts() -> dict:
    from fluidframework_tpu_torch.ops import map_fold_cuda as mfc
    from fluidframework_tpu_torch.ops import matrix_cuda as mxc
    from fluidframework_tpu_torch.ops import mergetree_blocks_cuda as mtbc
    from fluidframework_tpu_torch.ops import mergetree_cuda as mtc
    from fluidframework_tpu_torch.ops import sequencer_cuda as seqc
    from fluidframework_tpu_torch.ops import tree_cuda as tcc
    mods = {"map_fold": mfc, "sequencer_tick": seqc,
            "mergetree_blocks": mtbc, "mergetree_flat": mtc,
            "matrix_tick": mxc.tick, "tree_tick": tcc.tick}
    out = {name: mod.launches for name, mod in mods.items()}
    out["shapes"] = {name: dict(mod.shapes) for name, mod in mods.items()}
    out["variants"] = {name: dict(mod.variants)
                       for name, mod in mods.items()}
    return out


def serve_mixed(device, script, shards: int = 1, hosts: int = 1,
                depth: int = MIXED_DEPTH, record: dict | None = None,
                ticks_ctx=None) -> dict:
    """The script through a ``ShardedServing`` on a mesh of ``shards``
    shards of ``device`` (a virtual mesh past one) with ``hosts``
    simulated hosts: tick 0 untimed, the rest timed by the host clock
    (``ticks_ctx`` wraps them, e.g. a profiler); every tick's
    harvest, the tick outputs, the states and the durable records."""
    import torch

    from fluidframework_tpu_torch.parallel.mesh import make_mesh
    from fluidframework_tpu_torch.parallel.serving import ShardedServing
    from fluidframework_tpu_torch.server import storm
    serving = ShardedServing(make_mesh([device] * shards), num_hosts=hosts,
                             pipeline_depth=depth, **mixed_kwargs())
    outs = []
    inner = storm._mixed_tick_shards

    def keep(*args, **kw):
        res = inner(*args, **kw)
        outs.append([[None if x is None else x.clone() for x in r[5:]]
                     for r in res])
        return res
    storm._mixed_tick_shards = keep
    record = record if record is not None else {}
    try:
        from fluidframework_tpu_torch.ops import map_fold_cuda as mfc
        from fluidframework_tpu_torch.ops import matrix_cuda as mxc
        from fluidframework_tpu_torch.ops import \
            mergetree_blocks_cuda as mtbc
        from fluidframework_tpu_torch.ops import tree_cuda as tcc
        from fluidframework_tpu_torch.parallel import serving as sv
        with last_call(mfc, "fold_words", record, "map_fold"), \
                last_call(mtbc, "apply_tick_blocks_best", record,
                          "mergetree_blocks"), \
                last_call(mxc, "apply_tick_best", record, "matrix_tick"), \
                last_call(tcc, "apply_tick_best", record, "tree_tick"), \
                last_call(sv.seqc, "process_batch_best", record,
                          "sequencer_tick"):
            serving.join_all()
            harvests = [play_mixed(serving, script, 0)]
            harvests += serving.flush()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with (ticks_ctx() if ticks_ctx else contextlib.nullcontext()):
                for t in range(1, len(script["ticks"])):
                    harvests.append(play_mixed(serving, script, t))
                harvests += serving.flush()
                torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
    finally:
        storm._mixed_tick_shards = inner
    return {"serving": serving, "harvests": [h for h in harvests
                                             if any(h.values())],
            "outs": outs, "wall_s": wall_s}


def mixed_states_equal(a, b, what: str) -> None:
    """Every plane of every family state of two assemblies (read back row
    by row), their durable records and text pools equal."""
    import numpy as np
    for name in a._family_states():
        for i, (x, y) in enumerate(zip(leaves(a.family_rows(name)),
                                       leaves(b.family_rows(name)))):
            check(np.array_equal(x, y), f"{what}: {name} plane {i} differs")
    check(a.text_pool == b.text_pool, f"{what}: text pools differ")
    check(sorted(a.durable) == sorted(b.durable)
          and all(len(a.durable[r]) == len(b.durable[r])
                  and all(x["n_seq"] == y["n_seq"] and x["first"] == y["first"]
                          and x["last"] == y["last"]
                          and x["cseq0"] == y["cseq0"]
                          for x, y in zip(a.durable[r], b.durable[r]))
                  for r in a.durable), f"{what}: durable records differ")


def mixed_replays(serving, script) -> None:
    """Every row of each family equals that family's scalar replay: the
    rows of a family took the same traffic, so every row must equal the
    family's first row, and the first row a numpy LWW fold (map), a
    ``MergeEngine`` replay (text), a PermutationVector + LWW grid replay
    (matrix) and a ``Transaction`` replay (tree)."""
    import numpy as np
    import torch

    from fluidframework_tpu_torch.dds.tree_core import ROOT_ID, TreeSnapshot
    from fluidframework_tpu_torch.ops import matrix_kernel as mxk
    from fluidframework_tpu_torch.ops import mergetree_kernel as mtk
    from fluidframework_tpu_torch.parallel.mesh import tree_map
    rows = script["fam_rows"]
    names = {"map": "map", "text": "text", "matrix": "matrix",
             "tree": "tree"}
    firsts = {}
    for fam, name in names.items():
        planes = serving.family_rows(name)
        first = tree_map(lambda a: a[rows[fam][0]:rows[fam][0] + 1], planes)
        for i, (plane, one) in enumerate(zip(leaves(planes), leaves(first))):
            check(np.array_equal(plane[rows[fam]],
                                 np.broadcast_to(one, (len(rows[fam]),)
                                                 + one.shape[1:])),
                  f"mixed: a {fam} row differs from the family's first row "
                  f"(plane {i})")
        firsts[fam] = first
    # Map: seqs 2.. after the one join, K words a tick, last write wins.
    present = np.zeros(mixed_kwargs()["map_slots"], bool)
    value = np.zeros_like(present, np.int32)
    vseq = np.zeros_like(value)
    seq = 1
    for words in script["replay"]["map"]:
        for w in words.tolist():
            seq += 1
            slot, kind = (w >> 2) & 0x3FF, w & 3
            check(kind == 0, "the mixed map script holds a non-set word")
            present[slot], value[slot], vseq[slot] = True, w >> 12, seq
    m = firsts["map"]
    check(np.array_equal(m.present[0], present)
          and np.array_equal(np.where(present, m.value[0], 0), value)
          and np.array_equal(np.where(present, m.vseq[0], 0), vseq),
          "mixed: map rows != the numpy LWW fold")
    # Text.
    ops, seq = [], 1
    for t, tick_ops in enumerate(script["replay"]["text"]):
        ref = 1 + t * MIXED_K["text"]
        for op in tick_ops:
            seq += 1
            if op["kind"] == mtk.MT_INSERT:
                wire = {"type": "insert", "pos": op["pos"], "text": "ab"}
            elif op["kind"] == mtk.MT_REMOVE:
                wire = {"type": "remove", "start": op["pos"],
                        "end": op["end"]}
            else:
                wire = {"type": "annotate", "start": op["pos"],
                        "end": op["end"], "props": {"k": op["prop_val"]}}
            ops.append((wire, seq, ref, "c0"))
    want = engine_text(ops)
    check(serving.text_of(int(rows["text"][0])) == want,
          "mixed: text rows != the MergeEngine replay")
    # Matrix.
    ops, seq = [], 1
    for t, tick_ops in enumerate(script["replay"]["matrix"]):
        ref = 1 + t * MIXED_K["matrix"]
        for op in tick_ops:
            seq += 1
            if op["target"] == mxk.MX_CELL:
                wire = {"target": "cell", "row": op["row"], "col": op["col"],
                        "value": op["value"]}
            else:
                wire = {"target": "rows" if op["target"] == mxk.MX_ROWS
                        else "cols", "type": "insert", "pos": op["pos"],
                        "count": op["count"]}
            ops.append((wire, seq, ref, "c0"))
    one = tree_map(torch.from_numpy, firsts["matrix"])
    check(mxk.materialize_grid(one, 0, _Identity()) == replay_grid(ops),
          "mixed: matrix rows != the PermutationVector + LWW replay")
    # Tree.
    slots = mixed_kwargs()["tree_slots"]
    slot_names = {0: ROOT_ID, **{i: f"s{i}" for i in range(1, slots)}}
    snap = TreeSnapshot()
    for tick_ops in script["replay"]["tree"]:
        snap, applied, _ = tree_scalar_apply(snap, tick_ops, slot_names)
        check(all(applied), "mixed: a tree op failed in the replay")
    tree_state_matches(tree_map(torch.from_numpy, firsts["tree"]), snap,
                       slot_names)


def mixed_device_rate(device, script) -> dict:
    """``_mixed_tick`` on inputs staged on the card ahead of time (the
    kept-fed serving pipeline's device rate): fresh joined states, the
    script's ticks, CUDA events around the whole series and after every
    leg. Returns ops/s, ms a tick and each leg's ms a tick."""
    import numpy as np
    import torch

    from fluidframework_tpu_torch.ops import tree_kernel as tk
    from fluidframework_tpu_torch.parallel.mesh import make_mesh
    from fluidframework_tpu_torch.parallel.serving import ShardedServing
    from fluidframework_tpu_torch.server import storm
    kw = mixed_kwargs()
    rows, docs = script["fam_rows"], kw["num_docs"]
    fields = {"text": storm.TEXT_PACK, "matrix": storm.MATRIX_PACK,
              "tree": storm.TREE_PACK}
    staged = []
    for t, (per_fam, _blob) in enumerate(script["ticks"]):
        scalars = np.zeros((docs, 6), np.int32)
        words = np.zeros((docs, MIXED_K["map"]), np.uint32)
        packs = {f: np.zeros((docs, len(fields[f]), MIXED_K[f]), np.int32)
                 for f in fields}
        for fam in script["families"]:
            n, r = MIXED_K[fam], rows[fam]
            scalars[r, 1], scalars[r, 2] = t * n + 1, 1 + t * n
            scalars[r, 3], scalars[r, 4] = 2 + t, n
            if fam == "map":
                scalars[r, 5] = n
                words[r] = per_fam["map"]
            else:
                packs[fam][r, 0, :n] = 1
                for i, name in enumerate(fields[fam][1:]):
                    packs[fam][r, i + 1, :n] = per_fam[fam][name]
        steps = tk.subtree_steps([[{"kind": int(x)} for x in
                                   per_fam["tree"]["kind"]]],
                                 MIXED_K["tree"])
        staged.append((torch.from_numpy(scalars).to(device),
                       torch.from_numpy(words.view(np.int32)).to(device),
                       *(torch.from_numpy(packs[f]).to(device)
                         for f in ("text", "matrix", "tree")), steps))

    def fresh():
        s = ShardedServing(make_mesh([device]), num_hosts=1, **kw)
        s.join_all()
        return [s.seq_state[0], s.map_state[0], s.merge_state[0],
                s.matrix_state[0], s.tree_state[0]]

    def run(states, marks=None):
        for t, (*inputs, steps) in enumerate(staged):
            if marks is not None:
                marks.append(("start", t, torch.cuda.Event(
                    enable_timing=True)))
                marks[-1][2].record()

            def mark(leg, t=t):
                if marks is not None:
                    marks.append((leg, t, torch.cuda.Event(
                        enable_timing=True)))
                    marks[-1][2].record()
            out = storm._mixed_tick(*states, *inputs, tree_steps=steps,
                                    mark=mark)
            states = list(out[:5])
        return states

    run(fresh())  # warm-up
    states = fresh()
    torch.cuda.synchronize()
    marks = []
    t0 = time.perf_counter()
    run(states, marks)
    end = torch.cuda.Event(enable_timing=True)
    end.record()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    ticks = len(staged)
    total_ms = marks[0][2].elapsed_time(end)
    legs: dict = {}
    for (_l0, t0_, e0), (leg, t1, e1) in zip(marks, marks[1:]):
        if leg != "start" and t0_ == t1:
            legs[leg] = legs.get(leg, 0.0) + e0.elapsed_time(e1) / ticks
    ops = script["ops_per_tick"] * ticks
    return {"device_ops_per_sec": ops / (total_ms / 1e3),
            "device_tick_ms": total_ms / ticks, "host_s": host_s,
            "leg_ms": legs, "ticks": ticks}


def mixed_path_a(device) -> dict:
    """Mixed A: ``bench_mixed_serving`` at full width through the port's
    ``ShardedServing`` on a one-shard mesh, kernels launched (counts
    zeroed just before, read just after); then the same on the plain
    versions, every plane, ack, tick output and durable record of the two
    runs equal; every row of each family held to its scalar replay; the
    staged device rate; and each kernel held to its plain version on the
    last call the path made to it."""
    import torch
    script = mixed_script()
    record: dict = {}
    launch_counts_reset()
    run = serve_mixed(device, script, record=record)
    counts = launch_counts()
    for name in ("map_fold", "sequencer_tick", "mergetree_blocks",
                 "matrix_tick", "tree_tick"):
        check(counts[name] > 0, f"mixed A launched no {name} kernel")
    # Every tick holds tree ops: one tree launch a tick.
    check(counts["tree_tick"] == MIXED_TICKS,
          f"mixed A: {counts['tree_tick']} tree kernel launches for "
          f"{MIXED_TICKS} ticks")
    serving = run["serving"]
    with plain_mixed_versions():
        plain = serve_mixed(device, script)
    check(run["harvests"] == plain["harvests"],
          "mixed A: acks of the kernel run != the plain run")
    check(len(run["harvests"]) == MIXED_TICKS,
          f"mixed A harvested {len(run['harvests'])} ticks")
    for t, (x, y) in enumerate(zip(run["outs"], plain["outs"])):
        for i, (p, q) in enumerate(zip(x[0], y[0])):
            check((p is None and q is None) or torch.equal(p, q),
                  f"mixed A tick {t}: output {5 + i} (n_seq, first, last, "
                  "msn, tree_overflow, text_overflow, kstats) != plain run")
    mixed_states_equal(serving, plain["serving"], "mixed A vs plain")
    del plain
    acked = sum(n for h in run["harvests"] for rows in h.values()
                for (n, _f, _l) in rows.values())
    check(acked == script["ops_per_tick"] * MIXED_TICKS,
          f"mixed A acked {acked} ops of "
          f"{script['ops_per_tick'] * MIXED_TICKS}")
    mixed_replays(serving, script)
    rate = mixed_device_rate(device, script)
    timed = MIXED_TICKS - 1
    out = {"docs": MIXED_DOCS, "ticks": MIXED_TICKS, "depth": MIXED_DEPTH,
           "ops_per_tick": script["ops_per_tick"],
           "assembly_ops_per_sec": script["ops_per_tick"] * timed
           / run["wall_s"],
           "assembly_tick_ms": 1e3 * run["wall_s"] / timed,
           **rate, "launches": {k: counts[k] for k in (
               "map_fold", "sequencer_tick", "mergetree_blocks",
               "matrix_tick", "tree_tick")},
           "launch_shapes": {k: [[*s, n] for s, n in v.items()]
                             for k, v in counts["shapes"].items()},
           "rebalance_stats": serving.rebalance_stats,
           "durable_records": sum(len(v) for v in serving.durable.values())}
    print("mixed_a: " + json.dumps(out), flush=True)
    return {"out": out, "counts": counts, "serving": serving,
            "harvests": run["harvests"], "outs": run["outs"],
            "record": record, "script": script}


def mixed_path_b(device, a: dict) -> dict:
    """Mixed B: the same script on a virtual mesh of MIXED_SHARDS shards
    of the card with MIXED_SHARDS simulated hosts. Each host harvests its
    own rows only; every plane and ack equals mixed A's; global_metrics
    equals the sum over mixed A's rows."""
    import numpy as np
    import torch
    launch_counts_reset()
    run = serve_mixed(device, a["script"], shards=MIXED_SHARDS,
                      hosts=MIXED_SHARDS)
    counts = launch_counts()
    check(counts["tree_tick"] == MIXED_TICKS * MIXED_SHARDS,
          f"mixed B: {counts['tree_tick']} tree kernel launches for "
          f"{MIXED_TICKS} ticks on {MIXED_SHARDS} shards")
    serving = run["serving"]
    for h in run["harvests"]:
        for port in serving.hosts:
            check(set(h[port.host_id]) <= set(range(port.start, port.stop)),
                  f"mixed B: host {port.host_id} harvested a foreign row")
    merged = [{r: v for rows in h.values() for r, v in rows.items()}
              for h in run["harvests"]]
    want = [{r: v for rows in h.values() for r, v in rows.items()}
            for h in a["harvests"]]
    check(merged == want, "mixed B acks != mixed A's")
    mixed_states_equal(serving, a["serving"], "mixed B vs mixed A")
    # The tick outputs, shards in row order, equal mixed A's; the kstats
    # rebalance cells are batch-wide, the others sum over the shards.
    for t, (x, y) in enumerate(zip(run["outs"], a["outs"])):
        for i in range(6):
            if y[0][i] is None:
                continue
            got = torch.cat([shard[i] for shard in x])
            check(torch.equal(got, y[0][i]),
                  f"mixed B tick {t}: output {5 + i} != mixed A's")
        ks = torch.stack([shard[6] for shard in x])
        check(torch.equal(ks[:, :3].sum(dim=0).to(torch.int32),
                          y[0][6][:3])
              and bool((ks[:, 3:] == y[0][6][3:]).all()),
              f"mixed B tick {t}: kstats != mixed A's")
    seq_a = a["serving"].family_rows("seq").seq
    present_a = a["serving"].family_rows("map").present
    metrics = serving.global_metrics()
    check(metrics == {"seq": int(seq_a.sum()),
                      "present": int(np.sum(present_a))},
          f"mixed B global_metrics {metrics} != the sum over mixed A")
    out = {"shards": MIXED_SHARDS, "hosts": MIXED_SHARDS,
           "assembly_ops_per_sec": a["script"]["ops_per_tick"]
           * (MIXED_TICKS - 1) / run["wall_s"],
           "assembly_tick_ms": 1e3 * run["wall_s"] / (MIXED_TICKS - 1),
           "global_metrics": metrics,
           "launches": {k: counts[k] for k in (
               "map_fold", "sequencer_tick", "mergetree_blocks",
               "matrix_tick", "tree_tick")},
           "launch_shapes": {k: [[*s, n] for s, n in v.items()]
                             for k, v in counts["shapes"].items()}}
    print("mixed_b: " + json.dumps(out), flush=True)
    return {"out": out, "counts": counts}


def grow_rounds(rng, rounds: int, writers: int, lag: int = 3):
    """Sequenced SharedString traffic for one document: per round every
    writer sends ONE op at the round's head ref (inserts 9 in 10, else a
    remove), positions valid in that frame; the msn is the ref of the
    round ``lag`` rounds back. Yields (op, seq, ref, msn, client)."""
    seq, length, refs = 0, 0, [0] * lag
    for _ in range(rounds):
        ref, grown, removed = seq, 0, []
        for w in range(writers):
            if length > 8 and rng.random() < 0.1:
                s = rng.randrange(length - 2)
                e = min(length, s + rng.randint(1, 3))
                op = {"type": "remove", "start": s, "end": e}
                removed.append((s, e))
            else:
                text = "".join(rng.choice("abcdef")
                               for _ in range(rng.randint(1, 3)))
                op = {"type": "insert", "pos": rng.randint(0, length),
                      "text": text}
                grown += len(text)
            seq += 1
            yield op, seq, ref, refs[0], f"w{w}"
        length += grown - union_len([s for s, _ in removed],
                                    [e for _, e in removed])
        refs = refs[1:] + [ref]


def grow_host(device, mesh, traffic) -> dict:
    """One document's traffic, a round a flush, through three merge hosts:
    one with the sequence-parallel pools on the card (a virtual mesh: the
    pool ticks with kernel 4, whose launches are counted and whose last
    call is held to the plain flat tick), one without them on the card,
    and the first again on the CPU. After every flush the card's
    sequence-parallel host must equal its CPU twin (text and, at the end,
    every plane), and its text must equal the MergeEngine replay and the
    unsharded host's — except from a flush that starts with the migrated
    row still holding segments past its slot count: there the reference
    departs from the replay (ROADMAP Queue C: a block row installed into a
    flat pool keeps its gaps, and the flat tick's end-of-table placement
    lands among them), the port with it, and only the twin check holds.
    The document must end in the sharded pool."""
    import torch

    from fluidframework_tpu_torch.dds.mergetree import MergeEngine
    from fluidframework_tpu_torch.ops import mergetree_sharded as mts
    from fluidframework_tpu_torch.protocol.messages import (
        MessageType,
        SequencedDocumentMessage,
    )
    from fluidframework_tpu_torch.server.merge_host import (
        KernelMergeHost,
        _ShardedMergePool,
    )
    from fluidframework_tpu_torch.ops import mergetree_blocks_cuda as mtbc
    from fluidframework_tpu_torch.ops import mergetree_cuda as mtc
    from fluidframework_tpu_torch.ops import mergetree_kernel as mtk
    cpu_mesh = mts.make_seg_mesh(["cpu"] * mesh.size)
    hosts = {"sharded": KernelMergeHost(
        flush_threshold=1 << 20, device=device, seg_mesh=mesh,
        sharded_slot_threshold=GROW_THRESHOLD),
        "flat": KernelMergeHost(flush_threshold=1 << 20, device=device),
        "cpu": KernelMergeHost(
            flush_threshold=1 << 20, device="cpu", seg_mesh=cpu_mesh,
            sharded_slot_threshold=GROW_THRESHOLD)}
    serve_s = {name: 0.0 for name in hosts}
    engine = MergeEngine(local_client=None)
    departed, migrated_round = None, None
    # The sequence-parallel host's own launches, counted from 0 just
    # before each of its flushes and read just after; ``pool_flat``: the
    # kernel-4 launches of flushes that found the row in the sharded pool.
    launches = {"mergetree_flat": 0, "mergetree_blocks": 0}
    pool_flat, pool_flushes = 0, 0
    kernel4, kept = mtc.apply_tick_best, {}

    def keep(state, ops, *args, **kw):
        # The sharded pool's last kernel-4 call, for the check below.
        kept["call"] = (type(state)(*(t.clone() for t in state)),
                        type(ops)(*(t.clone() for t in ops)))
        return kernel4(state, ops, *args, **kw)

    def gaps(host) -> int:
        row = next(iter(host._merge_rows.values()), None)
        if row is None or not isinstance(row.pool, _ShardedMergePool):
            return 0
        st = row.pool.state
        return int(st.valid[row.row, int(st.count[row.row]):].sum())
    for r in range(0, len(traffic), GROW_CLIENTS):
        gapped = gaps(hosts["sharded"])
        for op, sq, ref, msn, client in traffic[r:r + GROW_CLIENTS]:
            engine.apply_remote(op, sq, ref, client)
            for host in hosts.values():
                host.ingest("doc", SequencedDocumentMessage(
                    client_id=client, sequence_number=sq,
                    minimum_sequence_number=msn, client_sequence_number=sq,
                    reference_sequence_number=ref,
                    type=MessageType.OPERATION,
                    contents={"address": "default",
                              "contents": {"address": "text",
                                           "contents": op}}))
        first = next(iter(hosts["sharded"]._merge_rows.values()), None)
        in_pool = first is not None and isinstance(first.pool,
                                                   _ShardedMergePool)
        for name, host in hosts.items():
            if name == "sharded":
                mtc.launches = mtbc.launches = 0
                mtc.apply_tick_best = keep if in_pool else kernel4
            t0 = time.perf_counter()
            try:
                host.flush()
            finally:
                mtc.apply_tick_best = kernel4
            if name != "cpu":
                torch.cuda.synchronize()
            serve_s[name] += time.perf_counter() - t0
            if name == "sharded":
                launches["mergetree_flat"] += mtc.launches
                launches["mergetree_blocks"] += mtbc.launches
                if in_pool:
                    pool_flat += mtc.launches
                    pool_flushes += 1
        texts = {name: h.text("doc", "default", "text")
                 for name, h in hosts.items()}
        rnd = r // GROW_CLIENTS
        row = next(iter(hosts["sharded"]._merge_rows.values()))
        if migrated_round is None and isinstance(row.pool,
                                                 _ShardedMergePool):
            migrated_round = rnd
        check(texts["sharded"] == texts["cpu"],
              f"grow round {rnd}: sequence-parallel host on the card != "
              "on the CPU")
        if departed is None and (texts["sharded"] != engine.get_text()
                                 or texts["sharded"] != texts["flat"]):
            check(gapped > 0, f"grow round {rnd}: the sequence-parallel "
                  "host departs from the replay outside the reference's "
                  "gapped-row fault")
            departed = rnd
        if departed is None:
            check(texts["flat"] == engine.get_text(),
                  f"grow round {rnd}: the unsharded host != the replay")
    host = hosts["sharded"]
    row = next(iter(host._merge_rows.values()))
    check(isinstance(row.pool, _ShardedMergePool),
          f"the grown document stayed in a {row.pool.slots}-slot pool")
    check(pool_flushes > 0 and pool_flat >= pool_flushes,
          f"the sharded pool's {pool_flushes} flushes launched kernel 4 "
          f"{pool_flat} times")
    # Kernel 4 against the plain flat tick on the sharded pool's last call.
    st, ops = kept["call"]
    err = max_abs_err(kernel4(st, ops), mtk.apply_tick(st, ops))
    check(err == 0, f"grow: kernel 4 != the flat tick on the sharded pool's "
          f"inputs (max |err| {err})")
    pool_tick = {"shape": [st.length.shape[0], ops.kind.shape[1],
                           st.length.shape[1], st.prop_val.shape[2],
                           st.rem_overlap.shape[2]],
                 "variant": mtc.choose_variant(
                     st.length.shape[1], st.prop_val.shape[2],
                     st.rem_overlap.shape[2], ops.kind.shape[1],
                     mtc.smem_limit(st.length.device)),
                 "max_abs_err": err,
                 "ms": cuda_time_ms(lambda: kernel4(st, ops), 3),
                 "plain_ms": cuda_time_ms(lambda: mtk.apply_tick(st, ops), 1),
                 "bound_ms": flat_bound(st, ops)[0]}
    twin = next(iter(hosts["cpu"]._merge_rows.values()))
    for f in type(row.pool.state)._fields:
        check(torch.equal(getattr(row.pool.state, f).cpu(),
                          getattr(twin.pool.state, f)),
              f"grow: sharded pool plane {f}: card != CPU")
    return {"writers": GROW_CLIENTS, "rounds": GROW_ROUNDS, "lag": GROW_LAG,
            "ops": len(traffic), "threshold": GROW_THRESHOLD,
            "pool_slots": row.pool.slots, "migrated_round": migrated_round,
            "departed_round": departed,
            "text_len": len(host.text("doc", "default", "text")),
            "sharded_ops": host.metrics.counter("megadoc.sharded_ops").value,
            "launches": launches, "pool_flushes": pool_flushes,
            "pool_kernel4_launches": pool_flat, "pool_tick": pool_tick,
            "serve_s": serve_s, "stats": host.stats}


def seqpar_path(device) -> dict:
    """The sequence-parallel tier on the card.

    * ``apply_tick_sharded`` on a virtual mesh of SEQPAR_SHARDS shards of
      the card: one document of SEQPAR_S slots (the merge host's default
      ``sharded_slot_threshold``), SEQPAR_TICKS ticks of K = SEQPAR_K ops
      from SEQPAR_CLIENTS writers; every plane equal to kernel 4 and to
      the port's flat plain tick on the same inputs, every tick. Prints
      ms and launches a tick.
    * A ``KernelMergeHost`` with that mesh and a 4,096-slot threshold
      grows one config-2 document (1 doc x 128 writers) past the
      threshold, so it migrates into the sharded pool (``grow_host``)."""
    import random

    import numpy as np
    import torch

    from fluidframework_tpu_torch.ops import mergetree_cuda as mtc
    from fluidframework_tpu_torch.ops import mergetree_kernel as mtk
    from fluidframework_tpu_torch.ops import mergetree_sharded as mts
    from fluidframework_tpu_torch.protocol.messages import (
        MessageType,
        SequencedDocumentMessage,
    )
    from fluidframework_tpu_torch.server.merge_host import (
        KernelMergeHost,
        _ShardedMergePool,
    )
    mesh = mts.make_seg_mesh([device] * SEQPAR_SHARDS)
    rng = np.random.default_rng(17)
    ticks = merge_ticks(rng, 1, SEQPAR_K, SEQPAR_TICKS, SEQPAR_CLIENTS)
    w = mtk.overlap_words_for(SEQPAR_CLIENTS)
    sharded = mts.shard_merge_state(mtk.init_state(1, SEQPAR_S, 4, w,
                                                   device), mesh)
    flat = kern = mtk.init_state(1, SEQPAR_S, 4, w, device)
    ms, bounds, err = [], [], 0
    for f in ticks:
        ops = op_batch(f, device)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        new = mts.apply_tick_sharded(sharded, ops, mesh)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
        bounds.append(flat_bound(flat, ops))
        prev = flat
        flat = mtk.apply_tick(flat, ops)
        kern = mtc.apply_tick_best(kern, ops)
        torch.cuda.synchronize()
        err = max(err, max_abs_err(new, flat), max_abs_err(kern, flat))
        check(err == 0, "sequence-parallel tick != the flat tick or "
              f"kernel 4 (max |err| {err})")
        sharded = new
    last_ops = op_batch(ticks[-1], device)
    _, dispatched = count_dispatched(
        lambda: mts.apply_tick_sharded(prev, last_ops, mesh))
    torch.cuda.synchronize()
    # Kernel 4 and the flat plain tick on the last tick's inputs.
    kernel4_ms = cuda_time_ms(lambda: mtc.apply_tick_best(prev, last_ops), 3)
    plain_ms = cuda_time_ms(lambda: mtk.apply_tick(prev, last_ops), 1)
    tick = {"shape": [1, SEQPAR_K, SEQPAR_S, 4, w], "shards": SEQPAR_SHARDS,
            "ticks": SEQPAR_TICKS, "ms": sum(ms) / len(ms),
            "ms_min": min(ms), "ms_max": max(ms),
            "launches_per_tick": dispatched, "kernel4_ms": kernel4_ms,
            "plain_ms": plain_ms,
            "bound_ms": sum(b for b, _ in bounds) / len(bounds),
            "bound_by": bounds[-1][1], "max_abs_err": err,
            "segments": int(flat.count[0]),
            "kernel4_variant": mtc.choose_variant(
                SEQPAR_S, 4, w, SEQPAR_K, mtc.smem_limit(device))}

    traffic = list(grow_rounds(random.Random(23), GROW_ROUNDS,
                               GROW_CLIENTS, GROW_LAG))
    grow = grow_host(device, mesh, traffic)
    out = {"tick": tick, "host": grow}
    print("seq_parallel: " + json.dumps(out), flush=True)
    return out


def mixed_recheck(device, a: dict) -> dict:
    """Kernels 1, 2, 3 and 5 and the tree tick kernel held to their plain
    versions, and timed, on the last call mixed A made to each (the
    shapes that path gives them), in the variant the shape picks and the
    other one (the tree tick has one)."""
    from fluidframework_tpu_torch.ops import map_fold_cuda as mfc
    from fluidframework_tpu_torch.ops import map_kernel as mk
    from fluidframework_tpu_torch.ops import matrix_cuda as mxc
    from fluidframework_tpu_torch.ops import matrix_kernel as mxk
    from fluidframework_tpu_torch.ops import mergetree_blocks as mtb
    from fluidframework_tpu_torch.ops import mergetree_blocks_cuda as mtbc
    from fluidframework_tpu_torch.ops import sequencer as seqk
    from fluidframework_tpu_torch.ops import sequencer_cuda as seqc
    from fluidframework_tpu_torch.ops import tree_cuda as tcc
    from fluidframework_tpu_torch.ops import tree_kernel as tk
    record, shapes = a["record"], a["counts"]["shapes"]

    def one(name):
        check(name in record and len(shapes[name]) == 1,
              f"mixed A gave {name} the shapes {shapes[name]}")
        shape = next(iter(shapes[name]))
        return {shape: 1}, {shape: [record[name]]}
    out = {}
    by, kept = one("map_fold")
    out["map_fold"] = recheck_recorded(
        "map_fold (mixed_a)", by, kept, mfc.fold_words, mk.fold_words_plain,
        fold_bound, ops_of=lambda args: windowed_ops(*args[1:4]),
        other=lambda *args: mfc.fold_words(*args, variant="block"),
        other_name="block")
    by, kept = one("mergetree_blocks")
    out["mergetree_blocks"] = recheck_recorded(
        "mergetree_blocks (mixed_a)", by, kept,
        blocks_planes(mtbc.apply_tick_blocks_best),
        blocks_planes(mtb.apply_tick_blocks), blocks_bound,
        other=blocks_planes(lambda st, op: mtbc.apply_tick_blocks_best(
            st, op, "global")))
    by, kept = one("matrix_tick")
    out["matrix_tick"] = recheck_recorded(
        "matrix_tick (mixed_a)", by, kept, mxc.apply_tick_best,
        mxk.apply_tick, matrix_bound,
        other=lambda st, op: mxc.apply_tick_best(st, op, "global"))
    by, kept = one("tree_tick")
    out["tree_tick"] = recheck_recorded(
        "tree_tick (mixed_a)", by, kept, tcc.apply_tick_best, tk.apply_tick,
        tree_bound)
    by, kept = one("sequencer_tick")
    got = recheck_recorded(
        "sequencer_tick (mixed_a)", by, kept,
        lambda st, op: seqc.process_batch_best(st, op, "warp"),
        seqk.process_batch, deli_bound,
        other=lambda st, op: seqc.process_batch_best(st, op, "thread"),
        other_name="thread", time_all=True)
    got["ms_warp"] = got.pop("ms")
    got["variant"] = seqc.deli_variant(*got["shape"],
                                       seqc.smem_limit(device))
    got["ms"] = got[f"ms_{got['variant']}"]
    out["sequencer_tick"] = got
    return {name: {k: r[k] for k in r if k != "by_call"}
            for name, r in out.items()}


def trace_mixed_path(device) -> dict:
    """Mixed A's front-door ticks again under ``torch.profiler``: device
    busy ms against the host's wall ms over the same ticks (the profiler
    slows the host, so the idle share is an upper bound)."""
    prof = new_profile()
    run = serve_mixed(device, mixed_script(), ticks_ctx=lambda: prof)
    out = idle_record(prof, run["wall_s"] * 1e3, "serve_ms")
    print("trace_mixed: " + json.dumps(out), flush=True)
    return out


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


def new_profile():
    """A ``torch.profiler`` session over the host and the card."""
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def idle_record(prof, wall_ms: float, wall_key: str = "wall_ms") -> dict:
    """A finished profile over ``wall_ms`` of host time: the device's busy
    ms, its idle share (an upper bound: the profiler slows the host) and
    the device events that took the most time."""
    busy_ms, top = device_busy(prof)
    return {wall_key: wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / wall_ms if busy_ms else None,
            "top_device_ms": top}


@contextlib.contextmanager
def traced(enabled: bool, out: dict, key: str):
    """Run the block under ``torch.profiler`` when ``enabled``; then
    ``out[key]`` holds its wall ms, device busy ms and idle share."""
    if not enabled:
        yield
        return
    import torch
    prof = new_profile()
    with prof:
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    out[key] = idle_record(prof, wall_ms)


def trace_main_path(device) -> dict:
    """The main path's served ticks again under ``torch.profiler``: device
    busy ms against the host's wall ms over the same ticks, and the
    device events that took the most time. The profiler slows the host,
    so the idle share is an upper bound."""
    script = make_script(7, DOCS, TICKS, K_MAP, FRAMES_PER_TICK)
    prof = new_profile()
    run = serve(device, script, DOCS, ticks_ctx=lambda: prof)
    out = idle_record(prof, run["t_serve"] * 1e3, "serve_ms")
    print("trace: " + json.dumps(out), flush=True)
    return out


def trace_durable_path(device) -> dict:
    """The durable path's serve again under ``torch.profiler`` (its own
    temp dir, deleted after): device busy ms against the host's wall ms
    over the served ticks, the checkpoints included."""
    import shutil
    import tempfile

    script = make_script(7, DOCS, TICKS, K_MAP, FRAMES_PER_TICK)
    prof = new_profile()
    root = pathlib.Path(tempfile.mkdtemp(prefix="ff-durable-trace-"))
    try:
        run = serve_durable(device, script, root, {},
                            ticks_ctx=lambda: prof)
        run["storm"]._group_wal.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out = idle_record(prof, run["t_serve"] * 1e3, "serve_ms")
    print("trace_durable: " + json.dumps(out), flush=True)
    return out


def trace_text_paths(device) -> dict:
    """Both text paths again, each whole under ``torch.profiler``: device
    busy ms against the host's wall ms over the path (an upper bound on
    the idle share, as for the map path)."""
    out: dict = {}
    for name, drive in (("a", text_path_a), ("b", text_path_b)):
        with traced(True, out, name):
            drive(device)
    print("trace_text: " + json.dumps(out), flush=True)
    return out


def trace_matrix_paths(device) -> dict:
    """Both matrix paths again, each whole under ``torch.profiler`` (path
    B at two flushes, for the profiler's post-processing time): device
    busy ms against the host's wall ms over the path."""
    out: dict = {}
    for name, drive in (("a", matrix_path_a),
                        ("b", lambda dev: matrix_path_b(dev, flushes=2))):
        with traced(True, out, name):
            drive(device)
    print("trace_matrix: " + json.dumps(out), flush=True)
    return out


def trace_tree_path(device) -> dict:
    """Tree path A again, whole under ``torch.profiler``: device busy ms
    against the host's wall ms over the path."""
    got: dict = {}
    with traced(True, got, "tree"):
        tree_path_a(device)
    out = got["tree"]
    print("trace_tree: " + json.dumps(out), flush=True)
    return out


# -- the device-pool planes: tiered residency and the mega-doc tier ------------

#: Residency A (the reference ``bench_residency_churn``): a pool of
#: RES_POOL resident docs (``max_resident`` and the sequencer host's
#: initial capacity), RES_POOL + RES_EXTRA_COLD docs ever served out of a
#: registered namespace of RES_REGISTERED ids (never-served ids hold no
#: state anywhere, so the namespace is a name only), joins in chunks of
#: RES_JOIN_CHUNK, two full-cohort warm ticks, then RES_CHURN_FRAMES
#: frames of RES_FRAME_DOCS docs x K = RES_K, RES_COLD_PER_FRAME of them
#: cold.
RES_REGISTERED = 1_000_000
RES_POOL = 10_000
RES_EXTRA_COLD = 800
RES_JOIN_CHUNK = 1_250
RES_CHURN_FRAMES = 30
RES_FRAME_DOCS = 64
RES_COLD_PER_FRAME = 6
RES_K = 8
#: Residency S (the reference ``bench_residency_storm``): every one of
#: STORM_COLD_DOCS cold docs knocks at simulated t = 0 against a
#: STORM_POOL-slot pool and a STORM_RATE hydrations/s bucket.
STORM_COLD_DOCS = 768
STORM_POOL = 256
STORM_RATE = 200.0
#: Mega A (the reference ``bench_megadoc_writers``' widest arm): one doc,
#: MEGA_WRITERS writers joined through the front door, one frame of K =
#: MEGA_K ops each, MEGA_LANES lanes, waves of MEGA_WAVE frames in
#: lane-striped order: the first MEGA_WAVES waves of the reference's 157
#: (one frame from each of 1,024 writers; a depth cut: every writer
#: still joins). The two arms share one join: the single-lane arm
#: recovers the promoted arm's checkpoint after the joins and text round
#: 0. MEGA_TEXT_WRITERS of the writers write the doc's
#: text channel through the service instead, before, during and after
#: promotion; the merge host's seg_mesh is MEGA_SEG_SHARDS virtual
#: shards of the card.
MEGA_WRITERS = 10_000
MEGA_K = 8
MEGA_LANES = 8
MEGA_WAVE = 64
MEGA_WAVES = 16
MEGA_TEXT_WRITERS = 8
MEGA_SEG_SHARDS = 4
#: Mega L: MegaDocLanes on mixed B's mesh shape (LANES_DOCS docs on
#: LANES_SHARDS virtual shards of the card, LANES_HOSTS simulated
#: hosts): LANES_ROWS lane rows spread over the shards, LANES_WRITERS
#: writers, LANES_ROUNDS rounds of fresh / dup / gap batches.
LANES_DOCS = 8192
LANES_SHARDS = 4
LANES_HOSTS = 4
LANES_ROWS = 8
LANES_WRITERS = 64
LANES_ROUNDS = 4
LANES_SLOTS = 32


#: The kernel wrappers the plane paths launch: (name, module, attribute).
PLANE_KERNELS = (("map_fold", "map_fold_cuda", "fold_words"),
                 ("sequencer_tick", "sequencer_cuda", "process_batch_best"),
                 ("mergetree_blocks", "mergetree_blocks_cuda",
                  "apply_tick_blocks_best"),
                 ("mergetree_flat", "mergetree_cuda", "apply_tick_best"))


@contextlib.contextmanager
def plane_recording(kept: dict):
    """``recording`` on the four plane-path kernel wrappers at once: every
    call's arguments kept in ``kept[kernel][shape]``."""
    import importlib
    with contextlib.ExitStack() as stack:
        for name, mod, attr in PLANE_KERNELS:
            kept[name] = {}
            stack.enter_context(recording(
                importlib.import_module(f"fluidframework_tpu_torch.ops.{mod}"),
                attr, kept[name]))
        yield


def drop_leading_repeats(kept: dict, ref: dict) -> dict:
    """Drop from ``kept`` (a plane path's calls) each call, from the first
    on, whose arguments equal ``ref``'s call at the same shape and index:
    those stand checked by ``ref``'s re-check. Returns the number dropped
    per kernel."""
    import torch

    def same(a, b) -> bool:
        la, lb = leaves(a), leaves(b)
        return len(la) == len(lb) and all(
            x.dtype == y.dtype and x.shape == y.shape
            and bool(torch.equal(x, y)) for x, y in zip(la, lb))
    dropped = {}
    for name, by_shape in kept.items():
        dropped[name] = 0
        for shape, calls in by_shape.items():
            theirs = ref.get(name, {}).get(shape, [])
            n = 0
            while n < min(len(calls), len(theirs)) \
                    and same(calls[n], theirs[n]):
                n += 1
            del calls[:n]
            dropped[name] += n
        for shape in [sh for sh, c in by_shape.items() if not c]:
            del by_shape[shape]
    return dropped


def plane_recheck(device, name: str, path: str, kept: dict,
                  ends_only: bool = False) -> dict | None:
    """One kernel held to its plain version on every call a plane path
    made (both variants), and timed on the last call at each launch
    shape. ``ends_only`` holds each shape's first and last call only
    (where the plain version takes over 100 ms a call)."""
    from fluidframework_tpu_torch.ops import map_fold_cuda as mfc
    from fluidframework_tpu_torch.ops import map_kernel as mk
    from fluidframework_tpu_torch.ops import matrix_cuda as mxc
    from fluidframework_tpu_torch.ops import matrix_kernel as mxk
    from fluidframework_tpu_torch.ops import mergetree_blocks as mtb
    from fluidframework_tpu_torch.ops import mergetree_blocks_cuda as mtbc
    from fluidframework_tpu_torch.ops import mergetree_cuda as mtc
    from fluidframework_tpu_torch.ops import mergetree_kernel as mtk
    from fluidframework_tpu_torch.ops import sequencer as seqk
    from fluidframework_tpu_torch.ops import sequencer_cuda as seqc
    from fluidframework_tpu_torch.ops import tree_cuda as tcc
    from fluidframework_tpu_torch.ops import tree_kernel as tk
    calls = kept.get(name) or {}
    if not calls:
        return None
    shapes = {sh: len(c) for sh, c in calls.items()}
    label = f"{name} ({path})"
    if name == "tree_tick":
        return recheck_recorded(
            label, shapes, calls, tcc.apply_tick_best, tk.apply_tick,
            tree_bound, time_all=True, time_last=True, ends_only=ends_only)
    if name == "map_fold":
        return recheck_recorded(
            label, shapes, calls, mfc.fold_words, mk.fold_words_plain,
            fold_bound, ops_of=lambda args: windowed_ops(*args[1:4]),
            other=lambda *args: mfc.fold_words(*args, variant="block"),
            other_name="block", time_all=True, time_last=True)
    if name == "mergetree_blocks":
        return recheck_recorded(
            label, shapes, calls,
            blocks_planes(mtbc.apply_tick_blocks_best),
            blocks_planes(mtb.apply_tick_blocks), blocks_bound,
            other=blocks_planes(lambda st, op: mtbc.apply_tick_blocks_best(
                st, op, "global")), time_all=True, time_last=True,
            ends_only=ends_only)
    if name == "mergetree_flat":
        return recheck_recorded(
            label, shapes, calls, mtc.apply_tick_best, mtk.apply_tick,
            flat_bound,
            other=lambda st, op: mtc.apply_tick_best(st, op, "global"),
            time_all=True, time_last=True, ends_only=ends_only)
    if name == "matrix_tick":
        return recheck_recorded(
            label, shapes, calls, mxc.apply_tick_best, mxk.apply_tick,
            matrix_bound,
            other=lambda st, op: mxc.apply_tick_best(st, op, "global"),
            time_all=True, time_last=True, ends_only=ends_only)
    # Both variants where a document's lanes fit the warp variant's
    # shared memory; past it (the mega doc's 10,000 writers) the
    # one-thread variant alone, the one the shape picks, held to the
    # plain version on each shape's first and last call (the plain deli
    # takes about a second a call at 16,385 lanes).
    limit = seqc.smem_limit(device)
    fits = {sh for sh in calls if seqc.warp_smem_bytes(sh[2]) <= limit}
    got = {}
    if fits:
        got = recheck_recorded(
            label, {sh: shapes[sh] for sh in fits},
            {sh: calls[sh] for sh in fits},
            lambda st, op: seqc.process_batch_best(st, op, "warp"),
            seqk.process_batch, deli_bound,
            other=lambda st, op: seqc.process_batch_best(st, op, "thread"),
            other_name="thread", time_all=True, time_last=True,
            ends_only=ends_only)
        got["ms_warp"] = got.pop("ms")
        for end in ("min", "max"):
            got[f"ms_warp_{end}"] = got.pop(f"ms_{end}")
        got["variant"] = seqc.deli_variant(*got["shape"], limit)
        got["ms"] = got[f"ms_{got['variant']}"]
    wide = sorted(set(calls) - fits)
    if wide:
        alone = recheck_recorded(
            f"{label}, past the warp variant's shared memory",
            {sh: shapes[sh] for sh in wide}, {sh: calls[sh] for sh in wide},
            lambda st, op: seqc.process_batch_best(st, op, "thread"),
            seqk.process_batch, deli_bound, time_all=True, time_last=True,
            ends_only=True)
        alone.update(variant="thread", ms_thread=alone["ms"])
        if not got:
            return alone
        got["thread_only"] = {k: v for k, v in alone.items()
                              if k != "by_call"}
        got["max_abs_err"] = max(got["max_abs_err"], alone["max_abs_err"])
    return got


def residency_stack(device, root: pathlib.Path, pool, clock=None,
                    durable_bus: bool = True, **res_kw):
    """The reference benches' residency stack on the card: a durable bus
    and state store (in memory with ``durable_bus=False``), a
    group-commit tick WAL and a git snapshot store under ``root``, a
    sequencer host sized to the pool, and (``pool`` not None) a
    ResidencyManager capping it. A pinned service clock."""
    from fluidframework_tpu_torch.server.durable_store import (
        DurableMessageBus,
        FileStateStore,
        GitSnapshotStore,
    )
    from fluidframework_tpu_torch.server.kernel_host import \
        KernelSequencerHost
    from fluidframework_tpu_torch.server.merge_host import KernelMergeHost
    from fluidframework_tpu_torch.server.residency import ResidencyManager
    from fluidframework_tpu_torch.server.routerlicious import \
        RouterliciousService
    from fluidframework_tpu_torch.server.storm import StormController
    seq_host = KernelSequencerHost(num_slots=2,
                                   initial_capacity=pool or RES_POOL,
                                   device=device)
    merge_host = KernelMergeHost(flush_threshold=10**9, device=device)
    tiers = (dict(bus=DurableMessageBus(str(root / "bus")),
                  store=FileStateStore(str(root / "state")))
             if durable_bus else {})
    service = RouterliciousService(
        merge_host=merge_host, batched_deli_host=seq_host,
        auto_pump=False, idle_check_interval=10**9, **tiers)
    ticks = iter(range(1000, 1 << 30, 3))
    service._clock = lambda: next(ticks)
    storm = StormController(
        service, seq_host, merge_host, flush_threshold_docs=10**9,
        spill_dir=str(root / "spill"), durability="group",
        snapshots=GitSnapshotStore(str(root / "git")))
    res = None
    if pool is not None:
        kw = dict(max_resident=pool, idle_evict_s=1e9,
                  hydration_rate_per_s=1e9)
        kw.update(res_kw)
        if clock is not None:
            kw["clock"] = clock
        res = ResidencyManager(storm, **kw)
    return service, storm, seq_host, merge_host, res


def residency_words(seed, k):
    """The reference benches' residency words: SETs of slots 0-15 to
    values 1 .. 2^18 (no deletes or clears)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    slots = rng.integers(0, 16, k).astype(np.uint32)
    vals = rng.integers(1, 1 << 18, k).astype(np.uint32)
    return (slots << np.uint32(2)) | (vals << np.uint32(12))


def connect_in_chunks(service, docs, chunk) -> dict:
    clients = {}
    for base in range(0, len(docs), chunk):
        for d in docs[base:base + chunk]:
            clients[d] = service.connect(d, lambda m: None).client_id
        service.pump()
    return clients


def doc_maps(storm, merge_host, res, docs) -> dict:
    """Every doc's map (slot -> value): from its device row when resident
    (the planes read once), else from its cold snapshot in the store."""
    import numpy as np

    from fluidframework_tpu_torch.server.merge_host import (
        ChannelKey,
        _nd_unpack,
    )
    from fluidframework_tpu_torch.server.residency import COLD_KEY_PREFIX
    storm.flush()
    present = merge_host._xstate.present.cpu().numpy()
    value = merge_host._xstate.value.cpu().numpy()
    out = {}
    for d in docs:
        key = ChannelKey(d, storm.datastore, storm.channel)
        if res is None or res.is_resident(d):
            mrow = merge_host._map_rows.get(key)
            if mrow is None:
                out[d] = {}
                continue
            row = mrow.row
            out[d] = {int(s): int(value[row, s])
                      for s in np.flatnonzero(present[row])}
            continue
        snap = storm.snapshots.get(COLD_KEY_PREFIX + d, res.cold_handle(d))
        m = snap["map_row"] if snap else None
        if m is None:
            out[d] = {}
            continue
        p, v = _nd_unpack(m["present"]), _nd_unpack(m["value"])
        out[d] = {int(s): int(v[s]) for s in np.flatnonzero(p)}
    return out


def fold_frames(frames, docs) -> dict:
    """The numpy fold of every doc's words over the frames, in order
    (SETs only: the last write to a slot wins)."""
    import numpy as np
    out = {d: {} for d in docs}
    for _rid, entries, payload in frames:
        words = np.frombuffer(payload, np.uint32)
        off = 0
        for d, _c, _c0, _r, k in entries:
            for w in words[off:off + k].tolist():
                out[d][(w >> 2) & 0x3FF] = w >> 12
            off += k
    return out


def residency_path_a(device, root: pathlib.Path, churn_ctx=None,
                     verify: bool = True, after_join=None) -> dict:
    """Residency A (see RES_*): serve the churn on the card with a pool
    of RES_POOL, held to a numpy fold of every doc's words and to a twin
    stack on the card with no residency (every doc resident) serving the
    same frames. ``churn_ctx`` wraps the churn frames (the trace);
    ``verify=False`` skips the checks and the twin; ``after_join()`` runs
    after the joins, before the first frame."""
    import numpy as np
    import torch

    from fluidframework_tpu_torch.server.residency import _rss_mb
    torch.cuda.reset_peak_memory_stats()
    base_mb = torch.cuda.memory_allocated() / 2**20  # earlier phases' own
    service, storm, seq_host, merge_host, res = residency_stack(
        device, root / "res", RES_POOL)
    ever = RES_POOL + RES_EXTRA_COLD
    docs = [f"r12-doc-{i}" for i in range(ever)]
    rng = np.random.default_rng(12)
    kept: dict = {}
    launch_counts_reset()
    with plane_recording(kept):
        t0 = time.perf_counter()
        clients = connect_in_chunks(service, docs, RES_JOIN_CHUNK)
        t_join = time.perf_counter() - t0
        if after_join is not None:
            after_join()
        hot = list(res.resident)
        cseqs = {d: 1 for d in docs}
        frames, acks = [], {}

        def sink(p):
            acks[p["rid"]] = p

        for r in range(2):
            entries = [[d, clients[d], cseqs[d], 1, RES_K] for d in hot]
            payload = b"".join(residency_words((12, r, i), RES_K).tobytes()
                               for i in range(len(hot)))
            frames.append((r, entries, payload))
            storm.submit_frame(sink, {"rid": r, "docs": entries},
                               memoryview(payload))
            storm.flush()
            for d in hot:
                cseqs[d] += RES_K
        storm.checkpoint()  # Residency R's restore source
        rss_hot = _rss_mb()
        ev0, hy0 = res.stats["evictions"], res.stats["hydrations"]
        reads0 = merge_host.map_row_reads
        ctx = churn_ctx() if churn_ctx is not None \
            else contextlib.nullcontext()
        ctx.__enter__()
        t1 = time.perf_counter()
        ops = 0
        for f in range(RES_CHURN_FRAMES):
            resident = list(res.resident)
            cold_pool = [d for d in docs if d not in res.resident]
            picks = ([resident[i] for i in rng.choice(
                len(resident), RES_FRAME_DOCS - RES_COLD_PER_FRAME,
                replace=False)]
                + [cold_pool[i] for i in rng.choice(
                    len(cold_pool), RES_COLD_PER_FRAME, replace=False)])
            entries = [[d, clients[d], cseqs[d], 1, RES_K] for d in picks]
            payload = b"".join(residency_words((13, f, i), RES_K).tobytes()
                               for i in range(len(picks)))
            frames.append((100 + f, entries, payload))
            storm.submit_frame(sink, {"rid": 100 + f, "docs": entries},
                               memoryview(payload))
            storm.flush()
            for d in picks:
                cseqs[d] += RES_K
            ops += len(picks) * RES_K
        torch.cuda.synchronize()
        t_churn = time.perf_counter() - t1
        ctx.__exit__(None, None, None)
    counts = launch_counts()
    if not verify:
        storm._group_wal.close()
        return {"churn_s": t_churn}
    rss_churn = _rss_mb()
    snap = merge_host.metrics.snapshot()
    hydrations = res.stats["hydrations"] - hy0
    evictions = res.stats["evictions"] - ev0
    check(hydrations > 0 and evictions > 0,
          f"residency A: {hydrations} hydrations, {evictions} evictions "
          "in the churn")
    check(len(acks) == len(frames)
          and not any(a.get("error") for a in acks.values()),
          "residency A: a frame was not acked")
    maps = doc_maps(storm, merge_host, res, docs)
    want = fold_frames(frames, docs)
    bad = [d for d in docs if maps[d] != want[d]]
    check(not bad, f"residency A: {len(bad)} docs' maps != the numpy fold "
          f"(first {bad[:3]})")
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    # The twin: every doc resident, the same frames in the same order.
    # Its bus and state store are in memory: the checks read only its
    # acks and map rows, and in-memory joins are cheaper.
    t_svc, t_storm, t_seq, t_mh, _ = residency_stack(
        device, root / "twin", None, durable_bus=False)
    t_acks: dict = {}
    t0 = time.perf_counter()
    t_clients = connect_in_chunks(t_svc, docs, RES_JOIN_CHUNK)
    t_twin_join = time.perf_counter() - t0
    check(t_clients == clients, "residency twin: client ids differ")
    for rid, entries, payload in frames:
        t_storm.submit_frame(lambda p: t_acks.__setitem__(p["rid"], p),
                             {"rid": rid, "docs": entries},
                             memoryview(payload))
        t_storm.flush()
    for rid, a in acks.items():
        check(np.array_equal(np.asarray(a.rows),
                             np.asarray(t_acks[rid].rows)),
              f"residency A: frame {rid}'s acks != the twin's")
    t_maps = doc_maps(t_storm, t_mh, None, docs)
    check(t_maps == maps, "residency A: maps != the no-residency twin's")
    t_storm._group_wal.close()
    out = {
        "registered_docs": RES_REGISTERED, "pool_slots": RES_POOL,
        "ever_served_docs": ever,
        "never_served_docs": RES_REGISTERED - ever,
        "resident_docs": len(res.resident),
        "seq_row_high_water": seq_host._row_count,
        "join_s": t_join, "twin_join_s": t_twin_join,
        "churn_frames": RES_CHURN_FRAMES,
        "churn_s": t_churn, "churn_ops_per_s": ops / t_churn,
        "hydrations": hydrations, "evictions": evictions,
        "hydration_ms_p50": 1e3 * snap.get("residency.hydrate_s.p50", 0.0),
        "hydration_ms_p99": 1e3 * snap.get("residency.hydrate_s.p99", 0.0),
        "evict_ms_p50": 1e3 * snap.get("residency.evict_s.p50", 0.0),
        "evict_ms_p99": 1e3 * snap.get("residency.evict_s.p99", 0.0),
        "rss_mb_hot": rss_hot, "rss_mb_after_churn": rss_churn,
        "cuda_max_memory_allocated_mb": peak_mb,
        "cuda_allocated_before_mb": base_mb,
        # The recorded kernel inputs (instrumentation) are in the peak.
        "cuda_recorded_inputs_mb": sum(
            t.numel() * t.element_size() for by_shape in kept.values()
            for calls in by_shape.values() for args in calls
            for t in leaves(args)) / 2**20,
        "evict_device_reads": merge_host.map_row_reads - reads0,
        "launches": {k: counts[k] for k in (
            "map_fold", "sequencer_tick", "mergetree_blocks",
            "mergetree_flat")}}
    print("residency_a: " + json.dumps(out), flush=True)
    deli_picks(device, counts["shapes"]["sequencer_tick"],
               counts["variants"]["sequencer_tick"], "residency A")
    check(counts["map_fold"] > 0 and counts["sequencer_tick"] > 0,
          "residency A launched no map fold or no deli")
    return {"out": out, "counts": counts, "kept": kept, "docs": docs,
            "maps": maps, "storm": storm, "clients": clients}


def residency_path_r(device, root: pathlib.Path, a: dict) -> dict:
    """Residency R: a fresh stack with a ResidencyManager recovers
    Residency A's directories on the card (the checkpoint after the warm
    ticks, then the churn replayed: cold docs hydrate on first touch) and
    every doc's map equals the live stack's."""
    a["storm"]._group_wal.close()
    service, storm, seq_host, merge_host, res = residency_stack(
        device, root / "res", RES_POOL)
    kept: dict = {}
    launch_counts_reset()
    with plane_recording(kept):
        t0 = time.perf_counter()
        info = storm.recover()
        import torch
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    counts = launch_counts()
    check(info["restored_from"] is not None and info["replayed_ticks"] > 0,
          f"residency R: recover() {info}")
    maps = doc_maps(storm, merge_host, res, a["docs"])
    bad = [d for d in a["docs"] if maps[d] != a["maps"][d]]
    check(not bad, f"residency R: {len(bad)} docs != the live stack's "
          f"(first {bad[:3]})")
    check(res.stats["replay_hydrations"] > 0,
          "residency R: the replay hydrated no cold doc")
    check(counts["map_fold"] > 0, "residency R launched no map fold")
    storm._group_wal.close()
    out = {"recover_s": seconds, **info,
           "replay_hydrations": res.stats["replay_hydrations"],
           "resident_docs": len(res.resident),
           "launches": {k: counts[k] for k in (
               "map_fold", "sequencer_tick", "mergetree_blocks",
               "mergetree_flat")}}
    print("residency_r: " + json.dumps(out), flush=True)
    return {"out": out, "counts": counts, "kept": kept}


def residency_path_s(device, root: pathlib.Path) -> dict:
    """Residency S (see STORM_*): serve every doc, evict them all, then
    every client knocks at simulated t = 0 and returns at its hint;
    hydration starts per simulated second stay within rate + burst and
    every doc converges to its served map."""
    import heapq

    clk = [0.0]
    service, storm, seq_host, merge_host, res = residency_stack(
        device, root, STORM_POOL, clock=lambda: clk[0],
        hydration_rate_per_s=STORM_RATE)
    docs = [f"storm-doc-{i}" for i in range(STORM_COLD_DOCS)]
    kept: dict = {}
    frames = []
    launch_counts_reset()
    with plane_recording(kept):
        clients = connect_in_chunks(service, docs, STORM_POOL)
        for base in range(0, STORM_COLD_DOCS, STORM_POOL):
            chunk = docs[base:base + STORM_POOL]
            for d in chunk:
                res.ensure_resident(d, gate=False)
            entries = [[d, clients[d], 1, 1, RES_K] for d in chunk]
            payload = b"".join(residency_words((14, base, i), RES_K)
                               .tobytes() for i in range(len(chunk)))
            frames.append((base, entries, payload))
            storm.submit_frame(None, {"rid": base, "docs": entries},
                               memoryview(payload))
            storm.flush()
        for d in list(res.resident):
            res.evict(d)
        check(not res.resident, "residency S: docs still resident")
        nacks0 = res.stats["hydration_nacks"]
        events = [(0.0, i, docs[i]) for i in range(STORM_COLD_DOCS)]
        heapq.heapify(events)
        hydrated_at: dict = {}
        attempts = 0
        t0 = time.perf_counter()
        while events:
            t, i, doc = heapq.heappop(events)
            clk[0] = t
            attempts += 1
            retry = res.ensure_resident(doc)
            if retry is None:
                hydrated_at[doc] = t
            else:
                heapq.heappush(events, (t + retry, i, doc))
        wall_s = time.perf_counter() - t0
    counts = launch_counts()
    per_sec: dict = {}
    for t in hydrated_at.values():
        per_sec[int(t)] = per_sec.get(int(t), 0) + 1
    burst = res.hydrations.burst
    check(len(hydrated_at) == STORM_COLD_DOCS,
          f"residency S: {len(hydrated_at)} of {STORM_COLD_DOCS} converged")
    check(max(per_sec.values()) <= STORM_RATE + burst,
          f"residency S: {max(per_sec.values())} hydrations in one "
          f"simulated second > rate + burst {STORM_RATE + burst}")
    maps = doc_maps(storm, merge_host, res, docs)
    check(maps == fold_frames(frames, docs),
          "residency S: a doc's map != the numpy fold of its words")
    storm._group_wal.close()
    makespan = max(hydrated_at.values())
    out = {"cold_docs": STORM_COLD_DOCS, "pool_slots": STORM_POOL,
           "hydration_rate_per_s": STORM_RATE, "hydration_burst": burst,
           "sim_makespan_s": makespan,
           "ideal_drain_s": STORM_COLD_DOCS / STORM_RATE,
           "peak_hydrations_per_sim_s": max(per_sec.values()),
           "attempts": attempts,
           "hydration_nacks": res.stats["hydration_nacks"] - nacks0,
           "storm_wall_s": wall_s, "evictions": res.stats["evictions"],
           "launches": {k: counts[k] for k in (
               "map_fold", "sequencer_tick", "mergetree_blocks",
               "mergetree_flat")}}
    print("residency_s: " + json.dumps(out), flush=True)
    check(counts["map_fold"] > 0 and counts["sequencer_tick"] > 0,
          "residency S launched no map fold or no deli")
    return {"out": out, "counts": counts, "kept": kept}


def text_messages(service, doc, from_seq: int) -> list:
    """The doc's sequenced text ops past ``from_seq``."""
    from fluidframework_tpu_torch.protocol.messages import MessageType
    return [m for m in service.get_deltas(doc, from_seq)
            if m.type == MessageType.OPERATION
            and m.contents["contents"]["address"] == "text"]


class MegaClock:
    """Mega A's pinned service clock (1000, 1003, ...). ``at`` is its next
    reading, so a stack recovered from a checkpoint resumes it."""

    def __init__(self, at: int = 1000) -> None:
        self.at = at

    def __call__(self) -> int:
        self.at += 3
        return self.at - 3


def mega_stack(device, root: pathlib.Path, clock: MegaClock,
               promoted: bool) -> dict:
    """A Mega A serving stack on ``root`` (the durable bus, state store,
    group WAL and snapshots), with a MegaDocManager when ``promoted``."""
    from fluidframework_tpu_torch.ops.mergetree_sharded import make_seg_mesh
    from fluidframework_tpu_torch.server.durable_store import (
        DurableMessageBus,
        FileStateStore,
        GitSnapshotStore,
    )
    from fluidframework_tpu_torch.server.kernel_host import \
        KernelSequencerHost
    from fluidframework_tpu_torch.server.megadoc import MegaDocManager
    from fluidframework_tpu_torch.server.merge_host import KernelMergeHost
    from fluidframework_tpu_torch.server.routerlicious import \
        RouterliciousService
    from fluidframework_tpu_torch.server.storm import StormController

    seq_host = KernelSequencerHost(num_slots=256, initial_capacity=4,
                                   device=device)
    merge_host = KernelMergeHost(
        flush_threshold=10**9, device=device,
        seg_mesh=make_seg_mesh([device] * MEGA_SEG_SHARDS))
    service = RouterliciousService(
        bus=DurableMessageBus(str(root / "bus")),
        store=FileStateStore(str(root / "state")),
        merge_host=merge_host, batched_deli_host=seq_host,
        auto_pump=False, idle_check_interval=10**9)
    service._clock = clock
    storm = StormController(service, seq_host, merge_host,
                            flush_threshold_docs=10**9,
                            spill_dir=str(root / "spill"),
                            durability="group",
                            snapshots=GitSnapshotStore(str(root / "git")))
    mgr = MegaDocManager(storm, default_lanes=MEGA_LANES) if promoted \
        else None
    return {"seq_host": seq_host, "merge_host": merge_host,
            "service": service, "storm": storm, "mgr": mgr,
            "clock": clock, "doc": "mega"}


def mega_text_round(st: dict, text: dict, r: int) -> None:
    """Text round ``r`` of Mega A: each of the MEGA_TEXT_WRITERS writers
    submits one insert or remove through the service; the round's
    sequenced ops and the text after them kept in ``text["stages"]``."""
    from fluidframework_tpu_torch.protocol.messages import (
        DocumentMessage,
        MessageType,
    )
    service, merge_host, doc = st["service"], st["merge_host"], st["doc"]
    rng = text["rng"]
    head = st["seq_host"].checkpoint(doc).sequence_number
    for client in text["writers"]:
        if text["length"] > 2 and rng.random() < 0.3:
            a = rng.randrange(text["length"] - 1)
            op = {"type": "remove", "start": a,
                  "end": min(text["length"], a + rng.randint(1, 4))}
        else:
            op = {"type": "insert", "pos": rng.randint(0, text["length"]),
                  "text": "".join(rng.choice("abcdefgh") for _ in
                                  range(rng.randint(1, 6)))}
        service.submit(doc, client, [DocumentMessage(
            client_sequence_number=r + 1, reference_sequence_number=head,
            type=MessageType.OPERATION,
            contents={"address": "default",
                      "contents": {"address": "text", "contents": op}})])
    service.pump()
    merge_host.flush()
    text["length"] = len(merge_host.text(doc, "default", "text"))
    msgs = text_messages(service, doc, head)
    text["n"] += len(msgs)
    text["stages"][r] = {"ops": text["n"], "msgs": msgs,
                         "text": merge_host.text(doc, "default", "text")}


def mega_join(device, root: pathlib.Path, after_join=None) -> dict:
    """Mega A's shared prefix on the promoted arm's stack: MEGA_WRITERS
    writers join one doc, text round 0, a checkpoint (the single-lane
    arm's and the recovery's restore source). ``after_join`` is called
    once the joins are done."""
    import random
    st = mega_stack(device, root, MegaClock(), promoted=True)
    service = st["service"]
    t0 = time.perf_counter()
    conns = []
    for i in range(MEGA_WRITERS):
        conns.append(service.connect(st["doc"], lambda m: None))
        if (i + 1) % 256 == 0:
            service.pump()
    service.pump()
    join_s = time.perf_counter() - t0
    if after_join is not None:
        after_join()
    clients = [c.client_id for c in conns]
    text = {"rng": random.Random(5), "length": 0, "n": 0, "stages": {},
            "writers": clients[-MEGA_TEXT_WRITERS:]}
    mega_text_round(st, text, 0)
    st["storm"].checkpoint()
    return {"stack": st, "clients": clients, "text": text,
            "join_s": join_s}


def mega_serve(st: dict, clients: list, text: dict, promoted: bool,
               serve_ctx=None) -> dict:
    """The rest of a Mega A arm on ``st`` from the shared checkpoint:
    (promotion onto MEGA_LANES lanes), the waves of map frames, text
    round 1, (demotion), text round 2. ``serve_ctx`` wraps the timed
    waves (the trace)."""
    import numpy as np
    import torch

    from fluidframework_tpu_torch.server.megadoc import lane_of_writer
    seq_host, merge_host = st["seq_host"], st["merge_host"]
    storm, mgr, doc = st["storm"], st["mgr"], st["doc"]
    n_lanes = MEGA_LANES
    buckets: list = [[] for _ in range(n_lanes)]
    for w in range(MEGA_WRITERS):
        buckets[lane_of_writer(clients[w], n_lanes)].append(w)
    order = [b[i] for i in range(max(len(b) for b in buckets))
             for b in buckets if i < len(b)]
    if promoted:
        mgr.promote(doc, lanes=MEGA_LANES)
    gen = np.random.default_rng(0)
    words_all = (gen.integers(0, 1 << 20, (MEGA_WRITERS, MEGA_K))
                 .astype(np.uint32) << 12) | (gen.integers(
                     0, 32, (MEGA_WRITERS, MEGA_K)).astype(np.uint32) << 2)
    lat: list = []
    acks: dict = {}
    t_submit: dict = {}

    def sink(p):
        rid = p.get("rid")
        if rid is not None and not p.get("error"):
            lat.append(time.perf_counter() - t_submit[rid])
            acks[rid] = np.asarray(p.rows).tolist()

    storm.submit_frame(None, {"rid": None,
                              "docs": [[doc, clients[0], 1, 1, MEGA_K]]},
                       memoryview(words_all[0].tobytes()))
    storm.flush()
    ticks0 = storm.stats["ticks"]
    seq0 = storm.stats["sequenced_ops"]
    # The text writers' cseqs ride their text ops: they send no frames.
    served = [w for w in order if w < MEGA_WRITERS - MEGA_TEXT_WRITERS][
        :MEGA_WAVES * MEGA_WAVE]
    ctx = serve_ctx() if serve_ctx is not None \
        else contextlib.nullcontext()
    ctx.__enter__()
    t1 = time.perf_counter()
    for base in range(0, len(served), MEGA_WAVE):
        for w in served[base:base + MEGA_WAVE]:
            t_submit[w] = time.perf_counter()
            storm.submit_frame(sink, {
                "rid": w, "docs": [[doc, clients[w],
                                    MEGA_K + 1 if w == 0 else 1, 1,
                                    MEGA_K]]},
                memoryview(words_all[w].tobytes()))
        storm.flush()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t1
    ctx.__exit__(None, None, None)
    sequenced = storm.stats["sequenced_ops"] - seq0
    check(sequenced == len(served) * MEGA_K and len(acks) == len(served),
          f"mega arm: {sequenced} ops sequenced, {len(acks)} acks")
    ticks_served = storm.stats["ticks"] - ticks0
    entries = (mgr.map_entries(doc) if promoted else
               merge_host.map_entries(doc, storm.datastore, storm.channel))
    mega_text_round(st, text, 1)
    promoted_pool = None
    key = next(k for k in merge_host._merge_rows if k.doc_id == doc)
    if promoted:
        promoted_pool = type(merge_host._merge_rows[key].pool).__name__
        mgr.demote(doc)
    mega_text_round(st, text, 2)
    row = storm._storm_map_row(doc)
    planes = [getattr(merge_host._xstate, f)[row].cpu().numpy().tolist()
              for f in merge_host._xstate._fields]
    lat_ms = 1e3 * np.asarray(sorted(lat))
    storm._group_wal.close()
    return {"service": st["service"], "merge_host": merge_host, "doc": doc,
            "entries": entries, "acks": acks, "planes": planes,
            "words": words_all, "served": served, "clients": clients,
            "text_stages": text["stages"], "promoted_pool": promoted_pool,
            "key": key, "map_final": merge_host.map_entries(
                doc, storm.datastore, storm.channel),
            "stats": {"writers": MEGA_WRITERS, "frames": len(served),
                      "elapsed_s": elapsed,
                      "merged_ops_per_s": sequenced / elapsed,
                      "ticks": ticks_served,
                      "ack_ms_p50": float(np.percentile(lat_ms, 50)),
                      "ack_ms_p99": float(np.percentile(lat_ms, 99))}}


def mega_arm(device, root: pathlib.Path, serve_ctx=None) -> dict:
    """Mega A's promoted arm from its joins on: the shared prefix, then
    ``mega_serve`` (the trace's drive)."""
    shared = mega_join(device, root)
    return mega_serve(shared["stack"], shared["clients"], shared["text"],
                      True, serve_ctx=serve_ctx)

def text_cpu_twin(run: dict, promoted: bool) -> None:
    """Hold the card's text planes to a CPU merge host fed the same
    sequenced text ops, round by round, with the promotion and demotion
    at the same points."""
    from fluidframework_tpu_torch.ops.mergetree_sharded import make_seg_mesh
    from fluidframework_tpu_torch.server.merge_host import KernelMergeHost
    host = KernelMergeHost(flush_threshold=10**9, device="cpu",
                           seg_mesh=make_seg_mesh(["cpu"] * MEGA_SEG_SHARDS))
    for r in (0, 1, 2):
        for m in run["text_stages"][r]["msgs"]:
            host.ingest(run["doc"], m)
        host.flush()
        if promoted and r == 0:
            host.promote_merge_row(run["key"])
        if promoted and r == 1:
            host.demote_merge_row(run["key"])
        check(host.text(run["doc"], "default", "text")
              == run["text_stages"][r]["text"],
              f"mega A text round {r}: card != its CPU twin")
    card = run["merge_host"]
    for pools in ("_merge_pools", "_mega_pools"):
        a, b = getattr(card, pools), getattr(host, pools)
        check(sorted(a) == sorted(b), f"mega A {pools}: {sorted(a)} != "
              f"the CPU twin's {sorted(b)}")
        for slots, pa in a.items():
            for f in type(pa.state)._fields:
                x = getattr(pa.state, f)
                y = getattr(b[slots].state, f)
                for xt, yt in zip(leaves((x,)), leaves((y,))):
                    check(bool((xt.cpu() == yt).all()),
                          f"mega A text plane {pools}[{slots}].{f}: card "
                          "!= its CPU twin")


def mega_path_a(device, root: pathlib.Path, after_join=None) -> dict:
    """Mega A (see MEGA_*): the promoted arm and the single-lane twin on
    the card, held to each other (converged map, every ack's doc-space
    quad, the demoted row's planes) and to a numpy fold in doc-seq order;
    the text channel held to the twin while promoted and to a CPU twin
    throughout; then a fresh stack recovers the promoted arm. The two
    arms share one join: the promoted arm's stack joins the writers,
    writes text round 0 and checkpoints, and the single-lane arm is a
    fresh stack recovered from a copy of that checkpoint, served once
    the promoted arm is done. ``after_join`` runs after the joins,
    before anything of an arm is timed."""
    import copy
    import shutil

    root.mkdir(parents=True, exist_ok=True)
    # Both arms and the recovery run under the same recording wrappers,
    # so their clocks carry the same instrumentation.
    kept: dict = {}
    launch_counts_reset()
    with plane_recording(kept):
        shared = mega_join(device, root / "mega", after_join=after_join)
        stack = shared["stack"]
        at_checkpoint = (stack["seq_host"].checkpoint("mega"),
                         stack["merge_host"].text("mega", "default", "text"),
                         stack["clock"].at)
        single_text = copy.deepcopy(shared["text"])
        shutil.copytree(root / "mega", root / "single")
        mega = mega_serve(stack, shared["clients"], shared["text"], True)
    counts = launch_counts()
    twin_kept: dict = {}
    launch_counts_reset()
    with plane_recording(twin_kept):
        st = mega_stack(device, root / "single",
                        MegaClock(at_checkpoint[2]), promoted=False)
        t0 = time.perf_counter()
        st["storm"].recover()
        # The doc's deli lambda, made now as the live stack made it at
        # its first join: made lazily at text round 1, it would restore
        # its round-0 checkpoint over the row the waves advanced.
        st["service"]._deli._lambda_for("mega")
        twin_recover_s = time.perf_counter() - t0
        check((st["seq_host"].checkpoint("mega"),
               st["merge_host"].text("mega", "default", "text"))
              == at_checkpoint[:2], "mega A: the single-lane arm's stack, "
              "recovered from the shared checkpoint, != the promoted "
              "arm's at that checkpoint")
        twin = mega_serve(st, shared["clients"], single_text, False)
    twin_counts = launch_counts()
    for run in (mega, twin):
        run["stats"]["join_s"] = shared["join_s"]
    check(mega["entries"] == twin["entries"],
          "mega A: the promoted map != the single-lane twin's")
    check(mega["acks"] == twin["acks"],
          "mega A: doc-space ack quads != the single-lane twin's")
    check(mega["planes"] == twin["planes"],
          "mega A: the demoted row's planes != the twin's row")
    # The numpy fold in doc-seq order (every word a SET).
    order = sorted(mega["served"], key=lambda w: mega["acks"][w][0][1])
    fold: dict = {}
    for w in [0] + order:  # writer 0's warm-up frame came first
        for word in mega["words"][w].tolist():
            fold[f"k{(word >> 2) & 0x3FF}"] = word >> 12
    check(mega["entries"] == fold,
          "mega A: the promoted map != the numpy fold in doc-seq order")
    check(mega["promoted_pool"] == "_ShardedMergePool",
          f"mega A: the promoted text row sat in {mega['promoted_pool']}")
    for r in (0, 1):
        check(mega["text_stages"][r]["text"]
              == twin["text_stages"][r]["text"],
              f"mega A: text round {r} != the single-lane twin's")
    # The reference fault (ROADMAP Queue C): demotion restores the doc's
    # sequencer row from the combiner mirror, which never saw the text
    # ops sequenced on the frozen row while promoted, so the round after
    # demotion nacks as gaps on the promoted arm only.
    fault = (mega["text_stages"][2]["ops"] == mega["text_stages"][1]["ops"]
             and twin["text_stages"][2]["ops"]
             == twin["text_stages"][1]["ops"] + MEGA_TEXT_WRITERS)
    text_cpu_twin(mega, True)
    text_cpu_twin(twin, False)
    # Recovery of the promoted arm's WAL and snapshot on the card.
    st2 = mega_stack(device, root / "mega", MegaClock(), promoted=True)
    storm2, mgr2 = st2["storm"], st2["mgr"]
    rec_kept: dict = {}
    launch_counts_reset()
    with plane_recording(rec_kept):
        t0 = time.perf_counter()
        info = storm2.recover()
        rec_s = time.perf_counter() - t0
    rec_counts = launch_counts()
    got = st2["merge_host"].map_entries("mega", storm2.datastore,
                                        storm2.channel)
    check(got == mega["map_final"] and got == mega["entries"],
          "mega A: the recovered map != the live promoted run's")
    check(mgr2.has_history("mega") and not mgr2.is_promoted("mega"),
          "mega A: recovery did not replay the promoted lifecycle")
    storm2._group_wal.close()
    for run, name, c in ((mega, "sharded", counts),
                         (twin, "single-lane", twin_counts)):
        deli_picks(device, c["shapes"]["sequencer_tick"],
                   c["variants"]["sequencer_tick"], f"mega A ({name})")
    check(counts["mergetree_flat"] > 0,
          "mega A: the promoted text row ticked no kernel 4")
    check(counts["mergetree_blocks"] > 0 and counts["map_fold"] > 0
          and counts["sequencer_tick"] > 0,
          "mega A: kernel 1, 2 or 3 did not launch on the promoted arm")
    out = {"sharded": mega["stats"], "single_lane": twin["stats"],
           "ratio": mega["stats"]["merged_ops_per_s"]
           / twin["stats"]["merged_ops_per_s"],
           "lanes": MEGA_LANES, "wave": MEGA_WAVE,
           "waves": -(-len(mega["served"]) // MEGA_WAVE),
           "text_after_demotion_fault": fault,
           "single_lane_recover_s": twin_recover_s,
           "recover_s": rec_s, "recovered": info,
           "launches": {k: counts[k] for k in (
               "map_fold", "sequencer_tick", "mergetree_blocks",
               "mergetree_flat")},
           "single_lane_launches": {k: twin_counts[k] for k in (
               "map_fold", "sequencer_tick", "mergetree_blocks",
               "mergetree_flat")}}
    print("mega_a: " + json.dumps(out), flush=True)
    return {"out": out, "counts": counts, "kept": kept,
            "twin_counts": twin_counts, "twin_kept": twin_kept,
            "recover_counts": rec_counts, "recover_kept": rec_kept}

def mega_lanes_path(device) -> dict:
    """Mega L (see LANES_*): MegaDocLanes over LANES_ROWS rows of a
    LANES_DOCS-doc ShardedServing on a virtual mesh of LANES_SHARDS shards
    of the card, against a narrow single-row twin on the card serving the
    same batches one after another: every decision's doc-space quad and
    the converged entries equal."""
    import numpy as np

    from fluidframework_tpu_torch.parallel.mesh import make_mesh
    from fluidframework_tpu_torch.parallel.serving import (
        MegaDocLanes,
        ShardedServing,
    )
    kept: dict = {}
    launch_counts_reset()
    with plane_recording(kept):
        serving = ShardedServing(make_mesh([device] * LANES_SHARDS),
                                 num_docs=LANES_DOCS, k=MEGA_K,
                                 num_hosts=LANES_HOSTS,
                                 num_clients=LANES_SLOTS, map_slots=16)
        serving.join_all(slots=list(range(LANES_SLOTS)))
        step = LANES_DOCS // LANES_ROWS
        rows = [i * step + (i * 7) % step for i in range(LANES_ROWS)]
        lanes = MegaDocLanes(serving, lane_rows=rows)
        for w in range(LANES_WRITERS):
            lanes.join(f"writer-{w}")
        rng = np.random.default_rng(42)
        cseqs = {w: 1 for w in range(LANES_WRITERS)}
        prev: dict = {}
        batches, mega_acks = [], []
        t0 = time.perf_counter()
        for _r in range(LANES_ROUNDS):
            for w in range(LANES_WRITERS):
                action = rng.choice(["fresh", "fresh", "dup", "gap"])
                words = (rng.integers(0, 1 << 20, MEGA_K).astype(np.uint32)
                         << 12 | (rng.integers(0, 16, MEGA_K)
                                  .astype(np.uint32) << 2))
                if action == "dup" and w in prev:
                    cseq0, words = prev[w]
                elif action == "gap":
                    cseq0 = cseqs[w] + 3
                else:
                    cseq0 = cseqs[w]
                    cseqs[w] += MEGA_K
                    prev[w] = (cseq0, words)
                dec = lanes.submit(f"writer-{w}", words, cseq0, ref_seq=1)
                mega_acks.append((dec.n_seq, dec.first, dec.last))
                batches.append((w, words, cseq0))
            serving.flush()
        entries = lanes.entries()
        seconds = time.perf_counter() - t0
    counts = launch_counts()
    # The twin, after the lanes' counts are read: the same batches one
    # after another on one row.
    twin = ShardedServing(make_mesh([device]), num_docs=8, k=MEGA_K,
                          num_hosts=1, num_clients=LANES_WRITERS + 1,
                          map_slots=16)
    twin.join_all(slots=list(range(LANES_WRITERS)))
    twin_acks = []
    for w, words, cseq0 in batches:
        twin.submit(0, words, cseq0, ref_seq=1, client_slot=w)
        n_ok, first, last = twin.tick()[0][0]
        twin_acks.append((n_ok, first if n_ok else 2**31 - 1, last))
    twin.flush()
    check(mega_acks == twin_acks,
          "mega L: lane decisions != the single-row twin's acks")
    planes = twin.family_rows("map")
    want = {s: int(v) for s, v in enumerate(planes.value[0])
            if planes.present[0][s]}
    check(entries == want and bool(entries),
          "mega L: lane entries != the single-row twin's map")
    seqs = serving.family_rows("seq").seq
    spread = sum(1 for r in rows if int(seqs[r]) > LANES_SLOTS)
    check(spread > 1, f"mega L: only {spread} lane rows sequenced")
    check(len({serving._shard_of(r) for r in rows}) == LANES_SHARDS,
          "mega L: the lane rows do not span every shard")
    out = {"docs": LANES_DOCS, "shards": LANES_SHARDS, "rows": rows,
           "writers": LANES_WRITERS, "rounds": LANES_ROUNDS,
           "sequenced_batches": sum(1 for a in mega_acks if a[0]),
           "seconds": seconds, "lanes_sequenced": spread,
           "launches": {k: counts[k] for k in (
               "map_fold", "sequencer_tick", "mergetree_blocks",
               "mergetree_flat")}}
    print("mega_l: " + json.dumps(out), flush=True)
    check(counts["map_fold"] > 0 and counts["sequencer_tick"] > 0,
          "mega L launched no map fold or no deli")
    return {"out": out, "counts": counts, "kept": kept}


PLANE_CHAOS = (
    ("storm", "wal.pre_fsync", 2,
     dict(seed=0, docs=64, k=256, ticks=5, cp_every=2)),
    ("residency", "residency.mid_evict", 1,
     dict(seed=0, docs=3, k=8, ticks=5, cp_every=2, residency=2)),
    ("megadoc", "megadoc.mid_combine", 3,
     dict(seed=0, docs=1, k=8, ticks=4, cp_every=2, megadoc=2)),
    ("cluster", "placement.post_evict", 1,
     dict(seed=0, docs=2, k=8, ticks=5, cp_every=2, cluster=True,
          migrate_at=2)),
    ("replication", "repl.post_ship", 2,
     dict(seed=0, docs=2, k=8, ticks=6, cp_every=2, replication=True,
          migrate_at=3)))


def plane_chaos_start(device) -> list:
    """Start the ``PLANE_CHAOS`` kills of a chaos-harness serving process
    on the card (a torn group commit of the storm at 64 docs x K 256, and
    the reference suite's smoke configurations: residency, mega-doc,
    cluster migration, replication with a promoted follower), each in a
    thread of its own: their
    child processes run beside mega A's promoted-arm joins, which are
    set-up and not timed as a rate. ``plane_chaos_finish`` joins them."""
    import tempfile
    import threading

    from fluidframework_tpu_torch.tools import chaos
    runs = []
    for name, point, hits, cfg in PLANE_CHAOS:
        run = {"name": name, "cfg": cfg,
               "tmp": tempfile.mkdtemp(prefix=f"ff-chaos-{name}-")}

        def go(run=run, point=point, hits=hits, cfg=cfg):
            t0 = time.perf_counter()
            try:
                run["report"] = chaos.run_chaos(
                    run["tmp"], point, kill_hits=hits, device=device.type,
                    timeout=300, **cfg)
            except Exception as err:  # reported by plane_chaos_finish
                run["error"] = f"{type(err).__name__}: {str(err)[:2000]}"
            run["seconds"] = time.perf_counter() - t0
        run["thread"] = threading.Thread(target=go, daemon=True)
        run["thread"].start()
        runs.append(run)
    return runs


def plane_chaos_finish(runs: list) -> dict:
    """Wait for the chaos kills; each must have killed, recovered to its
    twin's digest and acked every round."""
    import shutil
    out = {}
    for run in runs:
        run["thread"].join()
        shutil.rmtree(run["tmp"], ignore_errors=True)
        name = run["name"]
        check("error" not in run,
              f"{name} chaos run on the card: {run.get('error')}")
        report = run["report"]
        check(report["killed"] and report["lives"] >= 2,
              f"the {name} chaos run did not kill and recover")
        check(report["acked_rounds"] == list(range(run["cfg"]["ticks"])),
              f"the {name} chaos run acked {report['acked_rounds']}")
        out[name] = {key: report[key] for key in (
            "kill_point", "kill_hits", "killed", "lives", "acked_rounds")}
        if run["cfg"].get("replication"):
            # Each resumed life promoted a follower (run_chaos holds their
            # count to the lives).
            out[name]["failover_blackouts_ms"] = \
                report["failover_blackouts_ms"]
        out[name]["seconds"] = run["seconds"]
    print("plane_chaos: " + json.dumps(out), flush=True)
    return out


def planes_path(device) -> dict:
    """Residency A, R and S, Mega A and L, and the five chaos kills
    (beside mega A's promoted-arm joins: after every residency clock, and
    joined before mega A's first timed wave), in temp dirs of the machine
    deleted after. Net N's netsplit soak and its CPU twin (child
    processes) run beside residency A's joins and are joined before its
    first frame (``out["net_split"]``)."""
    import shutil
    import tempfile
    root = pathlib.Path(tempfile.mkdtemp(prefix="ff-planes-"))
    out = {}
    chaos_runs = []
    waited = {}

    def join_chaos():
        t0 = time.perf_counter()
        out["chaos"] = plane_chaos_finish(chaos_runs)
        waited["s"] = time.perf_counter() - t0

    def join_split():
        t0 = time.perf_counter()
        out["net_split"] = net_split_finish(split)
        waited["split"] = time.perf_counter() - t0
    split = net_split_start(device)
    try:
        t = time.perf_counter()
        out["res_a"] = residency_path_a(device, root / "a",
                                        after_join=join_split)
        check("net_split" in out,
              "residency A did not join Net N's netsplit soak")
        out["res_r"] = residency_path_r(device, root / "a", out["res_a"])
        del out["res_a"]["storm"]
        out["res_s"] = residency_path_s(device, root / "s")
        t_res = time.perf_counter()
        chaos_runs = plane_chaos_start(device)
        out["mega_a"] = mega_path_a(device, root / "mega",
                                    after_join=join_chaos)
        check("chaos" in out, "mega A did not join the plane chaos kills")
        out["mega_l"] = mega_lanes_path(device)
        print(f"phase times: residency {t_res - t:.1f} s, of which "
              f"waiting for Net N's netsplit after residency A's joins "
              f"{waited['split']:.1f} s; mega-doc "
              f"{time.perf_counter() - t_res:.1f} s, of which waiting for "
              f"the plane chaos after mega A's joins {waited['s']:.1f} s",
              flush=True)
    finally:
        for run in chaos_runs:
            run["thread"].join()
        split["thread"].join()
        shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(split["root"], ignore_errors=True)
    return out


def trace_planes(device) -> dict:
    """Residency A's churn frames and Mega A's promoted waves again, each
    under ``torch.profiler``: device busy ms against the host's wall ms
    over the same frames (an upper bound on the idle share)."""
    import shutil
    import tempfile
    out = {}
    root = pathlib.Path(tempfile.mkdtemp(prefix="ff-planes-trace-"))
    try:
        for name, drive in (
                ("residency_churn", lambda ctx: residency_path_a(
                    device, root / "res", churn_ctx=ctx,
                    verify=False)["churn_s"]),
                ("mega_promoted", lambda ctx: mega_arm(
                    device, root / "mega",
                    serve_ctx=ctx)["stats"]["elapsed_s"])):
            prof = new_profile()
            out[name] = idle_record(prof, drive(lambda: prof) * 1e3)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print("trace_planes: " + json.dumps(out), flush=True)
    return out


# -- the history plane (time travel, branches, compaction) ---------------------

#: History H: the reference bench_history_reads, _compaction_disk and
#: _fork_merge at their published defaults (one doc each, K = HIST_K
#: ops a round): HIST_READ_ROUNDS rounds, a summary every
#: HIST_INTERVAL_OPS ops with compaction checked every flush, reads at
#: HIST_DEPTHS behind the head (and head - 1) HIST_READ_REPS times each,
#: with and without summaries; HIST_CHURN_ROUNDS rounds of churn on 8
#: slots with tail retention 0; HIST_FORK_ROUNDS rounds, a fork at the
#: middle, HIST_BRANCH_ROUNDS branch rounds, then merge_back.
HIST_READ_ROUNDS = 192
HIST_K = 64
HIST_INTERVAL_OPS = 2048
HIST_READ_REPS = 15
HIST_DEPTHS = (1, 64, 512, 4096)
HIST_CHURN_ROUNDS = 96
HIST_FORK_ROUNDS = 48
HIST_BRANCH_ROUNDS = 4
#: History P, on the durable path's recovered config-3 stack: HIST_P_FORKS
#: of its docs forked at their tick-DURABLE_HEAD_TICK seq (half before a
#: checkpoint, half after, so recovery imports the snapshot's ``history``
#: field and replays ``hp`` fork controls), HIST_P_TICKS ticks of K_MAP
#: ops to every parent and branch, one ``read_at`` of each, then
#: the parents compacted (retention 0) and a fresh stack recovered. The
#: cadence checks every HIST_P_CHECK_EVERY flushes (about twice in the
#: phase: a pass reads every doc's summary head) with a
#: HIST_P_INTERVAL_OPS summary interval, which every served doc passes, so
#: each pass compacts 8 docs from the front of the index.
HIST_P_FORKS = 16
HIST_P_TICKS = 2
HIST_P_INTERVAL_OPS = 4 * K_MAP
HIST_P_CHECK_EVERY = 32


def hist_words(seed, r, k, slots=16, churn=False):
    """The reference history benches' words (sets and deletes; churn
    rewrites 8 slots forever)."""
    import numpy as np
    rng = np.random.default_rng([seed, r])
    kinds = rng.choice([0, 0, 0, 1], size=k).astype(np.uint32)
    s = rng.integers(0, 8 if churn else slots, k).astype(np.uint32)
    vals = rng.integers(0, 1 << 20, k).astype(np.uint32)
    return (kinds | (s << 2) | (vals << 12)).astype(np.uint32)


def history_stack(device, root: pathlib.Path, residency: bool = False,
                  spill: bool = False, **hist_kw):
    """The reference benches' stack (``bench.py`` ``_history_stack``) on
    the port: a storm at pipeline depth 0, a git snapshot store, a
    group-commit WAL when ``spill``, a HistoryPlane, and (as
    ``tests/test_history.py``'s ``_stack``) a ResidencyManager when
    asked."""
    from fluidframework_tpu_torch.server.durable_store import \
        GitSnapshotStore
    from fluidframework_tpu_torch.server.history import HistoryPlane
    from fluidframework_tpu_torch.server.kernel_host import \
        KernelSequencerHost
    from fluidframework_tpu_torch.server.merge_host import KernelMergeHost
    from fluidframework_tpu_torch.server.residency import ResidencyManager
    from fluidframework_tpu_torch.server.routerlicious import \
        RouterliciousService
    from fluidframework_tpu_torch.server.storm import StormController
    seq_host = KernelSequencerHost(num_slots=2, initial_capacity=4,
                                   device=device)
    merge_host = KernelMergeHost(flush_threshold=10**9, device=device)
    service = RouterliciousService(merge_host=merge_host,
                                   batched_deli_host=seq_host,
                                   auto_pump=False,
                                   idle_check_interval=10**9)
    kw: dict = {}
    if spill:
        kw.update(spill_dir=str(root / "spill"), durability="group")
    storm = StormController(service, seq_host, merge_host,
                            flush_threshold_docs=10**9, pipeline_depth=0,
                            snapshots=GitSnapshotStore(str(root / "git")),
                            **kw)
    hist = HistoryPlane(storm, **hist_kw)
    res = ResidencyManager(storm, idle_evict_s=1e9,
                           hydration_rate_per_s=1e9) if residency else None
    return service, storm, hist, res


def tick_records(storm, docs) -> dict:
    """{doc: its records} for ``docs`` from the tick headers of their
    tick indices, each header read once (the checks' own lookup, apart
    from ``records_overlapping``, which scans a whole header per doc)."""
    want = set(docs)
    ticks = sorted({t for d in docs for _fs, _ls, t in storm._doc_ticks[d]})
    out: dict = {d: [] for d in docs}
    for tick in ticks:
        header, _off = storm._parse_header(storm._read_blob(tick))
        for (doc, _c, _cs, _ref, count, ns, fs, _ls, _msn,
             w_off) in header["docs"]:
            if doc in want:
                out[doc].append({"count": count, "n_seq": ns,
                                 "first_seq": fs, "tick": tick,
                                 "w_off": w_off})
    return out


def doc_batches(storm, doc: str, records=None) -> list:
    """The doc's durable records (``records_overlapping``'s unless given)
    as (words, seqs) batches in seq order, one a tick: the sequenced
    suffix of each record's words."""
    import numpy as np
    out = []
    if records is None:
        records = storm.records_overlapping(doc, 0)
    for rec in sorted(records, key=lambda r: r["first_seq"]):
        n = rec["n_seq"]
        if n <= 0:
            continue
        words = np.frombuffer(storm.read_tick_words(rec["tick"]), np.uint32,
                              rec["count"], rec["w_off"])
        skip = rec["count"] - n
        out.append((words[skip:].copy(),
                    rec["first_seq"] + np.arange(n, dtype=np.int64)))
    return out


def np_fold(batches, to_seq: int, slots: int, base=None):
    """A numpy fold of (words, seqs) batches through ``to_seq`` onto
    ``base`` (empty planes by default): each batch is one tick of the LWW
    map fold — ops before its last clear are dead, and per slot its last
    op lands. Returns (present, value, vseq, cleared_seq)."""
    import numpy as np
    if base is None:
        present = np.zeros(slots, np.bool_)
        value = np.zeros(slots, np.int32)
        vseq = np.full(slots, -1, np.int32)
        cleared = -1
    else:
        present, value, vseq, cleared = (base[0].copy(), base[1].copy(),
                                         base[2].copy(), int(base[3]))
    for words, seqs in batches:
        keep = seqs <= to_seq
        words, seqs = words[keep], seqs[keep]
        if not len(words):
            break
        kind = words & 3
        clears = np.flatnonzero(kind == 2)
        if clears.size:
            last = clears[-1]
            present[:] = False
            vseq[:] = -1
            cleared = int(seqs[last])
            words, seqs, kind = (words[last + 1:], seqs[last + 1:],
                                 kind[last + 1:])
        slot = ((words >> 2) & 0x3FF).astype(np.int64)
        _, idx = np.unique(slot[::-1], return_index=True)
        win = len(slot) - 1 - idx
        sl, kd = slot[win], kind[win]
        sets, dels = kd == 0, kd != 0
        present[sl[sets]] = True
        value[sl[sets]] = (words[win][sets] >> 12).astype(np.int32)
        vseq[sl[sets]] = seqs[win][sets]
        present[sl[dels]] = False
        vseq[sl[dels]] = seqs[win][dels]
    return present, value, vseq, cleared


def fold_entries(planes) -> dict:
    import numpy as np
    present, value = planes[0], planes[1]
    return {f"k{s}": int(value[s]) for s in np.flatnonzero(present)}


def map_row(storm, doc: str) -> list:
    """The doc's device map row: present, value, vseq (numpy) and
    cleared_seq."""
    xs = storm.merge_host._xstate
    row = storm._storm_mrow(doc).row
    return [xs.present[row].cpu().numpy(), xs.value[row].cpu().numpy(),
            xs.vseq[row].cpu().numpy(), int(xs.cleared_seq[row])]


def rows_equal(a, b) -> bool:
    import numpy as np
    return all(np.array_equal(x, y) for x, y in zip(a[:3], b[:3])) \
        and int(a[3]) == int(b[3])


def hist_serve(storm, doc, client, rounds, seed, churn=False, ref=1,
               rid=""):
    """``rounds`` frames of HIST_K words to one doc, a flush each."""
    k = HIST_K
    for r in range(rounds):
        storm.submit_frame(
            None, {"rid": (rid, r),
                   "docs": [[doc, client, 1 + r * k, ref, k]]},
            memoryview(hist_words(seed, r, k, churn=churn).tobytes()))
        storm.flush()


def history_reads(device, root: pathlib.Path) -> dict:
    """``bench_history_reads``: read p50/p99 at each depth behind the head
    with and without summaries; every sampled read == the numpy fold,
    and the head == the device row."""
    import numpy as np
    out = {}
    for name, summarize in (("no_summaries", False), ("summarized", True)):
        service, storm, hist, _ = history_stack(
            device, root / name,
            summary_interval_ops=HIST_INTERVAL_OPS if summarize else None,
            compact_check_every=1)
        client = service.connect("h0", lambda m: None).client_id
        service.pump()
        t0 = time.perf_counter()
        hist_serve(storm, "h0", client, HIST_READ_ROUNDS, 3)
        serve_s = time.perf_counter() - t0
        head = hist.head_seq("h0")
        batches = doc_batches(storm, "h0")
        s_live = storm.merge_host._xstate.present.shape[1]
        rows = {}
        for depth in HIST_DEPTHS + (head - 1,):
            seq = max(1, head - depth)
            samples = []
            for _ in range(HIST_READ_REPS):
                t1 = time.perf_counter()
                got = hist.read_at("h0", seq)
                samples.append(1e3 * (time.perf_counter() - t1))
            check(got["entries"] == fold_entries(
                np_fold(batches, seq, s_live)),
                f"history H reads ({name}): read_at(h0, {seq}) != the "
                "numpy fold")
            rows[f"depth_{depth}"] = {
                "seq": seq, "read_ms_p50": float(np.percentile(samples, 50)),
                "read_ms_p99": float(np.percentile(samples, 99))}
        entries = storm.merge_host.map_entries("h0", storm.datastore,
                                               storm.channel)
        check(hist.read_at("h0", head)["entries"] == entries
              and entries == fold_entries(np_fold(batches, head, s_live)),
              f"history H reads ({name}): the head != the device row")
        check(rows_equal(map_row(storm, "h0"),
                         np_fold(batches, head, s_live)),
              f"history H reads ({name}): the device row != the numpy fold")
        out[name] = {"head_seq": head, "ops": HIST_READ_ROUNDS * HIST_K,
                     "serve_s": serve_s,
                     "summaries": hist.stats["compactions"], "rows": rows,
                     "worst_read_ms_p50": max(
                         r["read_ms_p50"] for r in rows.values())}
    check(out["summarized"]["summaries"] > 0,
          "history H reads: the cadence made no summary")
    out["worst_p50_summarized_over_unsummarized"] = (
        out["summarized"]["worst_read_ms_p50"]
        / out["no_summaries"]["worst_read_ms_p50"])
    return out


def history_compaction(device, root: pathlib.Path) -> dict:
    """``bench_history_compaction_disk``: spill bytes before and after
    compact + trim_now on a churn doc; the head read == the device row ==
    the numpy fold, and a read below the trim floor raises."""
    from fluidframework_tpu_torch.server.history import HistoryError
    service, storm, hist, _ = history_stack(
        device, root, spill=True, tail_retention_summaries=0,
        trim_batch_ticks=1)
    client = service.connect("churn", lambda m: None).client_id
    service.pump()
    storm.checkpoint()
    hist_serve(storm, "churn", client, HIST_CHURN_ROUNDS, 5, churn=True)
    storm.checkpoint()
    spill = root / "spill" / "storm_tick_words.log"
    before = spill.stat().st_size
    entries = storm.merge_host.map_entries("churn", storm.datastore,
                                           storm.channel)
    s_live = storm.merge_host._xstate.present.shape[1]
    head = hist.head_seq("churn")
    folded = np_fold(doc_batches(storm, "churn"), head, s_live)
    t0 = time.perf_counter()
    hist.compact("churn")
    hist.trim_now()
    compact_ms = 1e3 * (time.perf_counter() - t0)
    after = spill.stat().st_size
    check(hist.read_at("churn", head)["entries"] == entries
          and entries == fold_entries(folded)
          and rows_equal(map_row(storm, "churn"), folded),
          "history H compaction: the head != the device row or the fold")
    try:
        hist.read_at("churn", head - 1)
        below = None
    except HistoryError:
        below = "HistoryError"
    check(below == "HistoryError" and hist.tail_floor("churn") == head,
          "history H compaction: a read below the trim floor did not raise")
    check(after < before and hist.stats["trimmed_ticks"] > 0,
          f"history H compaction: spill {before} -> {after} bytes")
    storm._group_wal.close()
    return {"ops": HIST_CHURN_ROUNDS * HIST_K, "live_keys": len(entries),
            "spill_bytes_before": before, "spill_bytes_after": after,
            "after_over_before": after / before,
            "trimmed_ticks": hist.stats["trimmed_ticks"],
            "compact_ms": compact_ms}


def history_fork_merge(device, root: pathlib.Path, residency: bool) -> dict:
    """``bench_history_fork_merge``: a fork at mid-history (without
    residency the branch row is written in place; with it the seed is a
    cold record the branch's first frame hydrates), branch rounds, then
    merge_back; the forked row == the fold at the fork seq, the branch
    and the parent after merge_back == the folds of their records."""
    import numpy as np
    service, storm, hist, res = history_stack(device, root,
                                              residency=residency)
    client = service.connect("f0", lambda m: None).client_id
    service.pump()
    hist_serve(storm, "f0", client, HIST_FORK_ROUNDS, 7)
    fork_seq = 1 + (HIST_FORK_ROUNDS // 2) * HIST_K
    s_live = storm.merge_host._xstate.present.shape[1]
    seed = np_fold(doc_batches(storm, "f0"), fork_seq, s_live)
    t0 = time.perf_counter()
    branch = hist.fork("f0", fork_seq, name="f0-branch", writer="w")
    fork_ms = 1e3 * (time.perf_counter() - t0)
    state = hist._state_at("f0", fork_seq)
    check(all(np.array_equal(a, b) for a, b in
              zip(state.planes(s_live), seed[:3]))
          and state.cleared_seq == seed[3],
          "history H fork: the fold state at the fork seq != the numpy fold")
    if residency:
        check(not res.is_resident(branch),
              "history H fork: the cold-seeded branch is resident")
    else:
        check(rows_equal(map_row(storm, branch), seed),
              "history H fork: the branch row != the fold at the fork seq")
    check(hist.read_at(branch, fork_seq)["entries"] == fold_entries(seed),
          "history H fork: read_at(branch, fork seq) != the fold")
    hist_serve(storm, branch, "w", HIST_BRANCH_ROUNDS, 11, ref=fork_seq,
               rid="b")
    if residency:
        check(res.is_resident(branch) and res.stats["hydrations"] > 0,
              "history H fork: the branch's first frame did not hydrate it")
    b_head = hist.head_seq(branch)
    b_fold = np_fold(doc_batches(storm, branch), b_head, s_live, base=seed)
    check(rows_equal(map_row(storm, branch), b_fold)
          and hist.read_at(branch, b_head)["entries"]
          == fold_entries(b_fold),
          "history H fork: the served branch != the fold of its records")
    branch_row = map_row(storm, branch)
    t0 = time.perf_counter()
    report = hist.merge_back(branch)
    merge_ms = 1e3 * (time.perf_counter() - t0)
    head = hist.head_seq("f0")
    p_fold = np_fold(doc_batches(storm, "f0"), head, s_live)
    check(report["merged_ops"] == HIST_BRANCH_ROUNDS * HIST_K
          and rows_equal(map_row(storm, "f0"), p_fold)
          and hist.read_at("f0", head)["entries"] == fold_entries(p_fold),
          "history H merge_back: the parent != the fold of its records")
    return {"fork_seq": fork_seq, "fork_ms": fork_ms,
            "branch_ops": HIST_BRANCH_ROUNDS * HIST_K,
            "merged_ops": report["merged_ops"], "merge_ms": merge_ms,
            "parent_seq_after": report["parent_seq"],
            "hydrations": res.stats["hydrations"] if res else None,
            "branch_row": branch_row, "parent_row": map_row(storm, "f0")}


def history_path_h(device) -> dict:
    """History H: the three reference history benches on the card, under
    the plane recording wrappers (every kernel call kept)."""
    import shutil
    import tempfile
    root = pathlib.Path(tempfile.mkdtemp(prefix="ff-history-h-"))
    kept: dict = {}
    t0 = time.perf_counter()
    try:
        launch_counts_reset()
        with plane_recording(kept):
            out = {"reads": history_reads(device, root / "reads"),
                   "compaction": history_compaction(device, root / "disk"),
                   "fork_merge": history_fork_merge(device, root / "fork",
                                                    residency=False),
                   "fork_merge_residency": history_fork_merge(
                       device, root / "fork_res", residency=True)}
        counts = launch_counts()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    plain, cold = out["fork_merge"], out["fork_merge_residency"]
    check(rows_equal(plain.pop("branch_row"), cold.pop("branch_row"))
          and rows_equal(plain.pop("parent_row"), cold.pop("parent_row")),
          "history H: the residency arm's branch or parent != the other's")
    check(counts["map_fold"] > 0 and counts["sequencer_tick"] > 0,
          "history H launched no map fold or no deli")
    out["seconds"] = time.perf_counter() - t0
    out["launches"] = {k: counts[k] for k in (
        "map_fold", "sequencer_tick", "mergetree_blocks", "mergetree_flat")}
    print("history_h: " + json.dumps(out), flush=True)
    return {"out": out, "counts": counts, "kept": kept}


def history_path_p(device, ctx: dict, trace: bool = False) -> dict:
    """History P (see HIST_P_*) on the durable path's recovered stack
    (``ctx``), under the plane recording wrappers: forks past the pool's
    10,240 rows, ticks to parents and branches, reads, compaction, and a
    fresh stack's ``recover()`` of the same directories, each held to
    the live stack and to numpy folds. With ``trace`` the live part runs
    under ``torch.profiler``."""
    import numpy as np
    import torch

    from fluidframework_tpu_torch.server.history import (
        HistoryError,
        HistoryPlane,
    )
    storm = ctx["storm"]  # its blobs and headers are read once
    hist_kw = dict(summary_interval_ops=HIST_P_INTERVAL_OPS,
                   tail_retention_summaries=0,
                   compact_check_every=HIST_P_CHECK_EVERY)
    hist = HistoryPlane(storm, **hist_kw)
    cadence = {"passes": 0, "s": 0.0}
    inner_pass = hist.maybe_compact

    def timed_pass(*args, **kw):
        t0 = time.perf_counter()
        done = inner_pass(*args, **kw)
        if done:
            cadence["passes"] += 1
            cadence["s"] += time.perf_counter() - t0
        return done
    hist.maybe_compact = timed_pass
    # Parents from the back half of the index order: the cadence compacts
    # due docs from the front, a pass at a time.
    order = list(storm._doc_ticks)
    parents = [order[i] for i in np.linspace(
        len(order) // 2, len(order) - 1, HIST_P_FORKS).astype(int)]
    s_live = storm.merge_host._xstate.present.shape[1]
    cap0 = storm.merge_host._map_capacity
    fork_seq, clients = {}, {}
    for p in parents:
        fork_seq[p] = max(rec["last_seq"] for rec in
                          storm.records_overlapping(p, 0)
                          if rec["tick"] <= DURABLE_HEAD_TICK
                          and rec["n_seq"] > 0)
        c = storm.seq_host.checkpoint(p).clients[0]
        clients[p] = [c["client_id"], c["client_seq"] + 1]
    gen = np.random.default_rng(11)
    kept: dict = {}
    branches: dict = {}
    branch_ticks: dict = {}
    secs: dict = {}

    def fork(lo, hi):
        t0 = time.perf_counter()
        for i in range(lo, hi):
            p = parents[i]
            branches[p] = hist.fork(p, fork_seq[p], name=f"{p}@hist",
                                    writer=f"hw{i}")
        secs["fork"] = secs.get("fork", 0.0) + time.perf_counter() - t0

    def tick(t):
        entries = []
        for p in parents:
            c, cseq = clients[p]
            ref = storm.seq_host.checkpoint(p).sequence_number
            entries.append([p, c, cseq, ref, K_MAP])
            clients[p][1] += K_MAP
        for i, p in enumerate(parents):
            if p in branches:
                n = branch_ticks[p] = branch_ticks.get(p, 0) + 1
                entries.append([branches[p], f"hw{i}", 1 + (n - 1) * K_MAP,
                                fork_seq[p], K_MAP])
        kinds = np.where(gen.random((len(entries), K_MAP)) < 0.05, 2,
                         np.where(gen.random((len(entries), K_MAP)) < 0.3,
                                  1, 0))
        words = (kinds
                 | (gen.integers(0, KEY_SLOTS, (len(entries), K_MAP)) << 2)
                 | (gen.integers(0, 1 << 20, (len(entries), K_MAP)) << 12))
        t0 = time.perf_counter()
        storm.submit_frame(None, {"rid": ("hist-p", t), "docs": entries},
                           memoryview(words.astype(np.uint32).tobytes()))
        storm.flush()
        torch.cuda.synchronize()
        secs["ticks"] = secs.get("ticks", 0.0) + time.perf_counter() - t0

    def read_all(h):
        """read_at at each read's seq: entries, or the refusal."""
        out = {}
        for doc, s in reads:
            try:
                out[(doc, s)] = h.read_at(doc, s)["entries"]
            except HistoryError:
                out[(doc, s)] = "HistoryError"
        return out

    prof = None
    ctx_trace = contextlib.nullcontext()
    if trace:
        prof = ctx_trace = new_profile()
    launch_counts_reset()
    t_all = time.perf_counter()
    with plane_recording(kept), ctx_trace:
        half = HIST_P_FORKS // 2
        fork(0, half)
        tick(0)
        t0 = time.perf_counter()
        storm.checkpoint()
        ckpt_tick = storm._tick_counter
        secs["checkpoint"] = time.perf_counter() - t0
        fork(half, HIST_P_FORKS)
        for t in range(1, HIST_P_TICKS):
            tick(t)
        # One read a doc (a depth cut from 4, PERF.md §4), alternating
        # between the pairs: the parent at its fork seq and the branch at
        # its head, or the parent at its head and the branch just below
        # its fork seq (where a branch read delegates to its parent).
        reads = []
        for i, p in enumerate(parents):
            q, b = fork_seq[p], branches[p]
            reads += ([(p, q), (b, hist.head_seq(b))] if i % 2 == 0
                      else [(p, hist.head_seq(p)), (b, q - 1)])
        t0 = time.perf_counter()
        before = read_all(hist)
        secs["reads"] = time.perf_counter() - t0
        # Where a parent's head read goes: its records' lookup (a scan
        # of each tick's header) against the whole read.
        t0 = time.perf_counter()
        storm.records_overlapping(parents[0], 0)
        secs["one_parent_records"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        hist.read_at(parents[0], hist.head_seq(parents[0]))
        secs["one_parent_head_read"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        storm.read_tick_words(storm._doc_ticks[parents[0]][0][2])
        secs["one_tick_words"] = time.perf_counter() - t0
        live_rows = {d: map_row(storm, d)
                     for d in parents + list(branches.values())}
        records = tick_records(storm, list(live_rows))
        batches = {d: doc_batches(storm, d, records[d]) for d in live_rows}
        t0 = time.perf_counter()
        for p in parents:
            hist.compact(p)
        trimmed = hist.trim_now()
        secs["compact"] = time.perf_counter() - t0
        torch.cuda.synchronize()
    secs["all"] = time.perf_counter() - t_all
    counts = launch_counts()
    check(storm.merge_host._map_capacity > cap0
          and len(storm.merge_host._map_rows) > DOCS,
          f"history P: the map pool did not grow past {DOCS} rows "
          f"({cap0} -> {storm.merge_host._map_capacity})")
    # Exactness, live: the seeds, the rows and every read == numpy folds.
    for i, p in enumerate(parents):
        b, q = branches[p], fork_seq[p]
        seed = np_fold(batches[p], q, s_live)
        state = hist._state_at(b, q)
        check(all(np.array_equal(x, y) for x, y in
                  zip(state.planes(s_live), seed[:3]))
              and state.cleared_seq == seed[3],
              f"history P: the seed of {b} != the numpy fold at {q}")
        check(rows_equal(live_rows[p], np_fold(batches[p], 1 << 40,
                                               s_live))
              and rows_equal(live_rows[b], np_fold(batches[b], 1 << 40,
                                                   s_live, base=seed)),
              f"history P: the rows of {p} or {b} != the folds")
        for doc, s in reads[2 * i:2 * i + 2]:
            want = (np_fold(batches[p], s, s_live) if doc == p or s < q
                    else np_fold(batches[b], s, s_live, base=seed))
            check(before[(doc, s)] == fold_entries(want),
                  f"history P: read_at({doc}, {s}) != the numpy fold")
            if s == hist.head_seq(doc):
                check(before[(doc, s)] == fold_entries(live_rows[doc]),
                      f"history P: the head read of {doc} != its device "
                      "row")
    # After compaction with retention 0 a parent serves its head alone:
    # reads below it raise, on the parent and through its branches.
    after = read_all(hist)
    refused = {k for k, v in after.items() if v == "HistoryError"}
    parent_of = {b: p for p, b in branches.items()}
    want_refused = {(d, s) for d, s in reads
                    if s < (fork_seq[parent_of[d]] if d in parent_of
                            else hist.head_seq(d))}
    check(refused == want_refused and all(
        after[k] == before[k] for k in after if k not in refused),
        f"history P: {len(refused)} reads refused after compaction, want "
        f"{len(want_refused)}")
    hp_after = 0
    for t in range(ckpt_tick, storm._tick_counter):
        header, _ = storm._parse_header(storm._read_blob(t))
        hp_after += (header.get("hp") or {}).get("op") == "fork"
    live_state = hist.export_state()
    storm._group_wal.close()
    # A fresh stack with a plane recovers the same directories.
    rec_kept: dict = {}
    storm2 = ctx["make_stack"]()
    hist2 = HistoryPlane(storm2, **hist_kw)
    launch_counts_reset()
    with plane_recording(rec_kept):
        t0 = time.perf_counter()
        info = storm2.recover()
        torch.cuda.synchronize()
        secs["recover"] = time.perf_counter() - t0
    rec_counts = launch_counts()
    read_blobs_once(storm2)
    check(hist2.export_state() == live_state
          and len(live_state["branches"]) == HIST_P_FORKS,
          "history P: the recovered branch registry != the live one")
    check(hp_after == HIST_P_FORKS - half and info["replayed_ticks"] > 0,
          f"history P: {hp_after} hp fork controls past the checkpoint, "
          f"recover() {info}")
    bad = [d for d, row in live_rows.items()
           if not rows_equal(map_row(storm2, d), row)]
    check(not bad, f"history P: recovered rows != live ({bad[:3]})")
    check(read_all(hist2) == after,
          "history P: the recovered stack's reads != the live stack's")
    storm2._group_wal.close()
    out = {"forks": HIST_P_FORKS, "docs": DOCS, "k": K_MAP,
           "ticks": HIST_P_TICKS,
           "map_capacity": [cap0, storm.merge_host._map_capacity],
           "reads": len(reads), "refused_after_compaction": len(refused),
           "compactions": hist.stats["compactions"],
           "cadence_passes": cadence["passes"], "cadence_s": cadence["s"],
           "trimmed_ticks": trimmed, "hp_forks_replayed": hp_after,
           "snapshot_branches": half, "restored_from": info["restored_from"],
           "replayed_ticks": info["replayed_ticks"], "seconds": secs,
           "launches": {k: counts[k] for k in (
               "map_fold", "sequencer_tick", "mergetree_blocks",
               "mergetree_flat")},
           "recover_launches": {k: rec_counts[k] for k in (
               "map_fold", "sequencer_tick")}}
    if prof is not None:
        out["trace"] = idle_record(prof, 1e3 * secs["all"])
    print("history_p: " + json.dumps(out), flush=True)
    check(counts["map_fold"] > 0, "history P launched no map fold")
    return {"out": out, "counts": counts, "kept": kept,
            "recover_counts": rec_counts, "recover_kept": rec_kept}


def trace_history(device) -> dict:
    """History H's fork/merge arm again under ``torch.profiler``: device
    busy ms against the host's wall ms (History P traces itself)."""
    import shutil
    import tempfile
    out: dict = {}
    root = pathlib.Path(tempfile.mkdtemp(prefix="ff-history-trace-"))
    try:
        with traced(True, out, "fork_merge"):
            history_fork_merge(device, root, residency=False)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print("trace_history: " + json.dumps(out), flush=True)
    return out


# -- the fleet tier (live placement, migration, quorum replication) ------------

#: Fleet H: the reference fleet benches (``bench.py``) at their published
#: defaults, but bench_cluster_scaling's serve windows (FLEET_SCALE_S for
#: 6.0 s, FLEET_SCALE_WARM_S for the 1.0 s warm-ups),
#: bench_replication_overhead's rounds (FLEET_REPL_ROUNDS for 250) and
#: bench_cluster_migration's migrations (FLEET_MIGRATIONS for 12; depth
#: cuts, PERF.md §4): bench_cluster_migration
#: (2 hosts, FLEET_MIGRATE_DOCS docs, K FLEET_K, FLEET_MIGRATIONS live
#: migrations under round-robin writes), bench_cluster_scaling (4 hosts,
#: genesis active on 2, FLEET_SCALE_DOCS docs, commit latency arms
#: FLEET_COMMIT_MS, each host served from its own thread), and
#: bench_replication_overhead (FLEET_REPL_DOCS docs, FLEET_REPL_ROUNDS
#: rounds after FLEET_REPL_WARM, pipeline depth FLEET_REPL_DEPTH, arms OFF,
#: F=1 and F=2).
FLEET_K = 64
FLEET_MIGRATE_DOCS = 6
FLEET_MIGRATIONS = 8
FLEET_SCALE_DOCS = 16
FLEET_SCALE_S = 1.0
FLEET_SCALE_WARM_S = 0.25
FLEET_COMMIT_MS = (0.0, 10.0, 80.0)
FLEET_REPL_DOCS = 4
FLEET_REPL_ROUNDS = 64
FLEET_REPL_WARM = 25
FLEET_REPL_DEPTH = 2
#: Fleet P: config 3 (DOCS x CLIENTS, KEY_SLOTS, K_MAP) on a StormCluster
#: of FLEET_HOSTS, each a replicated host over FLEET_FOLLOWERS in-process
#: followers (majority quorum), over one shared snapshot store: the joins
#: and a checkpoint, FLEET_P_TICKS ticks of one frame per doc, a
#: migrate_batch of FLEET_P_MOVES of h0's docs over the other hosts (the
#: first FLEET_P_PROBES of them probed during it), FLEET_P_AFTER ticks
#: (the first sends the moved docs' frames to h0, which redirects them),
#: h1 failed over to a promoted follower, FLEET_P_PROMOTED ticks. Every
#: doc's map is held to a numpy fold; the hosts' catch-up records of
#: FLEET_P_SPAN moved docs and as many others are held to their acked ops,
#: and ``cluster.get_deltas`` materialized for FLEET_P_READS of each.
FLEET_HOSTS = ("h0", "h1", "h2", "h3")
FLEET_FOLLOWERS = 2
FLEET_P_TICKS = 2
FLEET_P_MOVES = 512
FLEET_P_PROBES = 64
FLEET_P_AFTER = 2
FLEET_P_PROMOTED = 1
FLEET_P_SPAN = 512
FLEET_P_READS = 16


def doc_seed(doc: str) -> int:
    import zlib
    return zlib.crc32(doc.encode()) & 0x7FFFFFFF


def acked_entries(batches) -> dict:
    """The numpy fold of one doc's acked frames, in order."""
    import numpy as np
    words = np.concatenate(batches) if batches else np.zeros(0, np.uint32)
    return fold_entries(np_fold([(words, np.arange(len(words)))],
                                len(words), KEY_SLOTS))


def check_deltas(cluster, doc: str, joins: int, ops: int, what: str,
                 joins_kept: bool = True) -> None:
    """``cluster.get_deltas(doc, 0)``: seq-contiguous, the ``ops``
    sequenced ops right after the ``joins`` joins (a promoted host keeps
    no join rows: they live in the dead leader's bus tier)."""
    from fluidframework_tpu_torch.protocol.messages import MessageType
    msgs = cluster.get_deltas(doc, 0)
    seqs = [m.sequence_number for m in msgs]
    op_seqs = [m.sequence_number for m in msgs
               if m.type == MessageType.OPERATION]
    want = list(range(1 if joins_kept else joins + 1, joins + ops + 1))
    check(seqs == want and op_seqs == list(range(joins + 1,
                                                 joins + ops + 1)),
          f"{what}: get_deltas({doc}, 0) holds {len(seqs)} seqs "
          f"({seqs[:3]}..{seqs[-3:]}), want {want[0]}..{want[-1]}")


def fleet_cluster(device, root: pathlib.Path, labels, active, num_docs,
                  **storm_kw):
    """The reference benches' ``_cluster_build`` on the card."""
    from fluidframework_tpu_torch.parallel.placement import (
        StormCluster, make_cluster_host)
    from fluidframework_tpu_torch.server.durable_store import \
        GitSnapshotStore
    git = GitSnapshotStore(root / "git")
    hosts = {label: make_cluster_host(label, str(root / label), git,
                                      num_docs=num_docs, device=device,
                                      **storm_kw)
             for label in labels}
    return StormCluster(hosts, git, active=active)


def fleet_assign(cluster, docs, labels) -> None:
    """Round-robin ownership (the reference benches' even split)."""
    for i, d in enumerate(docs):
        cluster.directory.owners[d] = labels[i % len(labels)]
    cluster.directory._save()


def fleet_connect(cluster, docs) -> dict:
    clients = {}
    for d in docs:
        storm = cluster.storm_for(d)
        clients[d] = storm.service.connect(d, lambda m: None).client_id
        storm.service.pump()
    return clients


class FleetDocs:
    """Acked frames per doc, for the fold and the catch-up checks."""

    def __init__(self, docs):
        self.cseq = {d: 1 for d in docs}
        self.acked: dict = {d: [] for d in docs}

    def submit(self, storm, d, client, words, rid) -> bool:
        acks: list = []
        storm.submit_frame(
            acks.append,
            {"rid": rid, "docs": [[d, client, self.cseq[d], 1,
                                   len(words)]]},
            memoryview(words.tobytes()))
        storm.flush()
        if acks and not acks[0].get("error"):
            self.acked[d].append(words)
            self.cseq[d] += len(words)
            return True
        return False

    def check(self, cluster, what: str, deltas=None) -> None:
        """Every doc's map == the fold of its acked frames; ``deltas``
        of them hold the join and every acked op, seq-contiguous."""
        for d, batches in self.acked.items():
            storm = cluster.storm_for(d)
            storm.residency.ensure_resident(d, gate=False)
            got = storm.merge_host.map_entries(d, storm.datastore,
                                               storm.channel)
            check(got == acked_entries(batches),
                  f"{what}: the map of {d} != the fold of its acked frames")
        for d in (self.acked if deltas is None else deltas):
            check_deltas(cluster, d, 1,
                         sum(len(b) for b in self.acked[d]), what)


def fleet_migration(device, root: pathlib.Path) -> dict:
    """bench_cluster_migration on the card: blackout (freeze -> flip) and
    freeze -> first ack at the new owner, per migration."""
    import numpy as np
    labels = ["h0", "h1"]
    cluster = fleet_cluster(device, root, labels, labels,
                            FLEET_MIGRATE_DOCS)
    docs = [f"doc-{i}" for i in range(FLEET_MIGRATE_DOCS)]
    fleet_assign(cluster, docs, labels)
    clients = fleet_connect(cluster, docs)
    book = FleetDocs(docs)

    def serve_round(r):
        for d in docs:
            book.submit(cluster.storm_for(d), d, clients[d],
                        hist_words(doc_seed(d), r, FLEET_K), r)

    for r in range(3):
        serve_round(r)
    cluster.migrate(docs[0], "h1" if cluster.owner_of(docs[0]) == "h0"
                    else "h0")
    cluster.blackouts_s.clear()
    resume_ms = []
    for m in range(FLEET_MIGRATIONS):
        serve_round(100 + m)
        doc = docs[m % len(docs)]
        dst = next(h for h in labels if h != cluster.owner_of(doc))
        t0 = time.perf_counter()
        cluster.migrate(doc, dst)
        ok = book.submit(cluster.hosts[dst], doc, clients[doc],
                         hist_words(m, 7, FLEET_K), f"resume-{m}")
        check(ok, f"fleet H migration: the first frame at {dst} after "
              f"migration {m} did not ack")
        resume_ms.append(1e3 * (time.perf_counter() - t0))
    book.check(cluster, "fleet H migration")
    blk = np.asarray(cluster.blackouts_s) * 1e3
    for storm in cluster.hosts.values():
        storm._group_wal.close()
    return {"migrations": FLEET_MIGRATIONS, "docs": len(docs), "k": FLEET_K,
            "blackout_ms_p50": float(np.percentile(blk, 50)),
            "blackout_ms_p99": float(np.percentile(blk, 99)),
            "blackout_ms_max": float(blk.max()),
            "freeze_to_first_ack_ms_p50": float(np.percentile(resume_ms,
                                                              50)),
            "freeze_to_first_ack_ms_p99": float(np.percentile(resume_ms,
                                                              99))}


def fleet_serve_timed(cluster, clients, book, duration_s, active, r0):
    """Each active host serves its owned docs from its own thread, one
    durable frame at a time (the reference ``_cluster_serve_timed``).
    Returns (acked ops, per-host acked ops, seconds)."""
    import threading
    owned = {label: [d for d in clients if cluster.owner_of(d) == label]
             for label in active}
    acked = {label: 0 for label in active}
    errors: list = []
    start = time.perf_counter()

    def run(label):
        try:
            storm = cluster.hosts[label]
            r = r0
            while owned[label] and \
                    time.perf_counter() - start < duration_s:
                for d in owned[label]:
                    if book.submit(storm, d, clients[d],
                                   hist_words(doc_seed(d), r, FLEET_K),
                                   r):
                        acked[label] += FLEET_K
                r += 1
        except Exception as err:  # reported below, on the main thread
            errors.append(f"{label}: {type(err).__name__}: {err}")
    threads = [threading.Thread(target=run, args=(label,))
               for label in active]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    check(not errors, f"fleet H scaling: a serving thread failed: {errors}")
    return sum(acked.values()), acked, time.perf_counter() - start


def fleet_scaling(device, root: pathlib.Path) -> dict:
    """bench_cluster_scaling on the card: ops/s on 2 hosts, activation of
    2 more, convergence through PlacementController, ops/s on 4 hosts, per
    commit-latency arm."""
    from fluidframework_tpu_torch.parallel.placement import \
        PlacementController
    labels = ["h0", "h1", "h2", "h3"]
    arms = {}
    for latency_ms in FLEET_COMMIT_MS:
        cluster = fleet_cluster(
            device, root / f"arm{latency_ms:g}", labels, labels[:2],
            FLEET_SCALE_DOCS, wal_commit_latency_s=latency_ms / 1e3)
        docs = [f"doc-{i}" for i in range(FLEET_SCALE_DOCS)]
        fleet_assign(cluster, docs, labels[:2])
        clients = fleet_connect(cluster, docs)
        book = FleetDocs(docs)
        fleet_serve_timed(cluster, clients, book, FLEET_SCALE_WARM_S,
                          labels[:2], 0)
        ops2, per2, t2 = fleet_serve_timed(cluster, clients, book,
                                           FLEET_SCALE_S, labels[:2], 1000)
        cluster.activate_host("h2")
        cluster.activate_host("h3")
        rebalance = PlacementController(cluster,
                                        max_moves_per_round=8).rebalance()
        check(rebalance["converged"] and set(
            rebalance["docs_per_host"]) == set(labels),
            f"fleet H scaling: the rebalance did not converge {rebalance}")
        fleet_serve_timed(cluster, clients, book, FLEET_SCALE_WARM_S,
                          labels, 2000)
        ops4, per4, t4 = fleet_serve_timed(cluster, clients, book,
                                           FLEET_SCALE_S, labels, 3000)
        book.check(cluster, f"fleet H scaling, {latency_ms:g} ms")
        for storm in cluster.hosts.values():
            storm._group_wal.close()
        name = ("local_disk" if latency_ms == 0
                else f"commit_{latency_ms:g}ms")
        arms[name] = {
            "ops_per_s_2_hosts": ops2 / t2, "ops_per_s_4_hosts": ops4 / t4,
            "scaling_2_to_4": (ops4 / t4) / max(ops2 / t2, 1e-9),
            "per_host_acked_2": per2, "per_host_acked_4": per4,
            "convergence_s": rebalance["elapsed_s"],
            "migrations": rebalance["moves"],
            "docs_per_host_after": rebalance["docs_per_host"]}
    return {"docs": FLEET_SCALE_DOCS, "k": FLEET_K,
            "duration_s": FLEET_SCALE_S, "warmup_s": FLEET_SCALE_WARM_S,
            "arms": arms}


def fleet_replication(device, root: pathlib.Path) -> dict:
    """bench_replication_overhead on the card: per-frame ack latency
    (submit -> ack, gated on min(durable, replicated)) and acked ops/s
    with no replication, F=1 and F=2 followers."""
    import numpy as np

    from fluidframework_tpu_torch.parallel.placement import \
        make_cluster_host
    from fluidframework_tpu_torch.server.durable_store import \
        GitSnapshotStore
    from fluidframework_tpu_torch.server.replication import \
        make_replicated_host
    arms = {}
    for followers in (0, 1, 2):
        base = root / f"f{followers}"
        git = GitSnapshotStore(base / "git")
        plane = None
        kw = dict(num_docs=FLEET_REPL_DOCS, device=device,
                  pipeline_depth=FLEET_REPL_DEPTH)
        if followers:
            storm, plane = make_replicated_host(
                "hostA", str(base / "hostA"), git,
                [str(base / f"f{i}") for i in range(followers)], **kw)
        else:
            storm = make_cluster_host("hostA", str(base / "hostA"), git,
                                      **kw)
        docs = [f"doc-{i}" for i in range(FLEET_REPL_DOCS)]
        clients = {d: storm.service.connect(d, lambda m: None).client_id
                   for d in docs}
        storm.service.pump()
        cseq = {d: 1 for d in docs}
        sent: dict = {d: [] for d in docs}
        lat: list = []
        errors: list = []

        def serve(n):
            for r in range(n):
                for i, d in enumerate(docs):
                    words = hist_words(r, i, FLEET_K)
                    t0 = time.perf_counter()

                    def push(p, t0=t0):
                        lat.append(time.perf_counter() - t0)
                        if p.get("error"):
                            errors.append(p)
                    storm.submit_frame(
                        push, {"rid": (r, d), "docs": [[
                            d, clients[d], cseq[d], 1, FLEET_K]]},
                        memoryview(words.tobytes()))
                    sent[d].append(words)
                    cseq[d] += FLEET_K
            storm.flush()

        serve(FLEET_REPL_WARM)
        lat.clear()
        start = time.perf_counter()
        serve(FLEET_REPL_ROUNDS)
        elapsed = time.perf_counter() - start
        check(not errors and len(lat) == FLEET_REPL_ROUNDS * len(docs),
              f"fleet H replication F={followers}: {len(lat)} acks, "
              f"{len(errors)} errors")
        for d in docs:
            check(storm.merge_host.map_entries(d, storm.datastore,
                                               storm.channel)
                  == acked_entries(sent[d]),
                  f"fleet H replication F={followers}: the map of {d} != "
                  "the fold of its frames")
        arm = {"followers": followers,
               "acks_required": plane.acks_required if plane else None,
               "ack_ms_p50": 1e3 * float(np.percentile(lat, 50)),
               "ack_ms_p99": 1e3 * float(np.percentile(lat, 99)),
               "acked_ops_per_s": len(lat) * FLEET_K / elapsed,
               "frames": len(lat)}
        if plane is not None:
            check(plane.replicated_len == storm._group_wal.durable_len,
                  f"fleet H replication F={followers}: replicated "
                  f"{plane.replicated_len} != durable "
                  f"{storm._group_wal.durable_len}")
            arm["replicated_len"] = plane.replicated_len
            arm["batches_shipped"] = plane.stats["batches_shipped"]
            arm["ship_failures"] = plane.stats["ship_failures"]
        storm._group_wal.close()
        arms["off" if not followers else f"f{followers}"] = arm
    return {"docs": FLEET_REPL_DOCS, "k": FLEET_K,
            "rounds": FLEET_REPL_ROUNDS, "pipeline_depth": FLEET_REPL_DEPTH,
            "arms": arms,
            "ack_p99_f1_over_off": arms["f1"]["ack_ms_p99"]
            / arms["off"]["ack_ms_p99"],
            "ack_p99_f2_over_off": arms["f2"]["ack_ms_p99"]
            / arms["off"]["ack_ms_p99"]}


def fleet_path_h(device) -> dict:
    """Fleet H: the three reference fleet benches on the card, under the
    thread-safe recording wrappers (every kernel 1 and 2 call kept)."""
    import shutil
    import tempfile
    root = pathlib.Path(tempfile.mkdtemp(prefix="ff-fleet-h-"))
    kept: dict = {}
    secs: dict = {}
    try:
        launch_counts_reset()
        with plane_recording(kept):
            t0 = time.perf_counter()
            out = {"migration": fleet_migration(device, root / "mig")}
            secs["migration"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            out["scaling"] = fleet_scaling(device, root / "scale")
            secs["scaling"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            out["replication"] = fleet_replication(device, root / "repl")
            secs["replication"] = time.perf_counter() - t0
        counts = launch_counts()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    check(counts["map_fold"] > 0 and counts["sequencer_tick"] > 0,
          "fleet H launched no map fold or no deli")
    out["seconds"] = secs
    out["launches"] = {k: counts[k] for k in ("map_fold", "sequencer_tick")}
    print("fleet_h: " + json.dumps(out), flush=True)
    return {"out": out, "counts": counts, "kept": kept}


def fleet_p_words(t: int):
    """Tick ``t``'s words for every doc, config 3's mix (10% clears, 20%
    deletes, sets on KEY_SLOTS keys): u32[DOCS, K_MAP]."""
    import numpy as np
    rng = np.random.default_rng([11, t])
    r = rng.random((DOCS, K_MAP))
    kinds = np.where(r < 0.1, 2, np.where(r < 0.3, 1, 0)).astype(np.uint32)
    slots = rng.integers(0, KEY_SLOTS, (DOCS, K_MAP)).astype(np.uint32)
    vals = rng.integers(0, 1 << 20, (DOCS, K_MAP)).astype(np.uint32)
    return kinds | (slots << 2) | (vals << 12)


def fold_blocks(blocks, docs: int, slots: int):
    """The numpy LWW fold of u32[docs, K] word blocks, each doc's words in
    seq order: (present bool[docs, slots], value i32[docs, slots])."""
    import numpy as np
    present = np.zeros((docs, slots), bool)
    value = np.zeros((docs, slots), np.int32)
    rows = np.arange(docs)
    for words in blocks:
        kind, slot = words & 3, (words >> 2) & 0x3FF
        val = (words >> 12).astype(np.int32)
        for j in range(words.shape[1]):
            k, s = kind[:, j], slot[:, j]
            present[k == 2] = False
            sets, dels = rows[k == 0], rows[k == 1]
            present[sets, s[sets]] = True
            value[sets, s[sets]] = val[sets, j]
            present[dels, s[dels]] = False
    return present, value


def fleet_path_p(device, trace: bool = False, read: bool = False,
                 trace_read: bool = False) -> dict:
    """Fleet P (see FLEET_P_*): config 3 on a 4-host replicated cluster,
    under the recording wrappers: joins, ticks, a batch migration with
    its ``migrating`` and ``moved`` sheds, a failover of h1 to a promoted
    follower, and a tick through it; every doc held to a numpy fold, the
    promoted host to the dead leader. With ``trace`` the first ticks run
    under ``torch.profiler``. With ``read``, Read R rides it (``ReadR``):
    a replica of h0's follower with viewer rooms re-homed onto it after
    the batch, checked after the ticks that follow, and a mega-promoted
    doc shed to the leader after the last tick (``trace_read`` traces the
    ticks after the batch and the replica's poll)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from fluidframework_tpu_torch.parallel.placement import StormCluster
    from fluidframework_tpu_torch.server.durable_store import \
        GitSnapshotStore
    from fluidframework_tpu_torch.server.replication import (
        ReplicatedHeadStore, make_replicated_host, promote)
    root = pathlib.Path(tempfile.mkdtemp(prefix="ff-fleet-p-"))
    kept: dict = {}
    secs: dict = {}
    out: dict = {}
    storm_kw = dict(num_docs=DOCS // len(FLEET_HOSTS), device=device,
                    flush_threshold_docs=10**9, max_key_slots=KEY_SLOTS,
                    pipeline_depth=1)
    prof = None
    ctx_trace = contextlib.nullcontext()
    if trace:
        prof = ctx_trace = new_profile()
    total = FLEET_P_TICKS + FLEET_P_AFTER + FLEET_P_PROMOTED
    try:
        t_all = time.perf_counter()
        launch_counts_reset()
        with plane_recording(kept):
            git = GitSnapshotStore(root / "git")
            hosts, planes = {}, {}
            for label in FLEET_HOSTS:
                hosts[label], planes[label] = make_replicated_host(
                    label, str(root / label), git,
                    [str(root / f"{label}-f{i}")
                     for i in range(FLEET_FOLLOWERS)], **storm_kw)
            # The directory's head flips ride h0's quorum (h1 fails over).
            cluster = StormCluster(hosts,
                                   ReplicatedHeadStore(git, planes["h0"]))
            names = [f"doc{d}" for d in range(DOCS)]
            owner0 = {n: cluster.owner_of(n) for n in names}
            t0 = time.perf_counter()
            ids = {n: [hosts[owner0[n]].service.connect(
                n, lambda m: None).client_id for _ in range(CLIENTS)]
                for n in names}
            for storm in hosts.values():
                storm.service.pump()
            torch.cuda.synchronize()
            secs["joins"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            for storm in hosts.values():
                storm.checkpoint()
            secs["checkpoint"] = time.perf_counter() - t0
            acked = np.zeros((DOCS, total), bool)
            lat: list = []
            shipped: list = []

            def tick(t, route=None):
                """One frame per doc, to ``route(name)`` (default: its
                owner); every frame must ack."""
                words = fleet_p_words(t)
                c = t % CLIENTS
                cseq0, ref = 1 + (t // CLIENTS) * K_MAP, CLIENTS + t * K_MAP
                wal0 = {lb: len(cluster.hosts[lb]._blob_log)
                        for lb in FLEET_HOSTS}
                t_tick = time.perf_counter()
                for d, n in enumerate(names):
                    hdr = {"rid": (t, d), "docs": [[n, ids[n][c], cseq0,
                                                    ref, K_MAP]]}
                    storm = (route or cluster.storm_for)(n)
                    t_sub = time.perf_counter()

                    def push(p, d=d, t_sub=t_sub):
                        if p.get("error") is None:
                            acked[d, t] = True
                            lat.append(time.perf_counter() - t_sub)
                    storm.submit_frame(push, hdr,
                                       memoryview(words[d].tobytes()))
                for storm in cluster.hosts.values():
                    storm.flush()
                torch.cuda.synchronize()
                check(acked[:, t].all(), f"fleet P: tick {t} acked "
                      f"{int(acked[:, t].sum())} of {DOCS} frames")
                shipped.append(FLEET_FOLLOWERS * sum(
                    len(cluster.hosts[lb]._blob_log.read(i))
                    for lb in FLEET_HOSTS
                    for i in range(wal0[lb],
                                   len(cluster.hosts[lb]._blob_log))))
                return time.perf_counter() - t_tick

            with ctx_trace:
                t0 = time.perf_counter()
                secs["ticks"] = [tick(t) for t in range(FLEET_P_TICKS)]
                wall_trace = time.perf_counter() - t0
            ledger = [r["wal_commit_wait"] / 1e6 for storm in hosts.values()
                      for r in storm.ledger.records()]
            out["ack_ms"] = {"p50": 1e3 * float(np.percentile(lat, 50)),
                             "p99": 1e3 * float(np.percentile(lat, 99))}
            out["commit_wait_ms_p50"] = float(np.percentile(ledger, 50))
            # The batch: FLEET_P_MOVES of h0's docs, cheapest first, over
            # h1-h3; frames to them during it shed "migrating".
            moving = cluster.owned("h0")[:FLEET_P_MOVES]
            moves = [(n, FLEET_HOSTS[1 + i % 3])
                     for i, n in enumerate(moving)]
            moved_to = dict(moves)
            t_next = FLEET_P_TICKS
            probes = fleet_p_words(t_next)
            probe_nacks: list = []

            def on_phase(phase):
                if phase != "frozen":
                    return
                for n in moving[:FLEET_P_PROBES]:
                    d = names.index(n)
                    for label in ("h0", moved_to[n]):
                        cluster.hosts[label].submit_frame(
                            probe_nacks.append,
                            {"rid": ("probe", d), "docs": [[
                                n, ids[n][t_next % CLIENTS],
                                1 + (t_next // CLIENTS) * K_MAP,
                                CLIENTS + t_next * K_MAP, K_MAP]]},
                            memoryview(probes[d].tobytes()))
            t0 = time.perf_counter()
            batch = cluster.migrate_batch(moves, on_phase=on_phase)
            secs["batch"] = time.perf_counter() - t0
            check(batch["moved"] == FLEET_P_MOVES and not batch["aborted"]
                  and batch["directory_writes"] == 2,
                  f"fleet P: the batch {batch}")
            check(len(probe_nacks) == 2 * FLEET_P_PROBES and all(
                p.get("error") == "migrating" and p["retry_after_s"] > 0
                for p in probe_nacks),
                "fleet P: frames to migrating docs did not shed "
                "'migrating'")
            out["batch"] = {"moved": batch["moved"],
                            "directory_writes": batch["directory_writes"],
                            "blackout_ms": 1e3 * batch["blackout_s"]}
            read_r = ReadR(cluster, planes, git, names) if read else None
            # The first tick after it: the moved docs' clients still send
            # to h0, which sheds "moved" naming the owner; they redial.
            redirects: list = []

            def stale(n):
                if n not in moved_to:
                    return cluster.storm_for(n)
                return Redial(n)

            class Redial:
                def __init__(self, n):
                    self.n = n

                def submit_frame(self, push, hdr, payload):
                    nacks: list = []
                    cluster.hosts["h0"].submit_frame(nacks.append, hdr,
                                                     payload)
                    check(len(nacks) == 1 and nacks[0]["error"] == "moved"
                          and nacks[0]["moved_to"]
                          == {self.n: moved_to[self.n]},
                          f"fleet P: h0's redirect of {self.n}: {nacks}")
                    redirects.append(self.n)
                    cluster.hosts[moved_to[self.n]].submit_frame(
                        push, hdr, payload)
            # Read R's trace: the ticks its rooms see, and the poll.
            with traced(read_r is not None and trace_read,
                        read_r.trace if read_r is not None else {},
                        "read_r"):
                secs["ticks_after"] = [tick(FLEET_P_TICKS, stale)]
                for t in range(FLEET_P_TICKS + 1,
                               FLEET_P_TICKS + FLEET_P_AFTER):
                    secs["ticks_after"].append(tick(t))
                if read_r is not None:
                    read_r.poll()
            check(len(redirects) == FLEET_P_MOVES,
                  f"fleet P: {len(redirects)} redirects")
            if read_r is not None:
                read_r.check_after(FLEET_P_AFTER)
            # h1 dies; its most advanced follower is promoted on the card.
            old = cluster.hosts["h1"]
            h1_docs = [n for n in names if cluster.owner_of(n) == "h1"]
            dead = map_planes_by_doc(old.merge_host, h1_docs, device)
            check(planes["h1"].replicated_len == old._group_wal.durable_len,
                  "fleet P: h1's replicated length != its durable length")
            old._group_wal.close()
            before = launch_counts()
            storm2, plane2, rep = promote(
                "h1", [lk.node for lk in planes["h1"].links], git,
                cluster=cluster, follower_dirs=[str(root / "h1-f2")],
                **storm_kw)
            torch.cuda.synchronize()
            mk1 = launch_counts()
            out["promotion"] = {
                k: rep[k] for k in ("blackout_ms", "replayed_ticks",
                                    "log_len", "heads_rolled_forward")}
            out["promotion"]["launches"] = {
                k: mk1[k] - before[k] for k in ("map_fold",
                                                "sequencer_tick")}
            check(cluster.hosts["h1"] is storm2 and planes["h1"].fenced,
                  "fleet P: the failover did not replace and fence h1")
            nacks: list = []
            n0 = h1_docs[0]
            old.submit_frame(nacks.append, {"rid": "zombie", "docs": [[
                n0, ids[n0][0], 1, 1, K_MAP]]},
                memoryview(
                    fleet_p_words(0)[names.index(n0)].tobytes()))
            check(len(nacks) == 1 and nacks[0]["error"] == "moved"
                  and nacks[0]["moved_to"] == {n0: "h1"},
                  f"fleet P: the fenced ex-leader's shed {nacks}")
            try:
                old.checkpoint()
            except RuntimeError:
                pass
            else:
                fail("fleet P: the fenced ex-leader checkpointed")
            for n in h1_docs:
                storm2.residency.ensure_resident(n, gate=False)
            for f, x, y in zip(storm2.merge_host._xstate._fields, dead,
                               map_planes_by_doc(storm2.merge_host,
                                                 h1_docs, device)):
                check(torch.equal(x, y), f"fleet P: the promoted h1's {f} "
                      "plane != the dead leader's")
            planes["h1"] = plane2
            secs["ticks_promoted"] = [
                tick(t) for t in range(FLEET_P_TICKS + FLEET_P_AFTER,
                                       total)]
            if read_r is not None:
                read_r.mega_redirect()
        counts = launch_counts()
        secs["all"] = time.perf_counter() - t_all
        t_checks = time.perf_counter()
        for label, plane in planes.items():
            check(plane.replicated_len
                  == cluster.hosts[label]._group_wal.durable_len,
                  f"fleet P: {label}'s replicated length != durable")
        # Every doc's map == the numpy fold of its acked frames.
        present, value = fold_blocks(
            (fleet_p_words(t) for t in range(total)), DOCS, KEY_SLOTS)
        for label in FLEET_HOSTS:
            mine = [d for d, n in enumerate(names)
                    if cluster.owner_of(n) == label]
            got = map_planes_by_doc(cluster.hosts[label].merge_host,
                                    [names[d] for d in mine], device)
            p = got[0].cpu().numpy()
            v = got[1].cpu().numpy()
            check(np.array_equal(p, present[mine])
                  and np.array_equal(np.where(p, v, 0),
                                     np.where(present[mine],
                                              value[mine], 0)),
                  f"fleet P: {label}'s maps != the numpy fold")
        # The catch-up history, every acked op seq-contiguous: on the moved
        # docs and as many others, the union of each host's records (what
        # ``cluster.get_deltas`` reads: its hosts' ``records_overlapping``)
        # and, on FLEET_P_READS of each, ``cluster.get_deltas`` itself
        # (one message object a sequenced op: all 1,024 docs' 7.3M
        # messages would take minutes of host time). Each tick's blob is
        # read and its header parsed once.
        secs["fold_check"] = time.perf_counter() - t_checks
        t0 = time.perf_counter()
        for storm in cluster.hosts.values():
            read_blobs_once(storm)
        others = [n for n in names if n not in moved_to][::max(
            1, (DOCS - FLEET_P_MOVES) // FLEET_P_SPAN)][:FLEET_P_SPAN]
        span = moving[:FLEET_P_SPAN] + others
        for n in span:
            wins = sorted((r["first_seq"], r["last_seq"])
                          for label in FLEET_HOSTS
                          for r in cluster.hosts[label].records_overlapping(
                              n, 0)
                          if r["n_seq"] > 0)
            seqs = [s for a, b in dict.fromkeys(wins) for s in
                    range(a, b + 1)]
            check(seqs == list(range(CLIENTS + 1,
                                     CLIENTS + total * K_MAP + 1)),
                  f"fleet P: the merged records of {n} are not "
                  "seq-contiguous over every acked op")
        secs["records"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        for n in moving[:FLEET_P_READS] + others[:FLEET_P_READS]:
            check_deltas(cluster, n, CLIENTS, total * K_MAP, "fleet P",
                         joins_kept=owner0[n] != "h1")
        secs["get_deltas"] = time.perf_counter() - t0
        secs["checks"] = time.perf_counter() - t_checks
        for storm in cluster.hosts.values():
            storm._group_wal.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    check(counts["map_fold"] > 0 and counts["sequencer_tick"] > 0,
          "fleet P launched no map fold or no deli")
    out.update(
        docs=DOCS, clients=CLIENTS, k=K_MAP, hosts=len(FLEET_HOSTS),
        followers=FLEET_FOLLOWERS, ticks=total,
        shipped_bytes_per_tick=shipped, seconds=secs,
        ops_per_s=FLEET_P_TICKS * DOCS * K_MAP / sum(secs["ticks"]),
        launches={k: counts[k] for k in ("map_fold", "sequencer_tick")},
        shapes={k: {str(sh): n for sh, n in counts["shapes"][k].items()}
                for k in ("map_fold", "sequencer_tick")})
    if prof is not None:
        out["trace"] = idle_record(prof, 1e3 * wall_trace)
    if read_r is not None:
        out["read_r"] = {**read_r.out, "seconds": read_r.secs,
                         "trace": read_r.trace.get("read_r")}
    print("fleet_p: " + json.dumps(out), flush=True)
    return {"out": out, "counts": counts, "kept": kept}



# -- the read tier and the front door (viewers, read replicas, alfred) --------

#: Viewer V: bench_viewers (``bench.py:2384``) at its defaults but for
#: depth — VIEWER_COUNTS viewers on one hot doc, VIEWER_TICKS (for 8; PERF.md
#: §4) storm ticks of
#: VIEWER_K from one writer — then bench_viewer_rehome (``bench.py:3098``):
#: REHOME_VIEWERS viewers re-homed by a live migration, K REHOME_K.
VIEWER_COUNTS = (1_000, 10_000, 100_000)
VIEWER_TICKS = 4
VIEWER_K = 64
REHOME_VIEWERS = 64
REHOME_K = 32
#: Read R, on Fleet P's replicated config-3 stack after its batch
#: migration and before its failover: READ_ROOMS of h0's docs get
#: READ_ROOM_VIEWERS viewers each, READ_REHOMED of those rooms re-home onto
#: a read replica of h0's first follower (READ_LABEL), and READ_DOCS docs
#: are read (``read_at`` at 0, mid and head; ``get_deltas``) on the replica.
#: Then bench_replica_read_throughput (``bench.py:4078``) at its defaults
#: and bench_replica_writer_tax (``bench.py:3952``) at REPLICA_TAX_ROUNDS
#: rounds (a depth cut from 250, PERF.md §4).
READ_ROOMS = 256
READ_ROOM_VIEWERS = 16
READ_REHOMED = 128
READ_DOCS = 16
READ_LABEL = "replica-h0"
REPLICA_READ_TICKS = 24
REPLICA_READ_K = 64
REPLICA_READS = 400
REPLICA_TAX_DOCS = 4
REPLICA_TAX_K = 64
REPLICA_TAX_ROUNDS = 64
REPLICA_TAX_WARM = 25
REPLICA_TAX_DEPTH = 2
REPLICA_TAX_BLOCKS = 5
#: Front door F: an AlfredServer over the durable path's recovered config-3
#: stack, FRONT_TICKS ticks of every doc's frame through one socket,
#: FRONT_VIEWERS viewer sockets, a directory-routed viewer (FRONT_LABEL);
#: then the standalone entry point as a user starts it.
FRONT_TICKS = 2
FRONT_VIEWERS = 64
FRONT_LABEL = "replica-f"
FRONT_STANDALONE_OPS = 8


def storm_frames(frames) -> list:
    """The binary viewer tick frames among a viewer's payloads."""
    from fluidframework_tpu_torch.protocol.codec import is_storm_body
    return [bytes(p) for p in frames
            if isinstance(p, (bytes, bytearray)) and is_storm_body(p)]


def viewer_fanout(device, trace: dict | None = None) -> dict:
    """bench_viewers on the card: for each audience size a fresh storm
    stack, the viewers join one hot doc's room through the viewer plane,
    then one writer serves VIEWER_TICKS ticks; the broadcast hop (one
    encode, one batched native publish, the drain) timed per tick.
    Checks: one encode a tick, every viewer got every tick's frame, no lag
    drop, the native fan-out ran, and the first viewer's frames equal
    ``encode_viewer_tick_body`` of each tick's ack and words."""
    import numpy as np
    import torch

    from fluidframework_tpu_torch.protocol.codec import \
        encode_viewer_tick_body
    from fluidframework_tpu_torch.server.broadcaster import ViewerPlane
    from fluidframework_tpu_torch.server.kernel_host import \
        KernelSequencerHost
    from fluidframework_tpu_torch.server.merge_host import KernelMergeHost
    from fluidframework_tpu_torch.server.routerlicious import \
        RouterliciousService
    from fluidframework_tpu_torch.server.storm import StormController
    rows = {}
    k, doc = VIEWER_K, "live-doc"
    for n_viewers in VIEWER_COUNTS:
        seq_host = KernelSequencerHost(num_slots=2, initial_capacity=4,
                                       device=device)
        merge_host = KernelMergeHost(flush_threshold=10**9, device=device)
        service = RouterliciousService(merge_host=merge_host,
                                       batched_deli_host=seq_host,
                                       auto_pump=False)
        storm = StormController(service, seq_host, merge_host,
                                flush_threshold_docs=10**9)
        plane = ViewerPlane(service, join_rate_per_s=1e9)
        writer = service.connect(doc, lambda m: None)
        service.pump()
        delivered = [0]
        first: list = []

        def first_push(p):
            delivered[0] += 1
            first.append(p)

        def viewer_push(_p):
            delivered[0] += 1

        t0 = time.perf_counter()
        plane.join(doc, first_push)
        for _ in range(n_viewers - 1):
            plane.join(doc, viewer_push)
        join_s = time.perf_counter() - t0
        plane.drain_all()  # the joins' coalesced presence announces
        broadcast_s: list = []
        inner = plane.publish_ticks

        def timed_publish(items, inner=inner):
            t = time.perf_counter()
            out = inner(items)
            broadcast_s.append(time.perf_counter() - t)
            return out
        plane.publish_ticks = timed_publish
        words = residency_words((13, n_viewers), k)
        acks: dict = {}

        def sink(p):
            if not p.get("error"):
                acks[p["rid"]] = np.asarray(p.rows).tolist()
        storm.submit_frame(sink, {"rid": -1, "docs": [[
            doc, writer.client_id, 1, 1, k]]}, memoryview(words.tobytes()))
        storm.flush()  # the untimed warm-up tick
        broadcast_s.clear()
        first.clear()
        encodes0 = plane.stats["tick_encodes"]
        delivered0 = delivered[0]
        ctx = traced(trace is not None and n_viewers == VIEWER_COUNTS[-1],
                     trace if trace is not None else {}, "viewer_v")
        with ctx:
            t1 = time.perf_counter()
            for t in range(1, 1 + VIEWER_TICKS):
                storm.submit_frame(sink, {"rid": t, "docs": [[
                    doc, writer.client_id, 1 + t * k, 1, k]]},
                    memoryview(words.tobytes()))
                storm.flush()
            torch.cuda.synchronize()
            total_s = time.perf_counter() - t1
        encodes = plane.stats["tick_encodes"] - encodes0
        frames = delivered[0] - delivered0
        native = bool(getattr(plane.fanout, "is_native", False))
        check(encodes == VIEWER_TICKS,
              f"viewer V at {n_viewers}: {encodes} encodes in "
              f"{VIEWER_TICKS} ticks (want one a tick)")
        check(frames == n_viewers * VIEWER_TICKS,
              f"viewer V at {n_viewers}: {frames} frames delivered, want "
              f"{n_viewers * VIEWER_TICKS}")
        check(plane.stats["lag_drops"] == 0,
              f"viewer V at {n_viewers}: {plane.stats['lag_drops']} lag "
              "drops")
        check(native, f"viewer V at {n_viewers}: the fan-out is not the "
              "native library")
        want = [bytes(encode_viewer_tick_body(doc, *acks[t][0], k,
                                              words.tobytes()))
                for t in range(1, 1 + VIEWER_TICKS)]
        check(storm_frames(first) == want,
              f"viewer V at {n_viewers}: the first viewer's frames != "
              "encode_viewer_tick_body of each tick's ack and words")
        lat = 1e3 * np.asarray(broadcast_s)
        rows[f"viewers_{n_viewers}"] = {
            "viewers": n_viewers, "ticks": VIEWER_TICKS, "ops_per_tick": k,
            "join_s": join_s, "joins_per_sec": n_viewers / join_s,
            "e2e_ops_per_sec": VIEWER_TICKS * k / total_s,
            "broadcast_ms_p50": float(np.percentile(lat, 50)),
            "broadcast_ms_p99": float(np.percentile(lat, 99)),
            "broadcast_frames_delivered": frames,
            "frames_per_sec_fanout": frames / sum(broadcast_s),
            "broadcast_bytes_total": plane.stats["broadcast_bytes"],
            "lag_drops": plane.stats["lag_drops"],
            "encodes_per_tick": encodes / VIEWER_TICKS,
            "fanout_native": native}
    return rows


def viewer_rehome(device, root: pathlib.Path) -> dict:
    """bench_viewer_rehome on the card: REHOME_VIEWERS viewers on the
    source host's room; the migration drops each with a ``moved_to``
    directive; each runs the re-home dance (the merged ``get_deltas`` gap,
    then a join on the target's plane). Latency from each directive to
    live on the target; the target's harvest then broadcasts."""
    import numpy as np

    from fluidframework_tpu_torch.server.broadcaster import ViewerPlane
    labels = ["h0", "h1"]
    cluster = fleet_cluster(device, root, labels, labels, 4)
    doc = "hot-doc"
    clients = fleet_connect(cluster, [doc])
    src = cluster.owner_of(doc)
    dst = next(h for h in labels if h != src)
    src_plane = ViewerPlane(cluster.hosts[src].service)
    dst_plane = ViewerPlane(cluster.hosts[dst].service)
    directive_at: dict = {}
    moved_to: list = []
    for v in range(REHOME_VIEWERS):
        def push(p, v=v):
            if isinstance(p, dict) and p.get("event") == "viewer_resync":
                directive_at[v] = time.perf_counter()
                moved_to.append(p.get("moved_to"))
        src_plane.join(doc, push)
    cseq = 1
    for r in range(3):
        cluster.storm_for(doc).submit_frame(
            None, {"rid": r, "docs": [[doc, clients[doc], cseq, 1,
                                       REHOME_K]]},
            memoryview(hist_words(0, r, REHOME_K).tobytes()))
        cluster.storm_for(doc).flush()
        cseq += REHOME_K
    cluster.migrate(doc, dst)
    check(len(directive_at) == REHOME_VIEWERS
          and moved_to == [dst] * REHOME_VIEWERS,
          f"viewer V re-home: {len(directive_at)} directives, moved_to "
          f"{set(moved_to)} (want {REHOME_VIEWERS} naming {dst})")
    rehome_ms = []
    for v in range(REHOME_VIEWERS):
        gap = cluster.get_deltas(doc, 0)
        dst_plane.join(doc, lambda p: None)
        rehome_ms.append(1e3 * (time.perf_counter() - directive_at[v]))
    check_deltas(cluster, doc, 1, 3 * REHOME_K, "viewer V re-home")
    encodes0 = dst_plane.stats["tick_encodes"]
    cluster.storm_for(doc).submit_frame(
        None, {"rid": 3, "docs": [[doc, clients[doc], cseq, 1, REHOME_K]]},
        memoryview(hist_words(0, 3, REHOME_K).tobytes()))
    cluster.storm_for(doc).flush()
    check(dst_plane.stats["tick_encodes"] == encodes0 + 1
          and dst_plane.room_size(doc) == REHOME_VIEWERS,
          "viewer V re-home: the target's plane did not broadcast to the "
          "re-homed room")
    for storm in cluster.hosts.values():
        storm._group_wal.close()
    arr = np.asarray(rehome_ms)
    return {"viewers": REHOME_VIEWERS, "k": REHOME_K,
            "rehomed_viewers": cluster.stats["rehomed_viewers"],
            "gap_messages": len(gap),
            "rehome_ms_p50": float(np.percentile(arr, 50)),
            "rehome_ms_p99": float(np.percentile(arr, 99))}


def viewer_path_v(device, trace: bool = False) -> dict:
    """Viewer V: bench_viewers and bench_viewer_rehome on the card, under
    the plane recording wrappers (every kernel 1 and 2 call kept)."""
    import shutil
    import tempfile
    root = pathlib.Path(tempfile.mkdtemp(prefix="ff-viewer-v-"))
    kept: dict = {}
    secs: dict = {}
    traces: dict = {}
    try:
        launch_counts_reset()
        with plane_recording(kept):
            t0 = time.perf_counter()
            out = {"fanout": viewer_fanout(
                device, traces if trace else None)}
            secs["fanout"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            out["rehome"] = viewer_rehome(device, root)
            secs["rehome"] = time.perf_counter() - t0
        counts = launch_counts()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    check(counts["map_fold"] > 0 and counts["sequencer_tick"] > 0,
          "viewer V launched no map fold or no deli")
    out.update(seconds=secs, trace=traces.get("viewer_v"),
               launches={k: counts[k] for k in ("map_fold",
                                                "sequencer_tick")})
    print("viewer_v: " + json.dumps(out), flush=True)
    return {"out": out, "counts": counts, "kept": kept}


class ReadR:
    """Read R's part inside Fleet P (see READ_*): attached after the
    batch migration, checked after the ticks that follow it, and its
    mega-promoted redirect taken after Fleet P's last tick."""

    def __init__(self, cluster, planes, git, names):
        from fluidframework_tpu_torch.server.broadcaster import ViewerPlane
        from fluidframework_tpu_torch.server.read_replica import (
            ReadReplica, ReplicaDirectory)
        self.secs: dict = {}
        self.out: dict = {}
        self.trace: dict = {}
        self.cluster = cluster
        self.leader = cluster.hosts["h0"]
        t0 = time.perf_counter()
        self.rep = ReadReplica(planes["h0"].links[0].node, git, READ_LABEL,
                               leader_label="h0", join_rate_per_s=1e9)
        self.secs["replica_start"] = time.perf_counter() - t0
        self.directory = ReplicaDirectory(git)
        self.directory.register(READ_LABEL)
        owned = set(cluster.owned("h0"))
        self.rooms = [n for n in names if n in owned][:READ_ROOMS]
        check(len(self.rooms) == READ_ROOMS,
              f"read R: h0 owns {len(self.rooms)} docs, want {READ_ROOMS}")
        self.plane = ViewerPlane(self.leader.service, join_rate_per_s=1e9)
        self.first: dict = {}
        self.got = [0]
        self.moved: dict = {}
        t0 = time.perf_counter()
        for doc in self.rooms:
            self.first[doc] = []
            for v in range(READ_ROOM_VIEWERS):
                def push(p, doc=doc, v=v):
                    if isinstance(p, dict) \
                            and p.get("event") == "viewer_resync":
                        self.moved.setdefault(doc, []).append(
                            p.get("moved_to"))
                    elif v == 0:
                        self.first[doc].append(p)
                    elif storm_frames([p]):
                        self.got[0] += 1
                self.plane.join(doc, push)
        self.plane.drain_all()
        self.secs["viewer_joins"] = time.perf_counter() - t0
        # Re-home the first READ_REHOMED rooms: the directory flips, then
        # the leader's live room spreads; each member redials the replica
        # (a viewer there), and a witness stays on the leader's room.
        self.rehomed = self.rooms[:READ_REHOMED]
        self.on_replica: dict = {}
        self.witness: dict = {}
        t0 = time.perf_counter()
        spread = {}
        for doc in self.rehomed:
            self.directory.assign_room(doc, [READ_LABEL])
            spread[doc] = self.plane.spread_room(doc, [READ_LABEL])
        self.secs["rehome"] = time.perf_counter() - t0
        check(all(c == {READ_LABEL: READ_ROOM_VIEWERS}
                  for c in spread.values())
              and all(self.moved.get(d) == [READ_LABEL] * READ_ROOM_VIEWERS
                      for d in self.rehomed),
              "read R: a re-homed room's members did not all get a "
              f"viewer_resync naming {READ_LABEL}")
        for doc in self.rehomed:
            self.on_replica[doc] = []
            for _ in range(READ_ROOM_VIEWERS):
                self.rep.viewers.join(doc, self.on_replica[doc].append)
            self.witness[doc] = []
            self.plane.join(doc, self.witness[doc].append)
            self.first[doc].clear()
        self.rep.viewers.drain_all()
        self.plane.drain_all()

    def poll(self) -> None:
        """The replica applies what the leader shipped since it started,
        re-broadcasting each tick to its rooms."""
        t0 = time.perf_counter()
        self.applied = self.rep.poll()
        self.secs["poll"] = time.perf_counter() - t0

    def check_after(self, ticks: int) -> None:
        """After the post-migration ticks and the poll: the replica's
        frames == the leader's for the same rooms and ticks; lag 0; reads
        and ``get_deltas`` on READ_DOCS docs == numpy folds and the
        leader's OPERATION rows; writes redirect to the leader."""
        import numpy as np

        from fluidframework_tpu_torch.protocol.messages import MessageType
        from fluidframework_tpu_torch.server.read_replica import \
            ReplicaRedirect
        rep, leader = self.rep, self.leader
        read_blobs_once(leader)
        check(rep.lag == 0 and self.applied > 0,
              f"read R: replica lag {rep.lag} after polling {self.applied}")
        for doc in self.rehomed:
            # Each tick is published and drained to the room's viewers
            # before the next: the replica's frames come tick by tick.
            want = storm_frames(self.witness[doc])
            got = storm_frames(self.on_replica[doc])
            check(len(want) == ticks and got == [
                f for f in want for _ in range(READ_ROOM_VIEWERS)],
                f"read R: {doc}'s {len(got)} replica frames != the "
                f"leader's {len(want)} for each of its viewers")
        for doc in self.rooms[READ_REHOMED:]:
            check(len(storm_frames(self.first[doc])) == ticks,
                  f"read R: {doc}'s leader room got "
                  f"{len(storm_frames(self.first[doc]))} frames")
        check(self.got[0] == ticks * (READ_ROOM_VIEWERS - 1)
              * (READ_ROOMS - READ_REHOMED),
              f"read R: the leader's rooms delivered {self.got[0]} frames")
        docs = self.rehomed[:READ_DOCS]
        reads: list = []
        t_reads = time.perf_counter()
        for doc in docs:
            batches = doc_batches(leader, doc)
            head = rep.head_seq(doc)
            check(head == leader._doc_ticks[doc][-1][1],
                  f"read R: the replica's head of {doc} is {head}")
            for s in sorted({0, head // 2, head}):
                t0 = time.perf_counter()
                got = rep.read_at(doc, s)["entries"]
                reads.append(time.perf_counter() - t0)
                check(got == fold_entries(np_fold(batches, s, KEY_SLOTS)),
                      f"read R: read_at({doc}, {s}) != the numpy fold")
            check(rep.read_at(doc, head)["entries"]
                  == fold_entries(map_row(leader, doc)),
                  f"read R: the head read of {doc} != h0's device row")
        self.secs["reads"] = time.perf_counter() - t_reads
        op = int(MessageType.OPERATION)
        t0 = time.perf_counter()
        for doc in docs:
            got = [m for m in rep.get_deltas(doc, 0) if int(m.type) == op]
            want = [m for m in leader.service.get_deltas(doc, 0)
                    if int(m.type) == op]
            check(record_key(got) == record_key(want) and len(want) > 0,
                  f"read R: get_deltas({doc}) on the replica != the "
                  "leader's OPERATION rows")
        self.secs["get_deltas"] = time.perf_counter() - t0
        for verb in (lambda: rep.connect(docs[0]),
                     lambda: rep.fork_doc(docs[0], 1),
                     lambda: rep.merge_back(docs[0])):
            try:
                verb()
            except ReplicaRedirect as err:
                check(err.moved_to == "h0",
                      f"read R: a write redirected to {err.moved_to}")
            else:
                fail("read R: a write verb on the replica did not redirect")
        check(rep.read_router.route_read(docs[0], "write") == "h0",
              "read R: the replica's router kept a write")
        ms = 1e3 * np.asarray(reads)
        self.out.update(
            rooms=READ_ROOMS, viewers=READ_ROOMS * READ_ROOM_VIEWERS,
            rehomed_rooms=READ_REHOMED, replica_frames=sum(
                len(storm_frames(v)) for v in self.on_replica.values()),
            records_applied=rep.stats["records_applied"],
            broadcast_ticks=rep.stats["broadcast_ticks"],
            read_ms={"n": len(reads), "p50": float(np.percentile(ms, 50)),
                     "max": float(ms.max())},
            staleness_s_p99=rep.metrics.histogram(
                "replica.staleness_s").quantile(0.99))

    def mega_redirect(self) -> None:
        """A doc of h0 promoted (no frame while promoted) is shed by the
        replica to the leader, and stays so after its demotion."""
        from fluidframework_tpu_torch.server.megadoc import MegaDocManager
        from fluidframework_tpu_torch.server.read_replica import \
            ReplicaRedirect
        leader, rep = self.leader, self.rep
        doc = self.rooms[-1]
        check(rep.can_serve(doc), f"read R: {doc} unservable before")
        mgr = MegaDocManager(leader, default_lanes=2)
        mgr.promote(doc)
        leader._group_wal.sync()  # the control record, fsynced and shipped
        rep.poll()
        promoted = not rep.can_serve(doc)
        try:
            rep.read_at(doc, 1)
        except ReplicaRedirect as err:
            shed = err.moved_to
        else:
            shed = None
        mgr.demote(doc)
        leader._group_wal.sync()
        rep.poll()
        check(promoted and shed == "h0" and not rep.can_serve(doc)
              and rep.read_router.route_read(doc, "read_at") == "h0",
              f"read R: the mega-promoted {doc} was not shed to h0 "
              f"(promoted {promoted}, shed to {shed})")
        self.out["mega_redirect"] = {"doc": doc, "moved_to": shed}


def replica_read_throughput(device, root: pathlib.Path) -> dict:
    """bench_replica_read_throughput on the card: ``read_at`` at
    REPLICA_READS random seqs, by the leader's HistoryPlane and by a
    ReadReplica over its follower — the same fold, equal answers."""
    import numpy as np

    from fluidframework_tpu_torch.server.durable_store import \
        GitSnapshotStore
    from fluidframework_tpu_torch.server.history import HistoryPlane
    from fluidframework_tpu_torch.server.read_replica import ReadReplica
    from fluidframework_tpu_torch.server.replication import \
        make_replicated_host
    git = GitSnapshotStore(root / "git")
    storm, plane = make_replicated_host(
        "hostA", str(root / "hostA"), git, [str(root / "f0")],
        num_docs=4, device=device)
    hist = HistoryPlane(storm, summary_interval_ops=4 * REPLICA_READ_K)
    doc = "doc-0"
    client = storm.service.connect(doc, lambda m: None).client_id
    storm.service.pump()
    cseq = 1
    for t in range(REPLICA_READ_TICKS):
        storm.submit_frame(None, {"rid": t, "docs": [[
            doc, client, cseq, 1, REPLICA_READ_K]]},
            memoryview(hist_words(20, t, REPLICA_READ_K).tobytes()))
        cseq += REPLICA_READ_K
        storm.flush()
    rep = ReadReplica(plane.links[0].node, git, "replica0",
                      leader_label="hostA", viewer_plane=False)
    head = hist.head_seq(doc)
    seqs = np.random.default_rng(20).integers(0, head + 1,
                                              REPLICA_READS).tolist()

    def measure(read_fn) -> dict:
        read_fn(doc, head)
        got = []
        t0 = time.perf_counter()
        for s in seqs:
            got.append(read_fn(doc, int(s)))
        dt = time.perf_counter() - t0
        return {"reads_per_s": REPLICA_READS / dt,
                "read_ms_mean": 1e3 * dt / REPLICA_READS}, got
    leader, by_leader = measure(hist.read_at)
    replica, by_replica = measure(rep.read_at)
    check(by_replica == by_leader,
          "read R throughput: a replica read != the leader's")
    check(rep.read_at(doc, head)["entries"] == storm.merge_host.map_entries(
        doc, storm.datastore, storm.channel),
        "read R throughput: the head read != the leader's map")
    storm._group_wal.close()
    return {"ticks": REPLICA_READ_TICKS, "k": REPLICA_READ_K,
            "reads": REPLICA_READS, "head_seq": head, "leader": leader,
            "replica": replica,
            "replica_over_leader": replica["reads_per_s"]
            / leader["reads_per_s"]}


def replica_writer_tax(device, root: pathlib.Path) -> dict:
    """bench_replica_writer_tax on the card: writer ack latency on a
    replicated leader (F = 1) with a ReadReplica attached (tailing the
    follower, a viewer room, a poll every round) and without, the two
    stacks served round by round in turn; p99 ratio by block."""
    import numpy as np

    from fluidframework_tpu_torch.server.durable_store import \
        GitSnapshotStore
    from fluidframework_tpu_torch.server.read_replica import ReadReplica
    from fluidframework_tpu_torch.server.replication import \
        make_replicated_host
    docs = [f"doc-{i}" for i in range(REPLICA_TAX_DOCS)]
    k = REPLICA_TAX_K

    def build(attach: bool, sub: str) -> dict:
        git = GitSnapshotStore(root / sub / "git")
        storm, plane = make_replicated_host(
            "hostA", str(root / sub / "hostA"), git,
            [str(root / sub / "f0")], num_docs=REPLICA_TAX_DOCS,
            pipeline_depth=REPLICA_TAX_DEPTH, device=device)
        clients = {d: storm.service.connect(d, lambda m: None).client_id
                   for d in docs}
        storm.service.pump()
        rep = None
        if attach:
            rep = ReadReplica(plane.links[0].node, git, "replica0",
                              leader_label="hostA", join_rate_per_s=1e9)
            rep.viewers.join(docs[0], lambda payload: None)
        return {"storm": storm, "clients": clients, "rep": rep,
                "cseq": {d: 1 for d in docs}, "lat": [], "elapsed": 0.0,
                "sent": {d: [] for d in docs}, "errors": []}

    def serve_round(st: dict, r: int) -> None:
        storm, lat = st["storm"], st["lat"]
        t_round = time.perf_counter()
        for i, d in enumerate(docs):
            words = hist_words(r, i, k)
            t0 = time.perf_counter()

            def push(p, t0=t0):
                lat.append(time.perf_counter() - t0)
                if p.get("error"):
                    st["errors"].append(p)
            storm.submit_frame(push, {"rid": (r, d), "docs": [[
                d, st["clients"][d], st["cseq"][d], 1, k]]},
                memoryview(words.tobytes()))
            st["sent"][d].append(words)
            st["cseq"][d] += k
        if st["rep"] is not None:
            st["rep"].poll()
        st["elapsed"] += time.perf_counter() - t_round

    stacks = {"replica_off": build(False, "off"),
              "replica_on": build(True, "on")}
    for r in range(REPLICA_TAX_WARM):
        for st in stacks.values():
            serve_round(st, r)
    for st in stacks.values():
        st["storm"].flush()
        st["lat"].clear()
        st["elapsed"] = 0.0
    per_block = max(1, REPLICA_TAX_ROUNDS // REPLICA_TAX_BLOCKS)
    ratios: list = []
    pooled: dict = {name: [] for name in stacks}
    for b in range(REPLICA_TAX_BLOCKS):
        for st in stacks.values():
            st["lat"].clear()
        lo = REPLICA_TAX_WARM + b * per_block
        for r in range(lo, lo + per_block):
            for st in stacks.values():
                serve_round(st, r)
        for st in stacks.values():
            st["storm"].flush()
        p99 = {name: float(np.percentile(np.asarray(st["lat"]) * 1e3, 99))
               for name, st in stacks.items()}
        ratios.append(p99["replica_on"] / p99["replica_off"])
        for name, st in stacks.items():
            pooled[name].extend(st["lat"])
    arms = {}
    rounds = REPLICA_TAX_BLOCKS * per_block
    for name, st in stacks.items():
        storm = st["storm"]
        check(not st["errors"] and len(pooled[name])
              == rounds * len(docs),
              f"read R writer tax {name}: {len(pooled[name])} acks, "
              f"{len(st['errors'])} errors")
        for d in docs:
            check(storm.merge_host.map_entries(d, storm.datastore,
                                               storm.channel)
                  == acked_entries(st["sent"][d]),
                  f"read R writer tax {name}: the map of {d} != the fold "
                  "of its frames")
        arr = np.asarray(pooled[name]) * 1e3
        arm = {"replica_attached": st["rep"] is not None,
               "ack_ms_p50": float(np.percentile(arr, 50)),
               "ack_ms_p99": float(np.percentile(arr, 99)),
               "acked_ops_per_s": rounds * len(docs) * k / st["elapsed"]}
        rep = st["rep"]
        if rep is not None:
            rep.poll()
            check(rep.lag == 0, f"read R writer tax: replica lag {rep.lag}")
            arm["replica_lag_end"] = rep.lag
            stale = rep.metrics.histogram("replica.staleness_s")
            arm["staleness_s_p99"] = stale.quantile(0.99) \
                if stale.count else 0.0
            check(rep.read_at(docs[0], rep.head_seq(docs[0]))["entries"]
                  == storm.merge_host.map_entries(
                      docs[0], storm.datastore, storm.channel),
                  "read R writer tax: the replica's head read != the map")
        storm._group_wal.close()
        arms[name] = arm
    return {"docs": REPLICA_TAX_DOCS, "k": k, "rounds": rounds,
            "pipeline_depth": REPLICA_TAX_DEPTH, "blocks": REPLICA_TAX_BLOCKS,
            "arms": arms, "block_p99_ratios": ratios,
            "ack_p99_on_over_off": float(np.median(ratios))}


def read_path_r(device) -> dict:
    """Read R's two reference benches on the card, under the plane
    recording wrappers (Read R's part on Fleet P runs inside Fleet P)."""
    import shutil
    import tempfile
    root = pathlib.Path(tempfile.mkdtemp(prefix="ff-read-r-"))
    kept: dict = {}
    secs: dict = {}
    try:
        launch_counts_reset()
        with plane_recording(kept):
            t0 = time.perf_counter()
            out = {"read_throughput": replica_read_throughput(
                device, root / "reads")}
            secs["read_throughput"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            out["writer_tax"] = replica_writer_tax(device, root / "tax")
            secs["writer_tax"] = time.perf_counter() - t0
        counts = launch_counts()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    check(counts["map_fold"] > 0 and counts["sequencer_tick"] > 0,
          "read R launched no map fold or no deli")
    out.update(seconds=secs, launches={k: counts[k] for k in (
        "map_fold", "sequencer_tick")})
    print("read_r_benches: " + json.dumps(out), flush=True)
    return {"out": out, "counts": counts, "kept": kept}


class DoorThread:
    """An ``AlfredServer`` over ``service`` on its own event-loop thread,
    with blocking raw-frame clients; ``close()`` closes the clients, then
    the server, then the loop."""

    def __init__(self, service):
        import asyncio
        import threading

        from fluidframework_tpu_torch.server.alfred import AlfredServer
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.thread.start()
        self.server = AlfredServer(service, "127.0.0.1", 0)
        self.port = self.run(self.server.start())
        self.clients: list = []

    def run(self, coro, timeout: float = 300.0):
        import asyncio
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(
            timeout)

    def call(self, fn):
        """``fn()`` on the loop's thread, where the service runs."""
        async def wrap():
            return fn()
        return self.run(wrap())

    def client(self) -> "RawClient":
        self.clients.append(RawClient(self.port))
        return self.clients[-1]

    def close(self) -> None:
        for c in self.clients:
            c.close()
        try:
            self.run(self.server.close(), timeout=60.0)
        finally:
            self.loop.call_soon_threadsafe(self.loop.stop)
            self.thread.join(30)
            self.loop.close()


class RawClient:
    """A blocking socket speaking the front door's length-prefixed frames
    (``protocol/codec.py``); every frame read is kept in ``frames``."""

    def __init__(self, port: int):
        import socket
        self.sock = socket.create_connection(("127.0.0.1", port),
                                             timeout=300)
        self.rid = 0
        self.frames: list = []

    def send(self, body: bytes) -> None:
        from fluidframework_tpu_torch.protocol.codec import frame_body
        self.sock.sendall(frame_body(body))

    def read(self) -> bytes:
        from fluidframework_tpu_torch.server.alfred import \
            read_frame_raw_sync
        body = read_frame_raw_sync(self.sock)
        self.frames.append(body)
        return body

    @staticmethod
    def decode(body):
        from fluidframework_tpu_torch.protocol.codec import (
            decode_body, decode_storm_push, is_storm_body)
        return decode_storm_push(body) if is_storm_body(body) \
            else decode_body(body)

    def call(self, op: str, **kw) -> dict:
        """One JSON request; frames pushed before its response stay in
        ``frames``."""
        from fluidframework_tpu_torch.protocol.codec import encode_body
        self.rid += 1
        rid = self.rid
        self.send(encode_body({"rid": rid, "op": op, **kw}))
        while True:
            msg = self.decode(self.read())
            if isinstance(msg, dict) and msg.get("rid") == rid \
                    and not msg.get("storm"):
                return msg

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


def front_words(t: int):
    """Front door F's tick ``t``: u32[DOCS, K_MAP] of config 3's mix."""
    import numpy as np
    rng = np.random.default_rng([17, t])
    r = rng.random((DOCS, K_MAP))
    kinds = np.where(r < 0.1, 2, np.where(r < 0.3, 1, 0)).astype(np.uint32)
    slots = rng.integers(0, KEY_SLOTS, (DOCS, K_MAP)).astype(np.uint32)
    vals = rng.integers(0, 1 << 20, (DOCS, K_MAP)).astype(np.uint32)
    return kinds | (slots << 2) | (vals << 12)


def standalone_door(what: str, module: str, args: list, n_devices: int,
                    hops: list | None = None, scrape: bool = False) -> dict:
    """``python -m <module> --port 0 <args>`` as a user starts it: READY,
    its ``n_devices`` device hosts on the card (the ``DEVICE`` line),
    ``hops`` its bus and fan-out classes (the ``HOPS`` line) where given,
    a writer and a viewer over raw frames, ops submitted and read back,
    with ``scrape`` one ``python -m fluidframework_tpu_torch.tools.monitor
    --once`` scrape of it, then the process stopped."""
    from fluidframework_tpu_torch.protocol.messages import (
        DocumentMessage, MessageType)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", module, "--port", "0", *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=str(ROOT))
    out: dict = {}
    try:
        line = proc.stdout.readline()
        check(line.startswith("READY "),
              f"{what}: the standalone door said {line!r}: "
              f"{proc.stderr.read() if proc.poll() is not None else ''}")
        out["ready_s"] = time.perf_counter() - t0
        port = int(line.split()[1])
        devices = proc.stdout.readline().split()
        check(len(devices) == 1 + n_devices and devices[0] == "DEVICE"
              and all(d.startswith("cuda") for d in devices[1:]),
              f"{what}: the standalone door's hosts are on "
              f"{devices[1:]}, not the card")
        out["devices"] = devices[1:]
        if hops is not None:
            got = proc.stdout.readline().split()
            check(got == ["HOPS", *hops],
                  f"{what}: the standalone door's bus and fan-out are "
                  f"{got[1:]}, not the native libraries")
            out["hops"] = got[1:]
        writer, viewer = RawClient(port), RawClient(port)
        try:
            hello = writer.call("connect", doc_id="standalone")
            hello_v = viewer.call("connect", doc_id="standalone",
                                  mode="viewer")
            check(hello_v.get("viewer") is True and "client_id" in hello,
                  f"{what}: standalone hellos {hello} {hello_v}")
            t1 = time.perf_counter()
            for i in range(FRONT_STANDALONE_OPS):
                resp = writer.call("submit", messages=[DocumentMessage(
                    type=MessageType.OPERATION, contents={"k": i},
                    client_sequence_number=i + 1,
                    reference_sequence_number=0)])
                check(resp.get("ok") is True,
                      f"{what}: standalone submit {resp}")
            got: list = []
            deadline = time.perf_counter() + 60
            while time.perf_counter() < deadline:
                got = [m for m in writer.call(
                    "get_deltas", from_seq=0)["messages"]
                    if m.type == MessageType.OPERATION]
                if len(got) == FRONT_STANDALONE_OPS:
                    break
                time.sleep(0.02)
            out["ops_read_back_s"] = time.perf_counter() - t1
            check([(m.client_sequence_number, m.contents) for m in got]
                  == [(i + 1, {"k": i})
                      for i in range(FRONT_STANDALONE_OPS)],
                  f"{what}: the standalone door read back {len(got)} "
                  f"ops, want {FRONT_STANDALONE_OPS} in order")
            seen: list = []
            while len(seen) < FRONT_STANDALONE_OPS:
                msg = viewer.decode(viewer.read())
                if isinstance(msg, dict) and msg.get("event") == "ops":
                    seen += [m.sequence_number for m in msg["messages"]
                             if m.type == MessageType.OPERATION]
            check(seen == [m.sequence_number for m in got],
                  f"{what}: the standalone viewer saw {seen}")
            if scrape:
                mon = subprocess.run(
                    [sys.executable, "-m",
                     "fluidframework_tpu_torch.tools.monitor", "--port",
                     str(port), "--once"], capture_output=True, text=True,
                    timeout=120, env=env, cwd=str(ROOT))
                check(mon.returncode == 0,
                      f"{what}: the monitor's scrape failed: {mon.stderr}")
                metrics = json.loads(mon.stdout)
                check(metrics.get("alfred.connects", 0) >= 1
                      and metrics.get("deli.sequenced_ops", 0)
                      >= FRONT_STANDALONE_OPS,
                      f"{what}: the monitor scraped {metrics}")
                out["scrape"] = {k: metrics[k] for k in (
                    "alfred.connects", "deli.sequenced_ops")}
        finally:
            writer.close()
            viewer.close()
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    out["exit"] = proc.returncode
    return out


def front_path_f(device, ctx: dict, trace: bool = False) -> dict:
    """Front door F on the durable path's recovered stack (``ctx``), under
    the plane recording wrappers: an AlfredServer on its own loop thread
    with a viewer plane and a replica router, one socket submitting every
    doc's frames for FRONT_TICKS ticks (each doc's acks == the WAL-less
    twin's, served the same frames in process), viewer sockets on
    FRONT_VIEWERS docs (each tick's frame == ``encode_viewer_tick_body``),
    a socket ``get_deltas`` == the in-process call, a directory-routed
    viewer answered ``moved``, a writer joined through the cadence pump;
    then the standalone entry point."""
    import itertools
    import shutil
    import tempfile

    import numpy as np
    import torch

    from fluidframework_tpu_torch.protocol.codec import (
        encode_body, encode_storm_body, encode_viewer_tick_body)
    from fluidframework_tpu_torch.server.broadcaster import ViewerPlane
    from fluidframework_tpu_torch.server.durable_store import \
        GitSnapshotStore
    from fluidframework_tpu_torch.server.read_replica import (
        ReplicaDirectory, ReplicaRouter)
    storm, twin = ctx["storm"], ctx["twin"]
    names, joined = ctx["names"], ctx["joined"]
    service = storm.service
    secs: dict = {}
    out: dict = {}
    traces: dict = {}
    kept: dict = {}
    per = DOCS // FRAMES_PER_TICK
    twin_kept: dict = {}
    twin_acks: dict = {}
    all_words, tick_frames = [], []
    # The twin first, under a recording of its own: the door's counts
    # below hold the door's launches alone.
    launch_counts_reset()
    with plane_recording(twin_kept):
        # The twin takes the joins the recovered stack took.
        clock = itertools.count(1 << 24, 3)
        twin.service._clock = lambda: next(clock)
        for n in joined:
            twin.service.connect(n, lambda m: None)
        twin.service.pump()
        cps, twin_cps = (storm.seq_host.checkpoint_all(),
                         twin.seq_host.checkpoint_all())
        check(cps == twin_cps, "front door F: the twin's sequencer "
              "rows != the recovered stack's")
        cseq = {n: cps[n].clients[0]["client_seq"] + 1 for n in names}
        cid = {n: cps[n].clients[0]["client_id"] for n in names}

        def sink(p):
            if not p.get("error"):
                twin_acks[p["rid"]] = np.asarray(p.rows)
        for t in range(FRONT_TICKS):
            words = front_words(t)
            all_words.append(words)
            frames = []
            for f in range(FRAMES_PER_TICK):
                lo = f * per
                hdr = {"rid": t * FRAMES_PER_TICK + f, "docs": [
                    [n, cid[n], cseq[n], cps[n].sequence_number,
                     K_MAP] for n in names[lo:lo + per]]}
                frames.append((hdr, words[lo:lo + per].tobytes()))
            for n in names:
                cseq[n] += K_MAP
            tick_frames.append(frames)
            t0 = time.perf_counter()
            for hdr, payload in frames:
                twin.submit_frame(sink, hdr, memoryview(payload))
            twin.flush()
            torch.cuda.synchronize()
            secs.setdefault("twin_ticks", []).append(
                time.perf_counter() - t0)
    twin_counts = launch_counts()
    root = pathlib.Path(tempfile.mkdtemp(prefix="ff-front-f-"))
    launch_counts_reset()
    try:
        with plane_recording(kept):
            directory = ReplicaDirectory(GitSnapshotStore(root / "git"))
            directory.register(FRONT_LABEL)
            routed = names[-1]
            directory.assign_room(routed, [FRONT_LABEL])
            service.read_router = ReplicaRouter(directory,
                                                local_label="leader")
            plane = ViewerPlane(service, metrics=service.metrics,
                                join_rate_per_s=1e9)
            t0 = time.perf_counter()
            door = DoorThread(service)
            try:
                watched = names[::DOCS // FRONT_VIEWERS][:FRONT_VIEWERS]
                viewers = {n: door.client() for n in watched}
                for n, v in viewers.items():
                    hello = v.call("connect", doc_id=n, mode="viewer")
                    check(hello.get("viewer") is True,
                          f"front door F: viewer hello {hello}")
                moved = door.client().call("connect", doc_id=routed,
                                           mode="viewer")
                check(moved.get("error") == "moved"
                      and moved.get("moved_to") == FRONT_LABEL,
                      f"front door F: the routed viewer got {moved}")
                secs["connects"] = time.perf_counter() - t0
                # The viewer plane's fan-out on this stack is the native
                # library, not its Python twin.
                out["fanout"] = type(plane.fanout).__name__
                check(plane.fanout.is_native, "front door F: the viewer "
                      f"plane fans out through {out['fanout']}")
                writer = door.client()
                socket_acks: dict = {}
                for t, frames in enumerate(tick_frames):
                    with traced(trace and t == FRONT_TICKS - 1, traces,
                                "front_f"):
                        t0 = time.perf_counter()
                        for hdr, payload in frames:
                            writer.send(encode_storm_body(hdr, payload))
                        flushed = writer.call("storm_flush")
                        secs.setdefault("socket_ticks", []).append(
                            time.perf_counter() - t0)
                    check(flushed.get("ok") is True,
                          f"front door F: storm_flush answered {flushed}")
                for body in writer.frames:
                    msg = writer.decode(body)
                    if isinstance(msg, dict) and msg.get("storm"):
                        socket_acks[msg["rid"]] = np.asarray(msg["acks"])
                n_frames = FRONT_TICKS * FRAMES_PER_TICK
                check(len(socket_acks) == n_frames
                      and len(twin_acks) == n_frames
                      and all(np.array_equal(socket_acks[r], twin_acks[r])
                              for r in twin_acks),
                      f"front door F: {len(socket_acks)} socket acks, "
                      f"{len(twin_acks)} in-process; the acks differ")
                t0 = time.perf_counter()
                for i, (n, v) in enumerate(viewers.items()):
                    d = names.index(n)
                    got = storm_frames(v.frames)
                    while len(got) < FRONT_TICKS:
                        body = v.read()
                        got += storm_frames([body])
                    want = []
                    for t in range(FRONT_TICKS):
                        rid = t * FRAMES_PER_TICK + d // per
                        quad = [int(x) for x in socket_acks[rid][d % per]]
                        want.append(bytes(encode_viewer_tick_body(
                            n, *quad, K_MAP, all_words[t][d].tobytes())))
                    check(got == want, f"front door F: {n}'s viewer frames "
                          "!= encode_viewer_tick_body of its ticks")
                secs["viewer_checks"] = time.perf_counter() - t0
                probe = watched[1]
                t0 = time.perf_counter()
                deltas = writer.call("get_deltas", doc_id=probe, from_seq=0)
                secs["socket_get_deltas"] = time.perf_counter() - t0
                local = door.call(lambda: service.get_deltas(probe, 0))
                check(encode_body(deltas["messages"]) == encode_body(local)
                      and len(local) > FRONT_TICKS * K_MAP,
                      "front door F: the socket get_deltas != the "
                      "in-process call")
                # A writer joins over the socket; the cadence pump (the
                # standalone door's tick loop) sequences it on the deli.
                hello = writer.call("connect", doc_id=watched[0])
                before = door.call(
                    lambda: storm.seq_host.checkpoint(watched[0]).clients)
                door.call(service.pump)
                after = door.call(
                    lambda: storm.seq_host.checkpoint(watched[0]).clients)
                check(len(after) == len(before) + 1 and any(
                    c["client_id"] == hello["client_id"] for c in after),
                    f"front door F: the socket writer {hello} did not join")
                out["viewer_stats"] = dict(service.viewers.stats)
            finally:
                door.close()
            torch.cuda.synchronize()
        counts = launch_counts()
        t0 = time.perf_counter()
        out["standalone"] = standalone_door(
            "front door F", "fluidframework_tpu_torch.server.alfred",
            ["--cadence-ms", "10", "--native-fanout", "--native-bus"], 2,
            hops=["NativeMessageBus", "NativeFanout"])
        secs["standalone"] = time.perf_counter() - t0
    finally:
        service.read_router = None
        shutil.rmtree(root, ignore_errors=True)
    check(counts["map_fold"] > 0 and counts["sequencer_tick"] > 0,
          "front door F launched no map fold or no deli")
    out.update(docs=DOCS, k=K_MAP, ticks=FRONT_TICKS,
               viewers=FRONT_VIEWERS, seconds=secs,
               socket_ops_per_s=FRONT_TICKS * DOCS * K_MAP
               / sum(secs["socket_ticks"]),
               trace=traces.get("front_f"),
               launches={k: counts[k] for k in ("map_fold",
                                                "sequencer_tick")})
    print("front_f: " + json.dumps(out), flush=True)
    return {"out": out, "counts": counts, "kept": kept,
            "twin_counts": twin_counts, "twin_kept": twin_kept}


# -- the network tier (the C++ bridge door, the TCP replication wire) ---------

#: Front door B: bench_e2e_storm (``bench.py:1228``) at its published
#: width — E2E_DOCS docs of one writer each, K E2E_K over E2E_SLOTS key
#: slots, E2E_CONNS client processes of E2E_DOCS / E2E_CONNS docs, group
#: durability — one untimed warm tick, then E2E_TICKS timed ticks (10 in
#: the reference: a depth cut). Arm 0 serves through a BridgeFrontDoor
#: over the reference's StormController; arm 1 through the same door over
#: ``launch_cluster``'s leader, with E2E_FOLLOWERS follower processes
#: over localhost TCP (the reference's lease defaults).
E2E_DOCS = 10_240
E2E_K = 512
E2E_SLOTS = 32
E2E_CONNS = 8
E2E_TICKS = 4
E2E_FOLLOWERS = 2
#: Net N: the netsplit soak (``tests/test_chaos.py``: F = 2, seed 0, docs
#: 2, K 8, 12 ticks, checkpoints every 4, the kill at round 9), then the
#: reference net benches (``bench.py:4237``, ``:4361``, ``:4446``) at
#: their defaults but for depth: bench_net_ack_overhead's rounds 150 ->
#: NET_ACK_ROUNDS, bench_net_failover_blackout's 30 -> NET_FAILOVER_ROUNDS.
#: The netsplit soak (its CPU twin, then the card's lives) runs in child
#: processes beside residency A's joins (``net_split_start``).
NET_SPLIT = dict(followers=2, seed=0, docs=2, k=8, ticks=12, cp_every=4,
                 kill_at=9)
NET_DOCS = 4
NET_K = 64
NET_ACK_ROUNDS = 40
NET_ACK_WARM = 20
NET_ACK_DEPTH = 2
NET_FAILOVER_ROUNDS = 15
NET_PARKED_DOCS = 2
NET_PARKED_WRITES = 6

#: The client process of bench_e2e_storm (``bench.py:1120``, numpy and
#: sockets only): it builds its frames (and writes their words to
#: ``cfg["dump"]`` for the parent's fold), prints READY, waits for GO,
#: sends them, reads one storm ack a frame, and prints its ack times.
E2E_CLIENT_SRC = r"""
import json, socket, struct, sys, time
import numpy as np

cfg = json.loads(sys.stdin.readline())
sock = socket.create_connection(("127.0.0.1", cfg["port"]))
rng = np.random.default_rng(cfg["seed"])
docs = cfg["docs"]
k = cfg["k"]
cseqs = {d: c0 for (d, _cl), c0 in zip(docs, cfg["cseq0"])}
words = np.zeros((cfg["ticks"], len(docs), k), np.uint32)

def frame(rid):
    hdr_docs = []
    for i, (doc_id, client_id) in enumerate(docs):
        kinds = rng.choice([0, 0, 0, 1, 2], size=k).astype(np.uint32)
        slots = rng.integers(0, cfg["num_slots"], k).astype(np.uint32)
        vals = rng.integers(0, 1 << 20, k).astype(np.uint32)
        words[rid, i] = kinds | (slots << 2) | (vals << 12)
        hdr_docs.append([doc_id, client_id, cseqs[doc_id], 1, k])
        cseqs[doc_id] += k
    head = json.dumps({"op": "storm", "rid": rid, "docs": hdr_docs},
                      separators=(",", ":")).encode()
    body = (bytes((0, 1)) + struct.pack("<I", len(head)) + head
            + words[rid].tobytes())
    return struct.pack(">I", len(body)) + body

def recv_exact(n):
    raw = b""
    while len(raw) < n:
        chunk = sock.recv(n - len(raw))
        if not chunk:
            raise SystemExit("server closed the connection")
        raw += chunk
    return raw

def read_ack():
    length = struct.unpack(">I", recv_exact(4))[0]
    body = recv_exact(length)
    if body[:1] == b"\x00":
        hlen = struct.unpack_from("<I", body, 2)[0]
        hdr = json.loads(body[6:6 + hlen].decode())
        if hdr.get("op") == "storm_ack":
            hdr["storm"] = True
        return hdr
    return json.loads(body.decode())

frames = [frame(t) for t in range(cfg["ticks"])]
np.save(cfg["dump"], words)
print("READY", flush=True)
assert sys.stdin.readline().strip() == "GO"
t0 = time.perf_counter()
ack_times, acked, nacked = [], 0, 0
to_send = list(range(cfg["ticks"]))
while acked < cfg["ticks"]:
    if to_send:
        sock.sendall(frames[to_send.pop(0)])
        continue
    ack = read_ack()
    if not ack.get("storm"):
        continue
    if ack.get("error"):
        nacked += 1
        time.sleep(float(ack.get("retry_after_s", 0.01)))
        to_send.append(int(ack["rid"]))
        continue
    acked += 1
    ack_times.append(time.perf_counter() - t0)
print(json.dumps({"elapsed": time.perf_counter() - t0,
                  "ack_times": ack_times, "nacked": nacked}), flush=True)
"""


def pct(values, q: float) -> float:
    import numpy as np
    return float(np.percentile(np.asarray(values, float), q)) \
        if len(values) else 0.0


def e2e_stack(device, root: pathlib.Path, arm: int):
    """Arm 0: ``bench.py:1252-1281``'s stack on the card (a group-commit
    WAL under ``root``). Arm 1: ``launch_cluster``'s replicated leader on
    the card with E2E_FOLLOWERS follower processes. Returns (storm,
    cluster or None)."""
    if arm == 1:
        from fluidframework_tpu_torch.tools.launch_cluster import \
            launch_cluster
        cluster = launch_cluster(
            str(root), followers=E2E_FOLLOWERS, num_docs=E2E_DOCS,
            device=device, flush_threshold_docs=E2E_DOCS, pipeline_depth=1)
        return cluster.storm, cluster
    from fluidframework_tpu_torch.native.fanout import make_fanout
    from fluidframework_tpu_torch.server.kernel_host import \
        KernelSequencerHost
    from fluidframework_tpu_torch.server.merge_host import KernelMergeHost
    from fluidframework_tpu_torch.server.routerlicious import \
        RouterliciousService
    from fluidframework_tpu_torch.server.storm import StormController
    seq_host = KernelSequencerHost(num_slots=2, initial_capacity=E2E_DOCS,
                                   device=device)
    merge_host = KernelMergeHost(map_slots=E2E_SLOTS, row_capacity=E2E_DOCS,
                                 flush_threshold=10**9, device=device)
    service = RouterliciousService(merge_host=merge_host,
                                   batched_deli_host=seq_host,
                                   auto_pump=False, fanout=make_fanout())
    storm = StormController(service, seq_host, merge_host,
                            flush_threshold_docs=E2E_DOCS,
                            spill_dir=str(root / "spill"), pipeline_depth=1,
                            durability="group")
    return storm, None


def e2e_arm(device, root: pathlib.Path, arm: int, trace: bool) -> dict:
    """One arm of Front door B under the plane recording wrappers: joins
    in process (untimed), a warm tick, then E2E_CONNS client processes
    send E2E_TICKS frames each through a BridgeFrontDoor (the pump thread
    launches every kernel; this thread only waits on the clients until
    the door closes). Every frame acked over the wire, every doc's map
    == the numpy fold of its frames, and (arm 1) each follower's WAL a
    byte prefix of the leader's tick log."""
    import numpy as np
    import torch

    from fluidframework_tpu_torch.server.bridge_host import BridgeFrontDoor
    from fluidframework_tpu_torch.server.replication import \
        REPLICA_WAL_RELPATH
    what = f"front door B arm {arm}"
    docs = [f"storm-doc-{i}" for i in range(E2E_DOCS)]
    per = E2E_DOCS // E2E_CONNS
    kept: dict = {}
    secs: dict = {}
    out: dict = {}
    traces: dict = {}
    root.mkdir(parents=True, exist_ok=True)
    launch_counts_reset()
    with plane_recording(kept):
        t0 = time.perf_counter()
        storm, cluster = e2e_stack(device, root, arm)
        service = storm.service
        secs["build"] = time.perf_counter() - t0
        try:
            t0 = time.perf_counter()
            clients = {d: service.connect(d, lambda m: None).client_id
                       for d in docs}
            service.pump()
            secs["joins"] = time.perf_counter() - t0
            warm = (np.random.default_rng(123).integers(
                0, 1 << 20, (E2E_DOCS, E2E_K)).astype(np.uint32) << 12)
            t0 = time.perf_counter()
            storm.submit_frame(None, {"op": "storm", "docs": [
                [d, clients[d], 1, 1, E2E_K] for d in docs]},
                memoryview(warm.tobytes()))
            storm.flush()
            torch.cuda.synchronize()
            secs["warm_tick"] = time.perf_counter() - t0
            check(storm.stats["sequenced_ops"] == E2E_DOCS * E2E_K,
                  f"{what}: the warm tick sequenced "
                  f"{storm.stats['sequenced_ops']} ops")
            storm.tick_seconds.clear()
            storm.harvest_intervals.clear()
            storm.ledger.clear()
            storm._last_harvest = None
            before = storm.stats["sequenced_ops"]
            wal_paths = ([pathlib.Path(c.data_dir) / REPLICA_WAL_RELPATH
                          for c in cluster.children] if cluster else [])
            wal0 = [p.stat().st_size for p in wal_paths]
            t0 = time.perf_counter()
            front = BridgeFrontDoor(service, 0)
            procs = []
            try:
                for c in range(E2E_CONNS):
                    proc = subprocess.Popen(
                        [sys.executable, "-c", E2E_CLIENT_SRC],
                        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                        text=True)
                    procs.append(proc)
                    mine = docs[c * per:(c + 1) * per]
                    proc.stdin.write(json.dumps({
                        "port": front.port, "k": E2E_K, "ticks": E2E_TICKS,
                        "seed": c, "num_slots": E2E_SLOTS,
                        "docs": [[d, clients[d]] for d in mine],
                        "cseq0": [E2E_K + 1] * len(mine),
                        "dump": str(root / f"client{c}.npy")}) + "\n")
                    proc.stdin.flush()
                for proc in procs:
                    line = proc.stdout.readline().strip()
                    check(line == "READY", f"{what}: a client said {line!r}")
                secs["clients_ready"] = time.perf_counter() - t0
                with traced(trace, traces, f"front_b_arm{arm}"):
                    start = time.perf_counter()
                    for proc in procs:
                        proc.stdin.write("GO\n")
                        proc.stdin.flush()
                    results = [json.loads(proc.stdout.readline())
                               for proc in procs]
                    elapsed = time.perf_counter() - start
                for proc in procs:
                    proc.wait(timeout=60)
            finally:
                for proc in procs:
                    if proc.poll() is None:
                        proc.kill()
                        proc.wait()
                front.close()
            secs["timed"] = elapsed
            torch.cuda.synchronize()
            sequenced = storm.stats["sequenced_ops"] - before
            check(all(len(r["ack_times"]) == E2E_TICKS for r in results)
                  and sequenced == E2E_DOCS * E2E_K * E2E_TICKS,
                  f"{what}: {[len(r['ack_times']) for r in results]} "
                  f"frames acked a client, {sequenced} ops sequenced")
            gaps = [b - a for r in results
                    for a, b in zip([0.0] + r["ack_times"], r["ack_times"])]
            out.update(
                e2e_ops_per_sec=sequenced / elapsed,
                ack_interval_ms_p50=1e3 * pct(gaps, 50),
                ack_interval_ms_p99=1e3 * pct(gaps, 99),
                tick_ms_p50=1e3 * pct(storm.tick_seconds, 50),
                tick_ms_p99=1e3 * pct(storm.tick_seconds, 99),
                tick_cadence_ms_p50=1e3 * pct(storm.harvest_intervals, 50),
                tick_cadence_ms_p99=1e3 * pct(storm.harvest_intervals, 99),
                nacked=sum(r["nacked"] for r in results),
                stage_attribution=storm.ledger.attribution())
            t0 = time.perf_counter()
            sent = [np.load(root / f"client{c}.npy")
                    for c in range(E2E_CONNS)]
            blocks = [warm] + [np.concatenate([w[t] for w in sent])
                               for t in range(E2E_TICKS)]
            present, value = fold_blocks(blocks, E2E_DOCS, E2E_SLOTS)
            got = map_planes_by_doc(storm.merge_host, docs, device)
            p_dev = got[0].cpu().numpy()
            v_dev = got[1].cpu().numpy()
            check(not p_dev[:, E2E_SLOTS:].any()
                  and np.array_equal(p_dev[:, :E2E_SLOTS], present)
                  and np.array_equal(
                      np.where(present, v_dev[:, :E2E_SLOTS], 0),
                      np.where(present, value, 0)),
                  f"{what}: the maps != the numpy fold of the acked frames")
            secs["fold_check"] = time.perf_counter() - t0
            if cluster is not None:
                plane = cluster.plane
                storm._group_wal.sync()
                check(plane.replicated_len == storm._group_wal.durable_len,
                      f"{what}: replicated {plane.replicated_len} != "
                      f"durable {storm._group_wal.durable_len}")
                rtts = [r for lk in plane.links
                        for r in lk.transport_stats()["rtt_s"]]
                out.update(
                    shipped_bytes_per_tick=(sum(
                        p.stat().st_size for p in wal_paths) - sum(wal0))
                    / E2E_TICKS,
                    ship_rtt_ms_p50=1e3 * pct(rtts, 50),
                    ship_rtt_ms_p99=1e3 * pct(rtts, 99),
                    ship_failures=plane.stats["ship_failures"])
                leader_log = (pathlib.Path(cluster.workdir) / cluster.label
                              / "spill" / "storm_tick_words.log").read_bytes()
                for path in wal_paths:
                    wal = path.read_bytes()
                    check(len(wal) > 0 and leader_log.startswith(wal),
                          f"{what}: {path.parent} is not a byte prefix of "
                          "the leader's tick log")
                out["follower_wal_bytes"] = [p.stat().st_size
                                             for p in wal_paths]
        finally:
            if storm._group_wal is not None:
                storm._group_wal.close()
            if cluster is not None:
                cluster.close()
    counts = launch_counts()
    check(counts["map_fold"] > 0 and counts["sequencer_tick"] > 0,
          f"{what} launched no map fold or no deli")
    out.update(seconds=secs, trace=traces.get(f"front_b_arm{arm}"),
               launches={k: counts[k] for k in ("map_fold",
                                                "sequencer_tick")})
    return {"out": out, "counts": counts, "kept": kept}


def front_path_b(device, trace: bool = False) -> dict:
    """Front door B: bench_e2e_storm's two arms (see E2E_*), then
    ``python -m fluidframework_tpu_torch.server.bridge_host --device
    cuda`` as a user starts it, serving a writer and a viewer and
    scraped once by the monitor."""
    import shutil
    import tempfile
    root = pathlib.Path(tempfile.mkdtemp(prefix="ff-front-b-"))
    arms = {}
    try:
        for arm in (0, 1):
            arms[arm] = e2e_arm(device, root / f"arm{arm}", arm,
                                trace and arm == 1)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    standalone = standalone_door(
        "front door B", "fluidframework_tpu_torch.server.bridge_host",
        ["--device", "cuda"], 1, scrape=True)
    standalone["seconds"] = time.perf_counter() - t0
    out = {"docs": E2E_DOCS, "k": E2E_K, "slots": E2E_SLOTS,
           "conns": E2E_CONNS, "ticks": E2E_TICKS,
           "followers": E2E_FOLLOWERS,
           "arms": {a: r["out"] for a, r in arms.items()},
           "standalone": standalone}
    print("front_b: " + json.dumps(out), flush=True)
    return {"out": out, "arms": arms}


def net_serve(storm, docs, clients, cseq, rounds, sink, r0=0) -> None:
    """``rounds`` rounds of one NET_K frame a doc, a flush a round."""
    for r in range(r0, r0 + rounds):
        for i, d in enumerate(docs):
            words = hist_words(r, i, NET_K)
            storm.submit_frame(sink(), {"rid": (r, d), "docs": [
                [d, clients[d], cseq[d], 1, NET_K]]},
                memoryview(words.tobytes()))
            cseq[d] += NET_K
        storm.flush()


def net_join(storm, docs) -> tuple[dict, dict]:
    clients = {d: storm.service.connect(d, lambda m: None).client_id
               for d in docs}
    storm.service.pump()
    return clients, {d: 1 for d in docs}


def net_ack_overhead(device, root: pathlib.Path, trace: bool,
                     traces: dict) -> dict:
    """bench_net_ack_overhead (``bench.py:4237``) on the card: ack latency
    with one follower in process, and with one and two follower
    processes over localhost TCP."""
    import numpy as np

    from fluidframework_tpu_torch.server.durable_store import \
        GitSnapshotStore
    from fluidframework_tpu_torch.server.replication import \
        make_replicated_host
    from fluidframework_tpu_torch.tools.launch_cluster import (
        launch_follower, reap_all)
    docs = [f"doc-{i}" for i in range(NET_DOCS)]

    def run_arm(name: str, followers: int, net: bool) -> dict:
        arm_root = root / name
        children, links = [], []
        secs: dict = {}
        t0 = time.perf_counter()
        try:
            git = GitSnapshotStore(str(arm_root / "git"))
            if net:
                children = [launch_follower(str(arm_root / f"f{i}"),
                                            label=f"f{i}")
                            for i in range(followers)]
                links = [c.link() for c in children]
            else:
                links = [str(arm_root / f"f{i}") for i in range(followers)]
            storm, plane = make_replicated_host(
                "hostA", str(arm_root / "hostA"), git, links,
                num_docs=NET_DOCS, pipeline_depth=NET_ACK_DEPTH,
                device=device)
            clients, cseq = net_join(storm, docs)
            t_built = time.perf_counter()
            secs["build"] = t_built - t0
            lat: list = []

            def sink():
                t0 = time.perf_counter()
                return lambda p: lat.append(time.perf_counter() - t0)
            net_serve(storm, docs, clients, cseq, NET_ACK_WARM, sink)
            lat.clear()
            with traced(trace and name == "net_f1", traces, "net_f1"):
                start = time.perf_counter()
                net_serve(storm, docs, clients, cseq, NET_ACK_ROUNDS, sink,
                          NET_ACK_WARM)
                elapsed = time.perf_counter() - start
            check(len(lat) == NET_ACK_ROUNDS * NET_DOCS,
                  f"net N {name}: {len(lat)} acks of "
                  f"{NET_ACK_ROUNDS * NET_DOCS}")
            check(plane.replicated_len == storm._group_wal.durable_len,
                  f"net N {name}: replicated != durable length")
            arr = np.asarray(lat) * 1e3
            out = {"followers": followers, "net": net,
                   "ack_ms_p50": float(np.percentile(arr, 50)),
                   "ack_ms_p99": float(np.percentile(arr, 99)),
                   "acked_ops_per_s": NET_ACK_ROUNDS * NET_DOCS * NET_K
                   / elapsed,
                   "ship_failures": plane.stats["ship_failures"]}
            rtts = [r for lk in plane.links
                    for r in getattr(lk, "transport_stats",
                                     lambda: {"rtt_s": []})()["rtt_s"]]
            if rtts:
                out["ship_rtt_ms_p50"] = 1e3 * pct(rtts, 50)
                out["ship_rtt_ms_p99"] = 1e3 * pct(rtts, 99)
            t0 = time.perf_counter()
            storm._group_wal.close()
            secs["serve"] = t0 - t_built
            out["seconds"] = secs
            return out
        finally:
            for lk in links:
                close = getattr(lk, "close", None)
                if close is not None:
                    close()
            for child in children:
                child.shutdown()
            reap_all()
            secs["close"] = time.perf_counter() - t0

    arms = {"inproc_f1": run_arm("inproc_f1", 1, False),
            "net_f1": run_arm("net_f1", 1, True),
            "net_f2": run_arm("net_f2", 2, True)}
    return {"rounds": NET_ACK_ROUNDS, "warm": NET_ACK_WARM, "arms": arms,
            "ack_p99_net_f1_over_inproc_f1": arms["net_f1"]["ack_ms_p99"]
            / max(arms["inproc_f1"]["ack_ms_p99"], 1e-9)}


def net_failover_blackout(device, root: pathlib.Path) -> dict:
    """bench_net_failover_blackout (``bench.py:4361``) on the card: the
    leader abandoned twice, each time a follower process promoted over
    the wire; blackout ms per life."""
    from fluidframework_tpu_torch.tools.launch_cluster import (
        launch_cluster, promote_over_wire, reap_all)
    docs = [f"doc-{i}" for i in range(NET_DOCS)]
    secs: dict = {}
    t0 = time.perf_counter()
    cluster = launch_cluster(str(root), followers=2, detector=False,
                             num_docs=NET_DOCS, device=device)
    secs["launch"] = time.perf_counter() - t0
    try:
        storm, children = cluster.storm, list(cluster.children)
        t0 = time.perf_counter()
        clients, cseq = net_join(storm, docs)
        net_serve(storm, docs, clients, cseq, NET_FAILOVER_ROUNDS,
                  lambda: (lambda p: None))
        storm.checkpoint()
        secs["serve"] = time.perf_counter() - t0
        lives = []
        life = 0
        while children:
            for lk in cluster.plane.links:
                close = getattr(lk, "close", None)
                if close is not None:
                    close()
            storm._group_wal.close()
            life += 1
            storm, plane, rep = promote_over_wire(
                children, cluster.store, num_docs=NET_DOCS, device=device,
                follower_dirs=[str(root / f"fresh{life}")])
            cluster.storm, cluster.plane = storm, plane
            children = [c for c in children if c.alive]
            lives.append({"promoted": rep["promoted_node"],
                          "blackout_ms": rep["blackout_ms"],
                          "surviving_followers": len(children)})
            t0 = time.perf_counter()
            clients, cseq = net_join(storm, docs)
            acked: list = []
            net_serve(storm, docs, clients, cseq, 4,
                      lambda: acked.append)
            lives[-1]["serve_s"] = time.perf_counter() - t0
            check(len(acked) == 4 * NET_DOCS
                  and not any(a.get("error") for a in acked),
                  f"net N failover: life {life} acked {len(acked)} frames")
        storm._group_wal.close()
    finally:
        reap_all()
    return {"lives": lives, "seconds": secs,
            "blackout_ms_per_life": [lf["blackout_ms"] for lf in lives]}


def net_parked_write_recovery(device, root: pathlib.Path) -> dict:
    """bench_parked_write_recovery (``bench.py:4446``) on the card: the
    only follower partitioned, writes park (no ack, no shed), the heal
    drains them; heal -> last parked ack."""
    from fluidframework_tpu_torch.tools.launch_cluster import launch_cluster
    docs = [f"doc-{i}" for i in range(NET_PARKED_DOCS)]
    cluster = launch_cluster(
        str(root), followers=1, detector=True, hb_interval_s=0.05,
        lease_s=0.25, park_max_s=3600.0, fault_plan={"f0": {}},
        num_docs=NET_PARKED_DOCS, device=device)
    try:
        storm, plane = cluster.storm, cluster.plane
        ft = plane.links[0]
        clients, cseq = net_join(storm, docs)
        acked: list = []

        def sink():
            return lambda p: acked.append(time.perf_counter())
        net_serve(storm, docs, clients, cseq, 1, sink)
        check(len(acked) == NET_PARKED_DOCS, "net N parked: warm-up acks")
        acked.clear()
        ft.install("partition")
        deadline = time.monotonic() + 10.0
        while plane.quorum_ok:
            check(time.monotonic() < deadline, "net N parked: never "
                  "degraded")
            time.sleep(0.02)
        net_serve(storm, docs, clients, cseq, NET_PARKED_WRITES, sink, 1)
        check(not acked and storm.stats.get("quorum_rejects", 0) == 0,
              "net N parked: a write acked or shed without a quorum")
        t_heal = time.perf_counter()
        ft.heal()
        deadline = time.monotonic() + 10.0
        while len(acked) < NET_PARKED_WRITES * NET_PARKED_DOCS:
            check(time.monotonic() < deadline,
                  f"net N parked: {len(acked)} parked writes drained")
            storm.flush()
            time.sleep(0.01)
        recovery_ms = 1e3 * (max(acked) - t_heal)
        storm._group_wal.close()
    finally:
        cluster.close()
    return {"parked_writes": NET_PARKED_WRITES * NET_PARKED_DOCS,
            "heal_to_last_parked_ack_ms": recovery_ms}


def net_split_start(device) -> dict:
    """Start Net N's netsplit soak in a thread of its own (all its work is
    in child processes): the fault-free twin on the CPU first, then
    ``run_netsplit`` on ``device`` held to that twin's digest (the
    scenario-wide kernel == plain check: the parent cannot record its
    children's launches). Its leader lives run on the card: a ``kill -9``
    of a process holding a CUDA context, then a promotion over the wire
    on the card. ``net_split_finish`` joins it."""
    import tempfile
    import threading

    from fluidframework_tpu_torch.tools import chaos
    root = pathlib.Path(tempfile.mkdtemp(prefix="ff-net-split-"))
    runs: dict = {"root": root}

    def split():
        t0 = time.perf_counter()
        try:
            twin = root / "cpu_twin"
            life = chaos._spawn_net_life(
                str(twin), [], [str(twin / f"f{i}")
                                for i in range(NET_SPLIT["followers"])],
                [], None, NET_SPLIT["seed"], NET_SPLIT["docs"],
                NET_SPLIT["k"], NET_SPLIT["ticks"], NET_SPLIT["cp_every"],
                600.0, chaos.NETSPLIT_LEASE_S, device="cpu")
            runs["cpu_s"] = time.perf_counter() - t0
            if life["returncode"] != 0 or life["digest"] is None:
                raise RuntimeError(
                    f"the CPU twin failed: {life['stderr'][-2000:]}")
            t1 = time.perf_counter()
            runs["split"] = chaos.run_netsplit(
                str(root / "split"), device=device.type, timeout=600.0,
                twin_digest=life["digest"], **NET_SPLIT)
            runs["split_s"] = time.perf_counter() - t1
        except Exception as err:  # reported by net_split_finish
            runs["split_error"] = f"{type(err).__name__}: {str(err)[:2000]}"
    runs["thread"] = threading.Thread(target=split, daemon=True)
    runs["thread"].start()
    return runs


def net_split_finish(runs: dict) -> dict:
    """Join the netsplit soak: the leader was killed and promoted over the
    wire, every round acked, round 4 parked, the fence proven, and the
    killed run's digest == the CPU twin's (``run_netsplit`` raises
    otherwise)."""
    runs["thread"].join()
    check("split_error" not in runs,
          f"net N: the netsplit soak failed: {runs.get('split_error')}")
    rep = runs["split"]
    check(rep["killed"] and rep["lives"] >= 2
          and len(rep["failover_blackouts_ms"]) == rep["lives"] - 1,
          f"net N: the leader was not killed and promoted: {rep}")
    check(rep["acked_rounds"] == list(range(NET_SPLIT["ticks"])),
          f"net N: rounds acked {rep['acked_rounds']}")
    check(4 in rep["parked_rounds"],
          f"net N: round 4 did not park ({rep['parked_rounds']})")
    check(rep["zombie_fenced"] >= 2,
          f"net N: the fence was proven {rep['zombie_fenced']} times")
    return {**{k: rep[k] for k in (
        "lives", "killed", "acked_rounds", "parked_rounds",
        "failover_blackouts_ms", "zombie_fenced")},
        "seconds": {"netsplit": runs["split_s"], "cpu_twin": runs["cpu_s"]}}


def net_path_n(device, split: dict, trace: bool = False) -> dict:
    """Net N: the netsplit soak's report (``split``, run beside residency
    A's joins, see ``net_split_start``), then the three reference net
    benches under the plane recording wrappers."""
    import shutil
    import tempfile

    from fluidframework_tpu_torch.tools.launch_cluster import reap_all
    root = pathlib.Path(tempfile.mkdtemp(prefix="ff-net-n-"))
    out: dict = {"netsplit": split}
    secs: dict = {}
    traces: dict = {}
    kept: dict = {}
    try:
        launch_counts_reset()
        with plane_recording(kept):
            t0 = time.perf_counter()
            out["ack_overhead"] = net_ack_overhead(device, root / "ack",
                                                   trace, traces)
            secs["ack_overhead"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            out["failover"] = net_failover_blackout(device,
                                                    root / "failover")
            secs["failover"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            out["parked"] = net_parked_write_recovery(device,
                                                      root / "parked")
            secs["parked"] = time.perf_counter() - t0
        counts = launch_counts()
    finally:
        reap_all()
        shutil.rmtree(root, ignore_errors=True)
    check(counts["map_fold"] > 0 and counts["sequencer_tick"] > 0,
          "net N launched no map fold or no deli")
    out.update(seconds=secs, trace=traces.get("net_f1"),
               launches={k: counts[k] for k in ("map_fold",
                                                "sequencer_tick")})
    print("net_n: " + json.dumps(out), flush=True)
    return {"out": out, "counts": counts, "kept": kept}


# -- the client tier: the port's own Containers on the card ---------------------

#: Client C1: BASELINE config 1 (clicker on tinylicious, 2 clients): rounds
#: of increments and sets, the cadence of the service's tick loop, and the
#: rounds after the summary that a late third client loads past.
CLIENT_C1_ROUNDS = 8
CLIENT_C1_AFTER = 4
CLIENT_CADENCE_S = 0.01
#: Client C3: BASELINE config 2 through Containers (1 doc, 128 clients, a
#: SharedString); C4: config 4 (a 1k x 1k SharedMatrix, 256 clients).
CLIENT_C3_CLIENTS = 128
CLIENT_C3_ROUNDS = 4
CLIENT_C4_CLIENTS = 256
CLIENT_C4_GRID = 1024
CLIENT_C4_ROUNDS = 2
#: C4's clients that insert or remove a row or column each round (kernel
#: 5 runs on a flush with a structural op in flight).
CLIENT_C4_MOVERS = 4
CLIENT_PROFILE = "full"


@contextlib.contextmanager
def client_recording(kept: dict):
    """``plane_recording`` plus kernel 5 (the matrix op tick): every call's
    arguments kept in ``kept[kernel][shape]``."""
    from fluidframework_tpu_torch.ops import matrix_cuda as mxc
    with plane_recording(kept):
        kept["matrix_tick"] = {}
        with recording(mxc, "apply_tick_best", kept["matrix_tick"],
                       counts=mxc.tick):
            yield


def client_arm(name: str, drive, device) -> dict:
    """One arm of the client phase with kernels 1-5 counted from 0 just
    before it and read just after, every call's inputs kept."""
    import torch
    kept: dict = {}
    launch_counts_reset()
    t0 = time.perf_counter()
    with client_recording(kept):
        out = drive(device)
    torch.cuda.synchronize()
    out["seconds"] = time.perf_counter() - t0
    counts = launch_counts()
    deli_picks(device, counts["shapes"]["sequencer_tick"],
               counts["variants"]["sequencer_tick"], f"client {name}")
    out["launches"] = {k: counts[k] for k in (
        "map_fold", "sequencer_tick", "mergetree_blocks", "mergetree_flat",
        "matrix_tick")}
    print(f"client_{name}: " + json.dumps(out), flush=True)
    return {"out": out, "counts": counts, "kept": kept}


def chan(container, channel: str):
    return container.runtime.get_datastore("default").get_channel(channel)


def wait_for(cond, what: str, timeout: float = 120.0) -> None:
    deadline = time.perf_counter() + timeout
    while not cond():
        check(time.perf_counter() < deadline, f"timed out: {what}")
        time.sleep(0.001)


@contextlib.contextmanager
def client_door(device):
    """C1's stack, shared by C1 and C5: ``build_default_service(
    batched_cadence=True)`` on the card behind an in-process
    ``AlfredServer`` (a ``DoorThread``), ticked every CLIENT_CADENCE_S by
    a task on the door's event loop (every launch comes from that
    thread). Yields it as ``service``, ``door``, ``ticking`` and
    ``errors`` (the tick loop's); fails if the tick loop failed."""
    import asyncio
    from types import SimpleNamespace

    from fluidframework_tpu_torch.server.alfred import build_default_service
    service = build_default_service(batched_cadence=True, device=device)
    with sockets_shut_on_close():
        door = DoorThread(service)
        stack = SimpleNamespace(service=service, door=door, errors=[],
                                ticking={"on": True, "ticks": 0})

        async def tick_loop() -> None:
            while stack.ticking["on"]:
                await asyncio.sleep(CLIENT_CADENCE_S)
                try:
                    service.pump()
                    stack.ticking["ticks"] += 1
                except Exception as err:  # fails the phase below
                    stack.errors.append(repr(err))
                    return
        ticker = asyncio.run_coroutine_threadsafe(tick_loop(), door.loop)
        try:
            yield stack
        finally:
            stack.ticking["on"] = False
            try:
                ticker.result(10)
            except Exception as err:
                stack.errors.append(repr(err))
            door.close()
    check(not stack.errors, f"client door: the tick loop failed: "
          f"{stack.errors}")


@contextlib.contextmanager
def sockets_shut_on_close():
    """Every port network document service closed in the block shuts its
    socket down first: a reader thread blocked in recv keeps a closed
    socket open, and a closing door waits for it. (The examples, the
    gateway and the agent runner close theirs with ``close()``.)"""
    import socket

    from fluidframework_tpu_torch.drivers import network_driver
    cls = network_driver.NetworkDocumentService
    close = cls.close

    def shut_then_close(self) -> None:
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass  # already closed or never connected
        close(self)
    cls.close = shut_then_close
    try:
        yield
    finally:
        cls.close = close


def client_c1(stack) -> dict:
    """BASELINE config 1: two port Containers (a root SharedMap and a
    ``clicks`` SharedCounter, the clicker shape) reach ``client_door``'s
    ``AlfredServer`` over a localhost socket through the tinylicious
    driver. Rounds of increments and sets, a summary uploaded and acked,
    more rounds, then a third client loads late from the summary plus the
    trailing deltas."""
    from fluidframework_tpu_torch.dds.counter import SharedCounter
    from fluidframework_tpu_torch.dds.map import SharedMap
    from fluidframework_tpu_torch.drivers.tinylicious_driver import \
        TinyliciousDocumentServiceFactory
    from fluidframework_tpu_torch.runtime.container import Container
    from fluidframework_tpu_torch.runtime.summarizer import (
        SummaryConfig, SummaryManager)
    service, door, errors = stack.service, stack.door, stack.errors
    ticks0 = stack.ticking["ticks"]
    factory = TinyliciousDocumentServiceFactory(port=door.port)
    services: list = []
    doc = "clicker"
    try:
        t0 = time.perf_counter()
        svc1 = factory(doc)
        services.append(svc1)
        with svc1.dispatch_lock:
            c1 = Container.create_detached(svc1)
            ds = c1.runtime.create_datastore("default")
            ds.create_channel("root", SharedMap.channel_type)
            ds.create_channel("clicks", SharedCounter.channel_type)
            c1.attach()
        svc2 = factory(doc)
        services.append(svc2)
        with svc2.dispatch_lock:
            c2 = Container.load(svc2)
        clients = [(svc1, c1), (svc2, c2)]
        join_s = time.perf_counter() - t0
        acks: list = []
        sent = {"clicks": 0, "ops": 0}

        def rounds(r0: int, n: int) -> None:
            for r in range(r0, r0 + n):
                starts = []
                for i, (svc, c) in enumerate(clients):
                    with svc.dispatch_lock:
                        chan(c, "clicks").increment(i + 1)
                        chan(c, "root").set(f"k{(r + i) % 5}", [r, i])
                    sent["clicks"] += i + 1
                    sent["ops"] += 2
                    starts.append(time.perf_counter())
                for (svc, c), t_sent in zip(clients, starts):
                    wait_for(lambda: not c.runtime.pending.has_pending,
                             "client C1: an op was not acked")
                    acks.append(time.perf_counter() - t_sent)

        t1 = time.perf_counter()
        rounds(0, CLIENT_C1_ROUNDS)
        with svc1.dispatch_lock:
            manager = SummaryManager(c1, SummaryConfig(max_ops=10**6))
            handle = manager.summarize_now(reason="client C1")
        check(handle is not None, "client C1: no summary was uploaded")
        wait_for(lambda: [e.kind for e in manager.events]
                 == ["generated", "acked"], "client C1: no summary ack")
        rounds(CLIENT_C1_ROUNDS, CLIENT_C1_AFTER)
        serve_s = time.perf_counter() - t1
        t2 = time.perf_counter()
        svc3 = factory(doc)
        services.append(svc3)
        with svc3.dispatch_lock:
            c3 = Container.load(svc3)
        late_s = time.perf_counter() - t2
        clients.append((svc3, c3))
        head = door.call(lambda: service.get_deltas(doc, 0)[-1]
                         .sequence_number)
        wait_for(lambda: all(c.last_processed_seq >= head
                             for _s, c in clients),
                 "client C1: a client did not catch up")
        check(not errors, f"client C1: the tick loop failed: {errors}")
        summaries = []
        for svc, c in clients:
            with svc.dispatch_lock:
                summaries.append(c.summarize())
        check(all(s == summaries[0] for s in summaries),
              "client C1: the three clients' summaries differ")
        with svc3.dispatch_lock:
            clicks = chan(c3, "clicks").value
            root = dict(chan(c3, "root").items())
        check(clicks == sent["clicks"], f"client C1: counter {clicks} != "
              f"{sent['clicks']} increments sent")
        device_map = door.call(lambda: service.merge_host.map_entries(
            doc, "default", "root"))
        check(device_map == root, "client C1: the merge host's root map row "
              "!= the clients' SharedMap")
    finally:
        for svc in services:
            svc.close()
        quiesce(stack)
    return {"clients": 3, "rounds": CLIENT_C1_ROUNDS + CLIENT_C1_AFTER,
            "ops": sent["ops"], "join_s": join_s, "serve_s": serve_s,
            "merged_ops_per_s": sent["ops"] / serve_s,
            "ack_ms_p50": 1e3 * pct(acks, 50), "ack_ms_p99": 1e3 * pct(acks, 99),
            "late_load_s": late_s, "ticks": stack.ticking["ticks"] - ticks0,
            "counter": clicks, "summary_handle": handle}


def client_c2(device) -> dict:
    """The service-load-test's full profile through the port's load
    harness: ``run_load(CLIENT_PROFILE, device=...)`` (32 docs x 8
    Containers, 50 rounds x 8 ops), one kernel-2 launch a pump across
    every document."""
    from fluidframework_tpu_torch.tools.load_test import PROFILES, run_load
    report = run_load(CLIENT_PROFILE, device=device)
    check(report["converged"], "client C2: the load profile diverged")
    cfg = PROFILES[CLIENT_PROFILE]
    want = cfg["docs"] * cfg["clients_per_doc"] * cfg["rounds"] \
        * cfg["ops_per_round"]
    check(report["ops_sent"] == want, f"client C2: {report['ops_sent']} "
          f"ops sent, the profile has {want}")
    return report


def client_service(device, slots: int):
    from fluidframework_tpu_torch.server.kernel_host import \
        KernelSequencerHost
    from fluidframework_tpu_torch.server.merge_host import KernelMergeHost
    from fluidframework_tpu_torch.server.routerlicious import \
        RouterliciousService
    merge_host = KernelMergeHost(device=device)
    service = RouterliciousService(
        auto_pump=False, merge_host=merge_host,
        batched_deli_host=KernelSequencerHost(num_slots=slots,
                                              initial_capacity=1,
                                              device=device))
    return service, merge_host


def client_doc(service, doc: str, channel: str, channel_type: str,
               n: int) -> tuple[list, float]:
    """``n`` port Containers on one doc of ``service``: the first creates
    and attaches it with one channel (one pump), the rest load it (one
    pump sequences their joins, as the load harness joins)."""
    from fluidframework_tpu_torch.drivers.local_driver import \
        LocalDocumentService
    from fluidframework_tpu_torch.runtime.container import Container
    t0 = time.perf_counter()
    first = Container.create_detached(LocalDocumentService(service, doc))
    first.runtime.create_datastore("default").create_channel(
        channel, channel_type)
    first.attach()
    service.pump()
    clients = [first] + [Container.load(LocalDocumentService(service, doc))
                         for _ in range(n - 1)]
    service.pump()
    return clients, time.perf_counter() - t0


def channel_ops(service, doc: str, channel: str) -> list:
    """(channel op, seq, ref, client) of every sequenced op of ``channel``."""
    from fluidframework_tpu_torch.protocol.messages import MessageType
    out = []
    for m in service.get_deltas(doc, 0):
        if m.type != MessageType.OPERATION:
            continue
        inner = (m.contents or {}).get("contents") or {}
        if inner.get("address") == channel:
            out.append((inner["contents"], m.sequence_number,
                        m.reference_sequence_number, m.client_id))
    return out


def client_rounds(service, clients, rounds: int, edit) -> dict:
    """``rounds`` rounds: every client makes ``edit(r, i, client)`` (one
    op), then one pump; op-to-ack is the pump's end less the op's
    submit."""
    acks = []
    t0 = time.perf_counter()
    for r in range(rounds):
        sent = []
        for i, c in enumerate(clients):
            edit(r, i, c)
            sent.append(time.perf_counter())
        service.pump()
        done = time.perf_counter()
        check(not any(c.runtime.pending.has_pending for c in clients),
              "a client's op was not acked by its round's pump")
        acks += [done - t for t in sent]
    serve_s = time.perf_counter() - t0
    ops = rounds * len(clients)
    return {"rounds": rounds, "ops": ops, "serve_s": serve_s,
            "merged_ops_per_s": ops / serve_s,
            "ack_ms_p50": 1e3 * pct(acks, 50),
            "ack_ms_p99": 1e3 * pct(acks, 99)}


def record_live(service, doc: str, live: dict, root: pathlib.Path) -> None:
    """Record ``doc`` of ``service`` (its base snapshot and whole sequenced
    log) under ``root`` for C5's replay and debug checks, beside ``live``,
    its live clients' summary."""
    from fluidframework_tpu_torch.drivers.replay_driver import \
        record_document
    from fluidframework_tpu_torch.tools.replay import canonical
    record_document(service, doc, root / doc,
                    snapshot=service.get_latest_snapshot(doc))
    (root / f"{doc}.live.json").write_text(canonical(live))


def client_c3(device, record: pathlib.Path) -> dict:
    """BASELINE config 2 through Containers: CLIENT_C3_CLIENTS port
    Containers on one SharedString over ``RouterliciousService`` with the
    batched deli host and the merge host on the card. Each round every
    client makes one seeded insert or remove; then one pump (one flush:
    kernel 3). Every client's text == the merge host's device text ==
    a ``MergeEngine`` replay of ``get_deltas``. The doc is recorded under
    ``record`` for C5 (no rounds added)."""
    import numpy as np

    from fluidframework_tpu_torch.dds.sequence import SharedString
    service, merge_host = client_service(device, CLIENT_C3_CLIENTS)
    doc = "config2-clients"
    clients, join_s = client_doc(service, doc, "text",
                                 SharedString.channel_type,
                                 CLIENT_C3_CLIENTS)
    rng = np.random.default_rng(15)
    letters = "abcdefghijklmnopqrstuvwxyz"

    def edit(r, i, c):
        text = chan(c, "text")
        length = len(text.get_text())
        if length > 8 and rng.random() < 0.3:
            start = int(rng.integers(0, length - 1))
            text.remove_text(start, min(length, start + int(
                rng.integers(1, 5))))
        else:
            n = int(rng.integers(1, 9))
            at = int(rng.integers(0, 26 - n))
            text.insert_text(int(rng.integers(0, length + 1)),
                             letters[at:at + n])
    out = client_rounds(service, clients, CLIENT_C3_ROUNDS, edit)
    texts = {chan(c, "text").get_text() for c in clients}
    check(len(texts) == 1, f"client C3: {len(texts)} different texts")
    text = texts.pop()
    check(merge_host.text(doc, "default", "text") == text,
          "client C3: the merge host's device text != the clients'")
    check(engine_text(channel_ops(service, doc, "text")) == text,
          "client C3: the clients' text != a MergeEngine replay of "
          "get_deltas")
    check(merge_host.stats["scalar_ops"] == 0,
          "client C3: text ops left the device rows")
    record_live(service, doc, clients[0].summarize(), record)
    return {"clients": CLIENT_C3_CLIENTS, "join_s": join_s, **out,
            "length": len(text), "stats": merge_host.stats}


def sparse_grid(matrix) -> tuple:
    """A client SharedMatrix as (rows, cols, {(row, col): value}) over its
    live handles (every cell that holds a value)."""
    def live(vec):
        return [h for seg in vec.engine.segments if seg.removed_seq is None
                for h in seg.content]
    rows, cols = live(matrix.rows), live(matrix.cols)
    rpos = {h: i for i, h in enumerate(rows)}
    cpos = {h: i for i, h in enumerate(cols)}
    return (len(rows), len(cols),
            {(rpos[rh], cpos[ch]): v for (rh, ch), v in matrix.cells.items()
             if v is not None and rh in rpos and ch in cpos})


def dense_to_sparse(grid) -> tuple:
    return (len(grid), len(grid[0]) if grid else 0,
            {(r, c): v for r, row in enumerate(grid)
             for c, v in enumerate(row) if v is not None})


def client_c4(device, record: pathlib.Path) -> dict:
    """BASELINE config 4 through Containers: CLIENT_C4_CLIENTS port
    Containers on one SharedMatrix, laid out CLIENT_C4_GRID x
    CLIENT_C4_GRID by the first client, over the same service shape as
    C3. Each round every client writes one cell, and CLIENT_C4_MOVERS of
    them insert or remove a row or column instead (a structural op in
    every flush: kernel 5, not the cell-run append); then one pump. Every
    client's grid == the merge host's device grid == a PermutationVector
    + LWW replay of ``get_deltas``. The doc is recorded under ``record``
    for C5 (no rounds added)."""
    import numpy as np

    from fluidframework_tpu_torch.dds.matrix import SharedMatrix
    service, merge_host = client_service(device, CLIENT_C4_CLIENTS)
    doc = "config4-clients"
    clients, join_s = client_doc(service, doc, "grid",
                                 SharedMatrix.channel_type,
                                 CLIENT_C4_CLIENTS)
    grid0 = chan(clients[0], "grid")
    grid0.insert_rows(0, CLIENT_C4_GRID)
    grid0.insert_cols(0, CLIENT_C4_GRID)
    service.pump()
    rng = np.random.default_rng(16)

    def edit(r, i, c):
        grid = chan(c, "grid")
        if i % (CLIENT_C4_CLIENTS // CLIENT_C4_MOVERS) == r % 4:
            axis = ("rows", "cols")[int(rng.integers(0, 2))]
            size = grid.row_count if axis == "rows" else grid.col_count
            at = int(rng.integers(0, 16))
            if rng.random() < 0.5 and size > 32:
                getattr(grid, f"remove_{axis}")(at, int(rng.integers(1, 3)))
            else:
                getattr(grid, f"insert_{axis}")(at, int(rng.integers(1, 4)))
        else:
            grid.set_cell(int(rng.integers(0, grid.row_count)),
                          int(rng.integers(0, grid.col_count)),
                          int(rng.integers(0, 1 << 20)))
    out = client_rounds(service, clients, CLIENT_C4_ROUNDS, edit)
    grids = [sparse_grid(chan(c, "grid")) for c in clients]
    check(all(g == grids[0] for g in grids),
          "client C4: the clients' grids differ")
    check(dense_to_sparse(merge_host.matrix_grid(doc, "default", "grid"))
          == grids[0], "client C4: the merge host's device grid != the "
          "clients'")
    check(dense_to_sparse(replay_grid(channel_ops(service, doc, "grid")))
          == grids[0], "client C4: the clients' grid != a PermutationVector"
          " + LWW replay of get_deltas")
    check(merge_host.stats["scalar_ops"] == 0,
          "client C4: matrix ops left the device rows")
    record_live(service, doc, clients[0].summarize(), record)
    return {"clients": CLIENT_C4_CLIENTS, "join_s": join_s, **out,
            "rows": grids[0][0], "cols": grids[0][1],
            "cells": len(grids[0][2]), "stats": merge_host.stats}


#: C5: the seven example apps, each run by its own ``main`` over C1's
#: door on a fixed doc id.
CLIENT_C5_EXAMPLES = ("clicker", "collab_text", "dice_roller",
                      "task_board", "whiteboard", "table_document",
                      "rich_text_editor")
#: Op-to-ack samples per example doc: single sets on the doc's root
#: directory by the arm's own Container, each waited for before the next.
CLIENT_C5_ACKS = 8
#: Seeded top-up edits the arm may add to make kernel 3 or 5 launch.
CLIENT_C5_TOPUP = 8
#: Timed calls of ``apply_tick_runs`` and of kernel 4 on its tick.
CLIENT_C5_REPS = 5
#: Cut points per recording at which the debug tool's session is held to
#: a truncated replay.
CLIENT_C5_CUTS = 3
#: ``apply_tick_runs`` on the card at tests/test_mergetree_runs.py's
#: largest shape: 4 docs x 32 ops, 4 x 32 + 8 slots, runs of up to 8.
RUNS_DOCS, RUNS_OPS, RUNS_R = 4, 32, 8


def c5_doc(example: str) -> str:
    return f"c5-{example.replace('_', '-')}"


def http_get(url: str) -> tuple[bytes, float]:
    """(body, ms) of one GET; a status other than 2xx raises."""
    import urllib.request
    t0 = time.perf_counter()
    with urllib.request.urlopen(url, timeout=120) as resp:
        body = resp.read()
    return body, 1e3 * (time.perf_counter() - t0)


def runs_stream(rng, n_ops: int) -> list[dict]:
    """A seeded sequenced merge stream of inserts, removes and annotates
    (the shape of tests/test_mergetree_runs.py's streams)."""
    from fluidframework_tpu_torch.ops import mergetree_kernel as mtk
    ops, length, pool = [], 0, 0
    for seq in range(1, n_ops + 1):
        client, r = rng.randrange(4), rng.random()
        if length > 24 and r < 0.25:
            start = rng.randrange(length - 8)
            end = start + rng.randint(1, 6)
            ops.append(dict(kind=mtk.MT_REMOVE, pos=start, end=end,
                            seq=seq, ref_seq=seq - 1, client=client))
            length -= end - start
        elif length > 24 and r < 0.40:
            start = rng.randrange(length - 8)
            ops.append(dict(kind=mtk.MT_ANNOTATE, pos=start,
                            end=start + rng.randint(1, 6), seq=seq,
                            ref_seq=seq - 1, client=client,
                            prop_key=rng.randrange(2),
                            prop_val=rng.randrange(1, 50)))
        else:
            tlen = rng.randint(1, 6)
            ops.append(dict(kind=mtk.MT_INSERT, pos=rng.randint(0, length),
                            seq=seq, ref_seq=seq - 1, client=client,
                            pool_start=pool, text_len=tlen))
            pool += tlen
            length += tlen
    return ops


def runs_inputs(device) -> dict:
    """One seeded tick for ``apply_tick_runs`` and for kernel 4: the
    streams, their packed run batch and fresh states, on ``device``."""
    import random

    from fluidframework_tpu_torch.ops import mergetree_kernel as mtk
    from fluidframework_tpu_torch.ops import mergetree_runs as mtr
    rng = random.Random(116)
    streams = [runs_stream(rng, RUNS_OPS) for _ in range(RUNS_DOCS)]
    runs = [mtr.pack_runs(s, r_max=RUNS_R) for s in streams]
    steps = max(len(r) for r in runs)
    slots = 4 * RUNS_OPS + 8
    return {"streams": streams, "steps": steps,
            "state": lambda dev: mtk.init_state(RUNS_DOCS, slots,
                                                device=dev),
            "runs": lambda dev: mtr.make_run_batch(runs, RUNS_DOCS, steps,
                                                   RUNS_R, device=dev),
            "ops": mtk.make_merge_op_batch(streams, RUNS_DOCS, RUNS_OPS,
                                           device=device)}


def replay_and_debug(directory: pathlib.Path, live: str) -> dict:
    """A recording's replay == its live clients' summary ``live`` (the
    canonical form), and the debug tool's session, stepped to
    CLIENT_C5_CUTS cut points, == the truncated replay at each."""
    from fluidframework_tpu_torch.drivers.replay_driver import load_recorded
    from fluidframework_tpu_torch.tools.debug_tool import load_session
    from fluidframework_tpu_torch.tools.replay import (canonical,
                                                       replay_summary)
    messages, snapshot = load_recorded(directory)
    t0 = time.perf_counter()
    replayed = canonical(replay_summary(directory))
    replay_s = time.perf_counter() - t0
    check(replayed == live, f"client C5: the replay of {directory.name} != "
          "its live clients' summary")
    base = (snapshot or {}).get("sequence_number", 0)
    seqs = [m.sequence_number for m in messages if m.sequence_number > base]
    check(len(seqs) > CLIENT_C5_CUTS, f"client C5: {directory.name} holds "
          f"{len(seqs)} ops past its base")
    cuts = [seqs[len(seqs) * (i + 1) // (CLIENT_C5_CUTS + 1)]
            for i in range(CLIENT_C5_CUTS)]
    service, container = load_session(directory)
    for cut in cuts:
        service.play_to(cut)
        check(canonical(container.summarize())
              == canonical(replay_summary(directory, up_to_seq=cut)),
              f"client C5: the debug session of {directory.name} at seq "
              f"{cut} != the truncated replay")
    return {"ops": len(messages), "replay_s": replay_s, "cuts": cuts}


def fold_key_ops(ops) -> dict:
    """The last-writer-wins fold of a map or directory channel's sequenced
    key ops (set, delete, clear) by key name: a merge host map row."""
    out: dict = {}
    for op, _seq, _ref, _client in ops:
        if op["type"] == "set":
            out[op["key"]] = op["value"]
        elif op["type"] == "delete":
            out.pop(op["key"], None)
        elif op["type"] == "clear":
            out.clear()
    return out


def row_views(channel, merge_host):
    """For a client channel the merge host keeps a row of: how to view the
    channel, and how to read its row (by channel key) in the same form."""
    from fluidframework_tpu_torch.dds.directory import SharedDirectory
    from fluidframework_tpu_torch.dds.map import SharedMap
    from fluidframework_tpu_torch.dds.matrix import SharedMatrix
    from fluidframework_tpu_torch.dds.sequence import SharedString
    if isinstance(channel, SharedString):
        return (lambda c: c.get_text()), merge_host.text
    if isinstance(channel, SharedMatrix):
        return sparse_grid, \
            lambda *key: dense_to_sparse(merge_host.matrix_grid(*key))
    if isinstance(channel, (SharedMap, SharedDirectory)):
        return (lambda c: dict(c.items())), merge_host.map_entries
    fail(f"client C5: the merge host keeps a row of a "
         f"{type(channel).__name__}")


class DoorClients:
    """Port Containers on ``client_door``'s documents through the
    tinylicious driver, each with the service it runs over; ``close()``
    closes every service opened."""

    def __init__(self, stack) -> None:
        from fluidframework_tpu_torch.drivers.tinylicious_driver import \
            TinyliciousDocumentServiceFactory
        self.service, self.door = stack.service, stack.door
        self.factory = TinyliciousDocumentServiceFactory(port=self.door.port)
        self.services: list = []

    def track(self, svc):
        self.services.append(svc)
        return svc

    def connect(self, doc: str) -> tuple:
        from fluidframework_tpu_torch.runtime.container import Container
        svc = self.track(self.factory(doc))
        with svc.dispatch_lock:
            container = Container.load(svc)
        self.settled(svc, container, doc)
        return svc, container

    def head(self, doc: str) -> int:
        return self.door.call(lambda: self.service.get_deltas(doc, 0)[-1]
                              .sequence_number)

    def settled(self, svc, container, doc: str) -> None:
        at = self.head(doc)
        wait_for(lambda: container.last_processed_seq >= at
                 and not container.runtime.pending.has_pending,
                 f"client C5: a Container on {doc} did not catch up")

    def summary(self, svc, container, doc: str) -> dict:
        self.settled(svc, container, doc)
        with svc.dispatch_lock:
            return container.summarize()

    def close(self) -> None:
        for svc in self.services:
            svc.close()


def c5_examples(dc: DoorClients, out: dict) -> dict:
    """Every example's ``main`` over the door, then a port Container on
    each doc: its runtime state == the example clients' (captured as each
    session ends), CLIENT_C5_ACKS timed single ops, seeded top-up edits
    where kernel 3 or 5 has not launched, and the merge host's device
    rows held to each channel. Returns the Containers by doc."""
    import importlib
    import random

    from fluidframework_tpu_torch.examples import host as example_host
    from fluidframework_tpu_torch.tools.replay import canonical
    real_open = example_host.open_document
    seen: dict = {}

    @contextlib.contextmanager
    def capture(example, args, props=None):
        with real_open(example, args, props) as session:
            yield session
            session.settle()
            seen[args.doc] = [canonical(o.runtime.parent.container
                                        .summarize()["runtime"])
                              for o in (session.creator, session.joiner)]
    example_host.open_document = capture
    try:
        for name in CLIENT_C5_EXAMPLES:
            module = importlib.import_module(
                f"fluidframework_tpu_torch.examples.{name}")
            t0 = time.perf_counter()
            module.main(["--port", str(dc.door.port), "--doc", c5_doc(name)])
            out["examples"][name] = {"s": time.perf_counter() - t0}
    finally:
        example_host.open_document = real_open
    clients: dict = {}
    for name in CLIENT_C5_EXAMPLES:
        doc = c5_doc(name)
        check(len(seen.get(doc, ())) == 2 and seen[doc][0] == seen[doc][1],
              f"client C5: {name}'s two example clients differ")
        svc, container = clients[doc] = dc.connect(doc)
        check(canonical(dc.summary(svc, container, doc)["runtime"])
              == seen[doc][0], f"client C5: a Container loading {name}'s "
              "doc != the example clients' state")
        acks = []
        for i in range(CLIENT_C5_ACKS):
            with svc.dispatch_lock:
                container.runtime.get_datastore("default").get_channel(
                    "root").set("c5-acks", i)
            t_sent = time.perf_counter()
            wait_for(lambda: not container.runtime.pending.has_pending,
                     f"client C5: an op on {doc} was not acked")
            acks.append(time.perf_counter() - t_sent)
        out["examples"][name]["ack_ms_p50"] = 1e3 * pct(acks, 50)
    # Seeded top-up edits where the examples' own traffic left kernel 3
    # (text flushes) or kernel 5 (matrix flushes with a structural op in
    # flight) unlaunched.
    rng = random.Random(1605)
    topups = {"mergetree_blocks": 0, "matrix_tick": 0}
    for kernel, example, edit in (
            ("mergetree_blocks", "collab_text",
             lambda ds: ds.get_channel("body").insert_text(
                 0, "abcdefgh"[:rng.randint(1, 8)])),
            ("matrix_tick", "table_document",
             lambda ds: (ds.get_channel("grid").insert_rows(0, 1),
                         ds.get_channel("grid").set_cell(
                             0, 0, rng.randrange(1 << 20))))):
        doc = c5_doc(example)
        svc, container = clients[doc]
        while (launch_counts()[kernel] == 0
               and topups[kernel] < CLIENT_C5_TOPUP):
            with svc.dispatch_lock:
                edit(container.runtime.get_datastore("default"))
            topups[kernel] += 1
            dc.settled(svc, container, doc)
    out["topup_edits"] = topups
    out["device_rows"] = c5_device_rows(dc, clients)
    return clients


def c5_device_rows(dc: DoorClients, clients: dict) -> dict:
    """The merge host's device rows of the example docs, held to the
    Container's channel where the channel held nothing at attach and (a
    directory) has no subdirectory; a map or directory row otherwise to
    the last-writer-wins fold of its sequenced key ops by name. The merge
    host builds a row from sequenced ops alone, so content written before
    attach is not in it, and folds a directory's keys by name whatever
    their path: both packages do (ROADMAP Queue C). A text or grid row
    with content from before attach is counted, not held."""
    from fluidframework_tpu_torch.dds.directory import SharedDirectory
    from fluidframework_tpu_torch.dds.map import SharedMap
    from fluidframework_tpu_torch.drivers.replay_driver import \
        ReplayDocumentService
    from fluidframework_tpu_torch.runtime.container import Container
    service, door = dc.service, dc.door
    merge_host = service.merge_host
    rows = {"rows": 0, "equal_container": 0, "equal_key_fold": 0,
            "written_before_attach": 0}
    for doc, (svc, container) in clients.items():
        dc.settled(svc, container, doc)
        attach = door.call(lambda: service.get_latest_snapshot(doc))
        at_attach = Container.load(ReplayDocumentService([], snapshot=attach),
                                   mode="read")
        for key in door.call(lambda: merge_host.channels(doc)):
            with svc.dispatch_lock:
                channel = container.runtime.get_datastore(
                    key.datastore).get_channel(key.channel)
                view, read = row_views(channel, merge_host)
                now = view(channel)
                keyed = isinstance(channel, (SharedMap, SharedDirectory))
                flat = not isinstance(channel, SharedDirectory) \
                    or not channel.root.subdirectories()
            empty = view(at_attach.runtime.get_datastore(key.datastore)
                         .get_channel(key.channel)) in ("", {}, (0, 0, {}))
            got = door.call(lambda: read(*key))
            rows["rows"] += 1
            if empty and flat:
                check(got == now, f"client C5: the merge host's {key} row "
                      "!= the Container's channel")
                rows["equal_container"] += 1
            elif keyed:
                ops = door.call(lambda: channel_ops(service, doc,
                                                    key.channel))
                check(got == fold_key_ops(ops), f"client C5: the merge "
                      f"host's {key} row != the fold of its key ops")
                rows["equal_key_fold"] += 1
            else:
                rows["written_before_attach"] += 1
    check(rows["equal_container"] > 0, "client C5: no device row was held "
          "to a Container")
    return rows


def c5_gateway(dc: DoorClients, live: dict, out: dict) -> None:
    """The gateway over HTTP on localhost in front of the door: /healthz,
    a token minted for each doc and verified by the riddler, and each
    doc's /doc and /doc/view renders == the Container's summary."""
    import html
    import re

    from fluidframework_tpu_torch.server.gateway import Gateway, serve
    from fluidframework_tpu_torch.server.riddler import TenantManager
    from fluidframework_tpu_torch.tools.replay import canonical
    tenants = TenantManager()
    tenant = tenants.create_tenant("c5")
    server, thread = serve(Gateway("127.0.0.1", dc.door.port, "c5",
                                   tenant.secret))
    url = f"http://127.0.0.1:{server.server_address[1]}"
    render_ms = []
    try:
        body, _ms = http_get(f"{url}/healthz")
        check(json.loads(body) == {"ok": True},
              f"client C5: gateway /healthz answered {body!r}")
        for doc, summary in live.items():
            body, _ms = http_get(f"{url}/token?doc={doc}")
            claims = tenants.validate_token(json.loads(body)["token"],
                                            document_id=doc)
            check(claims["tenantId"] == "c5", f"client C5: token {claims}")
            body, ms = http_get(f"{url}/doc/{doc}")
            render_ms.append(ms)
            check(canonical(json.loads(body)) == summary, f"client C5: "
                  f"gateway /doc/{doc} != the Container's summary")
            body, _ms = http_get(f"{url}/doc/{doc}/view")
            state = re.search(r'<pre id="fluid-state">(.*)</pre>',
                              body.decode(), re.S)
            check(state is not None
                  and canonical(json.loads(html.unescape(state.group(1))))
                  == summary, f"client C5: gateway /doc/{doc}/view != the "
                  "Container's summary")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(30)
    out["gateway"] = {"docs": len(live), "render_ms_p50": pct(render_ms, 50),
                      "render_ms_p99": pct(render_ms, 99)}


def c5_agents(dc: DoorClients, clients: dict, root: pathlib.Path,
              out: dict) -> None:
    """The headless agents on the collab_text doc over the socket: its
    author asks for help, two agent hosts pick both tasks under the agent
    scheduler (each task claimed once), each winner's
    ``HeadlessAgentRunner`` runs its agent, and the insights map == the
    same agents run on a replay of the doc's recorded log."""
    from fluidframework_tpu_torch.agents import (
        INSIGHTS_CHANNEL, HeadlessAgentRunner, SpellCheckerAgent,
        TextAnalyticsAgent)
    from fluidframework_tpu_torch.drivers.network_driver import \
        NetworkDocumentService
    from fluidframework_tpu_torch.drivers.replay_driver import (
        FileDocumentService, record_document)
    from fluidframework_tpu_torch.protocol.messages import MessageType
    from fluidframework_tpu_torch.runtime.agent_scheduler import \
        AgentScheduler
    from fluidframework_tpu_torch.runtime.container import Container
    from fluidframework_tpu_torch.tools.replay import canonical
    service, port = dc.service, dc.door.port
    doc = c5_doc("collab_text")
    author_svc, author = clients[doc]
    agents = {"intelligence": TextAnalyticsAgent(),
              "spell": SpellCheckerAgent()}
    with author_svc.dispatch_lock:
        author.delta_manager.submit(MessageType.REMOTE_HELP,
                                    {"tasks": sorted(agents)},
                                    author.allocate_client_seq())
    control = dc.track(NetworkDocumentService("127.0.0.1", port, "_agent"))
    wait_for(lambda: len(control.help_tasks(doc)) == len(agents),
             "client C5: the foreman recorded no help tasks")
    # The first host creates the scheduler's data store; the second loads
    # it; then both pick every task at once and the sequencing decides.
    hosts, claims = [], []
    for h in range(2):
        svc, container = dc.connect(doc)
        with svc.dispatch_lock:
            hosts.append((svc, container, AgentScheduler.get(container)))
        dc.settled(svc, container, doc)
    for h, (svc, container, scheduler) in enumerate(hosts):
        with svc.dispatch_lock:
            for task in sorted(agents):
                scheduler.pick(task, lambda t=task, h=h: claims.append(
                    (t, h)))
    wait_for(lambda: len(claims) >= len(agents),
             "client C5: the agent tasks were not claimed")
    for svc, container, _s in hosts:
        dc.settled(svc, container, doc)
    check(sorted(t for t, _h in claims) == sorted(agents),
          f"client C5: agent task claims {claims}, want each once")
    for task, h in sorted(claims):
        for svc, container, scheduler in hosts:
            with svc.dispatch_lock:
                check(scheduler.claimant(task) == hosts[h][1].client_id,
                      f"client C5: the agent hosts disagree on {task}")
        runner = HeadlessAgentRunner(
            control, lambda d: NetworkDocumentService("127.0.0.1", port, d),
            [agents[task]])
        check(runner.run_once(doc) == 1, f"client C5: the {task} agent ran "
              "no task")
        dc.settled(author_svc, author, doc)
    check(control.help_tasks(doc) == [], "client C5: help tasks left over")

    def insights() -> dict:
        with author_svc.dispatch_lock:
            for ds in author.runtime.datastores.values():
                if INSIGHTS_CHANNEL in ds.channel_ids():
                    return dict(ds.get_channel(INSIGHTS_CHANNEL).items())
        return {}
    wait_for(lambda: sorted(insights()) == sorted(agents),
             "client C5: the author never saw both insights")
    directory = root / "agents-replay"
    dc.door.call(lambda: record_document(
        service, doc, directory, snapshot=service.get_latest_snapshot(doc)))
    replayed = Container.load(FileDocumentService(directory), mode="read")
    want = {task: agent.run(replayed) for task, agent in agents.items()}
    check(canonical(insights()) == canonical(want), "client C5: the agents' "
          "insights != the same agents on a replay of the recorded log")
    out["agents"] = {"claims": sorted(claims), "insights": want}


def c5_replays(dc: DoorClients, clients: dict, root: pathlib.Path,
               out: dict) -> None:
    """Each example doc recorded beside its live summary, then every
    recording under ``root`` (C3's and C4's too) replayed and stepped
    through the debug tool (``replay_and_debug``)."""
    for doc, (svc, container) in clients.items():
        live = dc.summary(svc, container, doc)
        dc.door.call(lambda: record_live(dc.service, doc, live, root))
    replays = {}
    for live_file in sorted(root.glob("*.live.json")):
        doc = live_file.name.removesuffix(".live.json")
        replays[doc] = replay_and_debug(root / doc, live_file.read_text())
    ops = sum(r["ops"] for r in replays.values())
    replay_s = sum(r["replay_s"] for r in replays.values())
    out["replay"] = {"docs": len(replays), "ops": ops, "seconds": replay_s,
                     "replay_ops_per_s": ops / replay_s,
                     "cuts": {d: r["cuts"] for d, r in replays.items()}}


def c5_runs(device, keep: dict, out: dict) -> None:
    """``apply_tick_runs`` on ``device`` at tests/test_mergetree_runs.py's
    largest shape == kernel 4 on the same stream and == its own CPU run,
    plane for plane; ``keep`` receives the inputs for their timing."""
    import torch

    from fluidframework_tpu_torch.ops import mergetree_cuda as mtc
    from fluidframework_tpu_torch.ops import mergetree_kernel as mtk
    from fluidframework_tpu_torch.ops import mergetree_runs as mtr
    inputs = runs_inputs(device)
    got = mtr.apply_tick_runs(inputs["state"](device), inputs["runs"](device))
    flat = mtc.apply_tick_best(inputs["state"](device), inputs["ops"])
    cpu = mtr.apply_tick_runs(inputs["state"]("cpu"), inputs["runs"]("cpu"))
    for field in mtk.MergeState._fields:
        check(torch.equal(getattr(got, field), getattr(flat, field)),
              f"client C5: apply_tick_runs' {field} != kernel 4's")
        check(torch.equal(getattr(got, field).cpu(), getattr(cpu, field)),
              f"client C5: apply_tick_runs' {field} on the card != its "
              "CPU run")
    out["runs"] = {"docs": RUNS_DOCS, "ops": RUNS_OPS, "r": RUNS_R,
                   "steps": inputs["steps"], "slots": 4 * RUNS_OPS + 8}
    keep.update(inputs, device=device)


def client_c5(stack, root: pathlib.Path, smi: str, keep: dict,
              device) -> dict:
    """The application tier on C1's stack (``client_door``): the example
    apps over the socket (``c5_examples``), the gateway (``c5_gateway``),
    the agents (``c5_agents``), the replay and debug path
    (``c5_replays``), then ``apply_tick_runs`` (``c5_runs``)."""
    from fluidframework_tpu_torch.tools.replay import canonical
    out: dict = {"device": smi, "examples": {}}
    dc = DoorClients(stack)
    try:
        clients = c5_examples(dc, out)
        c5_gateway(dc, {doc: canonical(dc.summary(svc, c, doc))
                        for doc, (svc, c) in clients.items()}, out)
        c5_agents(dc, clients, root, out)
        c5_replays(dc, clients, root, out)
    finally:
        dc.close()
    quiesce(stack)
    c5_runs(device, keep, out)
    return out


def quiesce(stack) -> None:
    """Wait until ``client_door``'s tick loop has run 3 ticks in a row
    with no kernel launch (the leaves of closed clients sequenced), so
    that an arm's launches all fall inside it."""
    def total() -> int:
        counts = launch_counts()
        return sum(counts[k] for k in ("map_fold", "sequencer_tick",
                                       "mergetree_blocks", "mergetree_flat",
                                       "matrix_tick"))
    while True:
        before, tick = total(), stack.ticking["ticks"]
        wait_for(lambda: stack.ticking["ticks"] >= tick + 3
                 or stack.errors, "client door: the tick loop stopped")
        check(not stack.errors, f"client door: {stack.errors}")
        if total() == before:
            return


def runs_timing(keep: dict) -> dict:
    """``apply_tick_runs`` and kernel 4 timed on the same tick (device ms,
    CUDA events): outside any arm, so these launches count nowhere."""
    from fluidframework_tpu_torch.ops import mergetree_cuda as mtc
    from fluidframework_tpu_torch.ops import mergetree_runs as mtr
    dev = keep["device"]
    state, runs, ops = keep["state"](dev), keep["runs"](dev), keep["ops"]
    return {"runs_ms": cuda_time_ms(
                lambda: mtr.apply_tick_runs(state, runs), CLIENT_C5_REPS),
            "kernel4_ms": cuda_time_ms(
                lambda: mtc.apply_tick_best(state, ops), CLIENT_C5_REPS)}


def client_path_c(device, smi: str) -> dict:
    """Client C: the port's own Containers served on the card, five arms,
    each with its kernels' launches counted and every call's inputs kept
    for the re-checks. C2-C4 run first (C3 and C4 record their documents
    for C5), then C1 and C5 on one ``client_door`` stack."""
    import shutil
    import tempfile
    arms: dict = {}
    root = pathlib.Path(tempfile.mkdtemp(prefix="client_c5_"))
    runs: dict = {}

    def arm(name: str, drive, need) -> None:
        with phase(f"client {name.upper()}"):
            arms[name] = client_arm(name, drive, device)
        for kernel in need:
            check(arms[name]["counts"][kernel] > 0,
                  f"client {name.upper()} launched no {kernel}")
    try:
        arm("c2", client_c2, ("sequencer_tick",))
        arm("c3", lambda d: client_c3(d, root),
            ("sequencer_tick", "mergetree_blocks"))
        arm("c4", lambda d: client_c4(d, root),
            ("sequencer_tick", "matrix_tick"))
        with client_door(device) as stack:
            arm("c1", lambda d: client_c1(stack), ("sequencer_tick",))
            arm("c5", lambda d: client_c5(stack, root, smi, runs, d),
                ("sequencer_tick", "mergetree_blocks", "matrix_tick"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    timing = runs_timing(runs)
    arms["c5"]["out"]["runs"].update(timing)
    print("client_c5_runs: " + json.dumps({
        "device": smi, **arms["c5"]["out"]["runs"]}), flush=True)
    return arms


# -- entry E: the entry point ---------------------------------------------------

#: BASELINE.json config 3's document count: the entry tick's full width.
ENTRY_DOCS = 10_240
#: Virtual shards of the card in the dry runs (the reference's main: 8).
ENTRY_SHARDS = (4, 8)
ENTRY_REPS = 20
#: Kernels 1-5 and the tree tick: the dry run launches 2 and 4 (its
#: tick, the segment axis's yardstick) and 1, 2, 3, 5 and the tree tick
#: (the serving loop's joins and mixed tick); the entry tick launches 2
#: and 4.
ENTRY_KERNELS = ("map_fold", "sequencer_tick", "mergetree_blocks",
                 "mergetree_flat", "matrix_tick", "tree_tick")


def report_err(want, got, what: str) -> int:
    """Largest |err| between two reports (nested dicts, lists, tuples,
    numpy arrays and host values), failing on any difference: the same
    keys and lengths, every array of the same dtype and shape, every
    other value equal."""
    import numpy as np
    if isinstance(want, dict):
        check(isinstance(got, dict) and sorted(want) == sorted(got),
              f"{what}: keys {sorted(want)} != {sorted(got)}")
        return max([report_err(want[k], got[k], f"{what}.{k}")
                    for k in want], default=0)
    if isinstance(want, (tuple, list)):
        check(type(got) is type(want) and len(got) == len(want),
              f"{what}: {type(want).__name__}[{len(want)}] != "
              f"{type(got).__name__}")
        return max([report_err(x, y, f"{what}[{i}]")
                    for i, (x, y) in enumerate(zip(want, got))], default=0)
    if isinstance(want, np.ndarray):
        check(isinstance(got, np.ndarray) and got.dtype == want.dtype
              and got.shape == want.shape, f"{what}: dtype or shape")
        err = int(np.abs(want.astype(np.int64)
                         - got.astype(np.int64)).max()) if want.size else 0
        check(err == 0, f"{what}: max |err| {err}")
        return err
    check(got == want, f"{what}: {got!r} != {want!r}")
    return 0


def entry_run(name: str, drive, runs: dict):
    """``drive()`` with every launch counter at 0 just before it and read
    just after, and every call of kernels 1-5 and the tree tick kept
    (``runs[name]``)."""
    import torch

    from fluidframework_tpu_torch.ops import matrix_cuda as mxc
    from fluidframework_tpu_torch.ops import tree_cuda as tcc
    kept: dict = {"matrix_tick": {}, "tree_tick": {}}
    launch_counts_reset()
    with plane_recording(kept), \
            recording(mxc, "apply_tick_best", kept["matrix_tick"],
                      mxc.tick), \
            recording(tcc, "apply_tick_best", kept["tree_tick"], tcc.tick):
        out = drive()
        torch.cuda.synchronize()
    runs[name] = {"counts": launch_counts(), "kept": kept}
    return out


def entry_path(device) -> dict:
    """Entry E: the port's entry point (``fluidframework_tpu_torch/
    entry.py``) as a user calls it, on the card by default.

    * ``entry()``'s 64-doc tick against ``entry("cpu")``, every plane;
    * the tick at ENTRY_DOCS docs (the entry's other widths), against its
      CPU run; each leg timed (kernel 2, kernel 4, the plain map tick)
      and the whole tick;
    * ``dryrun_multichip(n)`` on ENTRY_SHARDS virtual shards of the card
      against the same dry run on the CPU, report for report.

    Each run's launches are counted from 0; then every call of kernels
    1-5 and the tree tick it made is held to the plain version in every
    variant and timed (``plane_recheck``)."""
    import torch

    from fluidframework_tpu_torch import entry as te
    from fluidframework_tpu_torch.ops import map_kernel as mk
    from fluidframework_tpu_torch.parallel.mesh import gather_rows
    t0 = time.perf_counter()
    runs: dict = {}
    fn, args = te.entry()
    check(args[0].seq.device.type == "cuda", "entry() did not default to "
          "the card")
    got = entry_run("entry_64", lambda: fn(*args), runs)
    cpu_fn, cpu_args = te.entry("cpu")
    err = report_err(gather_rows([cpu_fn(*cpu_args)]), gather_rows([got]),
                     "entry tick (64 docs)")
    big = te._example_tick(ENTRY_DOCS, device=device)
    got = entry_run(f"entry_{ENTRY_DOCS}", lambda: fn(*big), runs)
    err = max(err, report_err(
        gather_rows([fn(*te._example_tick(ENTRY_DOCS, device="cpu"))]),
        gather_rows([got]), f"entry tick ({ENTRY_DOCS} docs)"))
    for name in (f"entry_{ENTRY_DOCS}", "entry_64"):
        counts = runs[name]["counts"]
        check(counts["sequencer_tick"] == 1 and counts["mergetree_flat"] == 1
              and counts["map_fold"] == counts["mergetree_blocks"]
              == counts["matrix_tick"] == counts["tree_tick"] == 0,
              f"{name} launched {counts}")
    map_state, map_ops = big[4], big[5]
    legs = {"map_tick": {"shape": [*map_ops.kind.shape,
                                   map_state.value.shape[1]],
                         "ms": cuda_time_ms(
                             lambda: mk.apply_tick(map_state, map_ops),
                             ENTRY_REPS)},
            "tick_ms": cuda_time_ms(lambda: fn(*big), ENTRY_REPS)}
    del big, got
    t_tick = time.perf_counter() - t0
    dry_s = {}
    for n in ENTRY_SHARDS:
        t1 = time.perf_counter()
        name = f"entry_dryrun_{n}"
        card = entry_run(name, lambda n=n: te.dryrun_multichip(n), runs)
        err = max(err, report_err(te.dryrun_multichip(n, "cpu"), card,
                                  f"dry run on {n} shards"))
        counts = runs[name]["counts"]
        for kernel in ENTRY_KERNELS:
            check(counts[kernel] > 0, f"{name} launched no {kernel}")
        dry_s[n] = time.perf_counter() - t1
    t_recheck = time.perf_counter()
    checks: dict = {}
    for name, run in runs.items():
        for kernel, by_shape in run["kept"].items():
            got = {sh: len(c) for sh, c in by_shape.items()}
            want = {sh: n for sh, n in run["counts"]["shapes"][kernel].items()
                    if n}
            check(got == want, f"{kernel} ({name}): launches by shape "
                  f"{want}, calls kept {got}")
            rec = plane_recheck(device, kernel, name, run["kept"])
            if rec is not None:
                checks.setdefault(kernel, {})[name] = {
                    k: v for k, v in rec.items() if k != "by_call"}
                err = max(err, rec["max_abs_err"])
        run["kept"].clear()
    out = {"docs": ENTRY_DOCS, "shards": list(ENTRY_SHARDS),
           "max_abs_err": err,
           "launches": {name: {k: run["counts"][k] for k in ENTRY_KERNELS}
                        for name, run in runs.items()},
           "legs": {**legs, **{
               kernel: {k: checks[kernel][f"entry_{ENTRY_DOCS}"][k]
                        for k in checks[kernel][f"entry_{ENTRY_DOCS}"]
                        if k in ("shape", "variant", "ms", "ms_global",
                                 "ms_warp", "ms_thread", "plain_ms",
                                 "bound_ms", "bound_by")}
               for kernel in ("sequencer_tick", "mergetree_flat")}},
           "seconds": {"ticks": t_tick, **{f"dryrun_{n}": s
                                           for n, s in dry_s.items()},
                       "re-checks": time.perf_counter() - t_recheck}}
    print("entry: " + json.dumps(out), flush=True)
    torch.cuda.synchronize()
    return {"counts": {name: run["counts"] for name, run in runs.items()},
            "checks": checks, "out": out}


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
    global T_START
    T_START = time.perf_counter()

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
                      "matrix_steps_smem", "tree_tick_smem"])
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"({_build.BUILD_DIR})", flush=True)

    trace_all = "--trace" in sys.argv[1:]
    trace_hist = trace_all or "--trace-history" in sys.argv[1:]
    trace_fleet = trace_all or "--trace-fleet" in sys.argv[1:]
    trace_read = trace_all or "--trace-read" in sys.argv[1:]
    trace_net = trace_all or "--trace-net" in sys.argv[1:]
    t_kernels = time.perf_counter()
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
    PHASE_S["kernels at full size"] = time.perf_counter() - t_kernels
    print(f"phase kernels at full size: {PHASE_S['kernels at full size']:.1f}"
          " s", flush=True)
    with phase("map"):
        path = main_path(device)
    # Front door F, then History P, run on the durable path's recovered
    # stack; F's seconds are its own phase.
    t0 = time.perf_counter()

    def after_durable(ctx):
        with phase("front door F"):
            front = front_path_f(device, ctx, trace=trace_read)
        return front, history_path_p(device, ctx, trace=trace_hist)
    durable = durable_path(device, path.pop("walless"), path.pop("script"),
                           then=after_durable)
    front_f, hist_p = durable.pop("then")
    PHASE_S["durable + history P"] = time.perf_counter() - t0 \
        - PHASE_S["front door F"]
    print(f"phase durable + history P: "
          f"{PHASE_S['durable + history P']:.1f} s", flush=True)
    with phase("text"):
        text = text_main_path(device)
    with phase("matrix"):
        matrix = matrix_main_path(device)
    with phase("steps"):
        steps = matrix_steps_path(device)
    with phase("tree A"):
        tree = tree_main_path(device)
    with phase("tree B"):
        tree_b = tree_path_b(device)
    with phase("mixed"):
        mixed_a = mixed_path_a(device)
        mixed_b = mixed_path_b(device, mixed_a)
        mixed_checks = mixed_recheck(device, mixed_a)
        del mixed_a["record"], mixed_a["serving"], mixed_a["outs"]
    with phase("sequence-parallel"):
        seqpar = seqpar_path(device)
    with phase("entry E"):
        entry_e = entry_path(device)
    with phase("planes"):
        planes = planes_path(device)
    with phase("history H"):
        planes["hist_h"] = history_path_h(device)
    with phase("fleet H"):
        planes["fleet_h"] = fleet_path_h(device)
    with phase("fleet P + read R"):
        planes["fleet_p"] = fleet_path_p(device, trace=trace_fleet,
                                         read=True, trace_read=trace_read)
    with phase("read R benches"):
        planes["read_r"] = read_path_r(device)
    with phase("viewer V"):
        planes["viewer_v"] = viewer_path_v(device, trace=trace_read)
    with phase("front door B"):
        front_b = front_path_b(device, trace=trace_net)
    with phase("net N"):
        planes["net_n"] = net_path_n(device, planes.pop("net_split"),
                                     trace=trace_net)
    with phase("client C"):
        client = client_path_c(device, smi)
    print("client: " + json.dumps({
        "device": smi,
        **{name: {k: arm["out"].get(k) for k in (
            "merged_ops_per_sec", "merged_ops_per_s", "ack_ms_p50",
            "ack_ms_p99", "join_s", "late_load_s", "ops_sent",
            "ops_seen_total", "ops", "clients", "rounds", "seconds",
            "launches", "examples", "gateway", "replay", "runs")
            if k in arm["out"]}
           for name, arm in client.items()}}), flush=True)
    for name, arm in client.items():
        planes[f"client_{name}"] = arm
    planes["front_f"] = front_f
    arm_b = front_b["arms"]
    print("net: " + json.dumps({
        "B": {a: {k: r["out"].get(k) for k in (
            "e2e_ops_per_sec", "ack_interval_ms_p50", "ack_interval_ms_p99",
            "tick_cadence_ms_p50", "tick_cadence_ms_p99",
            "shipped_bytes_per_tick", "ship_rtt_ms_p50", "ship_rtt_ms_p99",
            "seconds")} for a, r in arm_b.items()},
        "B_standalone": front_b["out"]["standalone"],
        "N": {k: planes["net_n"]["out"][k] for k in (
            "netsplit", "ack_overhead", "failover", "parked", "seconds")},
        "trace": {"front_b_arm1": arm_b[1]["out"]["trace"],
                  "net_f1": planes["net_n"]["out"]["trace"]}}),
        flush=True)
    read_r = planes["fleet_p"]["out"]["read_r"]
    print("read: " + json.dumps({
        "V": {"fanout": {n: {k: r[k] for k in (
            "broadcast_ms_p50", "broadcast_ms_p99", "joins_per_sec",
            "e2e_ops_per_sec", "encodes_per_tick", "fanout_native")}
            for n, r in planes["viewer_v"]["out"]["fanout"].items()},
            "rehome": planes["viewer_v"]["out"]["rehome"]},
        "R": {"on_fleet_p": {k: read_r[k] for k in (
            "read_ms", "replica_frames", "mega_redirect", "seconds")},
            "read_throughput": planes["read_r"]["out"]["read_throughput"],
            "writer_tax": {k: planes["read_r"]["out"]["writer_tax"][k]
                           for k in ("ack_p99_on_over_off",
                                     "block_p99_ratios")}},
        "F": {k: front_f["out"][k] for k in (
            "socket_ops_per_s", "seconds", "fanout", "standalone")},
        "trace": {"viewer_v": planes["viewer_v"]["out"]["trace"],
                  "read_r": read_r["trace"],
                  "front_f": front_f["out"]["trace"]}}), flush=True)
    print("fleet: " + json.dumps({
        "H": {k: planes["fleet_h"]["out"][k]
              for k in ("migration", "scaling", "replication")},
        "P": {k: planes["fleet_p"]["out"][k] for k in (
            "ack_ms", "commit_wait_ms_p50", "shipped_bytes_per_tick",
            "batch", "promotion", "ops_per_s", "launches", "shapes")
            + (("trace",) if trace_fleet else ())},
        "durable_path": {"ack_ms": durable["ack_latency_ms"],
                         "commit_wait_ms_p50": durable[
                             "wal_commit_wait_ms"]}}), flush=True)
    planes["hist_p"] = {"counts": hist_p["counts"], "kept": hist_p["kept"]}
    planes["hist_p_recover"] = {"counts": hist_p["recover_counts"],
                                "kept": hist_p["recover_kept"]}
    # Kernels 1-4 on every call each plane path made, both variants held
    # to the plain version, and timed on the last call at each shape.
    mega = planes["mega_a"]
    plane_paths = {"res_a": (planes["res_a"]["kept"],
                             planes["res_a"]["counts"]),
                   "res_r": (planes["res_r"]["kept"],
                             planes["res_r"]["counts"]),
                   "res_s": (planes["res_s"]["kept"],
                             planes["res_s"]["counts"]),
                   "mega_a": (mega["kept"], mega["counts"]),
                   "mega_a_single": (mega["twin_kept"], mega["twin_counts"]),
                   "mega_a_recover": (mega["recover_kept"],
                                      mega["recover_counts"]),
                   "mega_l": (planes["mega_l"]["kept"],
                              planes["mega_l"]["counts"]),
                   "hist_h": (planes["hist_h"]["kept"],
                              planes["hist_h"]["counts"]),
                   "hist_p": (planes["hist_p"]["kept"],
                              planes["hist_p"]["counts"]),
                   "hist_p_recover": (planes["hist_p_recover"]["kept"],
                                      planes["hist_p_recover"]["counts"]),
                   "fleet_h": (planes["fleet_h"]["kept"],
                               planes["fleet_h"]["counts"]),
                   "fleet_p": (planes["fleet_p"]["kept"],
                               planes["fleet_p"]["counts"]),
                   "read_r": (planes["read_r"]["kept"],
                              planes["read_r"]["counts"]),
                   "viewer_v": (planes["viewer_v"]["kept"],
                                planes["viewer_v"]["counts"]),
                   "front_f": (front_f["kept"], front_f["counts"]),
                   "front_f_twin": (front_f["twin_kept"],
                                    front_f["twin_counts"]),
                   "front_b_0": (arm_b[0]["kept"], arm_b[0]["counts"]),
                   "front_b_1": (arm_b[1]["kept"], arm_b[1]["counts"]),
                   "net_n": (planes["net_n"]["kept"],
                             planes["net_n"]["counts"]),
                   **{f"client_{name}": (arm["kept"], arm["counts"])
                      for name, arm in client.items()}}
    for path_name, (kept, counts) in plane_paths.items():
        for name, by_shape in kept.items():
            got = {sh: len(c) for sh, c in by_shape.items()}
            want = {sh: n for sh, n in counts["shapes"][name].items() if n}
            check(got == want, f"{name} ({path_name}): launches by shape "
                  f"{want}, calls kept {got}")
    # The recovery replays the promoted arm's ticks: the calls equal to
    # the promoted arm's stand checked by its re-check too.
    same = drop_leading_repeats(mega["recover_kept"], mega["kept"])
    print(f"mega A recovery calls equal to the promoted arm's: {same}",
          flush=True)
    t_recheck = time.perf_counter()
    plane_checks: dict = {}
    recheck_s: dict = {}
    # Mega A's deli calls at thousands of lanes run a plain version of
    # about a second: each shape's first and last call held to it. Client
    # C2's (the load profile's ~1,000 pumps at a few shapes) likewise: the
    # plain deli's host time on every call was 22-29 s of the re-checks.
    slow_plain = {"mega_a", "client_c2"}
    for path_name, (kept, _counts) in plane_paths.items():
        for name in ("map_fold", "sequencer_tick", "mergetree_blocks",
                     "mergetree_flat", "matrix_tick"):
            t0 = time.perf_counter()
            got = plane_recheck(device, name, path_name, kept,
                                ends_only=path_name in slow_plain)
            if got is not None:
                plane_checks.setdefault(name, {})[path_name] = {
                    k: v for k, v in got.items() if k != "by_call"}
                recheck_s[f"{path_name} {name}"] = time.perf_counter() - t0
        kept.clear()
    print("re-check seconds by plane path: " + json.dumps(recheck_s),
          flush=True)
    t_recheck_planes = time.perf_counter()
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
                     ("matrix_a", matrix["deli"]["a"]),
                     ("tree_a", tree["deli"])):
        deli_paths[key] = (src["shapes"], src["inputs"])
    deli_main = {}
    for key, (by, kept) in deli_paths.items():
        got = recheck_recorded(
            f"sequencer_tick ({key})", by, kept,
            lambda st, op: seqc.process_batch_best(st, op, "warp"),
            seqk.process_batch, deli_bound,
            other=lambda st, op: seqc.process_batch_best(st, op, "thread"),
            other_name="thread", time_all=True,
            ends_only=key in ("text_a", "matrix_a"))
        got["ms_warp"] = got.pop("ms")
        for end in ("min", "max"):
            got[f"ms_warp_{end}"] = got.pop(f"ms_{end}")
        got["variant"] = seqc.deli_variant(*got["shape"],
                                           seqc.smem_limit(device))
        got["ms"] = got[f"ms_{got['variant']}"]
        deli_main[key] = got
    del path["deli_inputs"], path["fold_inputs"], text["deli"], \
        matrix["deli"], tree["deli"]
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
            st, op, "global")), ends_only=True)
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
            time_all=name == "a", ends_only=True)
        for key, name in (("matrix_b", "b"), ("matrix_a", "a"))}
    del matrix["inputs"]
    steps_main = recheck_recorded(
        "matrix_steps", steps["shapes"], steps["inputs"],
        mxc.apply_tick_steps_best, mxk.apply_tick_steps, steps_bound,
        ops_of=lambda args: int(args[1].vec_valid.sum()
                                + args[1].r_valid.sum()),
        other=lambda st, b: mxc.apply_tick_steps_best(st, b, "global"),
        ends_only=True)
    steps_split = steps_breakdown(
        steps["inputs"][max(steps["shapes"], key=steps["shapes"].get)])
    del steps["inputs"]
    print(f"re-check times: plane paths {t_recheck_planes - t_recheck:.1f} "
          f"s, earlier paths {time.perf_counter() - t_recheck_planes:.1f} s",
          flush=True)
    PHASE_S["re-checks"] = time.perf_counter() - t_recheck
    if trace_all:
        trace_main_path(device)
        trace_durable_path(device)
        trace_text_paths(device)
        trace_matrix_paths(device)
        trace_tree_path(device)
        trace_mixed_path(device)
        trace_planes(device)
    if trace_hist:
        trace_history(device)
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
                                if name == "matrix_steps" else 0),
               "tree_a": tree["launches"].get(name, 0),
               "mixed_a": mixed_a["counts"].get(name, 0),
               "mixed_b": mixed_b["counts"].get(name, 0),
               "seqpar_host": seqpar["host"]["launches"].get(name, 0),
               **{run: counts.get(name, 0)
                  for run, counts in entry_e["counts"].items()},
               "res_a": planes["res_a"]["counts"].get(name, 0),
               "res_r": planes["res_r"]["counts"].get(name, 0),
               "res_s": planes["res_s"]["counts"].get(name, 0),
               "mega_a": planes["mega_a"]["counts"].get(name, 0),
               "mega_a_single": planes["mega_a"]["twin_counts"].get(
                   name, 0),
               "mega_a_recover": planes["mega_a"]["recover_counts"].get(
                   name, 0),
               "mega_l": planes["mega_l"]["counts"].get(name, 0),
               "hist_h": planes["hist_h"]["counts"].get(name, 0),
               "hist_p": planes["hist_p"]["counts"].get(name, 0),
               "hist_p_recover": planes["hist_p_recover"]["counts"].get(
                   name, 0),
               "fleet_h": planes["fleet_h"]["counts"].get(name, 0),
               "fleet_p": planes["fleet_p"]["counts"].get(name, 0),
               "read_r": planes["read_r"]["counts"].get(name, 0),
               "viewer_v": planes["viewer_v"]["counts"].get(name, 0),
               "front_f": front_f["counts"].get(name, 0),
               "front_b_0": arm_b[0]["counts"].get(name, 0),
               "front_b_1": arm_b[1]["counts"].get(name, 0),
               "net_n": planes["net_n"]["counts"].get(name, 0),
               **{f"client_{arm}": client[arm]["counts"].get(name, 0)
                  for arm in client}}
        for name in ("map_fold", "sequencer_tick", "mergetree_blocks",
                     "mergetree_flat", "matrix_tick", "matrix_steps",
                     "tree_tick")}
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
                 "sequencer_tick_variants"] for n in ("a", "b")},
             "tree_a": tree["launches"]["sequencer_tick_variants"]},
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
        {"name": "tree_tick", "route": "cuda",
         "source": "fluidframework_tpu_torch/csrc/tree_tick_smem.cu",
         "replaces": "fluidframework_tpu/ops/tree_kernel.py:267",
         "launches": launches["tree_tick"],
         "launches_by_path": by_path["tree_tick"],
         "variant_launches": {
             "tree_a": {"warp": tree["launches"]["tree_tick"]}},
         **mixed_checks["tree_tick"], "library_ms": None,
         "at_tree_b": {key: tree_b[key] for key in
                       ("shape", "ms", "plain_ms", "bound_ms", "bound_by",
                        "tick_ms", "tick_ms_cold")}},
    ]
    for entry in kernels:
        name = entry["name"]
        if name in mixed_checks:
            entry["mixed_a"] = mixed_checks[name]
            entry["variant_launches"]["mixed_a"] = \
                mixed_a["counts"]["variants"][name]
            entry["variant_launches"]["mixed_b"] = \
                mixed_b["counts"]["variants"][name]
        if name == "mergetree_flat":
            entry["seq_parallel_yardstick"] = seqpar["tick"]
        if name in entry_e["checks"]:
            entry["entry_e"] = entry_e["checks"][name]
            entry["max_abs_err"] = max(
                [entry["max_abs_err"]]
                + [r["max_abs_err"] for r in entry_e["checks"][name].values()])
            for run, counts in entry_e["counts"].items():
                if counts["variants"][name]:
                    entry["variant_launches"][run] = counts["variants"][name]
        if name in plane_checks:
            entry["planes"] = plane_checks[name]
            entry["max_abs_err"] = max(
                [entry["max_abs_err"]]
                + [r["max_abs_err"] for r in plane_checks[name].values()])
            for path_name, rec in planes.items():
                variants = rec.get("counts", {}).get("variants") \
                    if isinstance(rec, dict) else None
                if variants and variants.get(name):
                    entry["variant_launches"][path_name] = variants[name]
            for a, rec in arm_b.items():
                if rec["counts"]["variants"].get(name):
                    entry["variant_launches"][f"front_b_{a}"] = \
                        rec["counts"]["variants"][name]
    print(json.dumps({"kernels": kernels}), flush=True)
    PHASE_S["all"] = time.perf_counter() - T_START
    print("phase_seconds: " + json.dumps(PHASE_S), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
