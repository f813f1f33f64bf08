#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``fluidframework_tpu_torch``).

Run on a machine with one NVIDIA H100 from the root of a checkout:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``fluidframework_tpu_torch/csrc``,
holds each kernel against its plain PyTorch version on the card at the
shapes the main path gives it (exact equality: every plane is integer),
then drives the port's main path — the map-storm serving tick of
BASELINE.json config 3 (SharedMap op storm: 10,240 docs x 4 clients,
64 key slots, K=1024 set/delete/clear words per doc per tick) — through
``RouterliciousService`` / ``KernelSequencerHost`` / ``KernelMergeHost`` /
``StormController``, checks acks, sequencing totals, a second run with
the plain versions and a numpy fold of the submitted words, and prints
the kernels' launch counts and times.

Phases print one line each. Any failed check exits non-zero before the
last line, which is the JSON device record
``{"ok": true, "device": {"platform": "gpu", ...}}``. Without CUDA, or
outside a checkout of the repository, it exits non-zero and prints no
result. It imports nothing of JAX and nothing of ``fluidframework_tpu``.

    python3 chip_smoke.py --trace

serves the main path's ticks once more, under ``torch.profiler``, and
prints the card's busy time and idle share.
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


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


L2_FLUSH_BYTES = 256 << 20  # well past the H100's 50 MB L2


def cuda_time_ms(fn, reps: int) -> float:
    """Mean device ms of ``fn()`` over ``reps`` calls, each timed alone
    with CUDA events after a write of 256 MB that evicts the L2, so
    every call finds its inputs in device memory as a serving tick does
    (one warm-up call first)."""
    import torch
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fn()
    pairs = []
    for _ in range(reps):
        flush.zero_()
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


def max_abs_err(a, b) -> int:
    """Largest |a - b| over every plane of two NamedTuples of tensors."""
    worst = 0
    for x, y in zip(a, b):
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


def check_map_fold(device, b=DOCS, k=K_MAP, s=KEY_SLOTS) -> dict:
    import torch

    from fluidframework_tpu_torch.ops import map_fold_cuda as mfc
    from fluidframework_tpu_torch.ops import map_kernel as mk
    gen = torch.Generator(device=device).manual_seed(1)
    state, words, lo, hi, base = map_fold_inputs(gen, device, b, k, s)
    got = mfc.fold_words(state, words, lo, hi, base)
    want = mk.fold_words_plain(state, words, lo, hi, base)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    check(err == 0, f"map fold kernel != plain version (max |err| {err})")
    for f in mk.MapState._fields:
        check(torch.equal(getattr(got, f), getattr(want, f)),
              f"map fold plane {f} differs")
    ms = cuda_time_ms(lambda: mfc.fold_words(state, words, lo, hi, base), 20)
    plain_ms = cuda_time_ms(
        lambda: mk.fold_words_plain(state, words, lo, hi, base), 3)
    b, s = state.present.shape
    window = (hi.clamp(max=words.shape[1]) - lo.clamp(min=0)).clamp(min=0)
    n_ops = int(window.sum().item())
    plane_bytes = b * s * (1 + 4 + 4) + 4 * b
    nbytes = 4 * n_ops + 12 * b + 2 * plane_bytes
    nops = 8 * n_ops + 12 * b * s
    b_ms, b_by = bound(nbytes, nops)
    print(f"kernel map_fold: B={b} K={words.shape[1]} S={s} windowed_ops="
          f"{n_ops} equal=True max_abs_err={err} ms={ms:.4f} "
          f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} ({b_by})",
          flush=True)
    return {"shape": [b, words.shape[1], s], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by}


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
               every_outcome: bool = True) -> dict:
    """Kernel 2 against its plain version on one deli tick of shape
    (B, K, C); ``every_outcome`` also requires the inputs to reach every
    nack code and every outcome (true of the K = 32 tick)."""
    import torch

    from fluidframework_tpu_torch.ops import sequencer as seqk
    from fluidframework_tpu_torch.ops import sequencer_cuda as seqc
    gen = torch.Generator(device=device).manual_seed(2)
    state, ops = deli_inputs(gen, device, b, k, c)
    got_s, got_t = seqc.process_batch_best(state, ops)
    want_s, want_t = seqk.process_batch(state, ops)
    torch.cuda.synchronize()
    err = max(max_abs_err(got_s, want_s), max_abs_err(got_t, want_t))
    check(err == 0, f"deli kernel != plain version (max |err| {err})")
    for name, a, b in zip(seqk.SequencerState._fields, got_s, want_s):
        check(torch.equal(a, b), f"deli state plane {name} differs")
    for name, a, b in zip(seqk.TicketBatch._fields, got_t, want_t):
        check(torch.equal(a, b), f"deli ticket plane {name} differs")
    codes = torch.bincount(got_t.nack_code.flatten().long(), minlength=7)
    outs = torch.bincount(got_t.kind.flatten().long(), minlength=3)
    check(not every_outcome
          or (bool((codes[1:] > 0).all()) and bool((outs > 0).all())),
          f"deli inputs miss an outcome: nack codes {codes.tolist()} "
          f"outcomes {outs.tolist()}")
    ms = cuda_time_ms(lambda: seqc.process_batch_best(state, ops), 20)
    plain_ms = cuda_time_ms(lambda: seqk.process_batch(state, ops), 3)
    b, c = state.active.shape
    k = ops.kind.shape[1]
    state_bytes = b * (3 * 4 + 1) + b * c * (3 * 4 + 4 * 1)
    nbytes = 2 * state_bytes + b * k * (6 * 4 + 5 * 1) + b * k * 5 * 4
    nops = b * k * (60 + 4 * c)
    b_ms, b_by = bound(nbytes, nops)
    print(f"kernel sequencer_tick: B={b} K={k} C={c} equal=True "
          f"max_abs_err={err} nack_codes={codes.tolist()} "
          f"outcomes={outs.tolist()} ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"bound_ms={b_ms:.4f} ({b_by})", flush=True)
    return {"shape": [b, k, c], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by}


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
          ticks_ctx=contextlib.nullcontext) -> dict:
    """Build the port's service stack on ``device`` and serve ``script``;
    ``plain`` swaps in the kernels' plain versions for the whole run, and
    ``ticks_ctx()`` is entered around the served frames (not the joins)."""
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
                                flush_threshold_docs=10**9,
                                max_key_slots=KEY_SLOTS, pipeline_depth=1)
        mfc.launches = 0
        seqc.launches = 0
        mfc.shapes.clear()
        seqc.shapes.clear()
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
        with ticks_ctx():
            t1 = time.perf_counter()
            for tick, rid, entries, payload in script:
                if tick == TICKS:
                    storm.flush()  # the ticks settle before the resend
                    t_serve = time.perf_counter() - t1
                hdr = {"op": "storm", "rid": rid, "docs": [
                    [names[d], ids[d][c], c0, ref, k]
                    for d, c, c0, ref, k in entries]}
                storm.submit_frame(
                    lambda p, rid=rid: acks.setdefault(rid, []).append(p),
                    hdr, memoryview(payload))
                submitted += sum(e[4] for e in entries)
            storm.flush()
        if device.type == "cuda":
            torch.cuda.synchronize()
        launches = {"map_fold": mfc.launches,
                    "sequencer_tick": seqc.launches}
        shapes = {"map_fold": dict(mfc.shapes),
                  "sequencer_tick": dict(seqc.shapes)}
    sample = np.linspace(0, docs - 1, 64).astype(int).tolist()
    return {
        "service": service, "storm": storm, "seq_host": seq_host,
        "merge_host": merge_host, "acks": acks, "submitted": submitted,
        "names": names, "launches": launches, "shapes": shapes,
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

    docs = DOCS
    script = make_script(7, docs, TICKS, K_MAP, FRAMES_PER_TICK)
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
    return out


def at_main_path_shapes(name: str, shapes: dict, checked: dict,
                        check_at) -> dict:
    """Hold a kernel against its plain version at every shape the main
    path launched it at that ``checked`` (the phase-3 result) did not
    cover. Returns the result at the shape with the most launches, with
    the largest error over every check."""
    results = {tuple(checked["shape"]): checked}
    for shape in shapes:
        if shape not in results:
            results[shape] = check_at(*shape)
    check(bool(shapes), f"no launch shapes recorded for {name}")
    top = max(shapes, key=lambda sh: shapes[sh])
    out = dict(results[top])
    out["max_abs_err"] = max(r["max_abs_err"] for r in results.values())
    return out


def trace_main_path(device) -> dict:
    """The main path's served ticks again under ``torch.profiler``: device
    busy ms (the summed self time of every CUDA event — kernels and
    copies, all on one stream) against the host's wall ms over the same
    ticks, and the device events that took the most time. The profiler
    slows the host, so the idle share is an upper bound."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    script = make_script(7, DOCS, TICKS, K_MAP, FRAMES_PER_TICK)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    run = serve(device, script, DOCS, ticks_ctx=lambda: prof)
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA")]
    busy: dict = {}
    for e in events:  # names cut to 60 characters; equal cuts add up
        busy[e.key[:60]] = busy.get(e.key[:60], 0.0) \
            + e.self_device_time_total / 1e3
    busy_ms = sum(busy.values())
    serve_ms = run["t_serve"] * 1e3
    top = sorted(busy.items(), key=lambda kv: -kv[1])[:6]
    out = {"serve_ms": serve_ms, "device_busy_ms": busy_ms,
           "idle_share": 1 - busy_ms / serve_ms if busy_ms else None,
           "top_device_ms": top}
    print("trace: " + json.dumps(out), flush=True)
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
    _build.build_all(["map_fold", "sequencer_tick"])
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"({_build.BUILD_DIR})", flush=True)

    fold = check_map_fold(device)
    deli = check_deli(device)
    path = main_path(device)
    shapes = path["shapes"]
    fold_main = at_main_path_shapes(
        "map_fold", shapes["map_fold"], fold,
        lambda b, k, s: check_map_fold(device, b, k, s))
    deli_main = at_main_path_shapes(
        "sequencer_tick", shapes["sequencer_tick"], deli,
        lambda b, k, c: check_deli(device, b, k, c, every_outcome=False))
    if "--trace" in sys.argv[1:]:
        trace_main_path(device)
    launches = path["launches"]
    kernels = [
        {"name": "map_fold", "route": "cuda",
         "source": "fluidframework_tpu_torch/csrc/map_fold.cu",
         "replaces": "fluidframework_tpu/ops/map_pallas.py:41",
         "launches": launches["map_fold"], **fold_main,
         "library_ms": None},
        {"name": "sequencer_tick", "route": "cuda",
         "source": "fluidframework_tpu_torch/csrc/sequencer_tick.cu",
         "replaces": "fluidframework_tpu/ops/sequencer_pallas.py:217",
         "launches": launches["sequencer_tick"], **deli_main,
         "library_ms": None,
         "at_K32": {key: deli[key] for key in
                    ("shape", "ms", "plain_ms", "bound_ms")}},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
