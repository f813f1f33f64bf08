"""Kill-and-recover chaos harness of the storm serving path — the proof
of the crash-consistency story, on the port's device.

The convergence guarantee (total order + deterministic rebase ⇒
byte-identical replicas) is only as strong as the ordering tier's
durability. This harness tests it the only honest way: it KILLS the
serving process (``os._exit`` via utils/faults.py crashpoints — no
atexit, no flushing) at the dangerous points of the serving loop,
restarts it over the same durable directory, lets the client resend its
unacked frames (at-least-once; the sequencer's clientSeq dedup absorbs
duplicates), and then diffs EVERY recovered plane against an
uninterrupted twin run of the same seeded workload:

* the per-document sequenced history (seq/cseq/ref/msn/type/contents),
* the converged map state of every storm channel,
* the sequencer checkpoint of every document (clients, cseqs, msn, …).

Two planes are excluded by design: op ``timestamp`` and client
``last_update`` record each submission's ARRIVAL clock — a retried tick
legitimately arrives later than the twin's single attempt.

The invariant on top of the diff: an op whose frame was ACKED in any
life must appear in the final history — acks are withheld until the WAL
fsync precisely so this can never fail.

Every serving life runs on ``--device`` (``cuda`` unless the caller asks
for ``cpu``). Run one scenario from the CLI::

    python -m fluidframework_tpu_torch.tools.chaos --workdir /tmp/chaos \\
        --kill-point wal.pre_fsync --kill-hits 2

or the full seeded matrix (every kill point × several seeds)::

    python -m fluidframework_tpu_torch.tools.chaos --workdir /tmp/chaos \\
        --matrix

Two fault classes run in-process, proven by direct assertion:

* :func:`run_fsync_failure` — WAL fsync failures: the circuit breaker
  opens (read-only, writes nacked retryable, acks withheld), half-open
  probes heal it, withheld acks drain, nothing acked is lost;
* :func:`run_poison_quarantine` — one doc's device state corrupted
  mid-serving: the sentinel quarantines exactly that doc, batch peers
  lose zero ticks, and readmission rebuilds it byte-identical from
  snapshot + WAL replay.

The reference harness's residency, mega-doc, cluster, QoS, history,
replication, read-replica, netsplit, overload and reconnect scenarios
need planes this package does not port; asking for one raises
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

#: Kill-point classes exercised by the matrix (see utils/faults.py for
#: where each fires).
KILL_POINTS = (
    "wal.pre_fsync",       # records appended, not fsynced
    "wal.post_fsync",      # durable, acks not yet released
    "storm.mid_tick",      # device state moved, nothing durable yet
    "storm.pre_ack",       # durable and drained, ack not yet pushed
    "snapshot.mid_upload",  # checkpoint chunks partially written
    "snapshot.pre_publish",  # checkpoint uploaded, head not flipped
)

#: Smoke subset (one per failure class: volatile-state loss, torn group
#: commit, torn checkpoint).
SMOKE_POINTS = ("storm.mid_tick", "wal.pre_fsync", "snapshot.pre_publish")

#: Overlap-window kill classes: the child serves PIPELINED (rounds step
#: through the un-forced flush path, so tick N's group fsync runs
#: concurrent with tick N+1's dispatch and acks lag the durable
#: watermark). N+1 dispatched while N's commit is in flight / results
#: read back before the record reached the writer / N durable and
#: acking while N+1 is still in flight.
OVERLAP_KILL_POINTS = ("storm.overlap_dispatch", "storm.readback_pre_wal",
                       "storm.overlap_fsynced")

_NOT_PORTED = ("the {} chaos scenario needs a plane this package does not "
               "port yet (ROADMAP Queue A 5)")


def _build_stack(data_dir: str, num_docs: int, device: str, **storm_kw):
    from ..server.durable_store import (
        DurableMessageBus,
        FileStateStore,
        GitSnapshotStore,
    )
    from ..server.kernel_host import KernelSequencerHost
    from ..server.merge_host import KernelMergeHost
    from ..server.routerlicious import RouterliciousService
    from ..server.storm import StormController

    seq_host = KernelSequencerHost(num_slots=2, initial_capacity=num_docs,
                                   device=device)
    merge_host = KernelMergeHost(flush_threshold=10**9, device=device)
    # Bus and store are the durable pair (deli checkpoints reference bus
    # offsets); the idle check is parked so no synthetic leaves perturb
    # the twin diff.
    service = RouterliciousService(
        bus=DurableMessageBus(os.path.join(data_dir, "bus")),
        store=FileStateStore(os.path.join(data_dir, "state")),
        merge_host=merge_host, batched_deli_host=seq_host,
        auto_pump=False, idle_check_interval=10**9)
    storm_kw.setdefault("flush_threshold_docs", 1)
    storm = StormController(
        service, seq_host, merge_host,
        spill_dir=os.path.join(data_dir, "spill"), durability="group",
        snapshots=GitSnapshotStore(os.path.join(data_dir, "git")),
        **storm_kw)
    return service, storm, seq_host, merge_host


def _tick_words(seed: int, round_no: int, doc_i: int, k: int,
                num_slots: int = 16):
    import numpy as np
    rng = np.random.default_rng([seed, round_no, doc_i])
    kinds = rng.choice([0, 0, 0, 1, 2], size=k).astype(np.uint32)
    slots = rng.integers(0, num_slots, k).astype(np.uint32)
    vals = rng.integers(0, 1 << 20, k).astype(np.uint32)
    return (kinds | (slots << 2) | (vals << 12)).astype(np.uint32)


def _digest(service, storm, seq_host, merge_host, docs: list[str]) -> dict:
    """Canonical serialization of every compared plane (see module doc
    for the two excluded arrival-clock planes)."""
    from ..protocol.codec import to_wire

    out: dict = {"docs": {}}
    for doc in docs:
        history = []
        for m in service.get_deltas(doc, 0):
            history.append([
                m.sequence_number, m.client_sequence_number,
                m.reference_sequence_number, m.minimum_sequence_number,
                int(m.type), m.client_id,
                json.dumps(to_wire(m.contents), sort_keys=True)])
        cp = dataclasses.asdict(seq_host.checkpoint(doc))
        cp.pop("log_offset", None)
        for client in cp["clients"]:
            client["last_update"] = 0  # arrival clock, not replica state
        out["docs"][doc] = {
            "history": history,
            "map": merge_host.map_entries(doc, storm.datastore,
                                          storm.channel),
            "sequencer": cp,
        }
    return out


def child_main(args) -> None:
    """One serving-process life. Protocol on stdout (parent parses):
    ``READY`` once serving can start, ``ACKED <round>`` per
    durably-acked workload round, ``DIGEST <json>`` before a clean
    exit. A planned crashpoint kill exits with faults.KILL_EXIT_CODE
    mid-stream."""
    from ..utils import faults

    docs = [f"chaos-doc-{i}" for i in range(args.docs)]
    service, storm, seq_host, merge_host = _build_stack(
        args.dir, args.docs, args.device)
    if args.resume_from is None:
        # Fresh life: joins + the genesis checkpoint (so every recovery
        # has a snapshot to restore — the harness arms kills only after).
        clients = {d: service.connect(d, lambda m: None).client_id
                   for d in docs}
        service.pump()
        storm.checkpoint()
        start = 0
        print("GENESIS", flush=True)
    else:
        info = storm.recover()
        assert info["restored_from"] is not None, "no snapshot to recover"
        # Client ids are deterministic: the durable client counter handed
        # them out join-order in the fresh life.
        clients = {d: f"client-{i + 1}" for i, d in enumerate(docs)}
        start = args.resume_from
    print("READY", flush=True)
    faults.arm()

    k = args.k
    # Pipelined serving (the overlap windows): rounds go through
    # submit_frame's un-forced threshold flush (threshold 1), so a tick
    # stays in flight while the next round stages and its ack drains at
    # a LATER round's watermark pass — ACKED lines lag by up to
    # pipeline_depth rounds and the final settle prints the rest.
    pipelined = bool(args.pipelined)
    pipe_acks: list = []
    printed: set[int] = set()

    def drain_ack_prints() -> None:
        for a in pipe_acks:
            if isinstance(a, dict) and a.get("error"):
                continue
            rid = a.get("rid")
            if isinstance(rid, int) and rid not in printed:
                printed.add(rid)
                print(f"ACKED {rid}", flush=True)
        pipe_acks.clear()

    for r in range(start, args.ticks):
        acks: list = []
        entries = [[d, clients[d], 1 + r * k, 1, k] for d in docs]
        payload = b"".join(
            _tick_words(args.seed, r, i, k).tobytes()
            for i in range(len(docs)))
        if pipelined:
            # flush_threshold_docs == 1: submit_frame runs the round
            # itself, un-forced — NO durability barrier here.
            storm.submit_frame(pipe_acks.append,
                               {"rid": r, "docs": entries},
                               memoryview(payload))
            drain_ack_prints()
        else:
            storm.submit_frame(acks.append, {"rid": r, "docs": entries},
                               memoryview(payload))
            storm.flush()
            if acks:
                print(f"ACKED {r}", flush=True)
        if (r + 1) % args.cp_every == 0:
            storm.checkpoint()
            if pipelined:
                drain_ack_prints()  # the checkpoint settle drained acks
    if pipelined:
        storm.flush()  # final settle: harvest + durability barrier
        drain_ack_prints()
    faults.disarm()
    digest = _digest(service, storm, seq_host, merge_host, docs)
    print("DIGEST " + json.dumps(digest, sort_keys=True), flush=True)


# -- parent (kill / restart / diff) -------------------------------------------


def _spawn_life(data_dir: str, seed: int, docs: int, k: int, ticks: int,
                cp_every: int, resume_from: int | None,
                kill_env: str | None, timeout: float, device: str,
                pipelined: bool = False) -> dict:
    cmd = [sys.executable, "-m", "fluidframework_tpu_torch.tools.chaos",
           "--child", "--dir", data_dir, "--seed", str(seed),
           "--docs", str(docs), "--k", str(k), "--ticks", str(ticks),
           "--cp-every", str(cp_every), "--device", device]
    if pipelined:
        cmd += ["--pipelined"]
    if resume_from is not None:
        cmd += ["--resume-from", str(resume_from)]
    env = dict(os.environ)
    env.pop("FFTPU_CRASHPOINT", None)
    if kill_env is not None:
        env["FFTPU_CRASHPOINT"] = kill_env
    # The child imports this package from the checkout it came from.
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=timeout, env=env)
    acked, digest = [], None
    for line in proc.stdout.splitlines():
        if line.startswith("ACKED "):
            acked.append(int(line.split()[1]))
        elif line.startswith("DIGEST "):
            digest = json.loads(line[len("DIGEST "):])
    return {"returncode": proc.returncode, "acked": acked,
            "digest": digest, "stderr": proc.stderr}


def run_chaos(workdir: str, kill_point: str, kill_hits: int = 1,
              seed: int = 0, docs: int = 2, k: int = 8, ticks: int = 5,
              cp_every: int = 2, timeout: float = 300.0,
              twin_digest: dict | None = None,
              pipelined: bool = False, device: str = "cuda",
              **not_ported) -> dict:
    """One scenario: a twin run, then a killed-and-recovered run, then
    the plane diff. Returns the report; raises AssertionError on any
    divergence or lost acked op. ``twin_digest`` lets callers share one
    twin across scenarios of the same configuration. ``pipelined``
    serves the child through the overlapped tick pipeline (the
    OVERLAP_KILL_POINTS scenarios) — and because the digest planes are
    pipelining-agnostic, an UNPIPELINED twin_digest may be shared in:
    equality then also proves pipelined ≡ barrier serving. Every life
    serves on ``device``."""
    from ..utils import faults

    for name, value in not_ported.items():
        if value not in (None, False, -1):
            raise NotImplementedError(_NOT_PORTED.format(name))
    cfg = dict(seed=seed, docs=docs, k=k, ticks=ticks, cp_every=cp_every,
               pipelined=pipelined, device=device)
    if twin_digest is None:
        twin = _spawn_life(os.path.join(workdir, "twin"), resume_from=None,
                           kill_env=None, timeout=timeout, **cfg)
        assert twin["returncode"] == 0, twin["stderr"]
        twin_digest = twin["digest"]

    chaos_dir = os.path.join(workdir, f"chaos-{kill_point}-{kill_hits}")
    acked: set[int] = set()
    lives = 0
    life = _spawn_life(chaos_dir, resume_from=None,
                       kill_env=f"{kill_point}:{kill_hits}",
                       timeout=timeout, **cfg)
    acked.update(life["acked"])
    lives += 1
    killed = life["returncode"] == faults.KILL_EXIT_CODE
    # Restart lives (no further kills) until a clean finish. The resend
    # window starts at the first round never durably acked.
    while life["returncode"] != 0:
        assert life["returncode"] == faults.KILL_EXIT_CODE, life["stderr"]
        resume = max(acked) + 1 if acked else 0
        life = _spawn_life(chaos_dir, resume_from=resume,
                           kill_env=None, timeout=timeout, **cfg)
        acked.update(life["acked"])
        lives += 1
        assert lives <= 8, "chaos run did not converge to a clean life"
    digest = life["digest"]

    report = {"kill_point": kill_point, "kill_hits": kill_hits,
              "killed": killed, "lives": lives,
              "acked_rounds": sorted(acked), **cfg}
    assert json.dumps(digest, sort_keys=True) == json.dumps(
        twin_digest, sort_keys=True), (
        f"recovered state diverged from the twin at {kill_point}:"
        f"{kill_hits}\n twin: {json.dumps(twin_digest, sort_keys=True)}\n"
        f"chaos: {json.dumps(digest, sort_keys=True)}")
    # No acked-durable op may be lost: every acked round's client seqs
    # must appear in the final history of every doc.
    from ..protocol.messages import MessageType
    for doc, planes in digest["docs"].items():
        cseqs = {h[1] for h in planes["history"]
                 if h[4] == int(MessageType.OPERATION)}
        for r in acked:
            # An ack with zero sequenced ops (dup resend) still covers
            # its round — the ops were sequenced by an earlier life.
            want = set(range(1 + r * k, 1 + (r + 1) * k))
            missing = want - cseqs
            assert not missing, (
                f"acked round {r} lost ops {sorted(missing)[:4]}… "
                f"for {doc}")
    report["twin_digest"] = twin_digest
    return report


def run_matrix(workdir: str, points=KILL_POINTS, seeds=(0, 1),
               hit_positions=(1, 2), **cfg) -> list[dict]:
    """The full randomized matrix: every kill point × seed × hit count.
    A kill plan that never fires (e.g. a snapshot point when the round
    count never reaches a checkpoint) still asserts twin equality."""
    reports = []
    twins: dict[tuple, dict] = {}
    for seed in seeds:
        for point in points:
            for hits in hit_positions:
                sub = os.path.join(workdir, f"s{seed}")
                report = run_chaos(
                    sub, point, kill_hits=hits, seed=seed,
                    twin_digest=twins.get((seed,)), **cfg)
                twins[(seed,)] = report["twin_digest"]
                reports.append(report)
    return reports


# -- in-process fault classes ---------------------------------------------------


def _build_overload_stack(data_dir: str | None, num_docs: int, device: str,
                          max_pending_docs: int | None = None,
                          snapshot: bool = False,
                          tick_threshold: int | None = None):
    """In-process storm stack: bounded tick ingress, group-commit WAL
    when ``data_dir`` is given, snapshots when asked (the quarantine
    readmit path needs them)."""
    from ..server.kernel_host import KernelSequencerHost
    from ..server.merge_host import KernelMergeHost
    from ..server.routerlicious import RouterliciousService
    from ..server.storm import StormController

    seq_host = KernelSequencerHost(num_slots=2, initial_capacity=num_docs,
                                   device=device)
    merge_host = KernelMergeHost(flush_threshold=10**9, device=device)
    kwargs: dict = {}
    if data_dir is not None:
        from ..server.durable_store import (
            DurableMessageBus,
            FileStateStore,
            GitSnapshotStore,
        )
        kwargs["bus"] = DurableMessageBus(os.path.join(data_dir, "bus"))
        kwargs["store"] = FileStateStore(os.path.join(data_dir, "state"))
        if snapshot:
            kwargs["snapshots"] = GitSnapshotStore(
                os.path.join(data_dir, "git"))
    service = RouterliciousService(
        merge_host=merge_host, batched_deli_host=seq_host,
        auto_pump=False, idle_check_interval=10**9, **kwargs)
    storm = StormController(
        service, seq_host, merge_host,
        flush_threshold_docs=(tick_threshold if tick_threshold is not None
                              else num_docs),
        spill_dir=(os.path.join(data_dir, "spill")
                   if data_dir is not None else None),
        durability="group" if data_dir is not None else None,
        snapshots=kwargs.get("snapshots"),
        max_pending_docs=max_pending_docs)
    return service, storm, seq_host, merge_host


def _join_docs(service, docs):
    clients = {d: service.connect(d, lambda m: None).client_id
               for d in docs}
    service.pump()
    return clients


def _setdel_words(seed: int, round_no: int, doc_i: int, k: int,
                  num_slots: int = 16):
    """set/delete-only storm words (no clears): the poison scenario's
    workload — a clear op wipes every slot including a corrupted one, so
    a clear-bearing stream would wash the injected poison before the
    sentinel reads it."""
    import numpy as np
    rng = np.random.default_rng([seed, round_no, doc_i, 7])
    kinds = rng.choice([0, 0, 0, 1], size=k).astype(np.uint32)
    slots = rng.integers(0, num_slots, k).astype(np.uint32)
    vals = rng.integers(0, 1 << 20, k).astype(np.uint32)
    return (kinds | (slots << 2) | (vals << 12)).astype(np.uint32)


def _submit_round(storm, docs, clients, cseqs, seed, round_no, k,
                  sink, advance: bool = True,
                  words_fn=_tick_words) -> None:
    """One frame per doc. ``advance=False`` submits WITHOUT advancing the
    client seqs."""
    for i, d in enumerate(docs):
        words = words_fn(seed, round_no, i, k)
        storm.submit_frame(
            sink, {"rid": (round_no, d),
                   "docs": [[d, clients[d], cseqs[d], 1, k]]},
            memoryview(words.tobytes()))
        if advance:
            cseqs[d] += k


def run_fsync_failure(workdir: str, num_docs: int = 4, k: int = 16,
                      rounds: int = 3, fail_times: int = 3,
                      seed: int = 0, timeout_s: float = 30.0,
                      device: str = "cuda") -> dict:
    """WAL-fsync-failure class: inject ``fail_times`` consecutive fsync
    failures mid-serving. The breaker must open (degraded read-only:
    writes nack retryable, acks stay withheld), half-open probes must
    heal it, the withheld acks must drain AFTER durability, and the
    final state must equal a no-fault twin's."""
    import time

    from ..utils import faults

    docs = [f"fs-doc-{i}" for i in range(num_docs)]

    def play(data_dir, inject: bool):
        service, storm, seq_host, merge_host = _build_overload_stack(
            data_dir, num_docs, device)
        storm._group_wal.breaker.cooldown_s = 0.02
        clients = _join_docs(service, docs)
        cseqs = {d: 1 for d in docs}
        acks: list = []
        nacks: list = []

        def sink(payload):
            (nacks if payload.get("error") else acks).append(payload)

        events = {}
        for r in range(rounds):
            _submit_round(storm, docs, clients, cseqs, seed, r, k, sink)
            storm.flush()
        assert len(acks) == rounds * num_docs  # healthy baseline
        if inject:
            faults.install_failure("wal.fsync", times=fail_times)
            faults.arm()
            acked_before = len(acks)
            _submit_round(storm, docs, clients, cseqs, seed, rounds, k,
                          sink)
            storm.flush()  # harvests; the WAL writer hits the failpoint
            deadline = time.monotonic() + timeout_s
            while not storm.wal_degraded and time.monotonic() < deadline:
                time.sleep(0.005)
            events["degraded_entered"] = storm.wal_degraded
            # The failed batch's acks are withheld (not durable) and new
            # writes shed with a retryable degraded nack.
            events["acks_withheld"] = len(acks) == acked_before
            _submit_round(storm, docs, clients, cseqs, seed, rounds + 1,
                          k, sink)
            events["degraded_nacks"] = [n for n in nacks
                                        if n["error"] == "degraded"]
            # Half-open probes heal the WAL, then a flush drains the
            # withheld acks — after their fsync, never before.
            deadline = time.monotonic() + timeout_s
            while storm.wal_degraded and time.monotonic() < deadline:
                time.sleep(0.005)
            events["healed"] = not storm.wal_degraded
            storm.flush()
            events["acks_after_heal"] = len(acks) - acked_before
            faults.clear()
            # The degraded-nacked round retries once healed (retryable
            # code + retry_after_s), so both runs converge.
            resend = {d: cseqs[d] - k for d in docs}
            for i, d in enumerate(docs):
                words = _tick_words(seed, rounds + 1, i, k)
                storm.submit_frame(
                    sink, {"rid": ("resend", d),
                           "docs": [[d, clients[d], resend[d], 1, k]]},
                    memoryview(words.tobytes()))
            storm.flush()
        else:
            for r in (rounds, rounds + 1):
                _submit_round(storm, docs, clients, cseqs, seed, r, k,
                              sink)
                storm.flush()
        digest = {d: {"map": merge_host.map_entries(d, storm.datastore,
                                                    storm.channel),
                      "history": [
                          [m.sequence_number, m.client_sequence_number]
                          for m in service.get_deltas(d, 0)]}
                  for d in docs}
        stats = dict(storm.stats)
        opens = storm._group_wal.breaker.stats["opens"]
        storm._group_wal.close()
        return digest, events, stats, opens

    twin_digest, _e, _s, _o = play(os.path.join(workdir, "twin"),
                                   inject=False)
    digest, events, stats, opens = play(os.path.join(workdir, "faulted"),
                                        inject=True)
    assert events["degraded_entered"], "breaker never opened"
    assert events["acks_withheld"], "ack released before durability"
    assert events["degraded_nacks"], "no degraded nack for writes"
    assert all(n.get("retryable") and n["retry_after_s"] > 0
               for n in events["degraded_nacks"])
    assert events["healed"], "half-open probes never healed the WAL"
    assert events["acks_after_heal"] >= num_docs, events
    assert opens >= 1
    assert stats["degraded_rejects"] >= num_docs
    assert digest == twin_digest, "post-heal state diverged from twin"
    return {"scenario": "fsync_failure", "events": {
        k_: v for k_, v in events.items() if k_ != "degraded_nacks"},
        "degraded_rejects": stats["degraded_rejects"],
        "breaker_opens": opens}


def run_poison_quarantine(workdir: str, num_docs: int = 4, k: int = 16,
                          rounds: int = 4, seed: int = 0,
                          device: str = "cuda") -> dict:
    """Poison-doc class: corrupt ONE doc's device map row mid-serving.
    The tick sentinel must quarantine exactly that doc, its in-flight ops
    must nack retryable, its batch peers must lose ZERO ticks (telemetry
    counters), and readmission must rebuild it byte-identical to an
    uninterrupted twin."""
    docs = [f"pq-doc-{i}" for i in range(num_docs)]
    poisoned = docs[0]

    def play(data_dir, inject: bool):
        service, storm, seq_host, merge_host = _build_overload_stack(
            data_dir, num_docs, device, snapshot=True)
        clients = _join_docs(service, docs)
        storm.checkpoint()  # genesis snapshot: the readmit rebuild source
        cseqs = {d: 1 for d in docs}
        acks: list = []
        nacks: list = []

        def sink(payload):
            (nacks if payload.get("error") else acks).append(payload)

        half = rounds // 2
        for r in range(half):
            _submit_round(storm, docs, clients, cseqs, seed, r, k, sink,
                          words_fn=_setdel_words)
            storm.flush()
        report = {}
        if inject:
            # Mid-serving poison: a drifted vseq on a present slot of the
            # doc's device map row (the corruption class the sentinel
            # watches for), written in place on the device, on a slot
            # outside the workload's range so no later LWW write masks it.
            row = storm._storm_map_row(poisoned)
            slot = storm.max_key_slots - 1
            xs = merge_host._xstate
            xs.present[row, slot] = True
            xs.vseq[row, slot] = 2**30
            ticks_before = dict(storm.doc_tick_counts)
            _submit_round(storm, docs, clients, cseqs, seed, half, k,
                          sink, words_fn=_setdel_words)
            storm.flush()
            assert poisoned in storm.quarantined, "sentinel missed"
            assert [d for d in docs if d in storm.quarantined] \
                == [poisoned], "blast radius exceeded one doc"
            flagged = [a for a in acks if a.get("quarantined")]
            assert flagged and all(a["quarantined"] == [poisoned]
                                   for a in flagged)
            # Frozen: further submits for the doc nack retryable; peers
            # keep serving at full rate.
            for r in range(half + 1, rounds):
                _submit_round(storm, docs, clients, cseqs, seed, r, k,
                              sink, words_fn=_setdel_words)
                storm.flush()
            qnacks = [n for n in nacks if n["error"] == "quarantined"]
            assert len(qnacks) == rounds - half - 1, qnacks
            assert all(n.get("retryable") and n["retry_after_s"] > 0
                       for n in qnacks)
            for d in docs[1:]:
                assert storm.doc_tick_counts[d] \
                    - ticks_before.get(d, 0) == rounds - half, d
            assert storm.doc_tick_counts[poisoned] \
                - ticks_before.get(poisoned, 0) == 1
            # Readmit: from-snapshot rebuild + per-doc WAL replay (the
            # controller self-verifies against the scalar fold), then the
            # nacked rounds resend and sequence normally.
            import time as _time
            readmit_start = _time.perf_counter()
            info = storm.readmit_doc(poisoned)
            report["readmit_ms"] = round(
                1000.0 * (_time.perf_counter() - readmit_start), 2)
            report["replayed_ticks"] = info["replayed_ticks"]
            for r in range(half + 1, rounds):
                words = _setdel_words(seed, r, 0, k)
                storm.submit_frame(
                    sink, {"rid": ("resend", r),
                           "docs": [[poisoned, clients[poisoned],
                                     1 + r * k, 1, k]]},
                    memoryview(words.tobytes()))
                storm.flush()
            assert not storm.quarantined
            report["stats"] = {s: storm.stats[s] for s in
                               ("quarantined_docs", "readmitted_docs")}
        else:
            for r in range(half, rounds):
                _submit_round(storm, docs, clients, cseqs, seed, r, k,
                              sink, words_fn=_setdel_words)
                storm.flush()
        digest = {d: merge_host.map_entries(d, storm.datastore,
                                            storm.channel) for d in docs}
        history = {d: [[m.sequence_number, m.client_sequence_number]
                       for m in service.get_deltas(d, 0)] for d in docs}
        if storm._group_wal is not None:
            storm._group_wal.close()
        return digest, history, report

    twin_digest, twin_history, _ = play(os.path.join(workdir, "twin"),
                                        inject=False)
    digest, history, report = play(os.path.join(workdir, "poisoned"),
                                   inject=True)
    # Byte-identical recovery: converged map AND sequenced history match
    # the uninterrupted twin for EVERY doc, the poisoned one included.
    assert digest == twin_digest, (digest, twin_digest)
    assert history == twin_history
    assert report["stats"] == {"quarantined_docs": 1,
                               "readmitted_docs": 1}
    return {"scenario": "poison_quarantine", **report}


def main(argv=None) -> None:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--child", action="store_true")
    parser.add_argument("--dir", default=None)
    parser.add_argument("--workdir", default=None)
    parser.add_argument("--device", default="cuda",
                        help="device every serving life runs on "
                             "(cuda, or cpu for the kernels' plain "
                             "versions)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--docs", type=int, default=2)
    parser.add_argument("--k", type=int, default=8)
    parser.add_argument("--ticks", type=int, default=5)
    parser.add_argument("--cp-every", type=int, default=2)
    parser.add_argument("--pipelined", action="store_true",
                        help="serve through the overlapped tick pipeline "
                             "(acks lag the durable watermark; the "
                             "OVERLAP_KILL_POINTS scenarios)")
    for flag in ("residency", "megadoc", "qos", "history", "replicas"):
        parser.add_argument(f"--{flag}", default=None,
                            help="not ported (ROADMAP Queue A 5)")
    for flag in ("cluster", "replication", "netsplit"):
        parser.add_argument(f"--{flag}", action="store_true",
                            help="not ported (ROADMAP Queue A 5)")
    parser.add_argument("--resume-from", type=int, default=None)
    parser.add_argument("--kill-point", default=None)
    parser.add_argument("--kill-hits", type=int, default=1)
    parser.add_argument("--matrix", action="store_true")
    args = parser.parse_args(argv)
    for flag in ("residency", "megadoc", "qos", "history", "replicas",
                 "cluster", "replication", "netsplit"):
        if getattr(args, flag):
            raise NotImplementedError(_NOT_PORTED.format(flag))
    if args.child:
        child_main(args)
        return
    assert args.workdir, "--workdir required"
    cfg = dict(docs=args.docs, k=args.k, ticks=args.ticks,
               cp_every=args.cp_every, device=args.device)
    if args.matrix:
        for r in run_matrix(args.workdir, **cfg):
            r.pop("twin_digest", None)
            print(json.dumps(r))
        return
    assert args.kill_point, "--kill-point or --matrix required"
    report = run_chaos(args.workdir, args.kill_point, args.kill_hits,
                       seed=args.seed, pipelined=args.pipelined, **cfg)
    report.pop("twin_digest", None)
    print(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
