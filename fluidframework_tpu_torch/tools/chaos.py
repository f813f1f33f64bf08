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

and :func:`run_overload` offers twice the bounded tick queue every
round: the overflow sheds as busy-nacks, every admitted round acks.

Six plane scenarios run as child lives like the storm kills:
``residency=N`` caps the device pool below the doc count so every round
crosses the hot/cold boundary (``RESIDENCY_KILL_POINTS``),
``megadoc=L`` serves one doc co-written by ``MEGADOC_WRITERS`` writers
through two promote → serve → demote cycles on L lanes
(``MEGADOC_KILL_POINTS``), ``qos=True`` serves three tenants, one at
10x, through the deficit scheduler against a tenant-blind twin
(``QOS_KILL_POINTS``), and ``history=True`` serves with a compacting
``HistoryPlane`` and one mid-run branch fork against a never-compacted
twin (``HISTORY_KILL_POINTS``), ``cluster=True`` serves a two-host
cluster that live-migrates one doc at round ``migrate_at`` against a
never-migrated twin (``MIGRATION_KILL_POINTS``), and
``replication=True`` serves the same cluster with a quorum-replicated
leader whose resumed life promotes a follower
(``REPLICATION_CHAOS_POINTS``).

The reference harness's read-replica, netsplit and reconnect scenarios
need planes this package does not port yet; asking for one raises
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

#: Residency kill classes: the child runs with a device pool capped BELOW
#: the doc count (``residency=`` in run_chaos), so every round demotes
#: the LRU doc and hydrates the cold one — each point fires
#: mid-transition.
RESIDENCY_KILL_POINTS = ("residency.mid_hydrate", "residency.mid_evict",
                         "residency.post_evict")

#: Mega-doc kill classes: the child serves ONE doc co-written by several
#: writers through the sequence-parallel tier (``megadoc=`` in run_chaos
#: promotes it onto N lanes after arming, so the promotion itself is
#: inside the kill window): promotion control journaled but lanes not
#: yet seeded / combiner advanced but the tick neither dispatched nor
#: journaled / demotion control journaled but the fold not yet applied.
MEGADOC_KILL_POINTS = ("megadoc.mid_promotion", "megadoc.mid_combine",
                       "megadoc.mid_demotion")

#: Writers co-editing the one mega doc in the megadoc child mode.
MEGADOC_WRITERS = 4

#: Multi-tenant QoS kill classes: mid-composition (the deficit scheduler
#: charged, the tick neither dispatched nor journaled), mid-tick (device
#: state moved, nothing durable), and pre-fsync (records appended, not
#: durable). The TWIN is tenant-BLIND (same frames, one tenant, no
#: weights, no budget): digest equality proves kill-recovery AND that
#: fair composition never changes converged replica state — fairness
#: moves latency, never bytes.
QOS_KILL_POINTS = ("storm.qos_mid_compose", "storm.mid_tick",
                   "wal.pre_fsync")

#: QoS-child tenants; the first is the abuser (10x doc groups).
QOS_TENANTS = ("tn-abuser", "tn-b", "tn-c")
QOS_ABUSE_FACTOR = 10

#: History-plane kill classes: the child serves with a HistoryPlane
#: compacting aggressively (summaries every ~2 rounds, tail retention 1 —
#: trims fire) and forks ONE branch mid-run whose seeded writer keeps
#: co-serving. Each point kills a distinct window: summary uploaded but
#: head not flipped (the previous summary stays authoritative; the next
#: cadence re-compacts) / fork control journaled but the branch not yet
#: seeded (replay re-derives the identical seed) / records appended, not
#: fsynced. The TWIN attaches the same plane but NEVER compacts or trims,
#: so one digest equality proves kill-recovery AND
#: compaction-never-changes-state.
HISTORY_KILL_POINTS = ("history.mid_compaction", "history.mid_fork",
                       "wal.pre_fsync")

#: Deterministic writer identity seeded INTO the fork control record
#: (no bus-ordered join, so branch serving replays self-contained).
HISTORY_BRANCH_WRITER = "branch-writer"
HISTORY_BRANCH = "chaos-branch"

#: Live-migration kill classes: the child serves a TWO-HOST in-process
#: cluster (``cluster=`` in run_chaos — per-host WAL/bus/state over ONE
#: shared content-addressed store + durable placement directory) and
#: migrates one doc between hosts mid-workload (``migrate_at=``). Each
#: point kills one migration phase: intent durable but the source still
#: resident / doc evicted to the shared cold record with no owner
#: serving / target hydrated (volatile) but the directory not yet
#: flipped. Recovery rolls the migration FORWARD from the durable intent
#: and must reconverge byte-identical to a NEVER-MIGRATED twin with zero
#: acked-durable ops lost.
MIGRATION_KILL_POINTS = ("placement.pre_evict", "placement.post_evict",
                         "placement.post_hydrate")

#: Host labels of the in-process chaos cluster.
CLUSTER_HOSTS = ("hostA", "hostB")

#: Replication-plane kill classes: the child serves a two-host cluster
#: whose doc-0 genesis owner is a quorum-REPLICATED leader — every
#: fsynced WAL batch ships to two follower directories before acks
#: release, and every shared-store head flip rides the same plane —
#: while doc 0 live-migrates to the plain host mid-run. The kill lands
#: either side of the ship or inside the classic WAL/tick windows; a
#: RESUMED life is the FAILOVER PATH ITSELF — it never reopens the dead
#: leader's serving directory, it PROMOTES the most advanced follower,
#: bumps the directory incarnation, prints ``FAILOVER <blackout_ms>``,
#: and keeps serving under the same label. The twin is the same
#: replicated stack never killed and never migrated.
REPLICATION_CHAOS_POINTS = ("repl.pre_ship", "repl.post_ship",
                            "wal.pre_fsync", "storm.mid_tick")

#: Smoke point: batch shipped and quorum-acked, leader killed before
#: anything else — promotion must serve every acked op.
REPLICATION_SMOKE_POINT = "repl.post_ship"

#: Follower count behind the replicated chaos leader (F=2; the default
#: quorum is (F+1)//2 = 1 follower ack).
REPLICATION_FOLLOWERS = 2

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
    # Always attached: recovery of a WAL holding mega-doc control records
    # requires a manager, and an idle manager costs one None check per
    # hook.
    from ..server.megadoc import MegaDocManager
    MegaDocManager(storm, default_lanes=2)
    return service, storm, seq_host, merge_host


def _tick_words(seed: int, round_no: int, doc_i: int, k: int,
                num_slots: int = 16):
    import numpy as np
    rng = np.random.default_rng([seed, round_no, doc_i])
    kinds = rng.choice([0, 0, 0, 1, 2], size=k).astype(np.uint32)
    slots = rng.integers(0, num_slots, k).astype(np.uint32)
    vals = rng.integers(0, 1 << 20, k).astype(np.uint32)
    return (kinds | (slots << 2) | (vals << 12)).astype(np.uint32)


def _digest(service, storm, seq_host, merge_host, docs: list[str],
            residency=None) -> dict:
    """Canonical serialization of every compared plane (see module doc
    for the two excluded arrival-clock planes). With a residency tier
    attached, each doc hydrates just before its planes are read — a doc
    that finished the run cold must digest identically to one that
    stayed hot."""
    from ..protocol.codec import to_wire

    out: dict = {"docs": {}}
    for doc in docs:
        if residency is not None:
            residency.ensure_resident(doc, gate=False)
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


def _qos_docs(g: int) -> dict[str, list[str]]:
    """Tenant -> owned docs: the abuser owns ``QOS_ABUSE_FACTOR`` doc
    groups of ``g``, the victims one group each — so per round the
    abuser offers 10x the victims' doc slots."""
    out: dict[str, list[str]] = {}
    for ti, tenant in enumerate(QOS_TENANTS):
        groups = QOS_ABUSE_FACTOR if ti == 0 else 1
        out[tenant] = [f"chaos-{tenant}-{i}" for i in range(groups * g)]
    return out


def _qos_child(args) -> None:
    """One multi-tenant serving life (``--qos fair|blind``): three
    tenants, the first at 10x, one frame per doc group per round,
    settled by a forced flush whose budget-limited rounds step the
    deficit scheduler several times per workload round. ``fair`` runs
    the DRR composer (weights + tick slot budget); ``blind`` is the
    tenant-agnostic twin (every frame "default", no budget) — the
    digest surface is identical by design."""
    from ..utils import faults

    fair = args.qos == "fair"
    g = args.docs
    tenants = _qos_docs(g)
    all_docs = [d for docs in tenants.values() for d in docs]
    doc_index = {d: i for i, d in enumerate(all_docs)}
    storm_kw: dict = {"flush_threshold_docs": 10**9}
    if fair:
        storm_kw.update(
            tenant_weights={t: 1.0 for t in QOS_TENANTS},
            tick_slot_budget=2 * g)
    service, storm, seq_host, merge_host = _build_stack(
        args.dir, len(all_docs), args.device, **storm_kw)
    if args.resume_from is None:
        clients = {d: service.connect(d, lambda m: None).client_id
                   for d in all_docs}
        service.pump()
        storm.checkpoint()
        start = 0
        print("GENESIS", flush=True)
    else:
        info = storm.recover()
        assert info["restored_from"] is not None, "no snapshot to recover"
        clients = {d: f"client-{i + 1}" for i, d in enumerate(all_docs)}
        start = args.resume_from
    print("READY", flush=True)
    faults.arm()
    k = args.k
    for r in range(start, args.ticks):
        acks: list = []
        n_frames = 0
        for tenant, docs in tenants.items():
            for chunk0 in range(0, len(docs), g):
                chunk = docs[chunk0:chunk0 + g]
                entries = [[d, clients[d], 1 + r * k, 1, k]
                           for d in chunk]
                payload = b"".join(
                    _tick_words(args.seed, r, doc_index[d], k).tobytes()
                    for d in chunk)
                storm.submit_frame(
                    acks.append, {"rid": (r, tenant, chunk0),
                                  "docs": entries},
                    memoryview(payload),
                    tenant_id=tenant if fair else "default")
                n_frames += 1
        # The settle: budget-limited composition rounds drain the
        # per-tenant queues (several ticks per workload round in the
        # fair arm — the scheduler state moves between them, which is
        # what the mid-compose kill window exercises).
        storm.flush()
        ok = [a for a in acks
              if not (isinstance(a, dict) and a.get("error"))]
        if len(ok) == n_frames:
            print(f"ACKED {r}", flush=True)
        if (r + 1) % args.cp_every == 0:
            storm.checkpoint()
    faults.disarm()
    digest = _digest(service, storm, seq_host, merge_host, all_docs)
    print("DIGEST " + json.dumps(digest, sort_keys=True), flush=True)


def _history_digest(service, storm, seq_host, merge_host, hist,
                    docs: list[str]) -> dict:
    """The history twin-diff surface: compaction-INVARIANT planes only
    — converged map, sequencer checkpoint (minus arrival clocks), the
    history plane's own read_at at head, and the branch registry. The
    full per-op history is deliberately absent: the compacting arm
    trimmed its tail prefix by design (a summary is a rollup), so the
    digest compares exactly what compaction promises to preserve."""
    out: dict = {"docs": {}, "branches": hist.export_state()}
    for doc in docs:
        cp = dataclasses.asdict(seq_host.checkpoint(doc))
        cp.pop("log_offset", None)
        for client in cp["clients"]:
            client["last_update"] = 0  # arrival clock, not replica state
        head = hist.head_seq(doc)
        out["docs"][doc] = {
            "map": merge_host.map_entries(doc, storm.datastore,
                                          storm.channel),
            "sequencer": cp,
            "read_at_head": hist.read_at(doc, head),
        }
    return out


def _history_child(args) -> None:
    """One history-plane serving life (``--history compact|plain``):
    per-doc frames per round, a mid-run branch fork (seeded writer
    co-serves from the fork round on), and — in the ``compact`` arm —
    the background summarizer rolling every ~2 rounds with tail
    retention 1 (trims fire under the checkpoint watermark). ``plain``
    is the never-compacted differential twin."""
    from ..server.history import HistoryPlane
    from ..utils import faults

    compact = args.history == "compact"
    docs = [f"chaos-doc-{i}" for i in range(args.docs)]
    service, storm, seq_host, merge_host = _build_stack(
        args.dir, args.docs + 1, args.device)
    hist = HistoryPlane(
        storm,
        summary_interval_ops=2 * args.k if compact else None,
        tail_retention_summaries=1 if compact else None,
        compact_check_every=1, trim_batch_ticks=1)
    if args.resume_from is None:
        clients = {d: service.connect(d, lambda m: None).client_id
                   for d in docs}
        service.pump()
        storm.checkpoint()
        start = 0
        print("GENESIS", flush=True)
    else:
        info = storm.recover()
        assert info["restored_from"] is not None, "no snapshot to recover"
        clients = {d: f"client-{i + 1}" for i, d in enumerate(docs)}
        start = args.resume_from
    print("READY", flush=True)
    faults.arm()
    k = args.k
    fork_at = max(1, args.ticks // 2)
    # doc 0's seq at the START of round fork_at: join at 1, k ops/round.
    fork_seq = 1 + fork_at * k
    for r in range(start, args.ticks):
        if r >= fork_at and HISTORY_BRANCH not in hist.branches:
            # Fresh fork, or a re-fork after a kill that lost the
            # unfsynced control — same seq, same derived seed.
            hist.fork(docs[0], fork_seq, name=HISTORY_BRANCH,
                      writer=HISTORY_BRANCH_WRITER)
        acks: list = []
        n_frames = 0
        for i, d in enumerate(docs):
            payload = _tick_words(args.seed, r, i, k).tobytes()
            storm.submit_frame(
                acks.append,
                {"rid": (r, d),
                 "docs": [[d, clients[d], 1 + r * k, 1, k]]},
                memoryview(payload))
            n_frames += 1
        if r >= fork_at:
            rb = r - fork_at
            payload = _tick_words(args.seed, 1000 + r, 0, k).tobytes()
            storm.submit_frame(
                acks.append,
                {"rid": (r, HISTORY_BRANCH),
                 "docs": [[HISTORY_BRANCH, HISTORY_BRANCH_WRITER,
                           1 + rb * k, fork_seq, k]]},
                memoryview(payload))
            n_frames += 1
        storm.flush()
        ok = [a for a in acks
              if not (isinstance(a, dict) and a.get("error"))]
        if len(ok) == n_frames:
            print(f"ACKED {r}", flush=True)
        if (r + 1) % args.cp_every == 0:
            storm.checkpoint()
    faults.disarm()
    digest = _history_digest(service, storm, seq_host, merge_host, hist,
                             docs + [HISTORY_BRANCH])
    print("DIGEST " + json.dumps(digest, sort_keys=True), flush=True)


def _build_cluster(data_dir: str, num_docs: int, device: str):
    """Two in-process serving hosts over one shared snapshot store +
    durable placement directory, each on ``device``."""
    from ..parallel.placement import make_cluster_host
    from ..server.durable_store import GitSnapshotStore
    from ..server.megadoc import MegaDocManager

    git = GitSnapshotStore(os.path.join(data_dir, "git"))
    hosts = {}
    for label in CLUSTER_HOSTS:
        storm = make_cluster_host(label, os.path.join(data_dir, label),
                                  git, num_docs=num_docs, device=device)
        MegaDocManager(storm, default_lanes=2)
        hosts[label] = storm
    return git, hosts


def _cluster_clients(cluster, docs: list[str],
                     connect: bool) -> dict[str, str]:
    """Deterministic doc->client-id map: docs connect to their GENESIS
    owner in doc order, so each host's durable client counter hands out
    the same ids in every life — a later migration moves the sequencer
    row (client identities ride it), never the id assignment."""
    per_host_count: dict[str, int] = {}
    clients: dict[str, str] = {}
    for d in docs:
        owner = cluster.directory.genesis_owner(d)
        per_host_count[owner] = per_host_count.get(owner, 0) + 1
        if connect:
            storm = cluster.hosts[owner]
            clients[d] = storm.service.connect(d, lambda m: None).client_id
        else:
            clients[d] = f"client-{per_host_count[owner]}"
    return clients


def _cluster_digest(cluster, docs: list[str]) -> dict:
    """The cluster twin-diff surface: per doc, the MERGED cross-host
    history (each host serves its own WAL segment of a migrated doc)
    plus the owning host's map row + sequencer checkpoint — placement-
    agnostic by construction, so a migrated run must digest identical
    to a never-migrated twin."""
    from ..protocol.codec import to_wire

    out: dict = {"docs": {}}
    for doc in docs:
        owner = cluster.owner_of(doc)
        storm = cluster.hosts[owner]
        storm.residency.ensure_resident(doc, gate=False)
        history = []
        for m in cluster.get_deltas(doc, 0):
            history.append([
                m.sequence_number, m.client_sequence_number,
                m.reference_sequence_number, m.minimum_sequence_number,
                int(m.type), m.client_id,
                json.dumps(to_wire(m.contents), sort_keys=True)])
        cp = dataclasses.asdict(storm.seq_host.checkpoint(doc))
        cp.pop("log_offset", None)
        for client in cp["clients"]:
            client["last_update"] = 0  # arrival clock, not replica state
        out["docs"][doc] = {
            "history": history,
            "map": storm.merge_host.map_entries(doc, storm.datastore,
                                                storm.channel),
            "sequencer": cp,
        }
    return out


def _cluster_rounds(args, cluster, docs, clients, start, migrate) -> None:
    """The cluster children's workload: per round, one frame per doc to
    its owner through the live directory, ``migrate()`` first at round
    ``migrate_at`` (the scripted live migration), a checkpoint of every
    host every ``cp_every`` rounds."""
    k = args.k
    for r in range(start, args.ticks):
        if r == args.migrate_at:
            migrate()
        acks: list = []
        for i, d in enumerate(docs):
            payload = _tick_words(args.seed, r, i, k).tobytes()
            storm = cluster.hosts[cluster.owner_of(d)]
            storm.submit_frame(
                acks.append,
                {"rid": r * len(docs) + i,
                 "docs": [[d, clients[d], 1 + r * k, 1, k]]},
                memoryview(payload))
            storm.flush()
        ok = [a for a in acks
              if not (isinstance(a, dict) and a.get("error"))]
        if len(ok) == len(docs):
            print(f"ACKED {r}", flush=True)
        if (r + 1) % args.cp_every == 0:
            for storm in cluster.hosts.values():
                storm.checkpoint()


def _cluster_child(args) -> None:
    """One cluster serving life: two hosts, per-doc frames routed by the
    live directory, ONE scripted migration of doc 0 to the other host at
    round ``migrate_at`` (-1 = never — the differential twin). Kill plans
    land inside the migration phases; a resumed life rolls any durable
    intent forward before serving."""
    from ..parallel.placement import StormCluster
    from ..utils import faults

    docs = [f"chaos-doc-{i}" for i in range(args.docs)]
    git, hosts = _build_cluster(args.dir, args.docs, args.device)
    if args.resume_from is None:
        cluster = StormCluster(hosts, git)
        clients = _cluster_clients(cluster, docs, connect=True)
        for storm in hosts.values():
            storm.service.pump()
            storm.checkpoint()
        start = 0
        print("GENESIS", flush=True)
    else:
        for storm in hosts.values():
            storm.recover()
        cluster = StormCluster(hosts, git)  # directory loads from store
        cluster.recover()  # roll forward any durable migration intent
        clients = _cluster_clients(cluster, docs, connect=False)
        start = args.resume_from
    print("READY", flush=True)
    faults.arm()
    genesis_owner = cluster.directory.genesis_owner(docs[0])
    target = next(h for h in CLUSTER_HOSTS if h != genesis_owner)

    def migrate() -> None:
        # The scripted live migration (skipped in resumed lives where
        # recovery already rolled it forward).
        if cluster.owner_of(docs[0]) == genesis_owner:
            cluster.migrate(docs[0], target)
    _cluster_rounds(args, cluster, docs, clients, start, migrate)
    faults.disarm()
    digest = _cluster_digest(cluster, docs)
    print("DIGEST " + json.dumps(digest, sort_keys=True), flush=True)


def _replication_digest(cluster, docs: list[str]) -> dict:
    """The replication twin-diff surface: the cluster digest with
    history filtered to OPERATION rows. Join rows live in each host's
    bus tier, which is NOT on the replicated plane (only WAL batches and
    head flips ship) — a promoted follower reproduces every sequenced
    op, map plane and sequencer row from the replica log + journaled
    heads, but not the dead leader's bus-tier join records."""
    from ..protocol.messages import MessageType

    digest = _cluster_digest(cluster, docs)
    op = int(MessageType.OPERATION)
    for planes in digest["docs"].values():
        planes["history"] = [h for h in planes["history"] if h[4] == op]
    return digest


def _replication_child(args) -> None:
    """One replicated-cluster serving life: the doc-0 genesis owner is a
    quorum-replicated leader over ``REPLICATION_FOLLOWERS`` follower
    directories, the other host is plain, and doc 0 live-migrates at
    round ``migrate_at`` (-1 = never — the differential twin). A resumed
    life IS the failover: it promotes the most advanced follower instead
    of reopening the dead leader's directory, and prints ``FAILOVER
    <blackout_ms>``. Every host serves on ``device``."""
    import zlib

    from ..parallel.placement import StormCluster, make_cluster_host
    from ..server.durable_store import GitSnapshotStore
    from ..server.replication import (
        ReplicaNode,
        ReplicatedHeadStore,
        make_replicated_host,
        promote,
    )
    from ..utils import faults

    docs = [f"chaos-doc-{i}" for i in range(args.docs)]
    labels = sorted(CLUSTER_HOSTS)
    leader = labels[zlib.crc32(docs[0].encode()) % len(labels)]
    other = next(h for h in CLUSTER_HOSTS if h != leader)
    git = GitSnapshotStore(os.path.join(args.dir, "git"))
    state_path = os.path.join(args.dir, "repl_state.json")
    if args.resume_from is None:
        f_dirs = [os.path.join(args.dir, f"f{i + 1}")
                  for i in range(REPLICATION_FOLLOWERS)]
        leader_storm, plane = make_replicated_host(
            leader, os.path.join(args.dir, leader), git, f_dirs,
            num_docs=args.docs, device=args.device)
        other_storm = make_cluster_host(
            other, os.path.join(args.dir, other), git, num_docs=args.docs,
            device=args.device)
        cluster = StormCluster({leader: leader_storm, other: other_storm},
                               ReplicatedHeadStore(git, plane))
        clients = _cluster_clients(cluster, docs, connect=True)
        for storm in cluster.hosts.values():
            storm.service.pump()
            storm.checkpoint()
        with open(state_path, "w") as fh:
            json.dump({"followers": f_dirs,
                       "next_id": REPLICATION_FOLLOWERS + 1}, fh)
        start = 0
        print("GENESIS", flush=True)
    else:
        # Failover life: the dead leader's serving directory is NEVER
        # reopened (its volatile state is the thing the kill lost) — the
        # most advanced follower promotes under the same label, a fresh
        # follower directory replaces it in the plane, and the survivor
        # host recovers normally.
        with open(state_path) as fh:
            st = json.load(fh)
        other_storm = make_cluster_host(
            other, os.path.join(args.dir, other), git, num_docs=args.docs,
            device=args.device)
        other_storm.recover()
        nodes = [ReplicaNode(d) for d in st["followers"]]
        fresh = os.path.join(args.dir, f"f{st['next_id']}")
        leader_storm, plane, rep = promote(
            leader, nodes, git, follower_dirs=[fresh],
            num_docs=args.docs, device=args.device)
        cluster = StormCluster({leader: leader_storm, other: other_storm},
                               ReplicatedHeadStore(git, plane))
        cluster.recover()  # roll forward any durable migration intent
        cluster.fail_over(leader, leader_storm,
                          blackout_ms=rep["blackout_ms"])
        remaining = [d for d in st["followers"]
                     if os.path.basename(d) != rep["promoted_node"]]
        with open(state_path, "w") as fh:
            json.dump({"followers": remaining + [fresh],
                       "next_id": st["next_id"] + 1}, fh)
        clients = _cluster_clients(cluster, docs, connect=False)
        start = args.resume_from
        print(f"FAILOVER {rep['blackout_ms']}", flush=True)
    print("READY", flush=True)
    faults.arm()

    def migrate() -> None:
        # The scripted live migration off the replicated leader (skipped
        # in resumed lives where recovery already rolled it forward): its
        # directory head flip rides the quorum.
        if cluster.owner_of(docs[0]) == leader:
            cluster.migrate(docs[0], other)
    _cluster_rounds(args, cluster, docs, clients, start, migrate)
    faults.disarm()
    digest = _replication_digest(cluster, docs)
    print("DIGEST " + json.dumps(digest, sort_keys=True), flush=True)


def child_main(args) -> None:
    """One serving-process life. Protocol on stdout (parent parses):
    ``READY`` once serving can start, ``ACKED <round>`` per
    durably-acked workload round, ``DIGEST <json>`` before a clean
    exit. A planned crashpoint kill exits with faults.KILL_EXIT_CODE
    mid-stream."""
    from ..utils import faults

    if getattr(args, "replication", False):
        _replication_child(args)
        return
    if getattr(args, "cluster", False):
        _cluster_child(args)
        return
    if getattr(args, "qos", None):
        _qos_child(args)
        return
    if getattr(args, "history", None):
        _history_child(args)
        return
    mega_lanes = getattr(args, "megadoc", None)
    docs = [f"chaos-doc-{i}" for i in range(args.docs)]
    service, storm, seq_host, merge_host = _build_stack(
        args.dir, args.docs, args.device)

    residency = None
    if args.residency:
        # Device pool capped below the doc count: every round's frame
        # against the round-robin cold doc forces an LRU eviction and a
        # hydration — the residency crashpoints fire mid-transition.
        # Deterministic tiering: idle eviction parked (capacity is the
        # only eviction trigger), hydration bucket effectively unmetered.
        from ..server.residency import ResidencyManager
        residency = ResidencyManager(storm, max_resident=args.residency,
                                     idle_evict_s=1e9,
                                     hydration_rate_per_s=1e9)

    writers: list[str] = []
    if args.resume_from is None:
        # Fresh life: joins + the genesis checkpoint (so every recovery
        # has a snapshot to restore — the harness arms kills only after).
        if mega_lanes:
            # One doc, several co-writers (the mega shape): every writer
            # joins the SAME doc; promotion happens after arm() so the
            # promotion window itself is killable.
            writers = [service.connect(docs[0], lambda m: None).client_id
                       for _ in range(MEGADOC_WRITERS)]
            clients = {}
        else:
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
        if mega_lanes:
            writers = [f"client-{i + 1}" for i in range(MEGADOC_WRITERS)]
            clients = {}
        else:
            clients = {d: f"client-{i + 1}" for i, d in enumerate(docs)}
        start = args.resume_from
    print("READY", flush=True)
    faults.arm()
    if mega_lanes:
        _megadoc_child_rounds(args, storm, docs[0], writers, start)
        faults.disarm()
        digest = _digest(service, storm, seq_host, merge_host, docs)
        print("DIGEST " + json.dumps(digest, sort_keys=True), flush=True)
        return

    k = args.k
    # Pipelined serving (the overlap windows): rounds go through
    # submit_frame's un-forced threshold flush (threshold 1), so a tick
    # stays in flight while the next round stages and its ack drains at
    # a LATER round's watermark pass — ACKED lines lag by up to
    # pipeline_depth rounds and the final settle prints the rest.
    pipelined = bool(args.pipelined)
    # A residency child serves per-doc frames through barrier flushes, so
    # "pipelined" would never exercise the overlap windows.
    assert not (pipelined and residency is not None), \
        "--pipelined and --residency cannot combine (the residency " \
        "workload serves through per-frame barriers)"
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
        if pipelined:
            entries = [[d, clients[d], 1 + r * k, 1, k] for d in docs]
            payload = b"".join(
                _tick_words(args.seed, r, i, k).tobytes()
                for i in range(len(docs)))
            # flush_threshold_docs == 1: submit_frame runs the round
            # itself, un-forced — NO durability barrier here.
            storm.submit_frame(pipe_acks.append,
                               {"rid": r, "docs": entries},
                               memoryview(payload))
            drain_ack_prints()
        elif residency is not None:
            # Per-doc frames so the residency gate sees each doc alone
            # (a whole-cohort frame could never fit the capped pool); the
            # round is ACKED only when EVERY doc's frame acked.
            for i, d in enumerate(docs):
                payload = _tick_words(args.seed, r, i, k).tobytes()
                storm.submit_frame(
                    acks.append,
                    {"rid": r * len(docs) + i,
                     "docs": [[d, clients[d], 1 + r * k, 1, k]]},
                    memoryview(payload))
                storm.flush()
            ok = [a for a in acks
                  if not (isinstance(a, dict) and a.get("error"))]
            if len(ok) == len(docs):
                print(f"ACKED {r}", flush=True)
        else:
            entries = [[d, clients[d], 1 + r * k, 1, k] for d in docs]
            payload = b"".join(
                _tick_words(args.seed, r, i, k).tobytes()
                for i in range(len(docs)))
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
    digest = _digest(service, storm, seq_host, merge_host, docs,
                     residency=residency)
    print("DIGEST " + json.dumps(digest, sort_keys=True), flush=True)


def _megadoc_child_rounds(args, storm, doc: str, writers: list[str],
                          start: int) -> None:
    """The mega-doc workload: TWO promotion cycles (promote → serve →
    demote → RE-promote into epoch 1 → serve → demote), one frame per
    writer per round (the lanes combine them into few ticks), with the
    final demote before the digest so every compared plane lives on the
    single-lane doc row. Lifecycle steps are keyed off the RECOVERED
    manager state (epoch + promoted flag), so a resumed life lands at
    the identical point whatever phase the kill hit. A round is ACKED
    only when every writer's frame durably acked."""
    mgr = storm.megadoc
    half = max(1, args.ticks // 2)
    k = args.k
    for r in range(start, args.ticks):
        st = mgr.docs.get(doc)
        if r < half:
            if st is None:
                mgr.promote(doc, lanes=args.megadoc)
        else:
            if st is not None and st.epoch == 0:
                if st.promoted:
                    mgr.demote(doc)
                mgr.promote(doc, lanes=args.megadoc)  # epoch 1
            elif st is None:
                mgr.promote(doc, lanes=args.megadoc)
        acks: list = []
        for w, client in enumerate(writers):
            payload = _tick_words(args.seed, r, w, k).tobytes()
            storm.submit_frame(
                acks.append,
                {"rid": r * len(writers) + w,
                 "docs": [[doc, client, 1 + r * k, 1, k]]},
                memoryview(payload))
        storm.flush()
        ok = [a for a in acks
              if not (isinstance(a, dict) and a.get("error"))]
        if len(ok) == len(writers):
            print(f"ACKED {r}", flush=True)
        if (r + 1) % args.cp_every == 0:
            storm.checkpoint()
    if mgr.is_promoted(doc):
        mgr.demote(doc)


# -- parent (kill / restart / diff) -------------------------------------------


def _spawn_life(data_dir: str, seed: int, docs: int, k: int, ticks: int,
                cp_every: int, resume_from: int | None,
                kill_env: str | None, timeout: float, device: str,
                pipelined: bool = False, residency: int | None = None,
                megadoc: int | None = None, qos: str | None = None,
                history: str | None = None, cluster: bool = False,
                replication: bool = False, migrate_at: int = -1) -> dict:
    cmd = [sys.executable, "-m", "fluidframework_tpu_torch.tools.chaos",
           "--child", "--dir", data_dir, "--seed", str(seed),
           "--docs", str(docs), "--k", str(k), "--ticks", str(ticks),
           "--cp-every", str(cp_every), "--device", device]
    if residency is not None:
        cmd += ["--residency", str(residency)]
    if pipelined:
        cmd += ["--pipelined"]
    if megadoc is not None:
        cmd += ["--megadoc", str(megadoc)]
    if qos is not None:
        cmd += ["--qos", qos]
    if history is not None:
        cmd += ["--history", history]
    if cluster:
        cmd += ["--cluster", "--migrate-at", str(migrate_at)]
    if replication:
        cmd += ["--replication", "--migrate-at", str(migrate_at)]
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
    acked, digest, failovers = [], None, []
    for line in proc.stdout.splitlines():
        if line.startswith("ACKED "):
            acked.append(int(line.split()[1]))
        elif line.startswith("FAILOVER "):
            failovers.append(float(line.split()[1]))
        elif line.startswith("DIGEST "):
            digest = json.loads(line[len("DIGEST "):])
    return {"returncode": proc.returncode, "acked": acked,
            "digest": digest, "failovers": failovers,
            "stderr": proc.stderr}


def run_chaos(workdir: str, kill_point: str, kill_hits: int = 1,
              seed: int = 0, docs: int = 2, k: int = 8, ticks: int = 5,
              cp_every: int = 2, timeout: float = 300.0,
              twin_digest: dict | None = None,
              residency: int | None = None,
              pipelined: bool = False,
              megadoc: int | None = None, device: str = "cuda",
              qos: bool = False, history: bool = False,
              cluster: bool = False, migrate_at: int | None = None,
              replication: bool = False, **not_ported) -> dict:
    """One scenario: a twin run, then a killed-and-recovered run, then
    the plane diff. Returns the report; raises AssertionError on any
    divergence or lost acked op. ``twin_digest`` lets callers share one
    twin across scenarios of the same configuration. ``residency`` caps
    the child's device pool BELOW ``docs`` so every round crosses the
    hot/cold boundary (the RESIDENCY_KILL_POINTS scenarios); ``megadoc``
    serves one co-written doc through two promotion cycles on that many
    lanes (the MEGADOC_KILL_POINTS scenarios); ``qos`` serves three
    tenants through the deficit scheduler against a tenant-blind twin (the
    QOS_KILL_POINTS scenarios); ``history`` serves with a compacting
    history plane and one branch fork against a never-compacted twin (the
    HISTORY_KILL_POINTS scenarios); ``cluster`` serves a two-host cluster
    with one scripted live migration (round ``migrate_at``, default
    mid-run — the MIGRATION_KILL_POINTS scenarios) against a twin that
    never migrates; ``replication`` serves the same cluster with a
    quorum-replicated leader whose resumed lives promote a follower (the
    REPLICATION_CHAOS_POINTS scenarios). ``pipelined`` serves the
    child through the overlapped tick pipeline (the OVERLAP_KILL_POINTS
    scenarios) — and because the digest planes are pipelining-agnostic,
    an UNPIPELINED twin_digest may be shared in: equality then also
    proves pipelined ≡ barrier serving. Every life serves on
    ``device``."""
    from ..utils import faults

    for name, value in not_ported.items():
        if value not in (None, False, -1):
            raise NotImplementedError(_NOT_PORTED.format(name))
    if pipelined and residency is not None:
        raise ValueError(
            "pipelined=True cannot combine with residency= (the "
            "residency workload serves through per-frame barriers, so "
            "the overlap windows would never be exercised)")
    if megadoc is not None and docs != 1:
        raise ValueError("megadoc= serves exactly ONE co-written doc")
    if cluster and (residency is not None or pipelined or megadoc):
        raise ValueError("cluster=True is its own scenario stack")
    if qos and (cluster or residency is not None or pipelined or megadoc):
        raise ValueError("qos=True is its own scenario stack")
    if history and (qos or cluster or residency is not None
                    or pipelined or megadoc):
        raise ValueError("history=True is its own scenario stack")
    if replication and (history or qos or cluster
                        or residency is not None or pipelined or megadoc):
        raise ValueError("replication=True is its own scenario stack")
    cfg = dict(seed=seed, docs=docs, k=k, ticks=ticks, cp_every=cp_every,
               residency=residency, pipelined=pipelined, megadoc=megadoc,
               device=device, qos="fair" if qos else None,
               history="compact" if history else None,
               cluster=cluster, replication=replication,
               migrate_at=(migrate_at if migrate_at is not None
                           else ticks // 2)
               if (cluster or replication) else -1)
    if twin_digest is None:
        # The qos twin is tenant-BLIND (same frames, no fairness); the
        # history twin is NEVER-compacted (same frames, same fork); the
        # cluster and replication twins NEVER migrate: digest equality
        # then ALSO proves fair composition (resp. summarization
        # compaction, live migration) never changes converged state.
        twin_cfg = dict(cfg, migrate_at=-1) if (cluster or replication) \
            else dict(cfg, qos="blind") if qos else (
                dict(cfg, history="plain") if history else cfg)
        twin = _spawn_life(os.path.join(workdir, "twin"), resume_from=None,
                           kill_env=None, timeout=timeout, **twin_cfg)
        assert twin["returncode"] == 0, twin["stderr"]
        twin_digest = twin["digest"]

    chaos_dir = os.path.join(workdir, f"chaos-{kill_point}-{kill_hits}")
    acked: set[int] = set()
    lives = 0
    failovers: list[float] = []
    life = _spawn_life(chaos_dir, resume_from=None,
                       kill_env=f"{kill_point}:{kill_hits}",
                       timeout=timeout, **cfg)
    acked.update(life["acked"])
    failovers.extend(life["failovers"])
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
        failovers.extend(life["failovers"])
        lives += 1
        assert lives <= 8, "chaos run did not converge to a clean life"
    digest = life["digest"]

    report = {"kill_point": kill_point, "kill_hits": kill_hits,
              "killed": killed, "lives": lives,
              "acked_rounds": sorted(acked), **cfg}
    if replication:
        # The failover path only runs when the kill actually fired: every
        # killed replication life must promote on restart, and each
        # promotion's blackout rides the report.
        assert len(failovers) == lives - 1, (failovers, lives)
        report["failover_blackouts_ms"] = failovers
    assert json.dumps(digest, sort_keys=True) == json.dumps(
        twin_digest, sort_keys=True), (
        f"recovered state diverged from the twin at {kill_point}:"
        f"{kill_hits}\n twin: {json.dumps(twin_digest, sort_keys=True)}\n"
        f"chaos: {json.dumps(digest, sort_keys=True)}")
    # No acked-durable op may be lost: every acked round's client seqs
    # must appear in the final history of every doc.
    from ..protocol.messages import MessageType
    if history:
        # The compacting arm's per-op prefix is trimmed BY DESIGN (the
        # summary is the rollup), so retention is proven on the
        # sequencer's per-client cseq watermarks instead: an acked
        # round's ops were absorbed iff the writer's cseq covers them
        # (their EFFECT is pinned by the twin-digest equality above).
        fork_at = max(1, ticks // 2)
        for doc, planes in digest["docs"].items():
            cseqs = {c["client_id"]: c["client_seq"]
                     for c in planes["sequencer"]["clients"]}
            for r in acked:
                if doc == HISTORY_BRANCH:
                    if r < fork_at:
                        continue
                    want = (r - fork_at + 1) * k
                    got = cseqs.get(HISTORY_BRANCH_WRITER, 0)
                else:
                    want = (r + 1) * k
                    got = max(cseqs.values(), default=0)
                assert got >= want, (
                    f"acked round {r} lost ops for {doc}: writer cseq "
                    f"{got} < {want}")
        report["twin_digest"] = twin_digest
        return report
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
    if megadoc is not None:
        # Per-WRITER retention (the co-writers share cseq ranges, so the
        # union check above cannot distinguish them): every acked round
        # covers every writer's batch — history rows carry client ids.
        doc0 = next(iter(digest["docs"]))
        per_client: dict[str, set[int]] = {}
        for h in digest["docs"][doc0]["history"]:
            if h[4] == int(MessageType.OPERATION):
                per_client.setdefault(h[5], set()).add(h[1])
        for r in acked:
            want = set(range(1 + r * k, 1 + (r + 1) * k))
            for w in range(MEGADOC_WRITERS):
                missing = want - per_client.get(f"client-{w + 1}", set())
                assert not missing, (
                    f"acked round {r} lost writer client-{w + 1} ops "
                    f"{sorted(missing)[:4]}…")
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


def run_overload(workdir: str, num_docs: int = 16, k: int = 32,
                 rounds: int = 12, seed: int = 0,
                 p99_factor: float | None = 2.0,
                 device: str = "cuda") -> dict:
    """Throttle-under-storm: offer 2x the bounded tick queue every round.
    The overflow sheds deterministically with busy-nacks carrying
    retry_after_s, the inbound queue never grows past its bound, every
    ADMITTED round acks durably, and the served cohorts' tick time stays
    within ``p99_factor`` of an unloaded twin."""
    import numpy as np

    docs = [f"ov-doc-{i}" for i in range(num_docs)]

    def play(data_dir, overload: bool):
        service, storm, seq_host, merge_host = _build_overload_stack(
            data_dir, num_docs, device, max_pending_docs=num_docs,
            tick_threshold=10**9)
        clients = _join_docs(service, docs)
        cseqs = {d: 1 for d in docs}
        acks: list = []
        nacks: list = []

        def sink(payload):
            (nacks if payload.get("error") else acks).append(payload)

        max_pending_seen = 0
        for r in range(rounds):
            # Admitted wave: exactly one cohort (fills the bound).
            _submit_round(storm, docs, clients, cseqs, seed, r, k, sink)
            max_pending_seen = max(max_pending_seen, storm._pending_docs)
            if overload:
                # Overflow wave: a second full cohort on top — 2x the
                # sustained capacity. Every frame must shed (bounded
                # queue), none may queue or stall the admitted wave.
                _submit_round(storm, docs, clients, cseqs, seed,
                              rounds + r, k, sink, advance=False)
                max_pending_seen = max(max_pending_seen,
                                       storm._pending_docs)
            storm.flush()
        report = {
            "acked_frames": len(acks),
            "shed_frames": len(nacks),
            "shed_frames_stat": storm.stats["shed_frames"],
            "shed_ops_stat": storm.stats["shed_ops"],
            "sequenced_ops": storm.stats["sequenced_ops"],
            "max_pending_seen": max_pending_seen,
            # Skip the first tick (kernel build and warm-up): the latency
            # bars compare steady-state serving.
            "tick_ms_p50": float(np.percentile(1000.0 * np.asarray(
                storm.tick_seconds[1:] or storm.tick_seconds), 50)),
            "tick_ms_p99": float(np.percentile(1000.0 * np.asarray(
                storm.tick_seconds[1:] or storm.tick_seconds), 99)),
            "durable_watermark": storm.durable_watermark,
            "nacks": nacks,
        }
        if storm._group_wal is not None:
            storm._group_wal.close()
        return report

    unloaded = play(os.path.join(workdir, "unloaded"), overload=False)
    loaded = play(os.path.join(workdir, "loaded"), overload=True)

    # Deterministic shed: the second wave is refused in full, as busy
    # nacks with a retry hint — never a silent drop, never queue growth.
    assert loaded["shed_frames"] == rounds * num_docs, loaded["shed_frames"]
    assert loaded["shed_frames"] == loaded["shed_frames_stat"]
    assert all(n["error"] == "busy" and n["retry_after_s"] > 0
               and n.get("retryable") for n in loaded["nacks"])
    assert loaded["max_pending_seen"] <= num_docs  # the bound held
    # Acked-durable progress never stalled: every admitted round's frames
    # acked, all sequenced, all under the durability watermark.
    assert loaded["acked_frames"] == rounds * num_docs
    assert loaded["sequenced_ops"] == unloaded["sequenced_ops"] \
        == rounds * num_docs * k
    assert loaded["durable_watermark"] == unloaded["durable_watermark"]
    report = {
        "scenario": "overload",
        "offered_x_capacity": 2.0,
        "shed_rate": loaded["shed_frames"]
        / (2.0 * rounds * num_docs),
        "tick_ms_p50_unloaded": unloaded["tick_ms_p50"],
        "tick_ms_p50_loaded": loaded["tick_ms_p50"],
        "tick_ms_p99_unloaded": unloaded["tick_ms_p99"],
        "tick_ms_p99_loaded": loaded["tick_ms_p99"],
        "acked_frames": loaded["acked_frames"],
        "shed_frames": loaded["shed_frames"],
    }
    if p99_factor is not None:
        # The factor bar holds on the MEDIAN (with ~rounds samples the
        # p99 is the max, one scheduler hiccup away from a false
        # failure); the p99 keeps an absolute stall guard.
        assert loaded["tick_ms_p50"] <= p99_factor * max(
            unloaded["tick_ms_p50"], 1.0), report
        assert loaded["tick_ms_p99"] <= max(
            10.0 * unloaded["tick_ms_p99"], 250.0), report
    return report


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
    parser.add_argument("--residency", type=int, default=None,
                        help="cap the device pool at N docs "
                             "(tiered hot/cold residency under test)")
    parser.add_argument("--megadoc", type=int, default=None,
                        help="serve ONE doc co-written by "
                             f"{MEGADOC_WRITERS} writers, promoted onto N "
                             "lanes (the MEGADOC_KILL_POINTS scenarios)")
    parser.add_argument("--qos", default=None, choices=("fair", "blind"),
                        help="child: serve three tenants, one at 10x, "
                             "through the deficit scheduler (fair) or "
                             "tenant-blind (the QOS_KILL_POINTS twin)")
    parser.add_argument("--history", default=None,
                        choices=("compact", "plain"),
                        help="child: serve with a HistoryPlane that "
                             "compacts and trims (compact) or never does "
                             "(plain), forking one branch mid-run (the "
                             "HISTORY_KILL_POINTS scenarios)")
    parser.add_argument("--cluster", action="store_true",
                        help="child: serve a two-host cluster that "
                             "live-migrates doc 0 at --migrate-at (the "
                             "MIGRATION_KILL_POINTS scenarios)")
    parser.add_argument("--replication", action="store_true",
                        help="child: serve the two-host cluster with a "
                             "quorum-replicated leader; a resumed life "
                             "promotes a follower (the "
                             "REPLICATION_CHAOS_POINTS scenarios)")
    parser.add_argument("--migrate-at", type=int, default=None,
                        help="round of the scripted migration (-1 = "
                             "never; default mid-run)")
    parser.add_argument("--replicas", default=None,
                        help="not ported (ROADMAP Queue A 5)")
    parser.add_argument("--netsplit", action="store_true",
                        help="not ported (ROADMAP Queue A 5)")
    parser.add_argument("--resume-from", type=int, default=None)
    parser.add_argument("--kill-point", default=None)
    parser.add_argument("--kill-hits", type=int, default=1)
    parser.add_argument("--matrix", action="store_true")
    args = parser.parse_args(argv)
    for flag in ("replicas", "netsplit"):
        if getattr(args, flag):
            raise NotImplementedError(_NOT_PORTED.format(flag))
    if args.child:
        child_main(args)
        return
    assert args.workdir, "--workdir required"
    cfg = dict(docs=args.docs, k=args.k, ticks=args.ticks,
               cp_every=args.cp_every, device=args.device,
               residency=args.residency, megadoc=args.megadoc,
               qos=args.qos is not None, history=args.history is not None,
               cluster=args.cluster, replication=args.replication,
               migrate_at=args.migrate_at)
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
