"""Multi-process cluster launcher: leader, followers and read
replicas as real OS subprocesses over localhost sockets.

The in-process cluster and replication tier run every host in one
interpreter, over a transport that can never time out. This launcher
puts them in separate processes:

* **Follower child** (``--serve-follower``): a bare
  :class:`~..server.replication.ReplicaNode` behind a
  :class:`~..server.transport.ReplicaServer` — own interpreter, own
  WAL directory on local disk, replication frames byte-for-byte over
  TCP. Prints ``READY <port>`` once listening.
* **Replica child** (``--serve-replica``): the same follower node
  plus a :class:`~..server.read_replica.ReadReplica` tailing it, with
  the read surface (``read_at``/``get_deltas``/``staleness``)
  registered as control verbs on the SAME socket — the
  ``ReplicaDirectory`` itself rides the shared snapshot store on
  local disk, so head flips reach the child through the store and
  reads come back over the wire.
* **Parent** (:func:`launch_cluster`): spawns the children, dials a
  :class:`~..server.transport.NetworkReplicaLink` per child
  (optionally wrapped in a :class:`FaultyTransport` built from a
  plan), builds the leader in-process over those links via
  ``make_replicated_host``, and arms the lease-based failure
  detector. The leader stays in process and on its device (the card
  unless ``device=`` asks for the CPU); the children see no card
  (``parallel.multihost.child_process_env``) — they only journal and
  fold on the host. :func:`promote_over_wire` fails over to the most
  advanced child: ``hello`` every survivor, shut the candidate child
  down (releasing its WAL), and promote over its directory with the
  remaining children as networked followers.

Subprocess hygiene: every spawn registers in a module-level registry;
:func:`reap_all` (atexit, and the port's test fixtures) terminates
anything still alive, so a failed test never orphans children.
"""

from __future__ import annotations

import argparse
import atexit
import json
import os
import select
import subprocess
import sys
import time

CHILD_READY_TIMEOUT_S = 30.0

_REGISTRY: list[subprocess.Popen] = []


def reap_all() -> int:
    """Terminate (then kill) every child this module ever spawned
    that is still alive. Idempotent; returns how many needed reaping."""
    reaped = 0
    while _REGISTRY:
        proc = _REGISTRY.pop()
        if proc.poll() is None:
            reaped += 1
            proc.terminate()
            try:
                proc.wait(2)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(10)
        if proc.stdout is not None:
            proc.stdout.close()
    return reaped


atexit.register(reap_all)


def _wait_ready(proc: subprocess.Popen, what: str) -> int:
    """Read child stdout lines until ``READY <port>``; raise with the
    captured output if the child dies or stalls first. The pipe is
    waited on with ``poll``, not ``select``: a parent holding 1,024 or
    more descriptors gets a pipe ``select`` refuses."""
    deadline = time.monotonic() + CHILD_READY_TIMEOUT_S
    seen: list[str] = []
    fd = proc.stdout.fileno()
    readable = select.poll()
    readable.register(fd, select.POLLIN)
    buf = b""
    while time.monotonic() < deadline:
        if b"\n" not in buf:
            if proc.poll() is not None and not buf:
                raise RuntimeError(
                    f"{what} exited {proc.returncode} before READY: "
                    f"{''.join(seen)!r}")
            if readable.poll(100):
                chunk = os.read(fd, 4096)
                if not chunk and proc.poll() is not None:
                    raise RuntimeError(
                        f"{what} closed stdout before READY: "
                        f"{''.join(seen)!r}")
                buf += chunk
            continue
        line, _, buf = buf.partition(b"\n")
        text = line.decode(errors="replace").strip()
        seen.append(text + "\n")
        if text.startswith("READY"):
            return int(text.split()[1])
    raise RuntimeError(f"{what} never printed READY: {''.join(seen)!r}")


class ClusterChild:
    """One launched subprocess: its Popen handle, listening port and
    data directory. ``shutdown`` is the graceful path (the control
    verb closes the node, releasing its WAL for promotion); ``kill``
    is the chaos path (SIGKILL, exactly what a host loss looks like)."""

    def __init__(self, kind: str, label: str, proc: subprocess.Popen,
                 port: int, data_dir: str) -> None:
        self.kind = kind
        self.label = label
        self.proc = proc
        self.port = port
        self.data_dir = data_dir

    @property
    def alive(self) -> bool:
        return self.proc.poll() is None

    def link(self, **kw):
        from ..server.transport import NetworkReplicaLink
        return NetworkReplicaLink(self.port, **kw)

    def shutdown(self, timeout_s: float = 10.0) -> None:
        """Graceful stop over the wire; falls back to terminate."""
        if not self.alive:
            return
        try:
            from ..server.transport import NetworkReplicaLink
            NetworkReplicaLink(self.port, retries=0,
                               call_timeout_s=2.0).control("shutdown")
        except Exception:
            pass
        try:
            self.proc.wait(timeout_s)
        except subprocess.TimeoutExpired:
            self.proc.terminate()
            self.proc.wait(10)

    def kill(self) -> None:
        """``kill -9`` — the real-process host-loss chaos primitive."""
        if self.alive:
            self.proc.kill()
            self.proc.wait(10)


def checkout_env(env: dict) -> dict:
    """``env`` with this package's checkout first on ``PYTHONPATH``: a
    child process imports the package from the checkout its parent came
    from, whatever its working directory."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return {**env, "PYTHONPATH": os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])}


def _spawn(cmd: list[str], kind: str, label: str,
           data_dir: str, env: dict | None = None) -> ClusterChild:
    from ..parallel.multihost import child_process_env
    child_env = checkout_env({**os.environ, **child_process_env()})
    child_env.update(env or {})
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, env=child_env)
    _REGISTRY.append(proc)
    port = _wait_ready(proc, f"{kind} {label}")
    return ClusterChild(kind, label, proc, port, data_dir)


def launch_follower(data_dir: str, label: str | None = None,
                    env: dict | None = None) -> ClusterChild:
    label = label or os.path.basename(data_dir)
    cmd = [sys.executable, "-m",
           "fluidframework_tpu_torch.tools.launch_cluster",
           "--serve-follower", "--dir", data_dir]
    return _spawn(cmd, "follower", label, data_dir, env)


def launch_replica(data_dir: str, snapshots_dir: str, label: str,
                   leader_label: str = "leader",
                   read_wait_s: float = 0.25,
                   env: dict | None = None) -> ClusterChild:
    cmd = [sys.executable, "-m",
           "fluidframework_tpu_torch.tools.launch_cluster",
           "--serve-replica", "--dir", data_dir,
           "--snapshots", snapshots_dir, "--label", label,
           "--leader-label", leader_label,
           "--read-wait-s", str(read_wait_s)]
    return _spawn(cmd, "replica", label, data_dir, env)


class LocalCluster:
    """A leader (in-process, it owns the devices) plus follower and
    read-replica CHILDREN over localhost sockets. ``plane.links[i]``
    is the wire to ``children[i]``; replica children are full
    followers (they journal the same durable WAL) that also serve the
    read surface as control verbs."""

    def __init__(self, storm, plane, store, children: list[ClusterChild],
                 workdir: str, label: str) -> None:
        self.storm = storm
        self.plane = plane
        self.store = store
        self.children = children
        self.workdir = workdir
        self.label = label

    @property
    def followers(self) -> list[ClusterChild]:
        return [c for c in self.children if c.kind == "follower"]

    @property
    def replicas(self) -> list[ClusterChild]:
        return [c for c in self.children if c.kind == "replica"]

    def link_to(self, child: ClusterChild):
        """The plane's live link to ``child`` (unwraps nothing — a
        FaultyTransport edge comes back as the wrapper, faults and
        all)."""
        for lk in self.plane.links:
            if getattr(lk, "address", (None, None))[1] == child.port:
                return lk
        raise KeyError(child.label)

    def close(self) -> None:
        self.plane.stop_failure_detector()
        for lk in self.plane.links:
            close = getattr(lk, "close", None)
            if close is not None:
                try:
                    close()
                except Exception:
                    pass
        for child in self.children:
            child.shutdown()
        reap_all()


def launch_cluster(workdir: str, followers: int = 1, replicas: int = 0,
                   label: str = "leader", num_docs: int = 8,
                   acks_required: int | None = None,
                   detector: bool = True,
                   hb_interval_s: float = 0.1, lease_s: float = 0.75,
                   park_max_s: float | None = None,
                   fault_plan: dict | None = None, seed: int = 0,
                   link_kw: dict | None = None,
                   **storm_kw) -> LocalCluster:
    """Spawn ``followers`` + ``replicas`` children, dial a link per
    child (wrapped in a seeded :class:`FaultyTransport` when a
    ``fault_plan`` names its edge), and build the replicated leader
    over the wire. Edges are named ``f0..``/``r0..`` for the plan."""
    from ..server.durable_store import GitSnapshotStore
    from ..server.replication import make_replicated_host
    from ..server.transport import FaultyTransport

    os.makedirs(workdir, exist_ok=True)
    store = GitSnapshotStore(os.path.join(workdir, "git"))
    children: list[ClusterChild] = []
    for i in range(followers):
        children.append(launch_follower(
            os.path.join(workdir, f"f{i}"), label=f"f{i}"))
    for i in range(replicas):
        children.append(launch_replica(
            os.path.join(workdir, f"r{i}"),
            os.path.join(workdir, "git"), label=f"r{i}",
            leader_label=label))
    links = []
    for child in children:
        lk = child.link(**(link_kw or {}))
        if fault_plan is not None:
            lk = FaultyTransport(lk, edge=child.label, seed=seed,
                                 plan=fault_plan)
        links.append(lk)
    storm, plane = make_replicated_host(
        label, os.path.join(workdir, label), store, links,
        acks_required=acks_required, num_docs=num_docs, **storm_kw)
    if park_max_s is not None:
        plane.park_max_s = park_max_s
    if detector:
        plane.start_failure_detector(interval_s=hb_interval_s,
                                     lease_s=lease_s)
    return LocalCluster(storm, plane, store, children, workdir, label)


def promote_over_wire(children: list[ClusterChild], shared_snapshots,
                      label: str = "leader", num_docs: int = 8,
                      acks_required: int | None = None,
                      **storm_kw) -> tuple:
    """Failover across real processes: ``hello`` every surviving
    child, pick the most advanced (longest log, freshest heads — the
    in-process :func:`choose_promotion_candidate` ordering), shut that
    child down so its WAL is released, and run the ordinary
    :func:`~..server.replication.promote` over its directory with the
    remaining children as networked followers. Returns
    ``(storm, plane, report)`` with the usual blackout report."""
    from ..server.replication import ReplicaNode, promote

    t0 = time.perf_counter()
    links = {c.label: c.link() for c in children if c.alive}
    if not links:
        raise RuntimeError("no surviving children to promote")
    best = max(children, key=lambda c: (
        links[c.label].log_len, links[c.label].max_hseq,
        links[c.label].node_id) if c.label in links else (-1, -1, ""))
    links.pop(best.label).close()
    best.shutdown()  # releases the WAL; the promoted storm owns it now
    candidate = ReplicaNode(best.data_dir)
    nodes = [candidate] + [links[c.label] for c in children
                           if c.label in links]
    storm, plane, report = promote(
        label, nodes, shared_snapshots, num_docs=num_docs,
        acks_required=acks_required, **storm_kw)
    report["blackout_ms"] = round(
        1000.0 * (time.perf_counter() - t0), 3)
    return storm, plane, report


# -- child mains ---------------------------------------------------------------


def _serve_follower(args) -> None:
    import asyncio

    from ..server.replication import ReplicaNode
    from ..server.transport import ReplicaServer

    node = ReplicaNode(args.dir)

    def _stats(_req: dict) -> dict:
        return {"ok": True, "len": node.log_len,
                "incarnation": node.incarnation, "stats": node.stats}

    async def main() -> None:
        server = ReplicaServer(node, port=args.port,
                               handlers={"stats": _stats})
        await server.start()
        print(f"READY {server.port}", flush=True)
        await server.serve_until_shutdown()

    asyncio.run(main())


def _serve_replica(args) -> None:
    import asyncio

    from ..protocol.codec import to_wire
    from ..server.durable_store import GitSnapshotStore
    from ..server.read_replica import ReadReplica, ReplicaRedirect
    from ..server.replication import ReplicaNode
    from ..server.transport import ReplicaServer

    node = ReplicaNode(args.dir)
    store = GitSnapshotStore(args.snapshots)
    rep = ReadReplica(node, store, args.label,
                      leader_label=args.leader_label,
                      read_wait_s=args.read_wait_s,
                      viewer_plane=False)

    def _guard(fn):
        def run(req: dict) -> dict:
            try:
                return {"ok": True, "result": fn(req)}
            except ReplicaRedirect as r:
                return {"ok": False, "redirect": True,
                        "moved_to": r.moved_to,
                        "retry_after_s": r.retry_after_s,
                        "error": str(r)}
        return run

    def _deltas(req: dict) -> list:
        msgs = rep.get_deltas(req["doc"], req.get("from_seq", 0),
                              req.get("to_seq"))
        return [[m.sequence_number, m.client_sequence_number,
                 m.reference_sequence_number,
                 m.minimum_sequence_number, int(m.type), m.client_id,
                 json.dumps(to_wire(m.contents), sort_keys=True)]
                for m in msgs]

    handlers = {
        "read_at": _guard(
            lambda req: rep.read_at(req["doc"], req["seq"])),
        "get_deltas": _guard(_deltas),
        "head_seq": _guard(lambda req: rep.head_seq(req["doc"])),
        "staleness": _guard(lambda req: rep.staleness()),
        "room_staleness": _guard(
            lambda req: rep.room_staleness(req["doc"],
                                           req.get("leader_seq"))),
        "poll": _guard(lambda req: rep.poll()),
    }

    async def main() -> None:
        server = ReplicaServer(node, port=args.port, handlers=handlers)
        await server.start()
        print(f"READY {server.port}", flush=True)
        await server.serve_until_shutdown()

    asyncio.run(main())


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(
        description="cluster child processes (see launch_cluster())")
    p.add_argument("--serve-follower", action="store_true")
    p.add_argument("--serve-replica", action="store_true")
    p.add_argument("--dir", help="node data directory")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--snapshots", help="shared snapshot store path")
    p.add_argument("--label", default="r0")
    p.add_argument("--leader-label", default="leader")
    p.add_argument("--read-wait-s", type=float, default=0.25)
    args = p.parse_args(argv)
    if args.serve_follower:
        _serve_follower(args)
    elif args.serve_replica:
        _serve_replica(args)
    else:
        p.error("pick --serve-follower or --serve-replica")


if __name__ == "__main__":
    main()
