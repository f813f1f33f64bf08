"""Seeded fault injection — named crashpoints on the durability paths.

The chaos harness (tools/chaos.py) proves the crash-consistency story by
actually killing the serving process at the points where a crash is
dangerous and diffing the recovered state against an uninterrupted twin.
The serving code declares those points by calling :func:`crashpoint`
with a stable name; a *plan* (installed from the environment or
programmatically) hard-kills the process — ``os._exit``, no atexit, no
buffer flushing, no destructors — at the N-th hit of one named point.

Registered points (grep for ``crashpoint(`` to audit):

==========================  ==================================================
``wal.pre_fsync``           group-commit writer: records appended, NOT yet
                            fsynced (the torn-batch window)
``wal.post_fsync``          records durable, completion callbacks / acks NOT
                            yet fired (durable-but-unacknowledged window)
``storm.mid_tick``          device state mutated by the fused tick, durable
                            record NOT yet enqueued (volatile-state window)
``storm.pre_ack``           durable record fsynced, ack NOT yet pushed
``storm.overlap_dispatch``  pipelined tick N+1 dispatched while tick N's
                            group commit may still be in flight (the
                            mid-overlap window: N replays byte-identically,
                            N+1 returns only via client resend)
``storm.readback_pre_wal``  tick results read back, durable record NOT yet
                            handed to the WAL writer (readback-before-fsync:
                            the whole tick is volatile, nothing acked)
``storm.overlap_fsynced``   tick N durable and about to ack while tick N+1
                            is still in flight (fsync-complete-before-
                            readback: N+1 must never be acked early)
``pool.mid_rebalance``      block merge pool mid-rebalance (layout moving)
``pool.mid_retune``         block geometry retune mid-move (whole-pool
                            re-block; the replayed retune must re-decide
                            the same geometry)
``snapshot.mid_upload``     snapshot chunks partially written
``snapshot.pre_publish``    snapshot uploaded, head ref NOT yet flipped
``residency.mid_hydrate``   cold-doc hydration mid-restore (sequencer row
                            installed, map row NOT yet) — volatile only
``residency.mid_evict``     cold snapshot uploaded, head ref NOT yet
                            flipped, device rows still live
``residency.post_evict``    cold head flipped, device rows NOT yet
                            released (doc durable both ways)
==========================  ==================================================

A plan is inert until :func:`arm` — the harness arms only after its
setup phase (joins, genesis checkpoint) so kills always land inside the
serving window under test. With no plan installed, :func:`crashpoint`
is one attribute load and a ``None`` check.

Environment protocol (used by the chaos child process)::

    FFTPU_CRASHPOINT="wal.pre_fsync:3"   # kill at the 3rd hit

``install_from_env()`` runs at import; the child calls ``arm()`` itself.

Besides kill plans there are *failure plans* — named :func:`failpoint`
hooks that RAISE an injected exception for the next N hits instead of
killing the process (the overload/robustness fault classes: a failing
fsync is survivable-by-design, a kill is not). Registered failpoints:

==========================  ==================================================
``wal.fsync``               group-commit writer, just before the batch fsync
                            (an injected OSError here drives the WAL circuit
                            breaker into its degraded/half-open cycle)
==========================  ==================================================

Environment protocol: ``FFTPU_FAILPOINT="wal.fsync:3"`` fails the next
3 hits, then heals. Failure plans share the :func:`arm` gate with kill
plans.

The third plan family is *link faults* — named network pathologies the
:class:`~..server.transport.FaultyTransport` wrapper injects per
replication edge (see ``server/transport.py``; the chaos ``--netsplit``
scenarios install them mid-run):

==================  ==========================================================
``drop`` (p)        per-call frame loss, nothing delivered
``delay`` (s, p)    added latency before delivery
``slow`` (s)        every call slowed (a saturated link)
``dup`` (p)         delivered twice — the idempotent-redelivery path
``reorder`` (p)     held past the next frame — a genuine out-of-order arrival
``partition``       full partition: every call fails, nothing delivered
``partition_send``  one-way: requests lost before the follower sees them
``partition_recv``  one-way: delivered, but the response is lost (the
                    leader retries — duplicate delivery for real)
==================  ==========================================================

Environment protocol (parsed by :func:`link_fault_plan_from_env`)::

    FFTPU_LINKFAULTS="f0:drop@p=0.2;f0:delay@s=0.01,p=0.5;f1:partition"
"""

from __future__ import annotations

import os
import sys

#: Exit status of a planned kill — distinguishes an injected crash from a
#: real failure in the parent harness (128 + SIGKILL, the conventional
#: "killed" status).
KILL_EXIT_CODE = 137

_plan: tuple[str, int] | None = None  # (point name, kill at N-th hit)
_armed = False
_hits = 0
#: Per-point fire counts while a plan is installed (tests introspect
#: these; the no-plan hot path never touches the dict).
fired: dict[str, int] = {}
#: Failure plans: point name -> remaining armed-hit count. Emptiness is
#: the hot-path gate (one dict truthiness check when nothing installed).
_fail_plans: dict[str, int] = {}


class InjectedFault(OSError):
    """The exception a :func:`failpoint` raises — an OSError subclass so
    injected fsync/IO failures travel the same except paths real ones do,
    while staying distinguishable in assertions."""


def install(point: str, hits: int = 1) -> None:
    """Install a kill plan: die at the ``hits``-th hit of ``point``."""
    global _plan, _hits
    if hits < 1:
        raise ValueError(f"hits must be >= 1, got {hits}")
    _plan = (point, hits)
    _hits = 0
    fired.clear()


def install_failure(point: str, times: int = 1) -> None:
    """Install a failure plan: the next ``times`` armed hits of ``point``
    raise :class:`InjectedFault`, then the point heals."""
    if times < 1:
        raise ValueError(f"times must be >= 1, got {times}")
    _fail_plans[point] = times


def install_from_env() -> None:
    spec = os.environ.get("FFTPU_CRASHPOINT")
    if spec:
        point, _, hits = spec.partition(":")
        install(point, int(hits) if hits else 1)
    spec = os.environ.get("FFTPU_FAILPOINT")
    if spec:
        point, _, times = spec.partition(":")
        install_failure(point, int(times) if times else 1)


def arm() -> None:
    global _armed
    _armed = True


def disarm() -> None:
    global _armed
    _armed = False


def clear() -> None:
    global _plan, _armed, _hits
    _plan, _armed, _hits = None, False, 0
    fired.clear()
    _fail_plans.clear()


def link_fault_plan_from_env(var: str = "FFTPU_LINKFAULTS") -> dict:
    """Parse a link-fault plan — ``{edge: {fault: params}}``, the shape
    ``server/transport.FaultyTransport`` installs from — out of the
    environment. Entries are ``;``-separated ``edge:fault[@k=v,...]``;
    parameter values parse as floats. Empty/missing env = empty plan."""
    plan: dict[str, dict] = {}
    for entry in filter(None, (e.strip() for e
                               in os.environ.get(var, "").split(";"))):
        edge, _, rest = entry.partition(":")
        fault, _, params = rest.partition("@")
        kw: dict[str, float] = {}
        for pair in filter(None, (s.strip() for s in params.split(","))):
            key, _, val = pair.partition("=")
            kw[key.strip()] = float(val)
        plan.setdefault(edge.strip(), {})[fault.strip()] = kw
    return plan


def crashpoint(name: str) -> None:
    """Declare a named kill point. No plan installed = near-free."""
    global _hits
    if _plan is None:
        return
    fired[name] = fired.get(name, 0) + 1
    if not _armed or name != _plan[0]:
        return
    _hits += 1
    if _hits >= _plan[1]:
        # A REAL crash: no cleanup, no flushing, no thread joins — the
        # recovery story must not depend on any graceful-shutdown path.
        sys.stderr.write(f"crashpoint {name} hit {_hits}: killing\n")
        sys.stderr.flush()
        os._exit(KILL_EXIT_CODE)


def failpoint(name: str) -> None:
    """Declare a named injectable failure. With an armed plan for
    ``name``, raises :class:`InjectedFault` and burns one planned hit;
    otherwise (the production path) it is one dict truthiness check."""
    if not _fail_plans:
        return
    fired[name] = fired.get(name, 0) + 1
    if not _armed:
        return
    remaining = _fail_plans.get(name)
    if remaining is None:
        return
    if remaining <= 1:
        del _fail_plans[name]
    else:
        _fail_plans[name] = remaining - 1
    raise InjectedFault(f"injected fault at {name}")


install_from_env()
