"""Service monitor — scrape and watch a running alfred's metrics.

Reference parity: server/service-monitor (the routerlicious monitoring
satellite) collapsed to its useful core: a poller that scrapes the
assembly's metrics registry through the front door (``get_metrics`` — the
alfred analog of a /metrics endpoint) and renders deltas, so an operator
can watch sequencing/broadcast/merge-host rates live. It also reads the
storm stage ledger: the per-stage histograms (``storm.stage.*``) render
as a live attribution bar — which hop of the serving tick eats the
budget — plus ``--json`` for the machine-readable line format.

Usage::

    python -m fluidframework_tpu_torch.tools.monitor --port 7070          # watch
    python -m fluidframework_tpu_torch.tools.monitor --port 7070 --json   # lines
    python -m fluidframework_tpu_torch.tools.monitor --port 7070 --once   # scrape
"""

from __future__ import annotations

import argparse
import json
import socket
import sys
import time

from ..protocol.codec import decode_body, encode_frame
from ..utils.metrics import STORM_STAGES


def scrape(host: str, port: int, timeout: float = 10.0) -> dict:
    """One metrics scrape over a fresh front-door socket."""
    with socket.create_connection((host, port), timeout=timeout) as sock:
        sock.sendall(encode_frame({"rid": 1, "op": "get_metrics"}))
        header = _recv_exactly(sock, 4)
        body = _recv_exactly(sock, int.from_bytes(header, "big"))
    resp = decode_body(body)
    if "error" in resp:
        raise RuntimeError(f"alfred error: {resp['error']}")
    return resp["metrics"]


def _recv_exactly(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("socket closed mid-frame")
        buf += chunk
    return buf


def stage_shares(metrics: dict,
                 prev: dict | None = None) -> dict[str, float]:
    """Per-stage share of attributed tick time from a metrics snapshot
    (the ``storm.stage.<name>.mean``/``.count`` histogram exports);
    empty when the scrape carries no stage ledger. With ``prev`` the
    shares cover only the time attributed SINCE that snapshot — the
    live window a watcher wants (cumulative shares stop moving as
    uptime grows); falls back to cumulative when the window saw no
    ticks."""
    def totals(snap):
        return {stage: snap.get(f"storm.stage.{stage}.mean", 0.0)
                * snap.get(f"storm.stage.{stage}.count", 0.0)
                for stage in STORM_STAGES}

    now_t = totals(metrics)
    if prev is not None:
        window = {s: now_t[s] - t for s, t in totals(prev).items()}
        # Any negative per-stage window means the service restarted
        # (registry reset) — the diff is meaningless, not just empty:
        # mixed signs could pass a sum>0 check and render shares
        # outside [0, 1]. Fall back to the fresh cumulative totals.
        if sum(window.values()) > 0 \
                and all(v >= 0 for v in window.values()):
            now_t = window
    grand = sum(now_t.values())
    if grand <= 0:
        return {}
    return {s: t / grand for s, t in now_t.items()}


def render_stage_bar(metrics: dict, width: int = 52,
                     prev: dict | None = None) -> str:
    """The live stage-attribution view: one proportional bar over the
    stage shares (windowed vs ``prev`` when given) plus a per-stage
    p50/p99 table (ms, cumulative histograms)."""
    shares = stage_shares(metrics, prev)
    if not shares:
        return "stage ledger: (no storm ticks yet)"
    glyphs = "#=+*o.:%~-"
    bar = ""
    legend = []
    for i, stage in enumerate(STORM_STAGES):
        share = shares.get(stage, 0.0)
        cells = int(round(share * width))
        g = glyphs[i % len(glyphs)]
        bar += g * cells
        p50 = metrics.get(f"storm.stage.{stage}.p50", 0.0) * 1e3
        p99 = metrics.get(f"storm.stage.{stage}.p99", 0.0) * 1e3
        legend.append(f"  {g} {stage:<16} {100 * share:5.1f}%"
                      f"  p50 {p50:8.3f}ms  p99 {p99:8.3f}ms")
    lines = [f"stage ledger  [{bar:<{width}}]"]
    lines.extend(legend)
    return "\n".join(lines)


def render_pipeline(metrics: dict, prev: dict | None = None) -> str:
    """Tick-pipelining line (the overlap plane): configured
    pipeline depth, wall-clock vs attributed stage time over the poll
    window, and the overlap share — how much concurrent stage time
    (tick N's WAL commit-wait under tick N+1's dispatch) the pipeline
    bought per unit of wall clock. Empty before any tick records a wall
    split (pre-r14 service, or no storm ticks yet)."""
    def totals(snap):
        wall = snap.get("storm.stage.wall.mean", 0.0) \
            * snap.get("storm.stage.wall.count", 0.0)
        att = sum(snap.get(f"storm.stage.{s}.mean", 0.0)
                  * snap.get(f"storm.stage.{s}.count", 0.0)
                  for s in STORM_STAGES)
        return wall, att, snap.get("storm.stage.wall.count", 0.0)

    wall, att, ticks = totals(metrics)
    if wall <= 0:
        return ""
    if prev is not None:
        p_wall, p_att, p_ticks = totals(prev)
        w_wall, w_att = wall - p_wall, att - p_att
        # Negative windows mean the service restarted (registry reset);
        # fall back to cumulative totals like the stage bar does.
        if w_wall > 0 and w_att >= 0:
            wall, att, ticks = w_wall, w_att, ticks - p_ticks
    overlap = max(0.0, att - wall)
    depth = metrics.get("storm.pipeline.depth", 0)
    return (f"pipeline: depth {depth:g}  wall {wall * 1e3:,.0f}ms  "
            f"attributed {att * 1e3:,.0f}ms  "
            f"overlap {overlap * 1e3:,.0f}ms "
            f"({100.0 * overlap / wall:.0f}% of wall)  ticks {ticks:g}")


def render_rebalance(metrics: dict, prev: dict | None = None) -> str:
    """Block-table maintenance line from the device kstats counters
    (``storm.device.rebalance_fired`` / ``blocks_touched`` — the
    rebalance-attribution plane) plus the merge-host pre-tick
    fires/retunes; empty when nothing has ever fired. The fire rate is
    fires per harvested tick over the window — the head-concentration
    signal geometry autotuning keys on."""
    fired = metrics.get("storm.device.rebalance_fired", 0)
    touched = metrics.get("storm.device.blocks_touched", 0)
    # Tick denominator: the stage ledger records one scatter split per
    # harvested tick, so its histogram count IS the tick count.
    ticks = metrics.get("storm.stage.scatter.count", 0)
    host_fires = metrics.get("merge.rebalance_fires", 0)
    retunes = metrics.get("merge.geometry_retunes", 0)
    if not (fired or host_fires or retunes):
        return ""
    if prev is not None:
        w_fired = fired - prev.get("storm.device.rebalance_fired", 0)
        w_ticks = ticks - prev.get("storm.stage.scatter.count", 0)
        w_touched = touched - prev.get("storm.device.blocks_touched", 0)
        if w_fired >= 0 and w_ticks > 0:
            fired, ticks = w_fired, w_ticks
            if w_touched >= 0:  # windowed WITH the rate, same interval
                touched = w_touched
    rate = (f"{fired / ticks:.2f}/tick" if ticks else f"{fired:g} fires")
    return (f"block rebalance: {rate}  blocks_touched {touched:g}  "
            f"host pre-tick fires {host_fires:g}  retunes {retunes:g}")


def render_residency(metrics: dict, prev: dict | None = None,
                     interval: float = 1.0) -> str:
    """Doc-residency line (the tiering plane): hot / known-cold
    / hydrating gauge levels, hydration + eviction rates over the poll
    window (cumulative counters when no window), hydration p99, and the
    process RSS the tiering exists to bound. Empty when no residency
    manager is attached (the gauges never appear)."""
    if "residency.hot_docs" not in metrics:
        return ""
    hot = metrics.get("residency.hot_docs", 0)
    cold = metrics.get("residency.known_cold_docs", 0)
    hydrating = metrics.get("residency.hydrating_docs", 0)
    hyd = metrics.get("residency.hydrations", 0)
    evi = metrics.get("residency.evictions", 0)
    per_s = max(interval, 1e-9)
    if prev:
        w_h = hyd - prev.get("residency.hydrations", 0)
        w_e = evi - prev.get("residency.evictions", 0)
        if w_h >= 0 and w_e >= 0:  # negative = service restarted
            hyd, evi = w_h / per_s, w_e / per_s
    p99 = metrics.get("residency.hydrate_s.p99", 0.0) * 1e3
    rss = metrics.get("residency.rss_mb", 0.0)
    return (f"residency: hot {hot:g}  cold {cold:g}  "
            f"hydrating {hydrating:g}  hydrations {hyd:,.1f}/s "
            f"p99 {p99:.3f}ms  evictions {evi:,.1f}/s  "
            f"rss {rss:,.0f}MB")


def render_viewers(metrics: dict, prev: dict | None = None,
                   interval: float = 1.0) -> str:
    """Viewer-plane line (the broadcast tier): rooms/viewers
    gauge levels, broadcast bytes/s and lag-drop rate over the poll
    window (cumulative counters with no window), and the serialize-once
    evidence (tick encodes vs frames delivered). Empty when no viewer
    has ever joined (the gauges never appear)."""
    if "viewer.rooms" not in metrics:
        return ""
    rooms = metrics.get("viewer.rooms", 0)
    viewers = metrics.get("viewer.viewers", 0)
    byts = metrics.get("viewer.broadcast_bytes", 0)
    drops = metrics.get("viewer.lag_drops", 0)
    encodes = metrics.get("viewer.tick_encodes", 0)
    frames = metrics.get("viewer.delivered_frames", 0)
    per_s = max(interval, 1e-9)
    if prev:
        w_b = byts - prev.get("viewer.broadcast_bytes", 0)
        w_d = drops - prev.get("viewer.lag_drops", 0)
        if w_b >= 0 and w_d >= 0:  # negative = service restarted
            byts, drops = w_b / per_s, w_d / per_s
    return (f"viewers: rooms {rooms:g}  viewers {viewers:g}  "
            f"broadcast {byts:,.0f}B/s  lag-drops {drops:,.1f}/s  "
            f"encodes {encodes:,.0f} / frames {frames:,.0f}")


def render_cluster(metrics: dict, prev: dict | None = None,
                   interval: float = 1.0) -> str:
    """Cluster-placement line (the elastic tier): active host
    count, docs this host owns, live migrations (in flight + rate over
    the poll window; cumulative counter with no window), viewer
    re-homes, and the last migration's blackout ms — the operator's
    first read on whether the placement controller is draining a hot
    host or a migration is wedged. Empty when no cluster directory is
    attached (the gauges never appear)."""
    if "cluster.hosts" not in metrics:
        return ""
    hosts = metrics.get("cluster.hosts", 0)
    docs = metrics.get("cluster.host_docs", 0)
    in_flight = metrics.get("cluster.migrations_in_flight", 0)
    migrations = metrics.get("cluster.migrations", 0)
    rehomes = metrics.get("viewer.rehomes", 0)
    blackout = metrics.get("cluster.last_blackout_ms", 0.0)
    per_s = max(interval, 1e-9)
    rate = ""
    if prev:
        w_m = migrations - prev.get("cluster.migrations", 0)
        if w_m >= 0:  # negative = service restarted
            rate = f" ({w_m / per_s:,.2f}/s)"
    return (f"cluster: hosts {hosts:g}  docs/host {docs:g}  "
            f"migrations {migrations:g}{rate} in-flight {in_flight:g}  "
            f"viewer re-homes {rehomes:g}  "
            f"last blackout {blackout:,.1f}ms")


def render_replication(metrics: dict, prev: dict | None = None,
                       interval: float = 1.0) -> str:
    """Replication-plane line (the HA tier): this host's role
    (leader / follower / demoted — a fenced old leader that must shed),
    follower count, replication lag (durable ticks the slowest follower
    is behind), the replicated-vs-durable watermark gap (ticks locally
    fsynced but not yet quorum-acked — what acks are waiting on), ship
    rate over the poll window (cumulative with no window), and the last
    failover's blackout ms. Empty when no replication plane is attached
    (the gauges never appear)."""
    if "repl.role_code" not in metrics:
        return ""
    role = {1: "leader", 2: "follower",
            3: "demoted"}.get(int(metrics.get("repl.role_code", 0)),
                              "unknown")
    followers = metrics.get("repl.followers", 0)
    lag = metrics.get("repl.lag", 0)
    gap = metrics.get("repl.watermark_gap", 0)
    shipped = metrics.get("repl.shipped_batches", 0)
    blackout = metrics.get("repl.last_failover_blackout_ms", 0.0)
    per_s = max(interval, 1e-9)
    rate = ""
    if prev:
        w_s = shipped - prev.get("repl.shipped_batches", 0)
        if w_s >= 0:  # negative = service restarted
            rate = f" ({w_s / per_s:,.1f}/s)"
    return (f"replication: role {role}  followers {followers:g}  "
            f"lag {lag:g}  watermark-gap {gap:g}  "
            f"shipped {shipped:g}{rate}  "
            f"last failover blackout {blackout:,.1f}ms")


def render_transport(metrics: dict, prev: dict | None = None,
                     interval: float = 1.0) -> str:
    """Networked-transport line (the cut-the-cord tier):
    live replication links, per-link round-trip p50/p99, retransmit
    rate over the poll window (cumulative with no window), heartbeat
    misses, links past their lease right now (open partitions), the
    parked-write depth (docs whose frames are held FIFO during a
    quorum blackout — never shed, never falsely acked), and how long
    the plane has currently been degraded. Empty when replication is
    purely in-process with no failure detector armed (the gauges never
    appear)."""
    if "transport.links" not in metrics:
        return ""
    links = metrics.get("transport.links", 0)
    p50 = metrics.get("transport.rtt_p50_ms", 0.0)
    p99 = metrics.get("transport.rtt_p99_ms", 0.0)
    retrans = metrics.get("transport.retransmits", 0)
    misses = metrics.get("transport.heartbeat_misses", 0)
    partitions = metrics.get("transport.open_partitions", 0)
    parked = metrics.get("repl.parked_docs", 0)
    degraded = metrics.get("repl.degraded_s", 0.0)
    per_s = max(interval, 1e-9)
    rate = ""
    if prev:
        window = retrans - prev.get("transport.retransmits", 0)
        if window >= 0:  # negative = service restarted
            rate = f" ({window / per_s:,.1f}/s)"
    state = f"DEGRADED {degraded:,.1f}s" if degraded else "quorum ok"
    return (f"transport: links {links:g}  rtt p50 {p50:,.1f}ms "
            f"p99 {p99:,.1f}ms  retransmits {retrans:g}{rate}  "
            f"hb-misses {misses:g}  open-partitions {partitions:g}  "
            f"parked {parked:g}  {state}")


def render_replicas(metrics: dict, prev: dict | None = None,
                    interval: float = 1.0) -> str:
    """Read-replica tier line (the read scale-out): replica
    host count, directory-assigned rooms (+ mean rooms per replica),
    the per-room staleness distribution against the leader's sequenced
    watermark (p50/p99 in seqs, plus the worst room right now — the
    BOUND a replica-served read can be behind by), re-homed viewers
    over the poll window, and read redirects shed through the front
    door (directory routing + stale sheds). Empty when no
    ReplicaBalancer scrapes (the gauges never appear)."""
    if "replica.hosts" not in metrics:
        return ""
    hosts = metrics.get("replica.hosts", 0)
    rooms = metrics.get("replica.rooms", 0)
    per = f" ({rooms / hosts:.1f}/replica)" if hosts else ""
    p50 = metrics.get("replica.staleness_seqs.p50", 0)
    p99 = metrics.get("replica.staleness_seqs.p99", 0)
    worst = metrics.get("replica.staleness_worst", 0)
    rehomed = metrics.get("replica.rehomed_viewers", 0)
    redirects = (metrics.get("replica.redirects", 0)
                 + metrics.get("replica.stale_redirects", 0))
    per_s = max(interval, 1e-9)

    def rate(cur: float, key: str) -> str:
        if not prev:
            return ""
        window = cur - prev.get(key, 0)
        if key == "redirects":
            window = cur - (prev.get("replica.redirects", 0)
                            + prev.get("replica.stale_redirects", 0))
        return f" ({window / per_s:,.1f}/s)" if window >= 0 else ""

    return (f"replicas: hosts {hosts:g}  rooms {rooms:g}{per}  "
            f"staleness p50 {p50:g} p99 {p99:g} worst {worst:g} seqs  "
            f"re-homed {rehomed:g}"
            f"{rate(rehomed, 'replica.rehomed_viewers')}  "
            f"redirects {redirects:g}{rate(redirects, 'redirects')}")


def render_megadoc(metrics: dict, prev: dict | None = None,
                   interval: float = 1.0) -> str:
    """Mega-doc write-tier line (the scale-out plane):
    promoted-doc / total-lane gauge levels, mean lanes per doc, the
    combiner's lane occupancy (active lane batches per tick / total
    lanes — how much of the promoted width the writer mix actually
    fills), combined-op rate over the poll window (cumulative with no
    window), and the sequence-parallel merge tier's boundary-exchange
    rate (ppermute edge hops, the ring-step cost). Empty when no doc was
    ever promoted (the gauges never appear)."""
    if "megadoc.promoted_docs" not in metrics:
        return ""
    promoted = metrics.get("megadoc.promoted_docs", 0)
    lanes = metrics.get("megadoc.total_lanes", 0)
    occupancy = metrics.get("megadoc.combiner_occupancy", 0.0)
    combined = metrics.get("megadoc.combined_ops", 0)
    exchanges = metrics.get("megadoc.boundary_exchanges", 0)
    per_s = max(interval, 1e-9)
    if prev:
        w_c = combined - prev.get("megadoc.combined_ops", 0)
        w_x = exchanges - prev.get("megadoc.boundary_exchanges", 0)
        if w_c >= 0 and w_x >= 0:  # negative = service restarted
            combined, exchanges = w_c / per_s, w_x / per_s
    lanes_per_doc = lanes / promoted if promoted else 0.0
    return (f"megadoc: promoted {promoted:g}  lanes {lanes:g} "
            f"({lanes_per_doc:.1f}/doc)  occupancy {occupancy:.2f}  "
            f"combined {combined:,.1f}/s  "
            f"boundary-exchanges {exchanges:,.1f}/s")


def render_history(metrics: dict, prev: dict | None = None,
                   interval: float = 1.0) -> str:
    """History-plane line (the time-travel tier): live branch
    count, summarization compactions (rate over the poll window;
    cumulative with no window), trimmed WAL ticks, the deepest
    un-summarized tail (ops behind the newest summary — the compaction
    backlog signal), historical-read rate + p99, and merge-backs.
    Empty when no history plane is attached (the gauges never
    appear)."""
    if "history.branches" not in metrics:
        return ""
    branches = metrics.get("history.branches", 0)
    compactions = metrics.get("history.compactions", 0)
    trimmed = metrics.get("history.trimmed_ticks", 0)
    tail = metrics.get("history.tail_ops", 0)
    reads = metrics.get("history.reads", 0)
    merges = metrics.get("history.merges", 0)
    per_s = max(interval, 1e-9)
    if prev:
        w_c = compactions - prev.get("history.compactions", 0)
        w_r = reads - prev.get("history.reads", 0)
        if w_c >= 0 and w_r >= 0:  # negative = service restarted
            compactions, reads = w_c / per_s, w_r / per_s
    p99 = metrics.get("history.read_s.p99", 0.0) * 1e3
    return (f"history: branches {branches:g}  "
            f"compactions {compactions:,.2f}/s  "
            f"trimmed-ticks {trimmed:g}  tail {tail:g} ops  "
            f"reads {reads:,.1f}/s p99 {p99:.3f}ms  merges {merges:g}")


def render_tenants(metrics: dict, prev: dict | None = None,
                   interval: float = 1.0) -> str:
    """Multi-tenant QoS table (the fairness plane): one SLO row
    per tenant — windowed share of tick doc slots (the deficit
    scheduler's actual allocation), sequenced-op and shed rates over the
    poll window (cumulative with no window), pending queue depth, and
    the per-tenant ack p50/p99 — the noisy-neighbor readout: an abusive
    tenant shows a fat share/shed row while the victims' p99 columns
    hold still. Empty when no tenant has ever sent (the metrics never
    appear)."""
    prefix = "storm.tenant."
    tenants = sorted({k[len(prefix):].rsplit(".", 1)[0]
                      for k in metrics
                      if k.startswith(prefix)
                      and k.rsplit(".", 1)[-1] in ("submitted_ops",
                                                   "tick_docs")})
    if not tenants:
        return ""
    per_s = max(interval, 1e-9)

    def windowed(name: str) -> dict[str, float]:
        out = {}
        for t in tenants:
            v = metrics.get(f"{prefix}{t}.{name}", 0.0)
            if prev is not None:
                w = v - prev.get(f"{prefix}{t}.{name}", 0.0)
                if w >= 0:  # negative = service restarted
                    v = w
            out[t] = v
        return out

    docs = windowed("tick_docs")
    seq = windowed("sequenced_ops")
    shed = windowed("shed_ops")
    grand = sum(docs.values())
    lines = ["tenants:  share   seq/s      shed/s   pending  "
             "ack p50      p99"]
    for t in tenants:
        share = docs[t] / grand if grand else 0.0
        pending = metrics.get(f"{prefix}{t}.pending_docs", 0)
        p50 = metrics.get(f"{prefix}{t}.ack_s.p50", 0.0) * 1e3
        p99 = metrics.get(f"{prefix}{t}.ack_s.p99", 0.0) * 1e3
        lines.append(
            f"  {t:<12} {100 * share:5.1f}% {seq[t] / per_s:9,.1f} "
            f"{shed[t] / per_s:9,.1f} {pending:8g} "
            f"{p50:8.3f}ms {p99:8.3f}ms")
    return "\n".join(lines)


def render_human(now: dict, prev: dict, interval: float) -> str:
    """Operator view of one poll: headline rates (per-second deltas of
    the interesting counters), the stage bar, and the hop decomposition
    when sampled tracing is live."""
    lines = [f"-- {time.strftime('%H:%M:%S')} " + "-" * 40]
    rates = []
    per_s = max(interval, 1e-9)
    for name in sorted(now):
        value = now[name]
        if name.rsplit(".", 1)[-1] in ("p50", "p99", "mean", "max"):
            continue  # histogram exports are levels, not counters — a
            # grown p99 is not a rate.
        if name in prev and isinstance(value, (int, float)) \
                and value > prev[name]:
            rates.append((value - prev[name], name))
    if rates:
        # Busiest counters first — alphabetical order would crowd the
        # display with whichever subsystem sorts earliest.
        rates.sort(reverse=True)
        lines.append("rates:")
        lines.extend(f"  {name:<32} +{delta / per_s:,.1f}/s"
                     for delta, name in rates[:16])
    lines.append(render_stage_bar(now, prev=prev or None))
    pipeline = render_pipeline(now, prev or None)
    if pipeline:
        lines.append(pipeline)
    rebal = render_rebalance(now, prev or None)
    if rebal:
        lines.append(rebal)
    residency = render_residency(now, prev or None, interval)
    if residency:
        lines.append(residency)
    viewer_line = render_viewers(now, prev or None, interval)
    if viewer_line:
        lines.append(viewer_line)
    mega_line = render_megadoc(now, prev or None, interval)
    if mega_line:
        lines.append(mega_line)
    cluster_line = render_cluster(now, prev or None, interval)
    if cluster_line:
        lines.append(cluster_line)
    repl_line = render_replication(now, prev or None, interval)
    if repl_line:
        lines.append(repl_line)
    transport_line = render_transport(now, prev or None, interval)
    if transport_line:
        lines.append(transport_line)
    replicas_line = render_replicas(now, prev or None, interval)
    if replicas_line:
        lines.append(replicas_line)
    history_line = render_history(now, prev or None, interval)
    if history_line:
        lines.append(history_line)
    tenant_line = render_tenants(now, prev or None, interval)
    if tenant_line:
        lines.append(tenant_line)
    hop_keys = sorted({k.rsplit(".", 1)[0] for k in now
                       if k.startswith("storm.hop.")})
    if hop_keys:
        lines.append("sampled op hops (ack latency decomposition):")
        for base in hop_keys:
            p50 = now.get(f"{base}.p50", 0.0) * 1e3
            p99 = now.get(f"{base}.p99", 0.0) * 1e3
            n = int(now.get(f"{base}.count", 0))
            lines.append(f"  {base.removeprefix('storm.hop.'):<28}"
                         f" p50 {p50:8.3f}ms  p99 {p99:8.3f}ms  n={n}")
    return "\n".join(lines)


def watch(host: str, port: int, interval: float,
          out=sys.stdout, as_json: bool = False,
          max_polls: int | None = None) -> None:
    """Poll forever (or ``max_polls`` times — the testable bound).

    ``--json`` keeps the original machine format: each scrape as one
    JSON line (absolute values) plus ``"+<name>"`` keys for the
    per-interval increase of every metric that grew. The default human
    mode renders rates + the stage-attribution bar. Either way a
    restarting service must not kill the watcher: scrape failures
    report and retry on the next interval (reconnect-on-restart)."""
    prev: dict = {}
    prev_t: float | None = None
    polls = 0
    while max_polls is None or polls < max_polls:
        polls += 1
        try:
            now = scrape(host, port)
        except (OSError, ConnectionError) as err:
            # A restarting service must not kill the watcher; report and
            # retry on the next interval.
            if as_json:
                print(json.dumps({"ts": round(time.time(), 1),
                                  "unreachable": repr(err)}),
                      file=out, flush=True)
            else:
                print(f"-- unreachable ({err!r}); retrying in "
                      f"{interval}s", file=out, flush=True)
            time.sleep(interval)
            continue
        now_t = time.monotonic()
        if as_json:
            line: dict = {name: value for name, value in sorted(now.items())}
            for name, value in now.items():
                if name in prev and value > prev[name]:
                    line[f"+{name}"] = round(value - prev[name], 3)
            print(json.dumps({"ts": round(time.time(), 1), **line}),
                  file=out, flush=True)
        else:
            # Rates divide by the MEASURED gap between scrapes — a slow
            # scrape on a loaded service must not overstate them.
            elapsed = now_t - prev_t if prev_t is not None else interval
            print(render_human(now, prev, elapsed), file=out, flush=True)
        prev = now
        prev_t = now_t
        time.sleep(interval)


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, required=True)
    parser.add_argument("--interval", type=float, default=5.0)
    parser.add_argument("--once", action="store_true",
                        help="print one scrape as JSON and exit")
    parser.add_argument("--json", action="store_true",
                        help="watch in machine format: one JSON line per "
                             "poll with +deltas for grown counters")
    args = parser.parse_args(argv)
    if args.once:
        print(json.dumps(scrape(args.host, args.port), indent=1,
                         sort_keys=True))
        return
    watch(args.host, args.port, args.interval, as_json=args.json)


if __name__ == "__main__":
    main(sys.argv[1:])
