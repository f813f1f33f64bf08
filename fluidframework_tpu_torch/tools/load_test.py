"""Service load harness — drive the assembled ordering service end-to-end.

Reference parity: packages/test/service-load-test/src/nodeStressTest.ts +
testConfig.json profiles (ci: 120 clients × 10 op/min; full: 240 clients,
10M ops) and loadTestDataStore.ts:43-56 (per-client seen/sent rates). The
service runs in BATCHED-CADENCE mode (auto_pump off, device sequencer
host batching every document's ops into one tick per pump) — the
throughput shape the kernels are built for. The device hosts run on
``device``: the card unless the caller asks for the CPU (where the
kernels' plain versions run).

Run:  python -m fluidframework_tpu_torch.tools.load_test ci [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time

from ..dds.counter import SharedCounter
from ..dds.map import SharedMap
from ..drivers.local_driver import LocalDocumentService
from ..runtime.container import Container
from ..server.routerlicious import RouterliciousService

PROFILES = {
    # Scaled-down analog of the reference's testConfig.json shapes: every
    # client writes a map key + bumps a shared counter per round.
    "smoke": {"docs": 2, "clients_per_doc": 3, "rounds": 10,
              "ops_per_round": 2},
    "ci": {"docs": 8, "clients_per_doc": 4, "rounds": 25,
           "ops_per_round": 4},
    "full": {"docs": 32, "clients_per_doc": 8, "rounds": 50,
             "ops_per_round": 8},
}


def _recv_exact(sock, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("server closed the connection")
        buf += chunk
    return buf


def _rss_mb() -> float:
    """Resident set size of this process in MB (soak evidence)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    return int(line.split()[1]) / 1024.0
    except OSError:
        pass
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def run_storm_load(total_ops: int = 1_000_000, num_docs: int = 512,
                   k: int = 256, sample_docs: int = 4,
                   window: int = 2, device="cuda") -> dict:
    """The reference's FULL-profile op volume (testConfig.json:10-16 —
    240 clients, 10M ops; the ``full10m`` CLI profile runs exactly that
    shape: 240 single-writer documents) pushed through the real serving
    path: binary storm frames over TCP -> C++ bridge -> alfred -> device
    deli -> device merger -> durable columnar log + acks. A sampled set
    of documents is verified against a scalar MapData replay of the
    materialized durable log; RSS is sampled over the run so memory
    growth (host logs, pools) is soak evidence, not a one-shot reading."""
    import socket
    import struct

    import numpy as np

    from ..dds.map_data import MapData
    from ..native.fanout import make_fanout
    from ..protocol.codec import encode_storm_frame
    from ..protocol.messages import MessageType
    from ..server.bridge_host import BridgeFrontDoor
    from ..server.kernel_host import KernelSequencerHost
    from ..server.merge_host import KernelMergeHost
    from ..server.routerlicious import RouterliciousService
    from ..server.storm import StormController

    import shutil
    import tempfile

    seq_host = KernelSequencerHost(num_slots=2, initial_capacity=num_docs,
                                   device=device)
    merge_host = KernelMergeHost(row_capacity=num_docs,
                                 flush_threshold=10**9, device=device)
    service = RouterliciousService(merge_host=merge_host,
                                   batched_deli_host=seq_host,
                                   auto_pump=False, fanout=make_fanout())
    # Tick words blobs spill to a disk oplog (the Mongo-storage analog):
    # the serving process must stay memory-bounded however many ops the
    # profile pushes.
    spill_dir = tempfile.mkdtemp(prefix="storm-spill-")
    storm = StormController(service, seq_host, merge_host,
                            flush_threshold_docs=num_docs,
                            spill_dir=spill_dir)
    front = BridgeFrontDoor(service, 0)
    sock = None
    try:
        docs = [f"storm-{i}" for i in range(num_docs)]
        clients = {d: service.connect(d, lambda msgs: None).client_id
                   for d in docs}
        service.pump()

        from ..protocol.codec import (
            decode_storm_push, is_storm_body, pack_map_words)

        sock = socket.create_connection(("127.0.0.1", front.port))
        sock.settimeout(600)
        rng = np.random.default_rng(0)
        cseq = {d: 1 for d in docs}
        ticks = -(-total_ops // (num_docs * k))
        sent = 0
        rss_series = [(0, round(_rss_mb(), 1))]
        rate_series = []
        dims_series = []
        sample_every = max(1, ticks // 16)
        start = time.perf_counter()
        # Windowed flow control: at most ``window`` frames in
        # flight, keyed off the ack stream — enough to keep the server's
        # tick pipeline full (window >= pipeline_depth + 1) without the
        # unbounded send-side backlog that used to masquerade as server
        # latency. A busy-nack frees its slot but the frame resends
        # after the hint — it was never sequenced.
        window = max(1, window)
        inflight = 0
        to_send = list(range(ticks))
        acked_ticks = 0
        high_water = 0  # first-send watermark (resends never re-sample)

        def read_one_ack() -> None:
            nonlocal inflight, acked_ticks
            # MSG_WAITALL is ignored on a socket with a timeout (the fd
            # goes non-blocking) — exact reads must loop.
            length = struct.unpack(">I", _recv_exact(sock, 4))[0]
            ack_body = _recv_exact(sock, length)
            if is_storm_body(ack_body):
                ack = decode_storm_push(ack_body)  # binary columnar ack
            else:
                ack = json.loads(ack_body.decode())
            if not ack.get("storm"):
                return
            inflight -= 1
            if ack.get("error"):
                hint = ack.get("retry_after_s", 0.01)
                time.sleep(float(hint))
                to_send.append(int(ack["rid"]))
            else:
                acked_ticks += 1

        tick = -1
        while acked_ticks < ticks:
            if to_send and inflight < window:
                tick = to_send.pop(0)
                header, chunks = [], []
                for d in docs:
                    chunks.append(pack_map_words(
                        rng.choice([0, 0, 0, 1, 2], size=k),
                        rng.integers(0, 32, k),
                        rng.integers(0, 1 << 20, k)))
                    header.append([d, clients[d], cseq[d], 1, k])
                    cseq[d] += k
                sock.sendall(encode_storm_frame(
                    {"op": "storm", "rid": tick, "docs": header},
                    b"".join(c.tobytes() for c in chunks)))
                sent += num_docs * k
                inflight += 1
                # Sample only on FIRST sends (high-water): a busy-nack
                # resend re-pops an old tick id, and re-sampling it
                # would append duplicate/out-of-order x-values into the
                # slope/plateau series.
                if tick < high_water:
                    continue
                high_water = tick + 1
                if (tick + 1) % sample_every == 0 or tick == ticks - 1:
                    t = time.perf_counter() - start
                    rss_series.append((tick + 1, round(_rss_mb(), 1)))
                    rate_series.append((tick + 1,
                                        round(sent / t / 1e6, 3)))
                    # Device table dims: growth must converge after
                    # warm-up (a monotone series here would mean
                    # unbounded pools).
                    dims_series.append((tick + 1, seq_host._capacity,
                                        seq_host._alloc_slots,
                                        merge_host._map_capacity,
                                        merge_host._map_slots))
            else:
                read_one_ack()
        elapsed = time.perf_counter() - start

        # Transport-retention CONTROL: host memory a bare host-to-device
        # transfer of one tick's words retains (30 copies of a zero
        # tick, nothing else running). The serving host's own memory is
        # bounded — tick blobs spill to disk — so an RSS slope at/below
        # this control is the transport's, not the host's.
        import torch

        probe = torch.zeros((num_docs, k), dtype=torch.int32)
        rss0 = _rss_mb()
        for i in range(30):
            arr = probe.to(seq_host.device)
            int(arr[0, 0])
        control_mb_per_tick = max(0.0, (_rss_mb() - rss0) / 30)
        ticks_run = len(rss_series) - 1 and rss_series[-1][0]
        slope = ((rss_series[-1][1] - rss_series[len(rss_series) // 2][1])
                 / max(1, ticks_run - rss_series[len(rss_series) // 2][0]))

        # Oracle on a sample: scalar replay of the materialized log.
        verified = True
        for d in docs[:sample_docs]:
            data = MapData()
            for m in service.get_deltas(d, 0):
                if m.type != MessageType.OPERATION:
                    continue
                inner = (m.contents or {}).get("contents",
                                               {}).get("contents")
                if inner:
                    data.process(inner, False, None)
            verified &= (merge_host.map_entries(d, "default", "root")
                         == dict(data.items()))
        sequenced = storm.stats["sequenced_ops"]
    finally:
        # Mid-run failures (timeout, short recv, nack) must not leak the
        # listening bridge + pump thread into the calling process.
        if sock is not None:
            sock.close()
        front.close()
        shutil.rmtree(spill_dir, ignore_errors=True)
    # RSS plateau check: flat (max-min)/mean over the LAST HALF of the
    # run — the memory-boundedness bar.
    half = [mb for _t, mb in rss_series[len(rss_series) // 2:]]
    rss_flat = ((max(half) - min(half)) / (sum(half) / len(half))
                if half else 0.0)
    return {
        "profile": "full_storm",
        "client_window": window,
        "ops_sent": sent,
        "ops_sequenced": sequenced,
        "clients": num_docs,
        "elapsed_s": round(elapsed, 3),
        "merged_ops_per_sec": round(sequenced / elapsed, 1),
        "docs": num_docs,
        "converged": bool(verified and sequenced >= total_ops),
        # Soak evidence: (tick, RSS MB) and (tick, cumulative Mops/s)
        # over the run — flat RSS = bounded host memory under sustained
        # load; flat rate = no degradation over the op volume.
        "rss_mb_series": rss_series,
        "rss_flat_last_half": round(rss_flat, 4),
        "rss_slope_mb_per_tick_last_half": round(slope, 4),
        "transport_control_mb_per_put": round(control_mb_per_tick, 4),
        "cumulative_mops_series": rate_series,
        "device_dims_series": dims_series,
        "spilled_tick_blobs": True,
        "path": "TCP -> C++ bridge -> alfred -> device deli -> device "
                "merger -> durable log + acks",
    }


def run_load(profile: str = "ci", use_device_sequencer: bool = True,
             pump_every_rounds: int = 1, device="cuda") -> dict:
    config = PROFILES[profile]
    kwargs: dict = {"auto_pump": False}
    if use_device_sequencer:
        from ..server.kernel_host import KernelSequencerHost
        kwargs["batched_deli_host"] = KernelSequencerHost(device=device)
    service = RouterliciousService(**kwargs)

    docs = []
    for d in range(config["docs"]):
        doc_id = f"load-{d}"
        c1 = Container.create_detached(LocalDocumentService(service, doc_id))
        datastore = c1.runtime.create_datastore("default")
        datastore.create_channel("root", SharedMap.channel_type)
        datastore.create_channel("clicks", SharedCounter.channel_type)
        c1.attach()
        service.pump()
        clients = [c1] + [
            Container.load(LocalDocumentService(service, doc_id))
            for _ in range(config["clients_per_doc"] - 1)]
        service.pump()
        docs.append(clients)

    sent = 0
    start = time.perf_counter()
    for round_index in range(config["rounds"]):
        for clients in docs:
            for ci, client in enumerate(clients):
                datastore = client.runtime.get_datastore("default")
                for k in range(config["ops_per_round"]):
                    if k % 2 == 0:
                        datastore.get_channel("root").set(
                            f"k{ci}-{k}", round_index)
                    else:
                        datastore.get_channel("clicks").increment()
                    sent += 1
        if (round_index + 1) % pump_every_rounds == 0:
            service.pump()  # the batched cadence: one device tick per pump
    service.pump()
    elapsed = time.perf_counter() - start

    # Convergence + seen-rate accounting (loadTestDataStore.ts:43-56).
    converged = True
    seen = 0
    expected_clicks = (config["rounds"] * config["ops_per_round"] // 2
                       * config["clients_per_doc"])
    for clients in docs:
        summaries = [c.summarize() for c in clients]
        converged &= all(s == summaries[0] for s in summaries)
        converged &= (clients[0].runtime.get_datastore("default")
                      .get_channel("clicks").value == expected_clicks)
        seen += sum(c.last_processed_seq for c in clients)

    report = {
        "profile": profile,
        "device_sequencer": use_device_sequencer,
        "clients": config["docs"] * config["clients_per_doc"],
        "docs": config["docs"],
        "ops_sent": sent,
        "ops_seen_total": seen,
        "elapsed_s": round(elapsed, 3),
        "merged_ops_per_sec": round(sent / elapsed, 1),
        "converged": converged,
        "sequenced_ops": service.metrics.snapshot().get(
            "deli.sequenced_ops", 0),
    }
    assert converged, "replicas diverged under load"
    return report


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("profile", nargs="?", default="ci",
                        help="smoke | ci | full | full_storm | full10m")
    parser.add_argument("total_ops", nargs="?", type=int,
                        default=1_000_000,
                        help="ops the full_storm profile pushes")
    parser.add_argument("--device", default="cuda",
                        help="device the kernel hosts run on (cuda, or "
                             "cpu for the kernels' plain versions)")
    args = parser.parse_args(argv)
    if args.profile == "full_storm":
        # The >=1M-sequenced-ops profile through the real socket path.
        report = run_storm_load(args.total_ops, device=args.device)
    elif args.profile == "full10m":
        # The reference's EXACT full profile: 240 clients, 10M ops
        # (testConfig.json:10-16), one writer per document.
        report = run_storm_load(10_000_000, num_docs=240, k=256,
                                device=args.device)
    else:
        report = run_load(args.profile, device=args.device)
    print(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
