"""Golden corpus generator — deterministic recorded documents.

Reference parity: the recorded op logs under the reference's
packages/test/snapshots/content (messages.json per document). Each
scenario drives the live client stack over a LocalCollabServer with a
fixed seed, records the full sequenced log + attach-time base snapshot +
converged summary, and self-verifies by replaying before writing.

Regenerate (ONLY when the wire/summary format intentionally changes):
    python -m fluidframework_tpu_torch.tools.record_goldens OUT_DIR

The committed corpus under ``tests/goldens`` is the reference package's;
the port replays it byte for byte and records into other directories.
"""

from __future__ import annotations

import json
import random
import sys
from pathlib import Path

from ..dds.cell import SharedCell
from ..dds.counter import SharedCounter
from ..dds.directory import SharedDirectory
from ..dds.map import SharedMap
from ..dds.matrix import SharedMatrix
from ..dds.sequence import SharedString
from ..dds.tree import SharedTree
from ..drivers.local_driver import LocalDocumentService
from ..drivers.replay_driver import record_document
from ..runtime.container import Container
from ..server.local_server import LocalCollabServer
from .replay import canonical, verify_golden


def _make_doc(server, doc_id, channels):
    container = Container.create_detached(
        LocalDocumentService(server, doc_id))
    datastore = container.runtime.create_datastore("default")
    for name, channel_type in channels:
        datastore.create_channel(name, channel_type)
    container.attach()
    return container


def _chan(container, name):
    return container.runtime.get_datastore("default").get_channel(name)


def _open(server, doc_id):
    return Container.load(LocalDocumentService(server, doc_id))


def scenario_string_conflict(server, doc_id):
    """Concurrent SharedString edits with paused interleavings
    (conflictFarm shape)."""
    rng = random.Random(42)
    c1 = _make_doc(server, doc_id, [("text", SharedString.channel_type)])
    others = [_open(server, doc_id) for _ in range(2)]
    clients = [c1] + others
    for _round in range(6):
        paused = [c for c in clients if rng.random() < 0.4]
        for c in paused:
            c.inbound.pause()
        for _ in range(6):
            text = _chan(clients[rng.randrange(3)], "text")
            length = len(text)
            r = rng.random()
            if r < 0.55 or length == 0:
                text.insert_text(rng.randrange(length + 1),
                                 rng.choice("abcdefgh") * rng.randint(1, 3))
            elif r < 0.85:
                start = rng.randrange(length)
                text.remove_text(start, min(length, start + rng.randint(1, 3)))
            else:
                start = rng.randrange(length)
                text.annotate_range(start, min(length, start + 2),
                                    {"k": rng.randrange(3)})
        for c in paused:
            c.inbound.resume()
    return clients


def scenario_map_directory(server, doc_id):
    rng = random.Random(7)
    c1 = _make_doc(server, doc_id, [("root", SharedMap.channel_type),
                                    ("dir", SharedDirectory.channel_type)])
    c2 = _open(server, doc_id)
    root1, root2 = _chan(c1, "root"), _chan(c2, "root")
    dir1, dir2 = _chan(c1, "dir"), _chan(c2, "dir")
    for i in range(10):
        (root1 if i % 2 else root2).set(f"k{rng.randrange(5)}", i)
    c1.inbound.pause()
    root1.set("contested", "one")
    root2.set("contested", "two")
    root1.delete("k0")
    c1.inbound.resume()
    sub = dir1.create_sub_directory("a").create_sub_directory("b")
    sub.set("deep", [1, 2, 3])
    dir2.get_sub_directory("a").set("shallow", True)
    return [c1, c2]


def scenario_matrix(server, doc_id):
    rng = random.Random(3)
    c1 = _make_doc(server, doc_id, [("grid", SharedMatrix.channel_type)])
    m1 = _chan(c1, "grid")
    m1.insert_rows(0, 3)
    m1.insert_cols(0, 3)
    c2 = _open(server, doc_id)
    m2 = _chan(c2, "grid")
    for _ in range(8):
        m = m1 if rng.random() < 0.5 else m2
        m.set_cell(rng.randrange(m.row_count), rng.randrange(m.col_count),
                   rng.randrange(100))
    c1.inbound.pause()
    m1.insert_rows(1, 1)
    m2.set_cell(2, 2, "race")
    c1.inbound.resume()
    m1.remove_cols(0, 1)
    return [c1, c2]


def scenario_tree(server, doc_id):
    from ..dds.tree_core import ROOT_ID

    def node(nid, payload=None):
        return {"id": nid, "definition": "n", "payload": payload,
                "traits": {}}

    def end_of(parent, label="children"):
        return {"referenceTrait": {"parent": parent, "label": label},
                "side": "end"}

    def range_of(nid):
        return {"start": {"referenceSibling": nid, "side": "before"},
                "end": {"referenceSibling": nid, "side": "after"}}

    c1 = _make_doc(server, doc_id, [("tree", SharedTree.channel_type)])
    c2 = _open(server, doc_id)
    t1, t2 = _chan(c1, "tree"), _chan(c2, "tree")
    t1.insert_node(node("a", "A"), end_of(ROOT_ID))
    t1.insert_node(node("b", "B"), end_of(ROOT_ID))
    t2.insert_node(node("kid", 1), end_of("a", "kids"))
    t1.set_payload("b", "B2")
    c1.inbound.pause()
    t1.set_payload("a", "A-mine")      # concurrent with the detach below
    t2.delete_range(range_of("a"))
    c1.inbound.resume()
    return [c1, c2]


def scenario_small_dds(server, doc_id):
    c1 = _make_doc(server, doc_id, [
        ("clicks", SharedCounter.channel_type),
        ("cell", SharedCell.channel_type)])
    c2 = _open(server, doc_id)
    _chan(c1, "clicks").increment(3)
    _chan(c2, "clicks").increment(-1)
    c1.inbound.pause()
    _chan(c1, "cell").set("first")
    _chan(c2, "cell").set("second")
    c1.inbound.resume()
    return [c1, c2]


def scenario_virtualized(server, doc_id):
    """Virtualized snapshot head: the big channel is a content-addressed
    blob stub in the stored tree (drivers/virtualized_driver.py wire
    format); replay resolves it from the recording's blobs/."""
    from ..drivers.virtualized_driver import VirtualizedDocumentService

    def virt():
        return VirtualizedDocumentService(
            LocalDocumentService(server, doc_id), inline_blob_bytes=256)

    c1 = Container.create_detached(virt())
    datastore = c1.runtime.create_datastore("default")
    datastore.create_channel("big", SharedString.channel_type)
    datastore.create_channel("small", SharedMap.channel_type)
    _chan(c1, "big").insert_text(0, "virtual " * 80)
    _chan(c1, "small").set("k", 1)
    c1.attach()
    c2 = Container.load(virt())
    _chan(c2, "big").insert_text(0, "head:")
    _chan(c1, "big").annotate_range(0, 5, {"mark": True})
    _chan(c2, "small").set("k", 2)
    return [c1, c2]


SCENARIOS = {
    "string-conflict": scenario_string_conflict,
    "map-directory": scenario_map_directory,
    "matrix-grid": scenario_matrix,
    "tree-edits": scenario_tree,
    "small-dds": scenario_small_dds,
    "virtualized-snapshot": scenario_virtualized,
}


def _collect_stub_blobs(server, doc_id, snapshot) -> dict | None:
    """Blob bytes referenced by virtualized stubs in a stored snapshot —
    recorded next to the golden so replay is self-contained."""
    from ..drivers.virtualized_driver import VIRTUAL_KEY, is_virtual_stub
    blobs: dict[str, bytes] = {}
    runtime = (snapshot or {}).get("runtime") or {}
    for ds in (runtime.get("datastores") or {}).values():
        for ch in (ds.get("channels") or {}).values():
            if is_virtual_stub(ch):
                blob_id = ch[VIRTUAL_KEY]["id"]
                blobs[blob_id] = server.read_blob(doc_id, blob_id)
    return blobs or None


def record_corpus(root: str | Path) -> list[str]:
    root = Path(root)
    for name, scenario in SCENARIOS.items():
        server = LocalCollabServer()
        doc_id = name
        clients = scenario(server, doc_id)
        summaries = [canonical(c.summarize()) for c in clients]
        assert all(s == summaries[0] for s in summaries), \
            f"{name}: replicas diverged at record time"
        directory = root / name
        head = server.get_latest_snapshot(doc_id)
        ops = record_document(
            server, doc_id, directory, snapshot=head,
            blobs=_collect_stub_blobs(server, doc_id, head))
        (directory / "summary.json").write_text(
            json.dumps(json.loads(summaries[0]), indent=1, sort_keys=True))
        (directory / "meta.json").write_text(json.dumps(
            {"name": name, "ops": ops,
             "description": scenario.__doc__ or name}, indent=1))
        verify_golden(directory, stress=True)  # self-check before shipping
    return list(SCENARIOS)


if __name__ == "__main__":
    if len(sys.argv) != 2:
        # No default: the committed corpus is the reference package's.
        sys.exit("usage: python -m fluidframework_tpu_torch.tools."
                 "record_goldens OUT_DIR")
    out = sys.argv[1]
    names = record_corpus(out)
    print(f"recorded {len(names)} goldens under {out}: {', '.join(names)}")
