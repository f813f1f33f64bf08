"""The port's process-spanning mesh (``parallel/multihost.py``) on
``torch.distributed`` with gloo, on the CPU.

* One process: ``initialize`` is a no-op, ``local_docs`` is the whole
  range, ``feed`` places the rows on the mesh's shards.
* Two processes (this file run as a script, ``if __name__ ==
  "__main__"``, through ``sys.executable``): each feeds only its
  ``local_docs`` rows of a mixed population (map, text, matrix and tree
  rows) into a ``ShardedServing`` on a 2-process × 2-shard mesh. The union
  of their harvests, their rows of every family state, the batch-wide
  rebalance counters and ``global_metrics`` (an ``all_reduce``) must
  equal a one-process run on 4 shards, exactly.
* The distributed sequence-parallel primitives (``DistPrims``: one shard
  of the segment axis per process) must equal the stacked ones.

Also home of :class:`Script`, the seeded multi-family traffic the mixed
tick and sharded serving differentials share (no JAX here: the workers
import this file).
"""

from __future__ import annotations

import json
import os
import random
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fluidframework_tpu_torch.ops import matrix_kernel as mxk
from fluidframework_tpu_torch.ops import mergetree_kernel as mtk
from fluidframework_tpu_torch.ops import mergetree_sharded as mts
from fluidframework_tpu_torch.ops import sequencer as seqk
from fluidframework_tpu_torch.ops import tree_kernel as tk
from fluidframework_tpu_torch.parallel import multihost
from fluidframework_tpu_torch.parallel.mesh import make_mesh, tree_leaves
from fluidframework_tpu_torch.parallel.serving import ShardedServing
from fluidframework_tpu_torch.protocol.messages import MessageType
from fluidframework_tpu_torch.server import storm

FAMILIES = ("map", "text", "matrix", "tree")
CLIENTS = 2
SHAPE = dict(map_k=6, text_k=4, matrix_k=4, tree_k=4, map_slots=16,
             text_blocks=4, text_bk=16, vec_slots=32, cell_slots=48,
             tree_slots=16)


# -- a seeded multi-family script ----------------------------------------------


class Script:
    """Tick inputs for a population of rows (``fams[row]`` its family),
    drawn from a numpy generator. Positions stay valid in each batch's
    frame (one client per row per tick, which sees its own ops); refs come
    from the acked seqs the caller reports back (:meth:`ack`)."""

    def __init__(self, fams, seed: int, shape=None) -> None:
        self.fams = list(fams)
        self.shape = dict(SHAPE, **(shape or {}))
        self.rng = np.random.default_rng(seed)
        n = len(self.fams)
        self.cseq = np.zeros((n, CLIENTS), np.int64)
        self.ref = np.full(n, CLIENTS, np.int64)    # after the joins
        self.text_len = np.zeros(n, np.int64)
        self.pool_len = np.zeros(n, np.int64)
        self.axis_len = np.zeros((n, 2), np.int64)
        self.handles = np.zeros(n, np.int64)
        self.tree_nodes = [[] for _ in range(n)]
        self.tree_next = np.ones(n, np.int64)
        self.last = None

    def _text(self, row, k):
        ops, blob = [], ""
        for _ in range(int(self.rng.integers(1, k + 1))):
            length = int(self.text_len[row])
            r = self.rng.random()
            if length > 2 and r < 0.3:
                s = int(self.rng.integers(0, length - 1))
                e = min(length, s + int(self.rng.integers(1, 4)))
                ops.append(dict(kind=mtk.MT_REMOVE, pos=s, end=e))
                self.text_len[row] -= e - s
            elif length > 2 and r < 0.45:
                s = int(self.rng.integers(0, length - 1))
                ops.append(dict(kind=mtk.MT_ANNOTATE, pos=s,
                                end=min(length, s + 2),
                                prop_key=int(self.rng.integers(0, 4)),
                                prop_val=int(self.rng.integers(1, 9))))
            else:
                n = int(self.rng.integers(1, 4))
                pos = 0 if self.rng.random() < 0.5 else int(
                    self.rng.integers(0, length + 1))
                ops.append(dict(kind=mtk.MT_INSERT, pos=pos,
                                pool_start=int(self.pool_len[row])
                                + len(blob), text_len=n))
                blob += "".join(self.rng.choice(list("abcdef"), n))
                self.text_len[row] += n
        self.pool_len[row] += len(blob)
        return ops, blob

    def _matrix(self, row, k):
        ops = []
        for _ in range(int(self.rng.integers(1, k + 1))):
            r = self.rng.random()
            nr, nc = self.axis_len[row]
            if r < 0.3 or nr == 0 or nc == 0:
                axis = int(self.rng.integers(0, 2))
                cnt = int(self.rng.integers(1, 3))
                ops.append(dict(target=axis, kind=mtk.MT_INSERT,
                                pos=int(self.rng.integers(
                                    0, self.axis_len[row, axis] + 1)),
                                count=cnt,
                                handle_base=int(self.handles[row])))
                self.handles[row] += cnt
                self.axis_len[row, axis] += cnt
            elif r < 0.4 and max(nr, nc) > 2:
                axis = 0 if nr > 2 else 1
                s = int(self.rng.integers(0, self.axis_len[row, axis] - 1))
                ops.append(dict(target=axis, kind=mtk.MT_REMOVE, pos=s,
                                end=s + 1))
                self.axis_len[row, axis] -= 1
            else:
                ops.append(dict(target=mxk.MX_CELL,
                                row=int(self.rng.integers(0, nr)),
                                col=int(self.rng.integers(0, nc)),
                                value=int(self.rng.integers(1, 1 << 16))))
        return ops

    def _tree(self, row, k):
        ops = []
        nodes = self.tree_nodes[row]
        for _ in range(int(self.rng.integers(1, k + 1))):
            r = self.rng.random()
            slots = self.shape["tree_slots"]
            if (not nodes or r < 0.4) and self.tree_next[row] < slots:
                node = int(self.tree_next[row])
                self.tree_next[row] += 1
                kind = (tk.TREE_INSERT if not nodes or r < 0.25
                        else tk.TREE_INSERT_BEFORE)
                parent = 0 if kind == tk.TREE_INSERT else int(
                    self.rng.choice(nodes))
                ops.append(dict(kind=kind, node=node, parent=parent,
                                trait=1, payload=int(
                                    self.rng.integers(0, 99))))
                nodes.append(node)
            elif nodes and r < 0.55:
                ops.append(dict(kind=tk.TREE_MOVE,
                                node=int(self.rng.choice(nodes)),
                                parent=int(self.rng.choice([0] + nodes)),
                                trait=2))
            elif nodes and r < 0.62:
                node = int(self.rng.choice(nodes))
                ops.append(dict(kind=tk.TREE_DETACH, node=node))
            elif nodes:
                ops.append(dict(kind=tk.TREE_SET_VALUE,
                                node=int(self.rng.choice(nodes)),
                                payload=int(self.rng.integers(0, 999))))
        return ops

    def tick(self, t: int, mode: str = "fresh"):
        """One tick's numpy inputs: (scalars, map_words, packs dict,
        per-row subs). ``mode`` "resend" replays the previous tick's
        inputs verbatim (every op a dup), "gap" skips a cseq on every
        row (the whole batch rejected)."""
        if mode == "resend":
            return self.last
        sh = self.shape
        n = len(self.fams)
        scalars = np.zeros((n, 6), np.int32)
        words = np.zeros((n, sh["map_k"]), np.uint32)
        widths = {"text": sh["text_k"], "matrix": sh["matrix_k"],
                  "tree": sh["tree_k"]}
        fields = {"text": storm.TEXT_PACK, "matrix": storm.MATRIX_PACK,
                  "tree": storm.TREE_PACK}
        packs = {f: np.zeros((n, len(fields[f]), widths[f]), np.int32)
                 for f in widths}
        subs = {}
        for row, fam in enumerate(self.fams):
            client = int((t + row) % CLIENTS)
            blob = ""
            if fam == "map":
                k = int(self.rng.integers(1, sh["map_k"] + 1))
                w = ((self.rng.integers(0, 1 << 20, k).astype(np.uint32)
                      << 12)
                     | (self.rng.integers(0, sh["map_slots"], k)
                        .astype(np.uint32) << 2)
                     | self.rng.choice(np.array([0, 0, 0, 1, 2],
                                                np.uint32), k))
                words[row, :k] = w
                scalars[row, 5] = k
                ops = w
            else:
                if fam == "text":
                    ops, blob = self._text(row, widths[fam])
                elif fam == "matrix":
                    ops = self._matrix(row, widths[fam])
                else:
                    ops = self._tree(row, widths[fam])
                k = len(ops)
                pack = packs[fam]
                pack[row, 0, :k] = 1
                for i, name in enumerate(fields[fam][1:]):
                    default = (int(self.ref[row]) if name == "ref_seq"
                               else client if name == "client" else 0)
                    pack[row, i + 1, :k] = [op.get(name, default)
                                            for op in ops]
            cseq0 = int(self.cseq[row, client]) + 1
            if mode == "gap":
                cseq0 += 2
            else:
                self.cseq[row, client] += k
            scalars[row, :5] = (client, cseq0, int(self.ref[row]), 2 + t, k)
            subs[row] = (fam, ops, k, cseq0, int(self.ref[row]), client,
                         blob)
        self.last = (scalars, words, packs, subs)
        return self.last

    def ack(self, last: np.ndarray) -> None:
        """The acked last seq per row becomes its next ref."""
        self.ref = np.where(last > 0, last, self.ref)


def submit_script(serving, subs) -> None:
    """One tick of :class:`Script` submissions through a
    ``ShardedServing`` front door."""
    from fluidframework_tpu_torch.parallel import serving as tsv
    fields = {"text": tsv.TEXT_FIELDS, "matrix": tsv.MATRIX_FIELDS,
              "tree": tsv.TREE_FIELDS}
    for row, (fam, ops, k, cseq0, ref, client, blob) in subs.items():
        if fam == "map":
            serving.submit(row, np.asarray(ops, np.uint32), cseq0, ref,
                           client)
            continue
        planes = {f: np.array([op.get(f, ref if f == "ref_seq" else
                                      client if f == "client" else 0)
                               for op in ops], np.int32)
                  for f in fields[fam]}
        serving.submit_planes(row, fam, planes, k, cseq0, ref, client,
                              text=blob)


def merged(harvest) -> dict:
    out = {}
    for rows in harvest.values():
        out.update(rows)
    return out


# -- the two-process run --------------------------------------------------------

NUM_DOCS = 16
FAMS = [FAMILIES[r % 4] for r in range(NUM_DOCS)]
MIXED = dict(num_docs=NUM_DOCS, k=6, num_hosts=4, num_clients=2,
             map_slots=16, text_slots=64, text_k=4, matrix_vec_slots=32,
             matrix_cell_slots=48, matrix_k=4, tree_slots=16, tree_k=4)
TICKS = 4
SEG_SLOTS = 64


#: A text block geometry small enough for the block-table ladder to fire
#: within a few ticks (the serving default's 128-slot blocks never fill in
#: a test this size).
TIGHT_TEXT = (4, 16)


def tighten_text(serving) -> None:
    """Re-make the port serving's (still empty) text table at
    :data:`TIGHT_TEXT`."""
    from fluidframework_tpu_torch.ops import mergetree_blocks as mtb
    serving.text_geometry = TIGHT_TEXT
    serving.merge_state = [
        mtb.init_state(hi - lo, *TIGHT_TEXT, serving.text_props,
                       mtk.overlap_words_for(serving.num_clients), dev)
        for (lo, hi), dev in zip(serving.shard_rows, serving.devices)]


def serve(serving, lo: int, hi: int) -> list:
    """Serve :data:`TICKS` ticks of the seeded script, submitting only rows
    [lo, hi); returns each tick's merged harvest."""
    tighten_text(serving)
    serving.join_all(slots=(0, 1))
    script = Script(FAMS, 61, SHAPE)
    acks = []
    for t in range(TICKS):
        subs = {row: sub for row, sub in script.tick(t)[3].items()
                if lo <= row < hi}
        submit_script(serving, subs)
        got = merged(serving.tick(now=2 + t))
        last = np.zeros(NUM_DOCS, np.int64)
        for row, (_n, _f, lst) in got.items():
            last[row] = lst
        script.ack(last)
        acks.append({str(row): list(v) for row, v in sorted(got.items())})
    return acks


def seg_stream(seed: int, n_ops: int) -> list[dict]:
    """Seeded text ops for one document (positions valid in each op's
    frame: every op sees the previous ones)."""
    rng = random.Random(seed)
    ops, length = [], 0
    for seq in range(1, n_ops + 1):
        if length > 4 and rng.random() < 0.4:
            s = rng.randrange(length - 2)
            e = s + rng.randint(1, min(4, length - s))
            ops.append(dict(kind=mtk.MT_REMOVE, pos=s, end=e, seq=seq,
                            ref_seq=seq - 1, client=rng.randrange(4)))
            length -= e - s
        else:
            n = rng.randint(1, 4)
            ops.append(dict(kind=mtk.MT_INSERT, pos=rng.randint(0, length),
                            seq=seq, ref_seq=seq - 1,
                            client=rng.randrange(4), pool_start=seq * 10,
                            text_len=n))
            length += n
    return ops


def seg_run(mesh) -> dict:
    """The seeded stream through ``apply_tick_sharded`` on ``mesh``."""
    full = mtk.init_state(1, SEG_SLOTS, 2, 1, "cpu")
    state = mts.shard_merge_state(full, mesh)
    stream = seg_stream(5, 40)
    for start in range(0, len(stream), 8):
        batch = mtk.make_merge_op_batch([stream[start:start + 8]], 1, 8,
                                        device="cpu")
        state = mts.apply_tick_sharded(state, batch, mesh)
    return {f: getattr(state, f).numpy().tolist()
            for f in mtk.MergeState._fields}


def _planes(serving) -> dict:
    return {name: [x.tolist() for x in tree_leaves(serving.family_rows(name))]
            for name in serving._family_states()}


def worker(rank: int, world: int, port: int, out: str) -> None:
    torch.set_num_threads(1)
    assert multihost.initialize(f"127.0.0.1:{port}", world, rank,
                                device="cpu")
    mesh = multihost.global_mesh(["cpu"] * 2)
    lo, hi = multihost.local_docs(mesh, NUM_DOCS)
    serving = ShardedServing(mesh, **MIXED)
    acks = serve(serving, lo, hi)
    seg_mesh = mts.make_seg_mesh(["cpu"], rank=rank, world=world)
    result = dict(lo=lo, hi=hi, acks=acks, planes=_planes(serving),
                  metrics=serving.global_metrics(),
                  rebalance=serving.rebalance_stats,
                  seg=seg_run(seg_mesh))
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()
    Path(out).write_text(json.dumps(result))


# -- tests ----------------------------------------------------------------------


def test_initialize_single_process_is_noop():
    assert multihost.initialize() is False
    assert multihost.initialize(num_processes=1) is False
    assert multihost.global_mesh(["cpu"] * 4).world == 1


def test_local_docs_and_feed():
    mesh = make_mesh(["cpu"] * 4)
    assert multihost.local_docs(mesh, 32) == (0, 32)
    second = make_mesh(["cpu"] * 2, rank=1, world=2)
    assert multihost.local_docs(second, 32) == (16, 32)
    state = seqk.init_state(8, 4, "cpu")
    ops = seqk.make_op_batch(
        [[dict(kind=int(MessageType.CLIENT_JOIN), slot=-1, target=0,
               timestamp=1)] for _ in range(8)], 8, 2, "cpu")
    fed_state = multihost.feed(mesh, state, global_batch=8)
    fed_ops = multihost.feed(mesh, ops, global_batch=8)
    assert [s.seq.shape[0] for s in fed_state] == [2, 2, 2, 2]
    outs = [seqk.process_batch(s, o)[0] for s, o in zip(fed_state, fed_ops)]
    assert torch.cat([o.seq for o in outs]).tolist() == [1] * 8
    with pytest.raises(ValueError):
        multihost.feed(second, state, global_batch=32)
    env = multihost.child_process_env(1, 2, "127.0.0.1:9")
    assert env["CUDA_VISIBLE_DEVICES"] == ""
    assert env["FFTPU_NUM_PROCESSES"] == "2"
    assert multihost.child_process_env() == {"CUDA_VISIBLE_DEVICES": ""}


def test_two_process_gloo_serving_equals_one_process(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = Path(__file__).resolve().parent.parent
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("FFTPU_", "XLA_", "JAX_"))}
    env["PYTHONPATH"] = str(root)
    outs = [tmp_path / f"rank{r}.json" for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), str(r), "2",
         str(port), str(outs[r])], cwd=root, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} failed:\n{logs[r]}"
    results = [json.loads(o.read_text()) for o in outs]

    one = ShardedServing(make_mesh(["cpu"] * 4), **MIXED)
    acks = serve(one, 0, NUM_DOCS)
    planes = _planes(one)
    for t in range(TICKS):
        union = {}
        for res in results:
            union.update(res["acks"][t])
        assert union == acks[t], t
    for res in results:
        lo, hi = res["lo"], res["hi"]
        for name, leaves in planes.items():
            for i, leaf in enumerate(leaves):
                assert res["planes"][name][i] == leaf[lo:hi], (name, i)
        assert res["metrics"] == one.global_metrics()
        assert res["rebalance"] == one.rebalance_stats
    assert one.rebalance_stats["fired"] > 0

    # The distributed primitives: each rank's half of the segment axis
    # equals the stacked 2-shard run's.
    stacked = seg_run(mts.make_seg_mesh(["cpu"] * 2))
    half = SEG_SLOTS // 2
    for r, res in enumerate(results):
        for f, plane in stacked.items():
            want = plane if f == "count" else [
                row[r * half:(r + 1) * half] for row in plane]
            assert res["seg"][f] == want, (r, f)


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
