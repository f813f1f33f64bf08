"""The application tier through both packages, on the CPU.

* Every example app's two-client session (``main(["--doc", ...])`` in
  local mode) runs once through the JAX package and once through the
  port, with the service clock, the trace clock and ``uuid.uuid4``
  pinned: the printed lines, the whole sequenced delta log and a third
  Container's summary must be equal. Run again over a service with a
  merge host (the port's on the CPU), every row the merge host keeps
  must be the reference's, faults included: a row is built from
  sequenced ops alone, so content a Container wrote before attach is not
  in it, and a directory's keys fold by name whatever their path.
* ``tools/record_goldens.record_corpus`` of both packages into two
  temporary directories: every file byte for byte.
* The port's ``apply_tick_runs`` against the reference's XLA function on
  seeded run batches at two shapes: every ``MergeState`` plane exact.
"""

from __future__ import annotations

import importlib
import itertools
import random
import uuid
from types import SimpleNamespace

import numpy as np
import pytest

from fluidframework_tpu.ops import mergetree_kernel as j_mtk
from fluidframework_tpu.ops import mergetree_runs as j_mtr
from fluidframework_tpu.tools import record_goldens as j_record

from fluidframework_tpu_torch.ops import mergetree_kernel as t_mtk
from fluidframework_tpu_torch.ops import mergetree_runs as t_mtr
from fluidframework_tpu_torch.tools import record_goldens as t_record

PACKAGES = {"jax": "fluidframework_tpu", "torch": "fluidframework_tpu_torch"}
#: The port builds its device hosts on the card unless asked.
DEVICE = {"jax": {}, "torch": {"device": "cpu"}}
EXAMPLES = ["clicker", "collab_text", "dice_roller", "task_board",
            "whiteboard", "table_document", "rich_text_editor"]


def _module(side: str, name: str):
    return importlib.import_module(f"{PACKAGES[side]}.{name}")


def _pin(side: str, monkeypatch) -> None:
    """Pin everything a session reads from the clock or the entropy pool:
    the deli's trace clock, ``uuid.uuid4`` (datastore and paragraph ids)
    and the rich-text editor's paragraph counter."""
    messages = _module(side, "protocol.messages")
    monkeypatch.setattr(messages, "time", SimpleNamespace(
        monotonic=itertools.count(1).__next__))
    ids = itertools.count(1)
    monkeypatch.setattr(uuid, "uuid4", lambda: uuid.UUID(int=next(ids)))
    monkeypatch.setattr(_module(side, "examples.rich_text_editor"), "_ids",
                        itertools.count())


def _example_session(side: str, name: str, monkeypatch, capsys,
                     merge_host: bool = False):
    """Run one example's ``main`` in local mode; return what it printed,
    its sequenced log on the wire and a third Container's summary (and,
    over a merge host, every row it keeps)."""
    doc = f"diff-{name}"
    _pin(side, monkeypatch)
    routerlicious = _module(side, "server.routerlicious")
    built = []

    def service(*args, **kwargs):
        if merge_host:
            kwargs["merge_host"] = _module(
                side, "server.merge_host").KernelMergeHost(**DEVICE[side])
        svc = real(*args, **kwargs)
        svc._clock = itertools.count(1000, 7).__next__
        built.append(svc)
        return svc

    real = routerlicious.RouterliciousService
    monkeypatch.setattr(routerlicious, "RouterliciousService", service)
    capsys.readouterr()
    _module(side, f"examples.{name}").main(["--doc", doc])
    out = capsys.readouterr().out
    (svc,) = built
    to_wire = _module(side, "protocol.codec").to_wire
    deltas = [to_wire(m) for m in svc.get_deltas(doc, 0)]
    third = _module(side, "runtime.container").Container.load(
        _module(side, "drivers.local_driver").LocalDocumentService(svc, doc))
    svc.pump()
    canonical = _module(side, "tools.replay").canonical
    summary = canonical(third.summarize())
    if merge_host:
        return out, deltas, summary, canonical(svc.merge_host.summarize(doc))
    return out, deltas, summary


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_session_is_the_same_in_both_packages(name, monkeypatch,
                                                      capsys):
    got = {side: _example_session(side, name, monkeypatch, capsys)
           for side in PACKAGES}
    out, deltas, summary = got["torch"]
    assert out and deltas and summary != "{}"
    assert out == got["jax"][0]
    assert deltas == got["jax"][1]
    assert summary == got["jax"][2]


@pytest.mark.parametrize("name", EXAMPLES)
def test_merge_host_rows_are_the_references(name, monkeypatch, capsys):
    got = {side: _example_session(side, name, monkeypatch, capsys,
                                  merge_host=True)
           for side in PACKAGES}
    assert got["torch"] == got["jax"]
    rows = got["torch"][3]
    assert rows != "{}"
    if name == "collab_text":
        # The Container reads "doc: hello world"; "hello" came in the
        # attach snapshot, which the merge host never sees.
        assert "world" in rows and "hello" not in rows


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """Both packages' golden corpora, recorded with the trace clock and
    ``uuid.uuid4`` pinned."""
    roots = {}
    for side, record in (("jax", j_record), ("torch", t_record)):
        with pytest.MonkeyPatch.context() as mp:
            _pin(side, mp)
            roots[side] = tmp_path_factory.mktemp(f"goldens_{side}")
            assert record.record_corpus(roots[side]) == list(
                t_record.SCENARIOS)
    return roots


@pytest.mark.parametrize("name", list(t_record.SCENARIOS))
def test_record_goldens_is_byte_equal(name, corpora):
    files = {side: sorted(p.relative_to(root / name)
                          for p in (root / name).rglob("*") if p.is_file())
             for side, root in corpora.items()}
    assert files["torch"] == files["jax"] and files["torch"]
    for rel in files["torch"]:
        assert ((corpora["torch"] / name / rel).read_bytes()
                == (corpora["jax"] / name / rel).read_bytes()), rel


def _stream(rng: random.Random, n_ops: int) -> list[dict]:
    """A seeded sequenced stream of inserts, removes and annotates (the
    shape of ``tests/test_mergetree_runs.py``'s streams)."""
    ops, length, pool = [], 0, 0
    for seq in range(1, n_ops + 1):
        client, r = rng.randrange(4), rng.random()
        if length > 24 and r < 0.25:
            start = rng.randrange(length - 8)
            end = start + rng.randint(1, 6)
            ops.append(dict(kind=j_mtk.MT_REMOVE, pos=start, end=end,
                            seq=seq, ref_seq=seq - 1, client=client))
            length -= end - start
        elif length > 24 and r < 0.40:
            start = rng.randrange(length - 8)
            ops.append(dict(kind=j_mtk.MT_ANNOTATE, pos=start,
                            end=start + rng.randint(1, 6), seq=seq,
                            ref_seq=seq - 1, client=client,
                            prop_key=rng.randrange(2),
                            prop_val=rng.randrange(1, 50)))
        else:
            tlen = rng.randint(1, 6)
            ops.append(dict(kind=j_mtk.MT_INSERT, pos=rng.randint(0, length),
                            seq=seq, ref_seq=seq - 1, client=client,
                            pool_start=pool, text_len=tlen))
            pool += tlen
            length += tlen
    return ops


@pytest.mark.parametrize("docs,n_ops,r_max", [(4, 32, 8), (8, 64, 16)])
@pytest.mark.parametrize("seed", range(2))
def test_apply_tick_runs_matches_reference(docs, n_ops, r_max, seed):
    rng = random.Random(1_000 * docs + seed)
    streams = [_stream(rng, n_ops) for _ in range(docs)]
    num_slots = 4 * n_ops + 8
    runs = [j_mtr.pack_runs(s, r_max=r_max) for s in streams]
    assert [t_mtr.pack_runs(s, r_max=r_max) for s in streams] == runs
    steps = max(len(r) for r in runs)
    want = j_mtr.apply_tick_runs(
        j_mtk.init_state(docs, num_slots),
        j_mtr.make_run_batch(runs, docs, steps, r_max))
    got = t_mtr.apply_tick_runs(
        t_mtk.init_state(docs, num_slots, device="cpu"),
        t_mtr.make_run_batch(runs, docs, steps, r_max, device="cpu"))
    assert int(got.count.max()) > n_ops  # the tick really grew the tables
    for field in j_mtk.MergeState._fields:
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)),
                                      err_msg=field)
