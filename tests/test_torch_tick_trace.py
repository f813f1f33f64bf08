"""Spans and counters inside the port's serving tick
(``fluidframework_tpu_torch/utils/tick_spans.py`` around
``server/storm.py`` ``_mixed_tick``).

Tracing is on exactly when the caller passes ``mark``: a traced tick
records one ledger entry (its legs' host ns, its root span, its host reads
and their wait) and lies on the profiler's host timeline as a
``storm.tick`` range holding one ``storm.<leg>`` range a leg, each with
the tick id as its argument; an untraced tick records nothing and opens
no range. Either way its outputs are the same in every plane. The block
ladder's device-to-host reads are counted on states built so that it
rests, spills right, needs the spill's left step, or rebalances in full.

The CPU runs the kernels' plain versions. The last case runs on the card
under ``torch.cuda.set_sync_debug_mode("warn")``, where every implicit
synchronisation warns, and holds the warnings to the counter.
"""

from __future__ import annotations

import contextlib
import importlib.util
import pathlib
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fluidframework_tpu_torch.ops import map_kernel as mk
from fluidframework_tpu_torch.ops import matrix_kernel as mxk
from fluidframework_tpu_torch.ops import mergetree_blocks as mtb
from fluidframework_tpu_torch.ops import mergetree_kernel as mtk
from fluidframework_tpu_torch.ops import sequencer as seqk
from fluidframework_tpu_torch.ops import tree_kernel as tk
from fluidframework_tpu_torch.parallel.mesh import tree_leaves
from fluidframework_tpu_torch.protocol.messages import MessageType
from fluidframework_tpu_torch.server import storm
from fluidframework_tpu_torch.utils import tick_spans
from fluidframework_tpu_torch.utils.metrics import STORM_STAGES, StageLedger


def _multihost():
    """``tests/test_torch_multihost.py`` (its seeded mixed script), loaded
    by path so that this file also runs without the suite's layout."""
    path = pathlib.Path(__file__).with_name("test_torch_multihost.py")
    spec = importlib.util.spec_from_file_location("torch_multihost_script",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


MH = _multihost()
MIXED = [MH.FAMILIES[r % 4] for r in range(8)]
#: (rows' families, text geometry, ticks): every family together, and
#: text alone at a geometry where the ladder spills and rebalances.
CASES = {"mixed": (MIXED, None, 4),
         "text_ladder": (["text"] * 2, dict(text_blocks=2, text_bk=24), 9)}


def _joined_seq(n, device):
    state = seqk.init_state(n, MH.CLIENTS + 1, device=device)
    ops = seqk.make_op_batch(
        [[dict(kind=int(MessageType.CLIENT_JOIN), slot=-1, target=c,
               timestamp=1) for c in range(MH.CLIENTS)] for _ in range(n)],
        n, MH.CLIENTS, device=device)
    return seqk.process_batch(state, ops)[0]


def _states(fams, shape, device="cpu"):
    sh = dict(MH.SHAPE, **(shape or {}))
    n, present = len(fams), set(fams)
    w = mtk.overlap_words_for(MH.CLIENTS)
    return [_joined_seq(n, device), mk.init_state(n, sh["map_slots"], device),
            mtb.init_state(n, sh["text_blocks"], sh["text_bk"], 4, w, device)
            if "text" in present else None,
            mxk.init_state(n, sh["vec_slots"], sh["cell_slots"], w, device)
            if "matrix" in present else None,
            tk.init_state(n, sh["tree_slots"], device)
            if "tree" in present else None]


def _serve(case, mark, device="cpu", around=contextlib.nullcontext):
    """Each tick's 12 outputs of the case's script, ``mark`` passed, each
    call inside ``around()``."""
    fams, shape, ticks = CASES[case]
    script = MH.Script(fams, 8, shape)
    st = _states(fams, shape, device)
    present = set(fams)
    outs = []
    for t in range(ticks):
        scalars, words, packs, _subs = script.tick(t)
        packs = {f: (torch.from_numpy(p).to(device) if f in present
                     else None) for f, p in packs.items()}
        args = (torch.from_numpy(scalars).to(device),
                torch.from_numpy(words.view(np.int32)).to(device),
                packs["text"], packs["matrix"], packs["tree"])
        with around():
            out = storm._mixed_tick(*st, *args, mark=mark)
        st = list(out[:5])
        outs.append(out)
        script.ack(out[7].cpu().numpy())
    return outs


class Marks:
    """A ``mark`` hook that keeps the legs it was called with."""

    def __init__(self) -> None:
        self.legs: list = []

    def __call__(self, leg: str) -> None:
        self.legs.append(leg)


def _legs_run(case):
    fams = set(CASES[case][0])
    return [leg for leg in tick_spans.LEGS
            if leg in ("deli", "map")
            or (leg == "rebalance" and "text" in fams) or leg in fams]


def _planes(out):
    return [x.cpu().numpy() for x in tree_leaves(list(out))
            if x is not None]


@pytest.mark.parametrize("case", sorted(CASES))
def test_untraced_tick_records_nothing_and_matches_a_traced_one(case):
    before = len(tick_spans.LEDGER)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        plain = _serve(case, None)
    assert len(tick_spans.LEDGER) == before
    assert not [e.name for e in prof.events()
                if e.name.startswith("storm.")]
    traced = _serve(case, Marks())
    assert len(tick_spans.LEDGER) == before + len(traced)
    for t, (a, b) in enumerate(zip(plain, traced)):
        pa, pb = _planes(a), _planes(b)
        assert len(pa) == len(pb), t
        for i, (x, y) in enumerate(zip(pa, pb)):
            assert x.dtype == y.dtype and np.array_equal(x, y), (t, i)


@pytest.mark.parametrize("case", sorted(CASES))
def test_traced_tick_records_each_tick_and_calls_mark_in_order(case):
    marks = Marks()
    before = len(tick_spans.LEDGER)
    outs = _serve(case, marks)
    recs = tick_spans.LEDGER.records()[before:]
    legs = _legs_run(case)
    assert len(recs) == len(outs)
    assert [r["tick"] for r in recs] == list(
        range(recs[0]["tick"], recs[0]["tick"] + len(outs)))
    assert marks.legs == legs * len(outs)
    starts = [r["start_ns"] for r in recs]
    assert starts == sorted(starts)
    for r in recs:
        assert [leg for leg in tick_spans.LEGS if r[leg] > 0] == legs
        assert sum(r[leg] for leg in legs) <= r["span_ns"]
        assert r["host_reads"] >= 1 and 0 < r["host_read_ns"] <= r[
            "rebalance"]
        assert r["profiled"] == 0


def test_profiler_ranges_nest_in_the_tick_and_carry_its_id():
    before = len(tick_spans.LEDGER)
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        outs = _serve("mixed", Marks())
    recs = tick_spans.LEDGER.records()[before:]
    assert [r["profiled"] for r in recs] == [1] * len(outs)
    events = sorted((e for e in prof.events()
                     if e.name.startswith("storm.")),
                    key=lambda e: e.time_range.start)
    ticks = [e for e in events if e.name == "storm.tick"]
    assert [e.concrete_inputs[0] for e in ticks] == [r["tick"]
                                                     for r in recs]
    for tick in ticks:
        inside = [e for e in events if e is not tick
                  and tick.time_range.start <= e.time_range.start
                  and e.time_range.end <= tick.time_range.end]
        legs = [e for e in inside if e.name != "storm.host_read"]
        assert [e.name for e in legs] == [
            f"storm.{leg}" for leg in _legs_run("mixed")]
        assert all(e.cpu_parent is tick for e in legs)
        assert {e.concrete_inputs[0] for e in inside} == {
            tick.concrete_inputs[0]}
        reads = [e for e in inside if e.name == "storm.host_read"]
        assert reads and all(e.cpu_parent.name == "storm.rebalance"
                             for e in reads)


#: Block counts of the one text row a ladder case starts from (4 blocks
#: of 16 slots, tick width 1: cap 12), the branch it takes, whether the
#: spill needs its left step, and the reads the tick makes: the flags;
#: then the spill's any() over the right step and its touched count, or
#: the full rebalance's one read of the slots that move.
LADDER = {"at_rest": ([5, 5, 5, 5], 0, False, 1),
          "spill_right": ([13, 0, 0, 0], 1, False, 3),
          "spill_left": ([0, 0, 0, 13], 1, True, 3),
          "full": ([13, 13, 13, 13], 2, False, 2)}


def _ladder_tick(counts, mark, device="cpu", around=contextlib.nullcontext):
    """One tick with no ops on a text row whose blocks hold ``counts``
    live one-character segments (the call inside ``around()``)."""
    w = mtk.overlap_words_for(MH.CLIENTS)
    st = mtb.init_state(1, 4, 16, 4, w, device)
    blk = torch.tensor([counts], dtype=torch.int32, device=device)
    occ = (torch.arange(16, device=device)[None, None]
           < blk[:, :, None])
    st = mtb.recompute_summaries(st._replace(
        blk_count=blk,
        length=torch.where(occ, 1, st.length),
        ins_seq=torch.where(occ, 1, st.ins_seq),
        ins_client=torch.where(occ, 0, st.ins_client),
        pool_start=torch.where(
            occ, torch.arange(64, dtype=torch.int32, device=device)
            .reshape(1, 4, 16), st.pool_start)))
    seq = _joined_seq(1, device)
    scalars = torch.zeros((1, 6), dtype=torch.int32, device=device)
    pack = torch.zeros((1, len(storm.TEXT_PACK), 1), dtype=torch.int32,
                       device=device)
    map_state = mk.init_state(1, 16, device)
    with around():
        return storm._mixed_tick(seq, map_state, st, None, None, scalars,
                                 None, pack, None, None, mark=mark)


@pytest.mark.parametrize("case", sorted(LADDER))
def test_host_reads_count_the_ladders_reads(case, monkeypatch):
    counts, branch, left, reads = LADDER[case]
    steps = []
    spill = mtb._spill

    def counted(planes, c, cap, right):
        steps.append("right" if right else "left")
        return spill(planes, c, cap, right)
    monkeypatch.setattr(mtb, "_spill", counted)
    before = len(tick_spans.LEDGER)
    out = _ladder_tick(counts, Marks())
    (rec,) = tick_spans.LEDGER.records()[before:]
    assert int(out[11][storm.KSTAT_REBALANCE_FIRED]) == int(branch > 0)
    assert steps == (["right", "left"] if left else
                     ["right"] if branch == 1 else [])
    assert rec["host_reads"] == reads
    assert 0 < rec["host_read_ns"] <= rec["rebalance"]
    assert len(_ladder_tick(counts, None)) == 12
    assert len(tick_spans.LEDGER) == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(LADDER) + sorted(CASES))
def test_host_reads_equal_the_syncs_the_card_reports(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (sync debug mode is CUDA's)")
    syncs = []

    @contextlib.contextmanager
    def watched():
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                yield
        finally:
            torch.cuda.set_sync_debug_mode("default")
        syncs.extend(w for w in caught if "synchroniz" in str(w.message))
    before = len(tick_spans.LEDGER)
    if case in LADDER:
        _ladder_tick(LADDER[case][0], Marks(), "cuda", watched)
    else:
        _serve(case, Marks(), "cuda", watched)
    recs = tick_spans.LEDGER.records()[before:]
    assert syncs and len(syncs) == sum(r["host_reads"] for r in recs)


@pytest.mark.parametrize("fields", [(), tick_spans.LEDGER.fields])
def test_stage_ledger_records_its_fields_alone(fields):
    led = StageLedger(fields=fields)
    rec = led.record(3, 1, 2, 4, {"readback": 5},
                     fields={f: 7 for f in fields})
    assert list(rec) == ["tick", "queue_depth", "batch_docs", "batch_ops",
                         "wall", "depth", *fields, *STORM_STAGES]
    assert [rec[f] for f in fields] == [7] * len(fields)
    with pytest.raises(ValueError):
        led.record(4, 0, 0, 0, {}, fields={"span": 1})
    assert len(led) == 1
