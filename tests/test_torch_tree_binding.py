"""The tree tick kernel's binding (``ops/tree_cuda.py``), without a card.

On the CPU ``apply_tick_best`` is the plain tick and counts no launch.
The launcher's pointer layout, its constants and its shared-memory
formula (documents a block from N alone, bytes a block) are read from
``csrc/tree_tick_smem.cu`` against the binding's, as
``tests/test_torch_smem_variants.py`` does for kernels 1-6; the choice
of documents a block is pinned at the serving widths and past the card's
limit. Inputs the kernel does not take raise ``KernelInputError``. The
serving tick's tree leg goes through the wrapper once a tick and shard
(the merge host's flush: ``tests/test_torch_tree_host.py``).
"""

from __future__ import annotations

import random
import re

import pytest
import torch

from fluidframework_tpu_torch.ops import _build
from fluidframework_tpu_torch.ops import tree_cuda as tcc
from fluidframework_tpu_torch.ops import tree_kernel as tk

#: cudaDevAttrMaxSharedMemoryPerBlockOptin of an H100.
H100_OPTIN = 232_448


def _source() -> str:
    return (_build.CSRC / "tree_tick_smem.cu").read_text()


def _define(macro: str) -> str:
    return re.search(rf"#define {macro} (.+)", _source())[1].strip()


def _random_tick(seed: int, b: int = 6, n: int = 24, k: int = 12):
    rng = random.Random(seed)
    state = tk.init_state(b, n, "cpu")
    per_doc = []
    for d in range(b):
        ops = [dict(kind=tk.TREE_INSERT, node=i, parent=rng.randrange(i),
                    trait=rng.randrange(2), payload=i)
               for i in range(1, rng.randrange(2, 9))]
        ops += [dict(kind=rng.randrange(12), node=rng.randrange(-1, n + 1),
                     parent=rng.randrange(-1, n + 1),
                     trait=rng.randrange(2), payload=rng.randrange(4))
                for _ in range(rng.randrange(0, k - len(ops) + 1))]
        per_doc.append(ops)
    return state, tk.make_tree_op_batch(per_doc, b, k, "cpu"), per_doc


@pytest.mark.parametrize("steps", ["host", None, "off"])
def test_cpu_tensors_take_the_plain_tick_and_count_nothing(steps):
    tcc.tick.reset()
    state, ops, per_doc = _random_tick(4)
    k = ops.valid.shape[1]
    flags = {"host": tk.subtree_steps(per_doc, k), None: None,
             "off": [False] * k}[steps]
    for _tick in range(3):
        want_s, want_o = tk.apply_tick(state, ops, flags)
        got_s, got_o = tcc.apply_tick_best(state, ops, flags)
        assert all(torch.equal(x, y) for x, y in zip(got_s, want_s))
        assert all(torch.equal(x, y) for x, y in zip(got_o, want_o))
        state = got_s
    assert (tcc.tick.launches, tcc.tick.shapes, tcc.tick.variants) \
        == (0, {}, {})


def test_launcher_reads_the_bindings_layout():
    """The launcher reads its pointer array in the order its layout
    string names, which is the binding's: the state, the op batch, the
    output state and the two flag planes."""
    src = _source()
    body = re.search(r"tree_tick_smem_layout\(\)\s*\{\s*return(.*?);", src,
                     re.S)[1]
    layout = tuple("".join(re.findall(r'"([^"]*)"', body)).split(","))
    reads = re.findall(r"a\.(\w+) = \([^)]*\)p\[(\d+)\];", src)
    assert layout == tcc.LAYOUT
    assert [int(i) for _, i in reads] == list(range(len(tcc.LAYOUT)))
    assert tuple(name for name, _ in reads) == tcc.LAYOUT
    assert tcc.LAYOUT[:5] == tk.TreeState._fields
    assert tcc.LAYOUT[-2:] == tk.TreeOpOut._fields


def test_launcher_arguments_match_the_binding():
    """(pointers, B, N, K, smem bytes, step words, word count, stream):
    the argument list the binding's argtypes give."""
    params = re.search(r"tree_tick_smem_launch\((.*?)\)\s*\{", _source(),
                       re.S)[1]
    names = [p.split()[-1].lstrip("*") for p in params.split(",")]
    assert names == ["p", "B", "N", "K", "smem_bytes", "steps", "n_words",
                     "stream"]


def test_constants_match_the_source():
    assert int(_define("TT_SLOT_BYTES")) == tcc.SLOT_BYTES \
        == 1 + 4 * 4 + 2
    assert int(_define("TT_DOCS")) == tcc.DOCS
    assert int(_define("TT_BLOCK_BYTES")) == tcc.BLOCK_BYTES
    assert int(_define("TT_STEP_WORDS")) == tcc.STEP_WORDS
    assert int(_define("TT_RANK_GAP")) == tk.RANK_GAP
    assert _define("TT_RANK_LIMIT") == "(1 << 30)" \
        and 1 << 30 == tk.RANK_LIMIT
    assert int(_define("TT_MAX_DEPTH_PASSES")) == tk.MAX_DEPTH_PASSES
    kinds = {"SET_VALUE": tk.TREE_SET_VALUE, "DETACH": tk.TREE_DETACH,
             "INSERT": tk.TREE_INSERT,
             "INSERT_BEFORE": tk.TREE_INSERT_BEFORE,
             "INSERT_AFTER": tk.TREE_INSERT_AFTER,
             "INSERT_START": tk.TREE_INSERT_START,
             "CONSTRAINT_EXISTS": tk.TREE_CONSTRAINT_EXISTS,
             "CONSTRAINT_COUNT": tk.TREE_CONSTRAINT_COUNT,
             "MOVE": tk.TREE_MOVE, "MOVE_BEFORE": tk.TREE_MOVE_BEFORE,
             "MOVE_AFTER": tk.TREE_MOVE_AFTER,
             "MOVE_START": tk.TREE_MOVE_START}
    for name, value in kinds.items():
        assert int(_define(f"TT_{name}")) == value, name


def test_shared_memory_formula_matches_the_source():
    """The source's bytes a document (``tt_doc_bytes``), evaluated at
    several widths, equal the binding's; its documents a block
    (``tt_docs``) and the launcher's check are the same formula."""
    src = _source()
    expr = re.search(r"tt_doc_bytes\(int N\) \{\s*return (.*?);", src,
                     re.S)[1]
    py = expr.replace("(long long)", "").replace("/", "//") \
        .replace("TT_SLOT_BYTES", str(tcc.SLOT_BYTES))
    for n in (1, 7, 32, 100, 128, 256, 600, 2048, 12234, 12235):
        assert eval(py, {"N": n}) == tcc.doc_bytes(n), n
    docs = re.search(r"tt_docs\(int N\) \{(.*?)\n\}", src, re.S)[1]
    assert "TT_BLOCK_BYTES / tt_doc_bytes(N)" in docs
    assert "d < 1 ? 1 : (d > TT_DOCS ? TT_DOCS : (int)d)" in docs
    assert "smem_bytes != tt_docs(N) * tt_doc_bytes(N)" in src


@pytest.mark.parametrize("n,docs,nbytes", [
    (128, 8, 19_456),    # the mixed cell's tree rows
    (256, 8, 38_912),    # tree B
    (32, 8, 4_864),      # the merge host's first width
    (600, 4, 45_632),    # rows rounded to 16 bytes
    (2048, 1, 38_912),   # one document a block from here on
    (8192, 1, 155_648),  # the merge host's widest doubling that fits
    (12234, 1, 232_448),  # the widest row the card takes
    (12235, 1, 232_480)])
def test_documents_a_block_by_width(n, docs, nbytes):
    assert tcc.docs_per_block(n) == docs
    assert tcc.smem_bytes(n) == nbytes
    if nbytes <= H100_OPTIN:
        assert tcc.fit_smem_bytes(n, H100_OPTIN) == nbytes
    else:
        with pytest.raises(_build.KernelInputError, match="shared memory"):
            tcc.fit_smem_bytes(n, H100_OPTIN)


def test_merge_host_widths_fit_until_past_the_limit():
    """The merge host doubles its tree slots from 32: every width up to
    8,192 fits one block, the next does not."""
    widths = [32 << i for i in range(10)]
    fits = [tcc.smem_bytes(n) <= H100_OPTIN for n in widths]
    assert fits == [True] * 9 + [False]
    assert widths[8] == 8192


def _meta_inputs(b=4, n=16, k=8):
    state = tk.TreeState(
        torch.zeros((b, n), dtype=torch.bool, device="meta"),
        *(torch.zeros((b, n), dtype=torch.int32, device="meta")
          for _ in range(4)))
    ops = tk.TreeOpBatch(
        torch.zeros((b, k), dtype=torch.bool, device="meta"),
        *(torch.zeros((b, k), dtype=torch.int32, device="meta")
          for _ in range(5)))
    return state, ops


def test_wrong_inputs_raise_kernel_input_error():
    state, ops = _meta_inputs()
    assert tcc.check_inputs(state, ops) == (4, 16, 8)
    bad = [
        (state._replace(rank=state.rank.to(torch.int64)), ops),
        (state._replace(exists=state.exists.to(torch.uint8)), ops),
        (state, ops._replace(kind=ops.kind.to(torch.int16))),
        (state._replace(parent=torch.zeros((16, 4), dtype=torch.int32,
                                           device="meta").t()), ops),
        (state, ops._replace(node=torch.zeros((8, 4), dtype=torch.int32,
                                              device="meta").t())),
        (state._replace(trait=state.trait[:, :8]), ops),
        (state, ops._replace(valid=ops.valid[:2])),
        (state._replace(payload=torch.zeros((4, 16), dtype=torch.int32)),
         ops)]
    for s, o in bad:
        with pytest.raises(_build.KernelInputError,
                           match="must be a contiguous"):
            tcc.check_inputs(s, o)
        with pytest.raises(_build.KernelInputError,
                           match="must be a contiguous"):
            tcc.apply_tick_best(s, o)
    empty, eops = _meta_inputs(n=0)
    with pytest.raises(_build.KernelInputError, match="no slots"):
        tcc.check_inputs(empty, eops)
    with pytest.raises(_build.KernelInputError, match="not CUDA or CPU"):
        tcc.apply_tick_best(state, ops)
    assert issubclass(_build.KernelInputError, ValueError)


def test_step_mask_words():
    assert tcc.step_words(None, 8) is None
    words = tcc.step_words([True, False] * 40 + [True], 81)
    assert list(words) == [0x5555555555555555, 0x15555]
    assert list(tcc.step_words([False] * 8 + [True], 8)) == [0]
    with pytest.raises(_build.KernelInputError, match="step flags"):
        tcc.step_words([True] * 7, 8)
    limit = 64 * tcc.STEP_WORDS
    assert len(tcc.step_words([True] * limit, limit)) == tcc.STEP_WORDS
    with pytest.raises(_build.KernelInputError, match="step mask holds"):
        tcc.step_words([True] * (limit + 1), limit + 1)


def test_serving_tick_calls_the_wrapper_once_a_tick_and_shard(monkeypatch):
    """The mixed tick's tree leg goes through ``apply_tick_best``, once a
    tick for each shard; on the CPU that is the plain tick."""
    from fluidframework_tpu_torch.parallel.mesh import make_mesh
    from fluidframework_tpu_torch.parallel.serving import ShardedServing
    from tests.test_torch_multihost import MIXED, TICKS, serve

    calls = []
    inner = tcc.apply_tick_best

    def spy(state, ops, steps=None):
        calls.append((tuple(state.exists.shape), steps))
        return inner(state, ops, steps)
    monkeypatch.setattr(tcc, "apply_tick_best", spy)
    serving = ShardedServing(make_mesh(["cpu"] * 2), **MIXED)
    serve(serving, 0, MIXED["num_docs"])
    assert len(calls) == 2 * TICKS
    assert {shape for shape, _ in calls} \
        == {(MIXED["num_docs"] // 2, MIXED["tree_slots"])}
    assert all(len(steps) == MIXED["tree_k"] for _, steps in calls)

