"""One cell of the benchmark: its files, its traffic, its device states
and the window that drives the serving tick.

Everything a cell is comes from files found by name: the workload file
``workloads/<cell>.json`` names its configuration ``configs/<config>.json``
and gives each served family's traffic parameters; each family's traffic
comes from ``traffic/<family>.py``, its plain replay from
``reference/<family>.py`` and its reading of the program's state from
``readout/<family>.py``."""

from __future__ import annotations

import importlib
import json
import pathlib
import time

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent.parent

#: The serving tick's families: the state each keeps on the ShardedServing
#: and the fields of its tick input, in the tick's argument order.
FAMILIES = ("map", "text", "matrix", "tree")
STATE_ATTR = {"map": "map_state", "text": "merge_state",
              "matrix": "matrix_state", "tree": "tree_state"}
#: Columns of the [docs, ticks] harvest read back every tick.
HARVEST = ("n_seq", "first", "last", "msn", "tree_overflow", "text_overflow")
OVF_NONE = 2**31 - 1


def load_json(*parts: str) -> dict:
    with open(HERE.joinpath(*parts)) as f:
        return json.load(f)


def load_cell(name: str) -> tuple[dict, dict]:
    """(workload, configuration) of the cell ``name``."""
    work = load_json("workloads", f"{name}.json")
    return work, load_json("configs", f"{work['config']}.json")


def module(kind: str, family: str):
    return importlib.import_module(f"perfbench.{kind}.{family}")


def seed_words(seed: int) -> int:
    """The seed as an unsigned 64-bit word (any whole number is a seed)."""
    return int(seed) % 2**64


def family_rows(config: dict, family: str) -> np.ndarray:
    mod, rem = config["families"][family]["rows"]
    return np.arange(rem, config["docs"], mod)


def generate(config: dict, work: dict, seed: int, index: int) -> dict:
    """Input set ``index`` of the cell: one epoch of every family's ticks
    for every document. Returns host arrays: the [ticks, docs, 6]
    ``scalars``, per family its [ticks, docs, ...] tick input (``inputs``)
    and its rows' per-tick sizes (``size``), and ``sample``: the rows
    whose final state is compared, per family.

    Every document's stream is drawn from ``seed``; or, where the workload
    names a ``population_seed``, the cell's input sets are one fixed
    population of streams drawn from it, which ``seed`` orders and deals
    out to the rows (each family's to its own rows) and samples: every
    seed then gives the same work in another order."""
    base = work.get("population_seed")
    if base is None:
        return draw(config, work,
                    np.random.default_rng([seed_words(seed), index]))
    order = np.random.default_rng([seed_words(seed)]).permutation(
        work["input_sets"])
    population = draw(config, work, np.random.default_rng(
        [seed_words(base), int(order[index])]))
    return deal(config, work, population,
                np.random.default_rng([seed_words(seed), index]))


def deal(config: dict, work: dict, out: dict, rng) -> dict:
    """The input set ``out`` with each family's streams dealt out to a
    permutation of its own rows by ``rng``, and its sample drawn anew."""
    perm = np.arange(config["docs"])
    local = {}
    for fam in out["inputs"]:
        rows = family_rows(config, fam)
        local[fam] = rng.permutation(len(rows))
        perm[rows] = rows[local[fam]]
    out["scalars"] = out["scalars"][:, perm]
    out["inputs"] = {f: x[:, perm] for f, x in out["inputs"].items()}
    out["size"] = {f: x[:, local[f]] for f, x in out["size"].items()}
    for fam in out["inputs"]:
        out["sample"][fam] = sample_rows(config, work, fam, rng,
                                         out["size"].get(fam))
    return out


def sample_rows(config: dict, work: dict, fam: str, rng, size) -> np.ndarray:
    """Rows of ``fam`` whose final state is compared: ``work["sample"]``
    drawn by ``rng``, and the document that grew largest."""
    rows = family_rows(config, fam)
    pick = rng.choice(len(rows), min(work["sample"], len(rows)),
                      replace=False)
    if size is not None:
        pick = np.union1d(pick, [int(np.argmax(size[-1]))])
    return rows[np.sort(pick)]


def draw(config: dict, work: dict, rng) -> dict:
    """One input set of :func:`generate`, every stream drawn by ``rng``."""
    docs, ticks = config["docs"], config["epoch_ticks"]
    counts = np.zeros(docs, np.int64)
    served = [f for f in FAMILIES if f in config["families"]]
    for fam in served:
        counts[family_rows(config, fam)] = config["families"][fam]["k"]
    deli = module("traffic", "deli").generate(rng, counts,
                                              config["clients"], ticks)
    scalars = np.zeros((ticks, docs, 6), np.int32)
    scalars[:, :, 0] = deli["slot"]
    scalars[:, :, 1] = deli["cseq0"]
    scalars[:, :, 2] = deli["ref"]
    scalars[:, :, 3] = deli["ts"][:, None]
    scalars[:, :, 4] = counts
    out = {"scalars": scalars, "inputs": {}, "size": {}, "sample": {}}
    for fam in served:
        fc = config["families"][fam]
        rows = family_rows(config, fam)
        params = {**fc, **work["traffic"][fam], "writers": config["writers"]}
        ctx = {"ref": deli["ref"][:, rows], "slot": deli["slot"][:, rows]}
        gen = module("traffic", fam).generate(rng, len(rows), fc["k"],
                                              ticks, ctx, params)
        key = "words" if fam == "map" else "pack"
        full = np.zeros((ticks, docs) + gen[key].shape[2:], np.int32)
        full[:, rows] = gen[key]
        out["inputs"][fam] = full
        if fam == "map":
            scalars[:, rows, 5] = fc["k"]
        size = gen.get("size")
        if size is not None:
            out["size"][fam] = size
        out["sample"][fam] = sample_rows(config, work, fam, rng, size)
    return out


def generate_sets(config: dict, work: dict, seed: int) -> list:
    """The cell's ``input_sets`` input sets."""
    return [generate(config, work, seed, i)
            for i in range(work["input_sets"])]


def tree_steps(pack: np.ndarray) -> list:
    """[k] flags: some document's op at that index is of the tree tick's
    subtree kinds (detaches and moves), as ``ShardedServing.tick`` sets
    them from its host pack."""
    from fluidframework_tpu_torch.ops import tree_kernel as tk
    valid = pack[:, 0] != 0
    return [bool(x) for x in (valid & np.isin(pack[:, 1],
                                              list(tk.SUBTREE_KINDS))
                              ).any(axis=0)]


class Staged:
    """The cell's input sets on the device, the joined snapshot, and the
    sampled rows' indices."""

    def __init__(self, config: dict, sets: list, device) -> None:
        import torch

        from fluidframework_tpu_torch.parallel.mesh import make_mesh
        from fluidframework_tpu_torch.parallel.serving import ShardedServing
        from fluidframework_tpu_torch.server import storm
        self.torch = torch
        self.device = device
        self.config = config
        self.families = [f for f in FAMILIES if f in config["families"]]
        packs = {"text": storm.TEXT_PACK, "matrix": storm.MATRIX_PACK,
                 "tree": storm.TREE_PACK}
        for fam in self.families:
            if fam in packs and module("traffic", fam).FIELDS != packs[fam]:
                raise RuntimeError(f"the serving tick's {fam} fields are "
                                   f"{packs[fam]}, the traffic's differ")
        if storm.SCALAR_PACK != ("slot", "cseq0", "ref", "ts", "seq_counts",
                                 "map_counts"):
            raise RuntimeError("the serving tick's scalar fields changed")
        self.serving = ShardedServing(make_mesh([device]), num_hosts=1,
                                      **serving_kwargs(config))
        self.serving.join_all(slots=range(config["clients"]))
        self.snapshot = [self.serving.seq_state[0]] + [
            (getattr(self.serving, STATE_ATTR[f])[0]
             if f in self.families else None) for f in FAMILIES]
        self.ops_per_tick = int(sets[0]["scalars"][0, :, 4].sum())
        self.ticks = []
        for s in sets:
            epoch = []
            for t in range(config["epoch_ticks"]):
                args = [torch.from_numpy(s["scalars"][t]).to(device)]
                for fam in FAMILIES:
                    x = s["inputs"].get(fam)
                    args.append(None if x is None
                                else torch.from_numpy(x[t]).to(device))
                steps = (tree_steps(s["inputs"]["tree"][t])
                         if "tree" in s["inputs"] else None)
                epoch.append((args, steps))
            self.ticks.append(epoch)
        self.sample = [torch.from_numpy(np.unique(np.concatenate(
            list(s["sample"].values())))).to(device) for s in sets]
        self.sample_rows = [np.unique(np.concatenate(
            list(s["sample"].values()))) for s in sets]

    def fresh(self) -> list:
        """The joined states, copied on the device."""
        return [clone(x) for x in self.snapshot]

    def capture(self, states: list, index: int):
        """Input set ``index``'s sampled rows of every served state as one
        flat i32 device tensor."""
        torch = self.torch
        idx = self.sample[index]
        return torch.cat([leaf.index_select(0, idx).reshape(-1).to(
            torch.int32) for leaf in leaves(states)])

    def split(self, flat: np.ndarray, index: int) -> list:
        """A host copy of :meth:`capture`'s tensor as per-row planes: for
        each sampled row, its state planes by family (nested dicts)."""
        n = len(self.sample_rows[index])
        out, at = [], 0
        shaped = []
        for path, leaf in named_leaves(self.snapshot):
            size = n * int(np.prod(leaf.shape[1:], dtype=np.int64))
            shaped.append((path, flat[at:at + size].reshape(
                (n,) + tuple(leaf.shape[1:]))))
            at += size
        for r in range(n):
            row: dict = {}
            for path, planes in shaped:
                node = row
                for key in path[:-1]:
                    node = node.setdefault(key, {})
                node[path[-1]] = planes[r]
            out.append(row)
        return out


def serving_kwargs(config: dict) -> dict:
    fams = config["families"]
    kw = dict(num_docs=config["docs"], num_clients=config["writers"],
              k=fams["map"]["k"] if "map" in fams else fams["text"]["k"])
    if "map" in fams:
        kw["map_slots"] = fams["map"]["slots"]
    if "text" in fams:
        kw.update(text_slots=fams["text"]["slots"], text_k=fams["text"]["k"],
                  text_props=fams["text"]["props"])
    if "matrix" in fams:
        kw.update(matrix_vec_slots=fams["matrix"]["vec_slots"],
                  matrix_cell_slots=fams["matrix"]["cell_slots"],
                  matrix_k=fams["matrix"]["k"])
    if "tree" in fams:
        kw.update(tree_slots=fams["tree"]["slots"], tree_k=fams["tree"]["k"])
    return kw


def clone(state):
    if state is None:
        return None
    if isinstance(state, tuple):
        return type(state)(*(clone(x) for x in state))
    return state.clone()


def named_leaves(states: list) -> list:
    """(path, tensor) of every tensor of the served states, in order; a
    path is (family, field, ...)."""
    out = []

    def walk(path, x):
        if x is None:
            return
        if isinstance(x, tuple):
            for f in x._fields:
                walk(path + (f,), getattr(x, f))
        else:
            out.append((path, x))
    for name, state in zip(("seq",) + FAMILIES, states):
        walk((name,), state)
    return out


def leaves(states: list) -> list:
    return [x for _p, x in named_leaves(states)]


def now() -> float:
    return time.perf_counter()
