"""The reference's ``tests/test_mergetree_runs.py`` run against the port:
the run-batched merge tick (``ops/mergetree_runs.py``) against the per-op
tick and the packer's rejections, each case with the reference's own
assertions (``torch_reference``)."""

from torch_reference import port_reference

#: The port's tensors land on the card unless asked.
ADAPT = [
    ("mtk.make_merge_op_batch([stream], 1, n_ops)",
     'mtk.make_merge_op_batch([stream], 1, n_ops, device="cpu")'),
    ("mtk.init_state(1, num_slots)", 'mtk.init_state(1, num_slots, device="cpu")'),
    ("mtr.make_run_batch([runs], 1, len(runs), 8)",
     'mtr.make_run_batch([runs], 1, len(runs), 8, device="cpu")'),
    ("mtk.make_merge_op_batch([ops], 1, 4)",
     'mtk.make_merge_op_batch([ops], 1, 4, device="cpu")'),
    ("mtk.init_state(1, 64)", 'mtk.init_state(1, 64, device="cpu")'),
    ("mtr.make_run_batch([runs], 1, len(runs), 4)",
     'mtr.make_run_batch([runs], 1, len(runs), 4, device="cpu")'),
    ("mtk.make_merge_op_batch(streams, n_docs, n_ops)",
     'mtk.make_merge_op_batch(streams, n_docs, n_ops, device="cpu")'),
    ("mtk.init_state(n_docs, num_slots)",
     'mtk.init_state(n_docs, num_slots, device="cpu")'),
    ("mtr.make_run_batch(runs, n_docs, t, 8)",
     'mtr.make_run_batch(runs, n_docs, t, 8, device="cpu")'),
]

port_reference("test_mergetree_runs", globals(), adapt=ADAPT)
