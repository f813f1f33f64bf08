"""The reference's ``tests/test_pool_snapshot.py`` run against the port:
the merge host's device-pool snapshot and restore, each case with the
reference's own assertions (``torch_reference``)."""

from torch_reference import port_reference

#: The port builds its device host on the card unless asked.
ADAPT = [("KernelMergeHost(", 'KernelMergeHost(device="cpu", ')]

port_reference("test_pool_snapshot", globals(), adapt=ADAPT)
