"""The reference's ``tests/test_farm_intensity.py`` run against the port:
the conflict farms at intensity through the merge host, each case with
the reference's own assertions and marks (``torch_reference``)."""

from torch_reference import port_reference

#: The port builds its device host on the card unless asked.
ADAPT = [("KernelMergeHost(", 'KernelMergeHost(device="cpu", ')]

port_reference("test_farm_intensity", globals(), adapt=ADAPT)
