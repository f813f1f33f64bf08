"""The reference's ``tests/test_audience_idle.py`` run against the port: the audience and idle-client ejection,
each case with the reference's own assertions (``torch_reference``)."""

from torch_reference import port_reference

#: The port builds its device host on the card unless asked.
ADAPT = [("KernelSequencerHost(num_slots=4)",
          'KernelSequencerHost(num_slots=4, device="cpu")')]

port_reference("test_audience_idle", globals(), adapt=ADAPT)
