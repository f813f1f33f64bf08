"""The reference's ``tests/test_load.py`` run against the port: the service load harness,
each case with the reference's own assertions (``torch_reference``)."""

from torch_reference import port_reference

#: The port builds its device hosts on the card unless asked.
ADAPT = [
    ("KernelSequencerHost()", 'KernelSequencerHost(device="cpu")'),
    ('run_load("smoke", use_device_sequencer=True)',
     'run_load("smoke", use_device_sequencer=True, device="cpu")'),
    ('run_load("smoke", use_device_sequencer=True,\n',
     'run_load("smoke", use_device_sequencer=True, device="cpu",\n'),
    ("run_storm_load(total_ops=8_192, num_docs=32, k=32)",
     'run_storm_load(total_ops=8_192, num_docs=32, k=32, device="cpu")'),
]

port_reference("test_load", globals(), adapt=ADAPT)
