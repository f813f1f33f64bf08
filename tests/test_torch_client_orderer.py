"""The reference's ``tests/test_orderer.py`` run against the port: the bus
orderer and the port's alfred as its front door, each case with the
reference's own assertions (``torch_reference``)."""

from torch_reference import port_reference

#: The port's alfred builds its device hosts on the card unless asked.
ADAPT = [('"--no-merge-host"', '"--no-merge-host", "--device", "cpu"')]

port_reference("test_orderer", globals(), adapt=ADAPT)
