"""The reference's ``tests/test_gateway.py`` run against the port: the
gateway web host in front of the port's alfred, each case with the
reference's own assertions (``torch_reference``)."""

from torch_reference import port_reference

#: The port's alfred builds its device hosts on the card unless asked.
ADAPT = [('"--port", "0", "--no-merge-host"],',
          '"--port", "0", "--no-merge-host", "--device", "cpu"],')]

port_reference("test_gateway", globals(), adapt=ADAPT)
