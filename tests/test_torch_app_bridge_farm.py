"""The reference's ``tests/test_bridge_farm.py`` run against the port: the
conflict farm through the C++ bridge front door, each case with the
reference's own assertions and marks (``torch_reference``)."""

from torch_reference import port_reference

#: The port's bridge host builds its device hosts on the card unless asked.
ADAPT = [('"--port", "0", "--no-merge-host"],',
          '"--port", "0", "--no-merge-host", "--device", "cpu"],')]

port_reference("test_bridge_farm", globals(), adapt=ADAPT)
