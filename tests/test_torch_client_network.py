"""The reference's ``tests/test_network.py`` run against the port: the network driver over alfred's socket,
each case with the reference's own assertions (``torch_reference``)."""

from torch_reference import port_reference

port_reference("test_network", globals())
