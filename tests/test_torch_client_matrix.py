"""The reference's ``tests/test_matrix.py`` run against the port: the SharedMatrix client DDS,
each case with the reference's own assertions (``torch_reference``)."""

from torch_reference import port_reference

port_reference("test_matrix", globals())
