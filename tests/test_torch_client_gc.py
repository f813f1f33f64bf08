"""The reference's ``tests/test_gc.py`` run against the port: handles and garbage collection,
each case with the reference's own assertions (``torch_reference``)."""

from torch_reference import port_reference

port_reference("test_gc", globals())
