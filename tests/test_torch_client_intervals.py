"""The reference's ``tests/test_intervals.py`` run against the port: SharedString interval collections,
each case with the reference's own assertions (``torch_reference``)."""

from torch_reference import port_reference

port_reference("test_intervals", globals())
