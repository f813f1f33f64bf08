"""The reference's ``tests/test_goldens.py`` run against the port: the
reference's committed goldens under ``tests/goldens`` replayed through
the port's client stack must give the committed summaries byte for byte
(Compare and Stress modes), each case with the reference's own
assertions (``torch_reference``)."""

from torch_reference import port_reference

port_reference("test_goldens", globals())
