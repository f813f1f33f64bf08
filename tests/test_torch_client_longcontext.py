"""The reference's ``tests/test_longcontext.py`` run against the port: long
documents through SharedString and SharedTree, each case with the
reference's own assertions (``torch_reference``)."""

from torch_reference import port_reference

port_reference("test_longcontext", globals())
