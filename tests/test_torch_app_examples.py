"""The reference's ``tests/test_examples.py`` run against the port: every
example app through the host's code-proposal boundary, each case with
the reference's own assertions (``torch_reference``)."""

from torch_reference import port_reference

port_reference("test_examples", globals())
