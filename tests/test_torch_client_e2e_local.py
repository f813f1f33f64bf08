"""The reference's ``tests/test_e2e_local.py`` run against the port: the e2e stack: Containers over ``LocalCollabServer``,
each case with the reference's own assertions (``torch_reference``)."""

from torch_reference import port_reference

port_reference("test_e2e_local", globals())
