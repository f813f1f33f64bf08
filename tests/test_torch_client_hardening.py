"""The reference's ``tests/test_hardening.py`` run against the port: driver errors, nacks and malformed input,
each case with the reference's own assertions (``torch_reference``)."""

from torch_reference import port_reference

port_reference("test_hardening", globals())
