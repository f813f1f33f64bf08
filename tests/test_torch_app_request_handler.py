"""The reference's ``tests/test_request_handler.py`` run against the port:
request routing and dependency synthesis, each case with the reference's
own assertions (``torch_reference``)."""

from torch_reference import port_reference

port_reference("test_request_handler", globals())
