"""The reference's ``tests/test_client_api_cached.py`` run against the port:
the legacy client-api facade and the caching driver, each case with the
reference's own assertions (``torch_reference``)."""

from torch_reference import port_reference

port_reference("test_client_api_cached", globals())
