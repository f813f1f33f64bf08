"""The reference's ``tests/test_loader.py`` run against the port: the loader and channel registries,
each case with the reference's own assertions (``torch_reference``)."""

from torch_reference import port_reference

port_reference("test_loader", globals())
