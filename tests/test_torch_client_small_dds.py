"""The reference's ``tests/test_small_dds.py`` run against the port: directory, ink, consensus collections and the summary block,
each case with the reference's own assertions (``torch_reference``)."""

from torch_reference import port_reference

port_reference("test_small_dds", globals())
