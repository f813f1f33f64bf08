"""The reference's ``tests/test_dds_farm.py`` run against the port: the cross-DDS conflict farm,
each case with the reference's own assertions (``torch_reference``)."""

from torch_reference import port_reference

port_reference("test_dds_farm", globals())
