"""The reference's ``tests/test_virtualized_driver.py`` run against the port: the snapshot-virtualizing driver,
each case with the reference's own assertions (``torch_reference``)."""

from torch_reference import port_reference

port_reference("test_virtualized_driver", globals())
