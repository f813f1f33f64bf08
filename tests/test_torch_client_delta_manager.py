"""The reference's ``tests/test_delta_manager.py`` run against the port: the delta manager, its queues and reconnects,
each case with the reference's own assertions (``torch_reference``)."""

from torch_reference import port_reference

port_reference("test_delta_manager", globals())
