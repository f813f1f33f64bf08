"""The reference's ``tests/test_framework_aux.py`` run against the port:
interceptions, last-edited tracking, undo/redo and the agent scheduler,
each case with the reference's own assertions (``torch_reference``)."""

from torch_reference import port_reference

port_reference("test_framework_aux", globals())
