"""The reference's ``tests/test_framework.py`` run against the port: the
DataObject framework (factories, the runtime factory, the fluid-static
container), each case with the reference's own assertions
(``torch_reference``)."""

from torch_reference import port_reference

port_reference("test_framework", globals())
