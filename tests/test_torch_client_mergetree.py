"""The reference's ``tests/test_mergetree.py`` run against the port: the merge-tree engine and SharedString,
each case with the reference's own assertions (``torch_reference``)."""

from torch_reference import port_reference

port_reference("test_mergetree", globals())
