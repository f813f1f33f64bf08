"""The reference's ``tests/test_summarizer.py`` run against the port: the summarizer and summary manager,
each case with the reference's own assertions (``torch_reference``)."""

from torch_reference import port_reference

port_reference("test_summarizer", globals())
