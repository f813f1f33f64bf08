"""The reference's ``tests/test_rich_text_editor.py`` run against the
port: the rich-text editor example through the merge host, each case
with the reference's own assertions (``torch_reference``)."""

from torch_reference import port_reference

#: The port builds its device host on the card unless asked.
ADAPT = [
    ("KernelMergeHost(flush_threshold=64)",
     'KernelMergeHost(flush_threshold=64, device="cpu")'),
    ("KernelMergeHost(flush_threshold=128)",
     'KernelMergeHost(flush_threshold=128, device="cpu")'),
]

port_reference("test_rich_text_editor", globals(), adapt=ADAPT)
