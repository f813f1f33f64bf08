"""Developer tools: the kill-and-recover chaos harness of the storm
serving path (``chaos.py``)."""
