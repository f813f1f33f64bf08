"""Developer tools: the kill-and-recover chaos harness (``chaos.py``),
the cluster launcher (``launch_cluster.py``), the service monitor
(``monitor.py``) and the service load driver (``load_test.py``).

Reference parity: packages/test/service-load-test.
"""
