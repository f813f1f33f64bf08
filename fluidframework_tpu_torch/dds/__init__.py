"""Distributed data structures the server side needs: the scalar merge-tree
engine (``mergetree.py``), the matrix permutation vector (``matrix.py``)
and the SharedTree snapshot and transaction core (``tree_core.py``),
copies of the reference package's."""
