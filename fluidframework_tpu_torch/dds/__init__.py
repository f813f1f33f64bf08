"""Distributed data structures the server side needs: the scalar merge-tree
engine (``mergetree.py``) and the matrix permutation vector
(``matrix.py``), copies of the reference package's."""
