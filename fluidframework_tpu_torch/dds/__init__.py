"""Distributed data structures — the client-side merge engines.

Reference parity: packages/dds/* (merge-tree, sequence, map, directory,
matrix, cell, counter, ordered-collection, register-collection, tree).
The server side reuses the scalar merge-tree engine (``mergetree.py``),
the matrix permutation vector (``matrix.py``) and the SharedTree core
(``tree_core.py``).
"""
