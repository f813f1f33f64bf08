"""Distributed data structures the server side needs: the scalar merge-tree
engine (``mergetree.py``), a copy of the reference package's."""
