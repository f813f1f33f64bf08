"""Client runtime: container, data stores, delta manager, pending state.

Reference parity: packages/runtime/* + packages/loader/container-loader.
"""
