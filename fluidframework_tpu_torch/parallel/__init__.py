"""Device mesh + sharding layout for multi-device scale-out.

The workload's data-parallel axis is *documents*: kernels are per-document
independent, so docs shard across devices with no collectives on the merge
path; metrics use one all-reduce. Port of ``fluidframework_tpu/parallel``
(``mesh``, ``multihost``, ``serving``, ``placement``).
"""
