"""Multi-host scale-out — the process-spanning side of the device mesh.

Port of ``fluidframework_tpu/parallel/multihost.py`` on
``torch.distributed``. The reference scales its ordering service over many
Node processes with Kafka partitions assigning documents to consumers; here
the same assignment is the document axis of a mesh spanning processes. The
merge path moves nothing between devices (per-doc independence, see
:mod:`.mesh`); the network carries the op streams each host feeds to its
own devices and the process group's control plane.

The serving recipe per host:

1. ``initialize(...)`` once per process (coordinator address, process
   count, process id — e.g. from the launcher env, :func:`initialize_from_env`).
   Single-process deployments skip it (returns False).
2. ``global_mesh()`` — this process's devices on the docs axis, tagged with
   its rank in the group.
3. ``local_docs(mesh, num_docs)`` — the contiguous row range this process
   is responsible for; the front door / bus partitions route exactly those
   documents here (the Kafka partition-assignment analog).
4. Build op batches for those rows only and place them with
   ``feed(mesh, tree)`` — each host supplies its shards; nothing moves
   between processes.
5. Run the tick on each local shard; outputs stay on their devices.
"""

from __future__ import annotations

import os

import torch

from ..device import resolve_device
from .mesh import Mesh, make_mesh, shard_state


def child_process_env(process_id: int = 0, num_processes: int = 1,
                      coordinator_address: str | None = None) -> dict:
    """Environment for one LAUNCHED cluster child: hide the cards
    (follower and read-replica children have no device work, and on a
    shared host they must never race the leader for them) and, for a
    multi-process mesh, carry the coordinates the child's
    :func:`initialize` consumes."""
    env = {"CUDA_VISIBLE_DEVICES": ""}
    if num_processes > 1:
        env.update({
            "FFTPU_COORDINATOR": coordinator_address or "127.0.0.1:0",
            "FFTPU_NUM_PROCESSES": str(num_processes),
            "FFTPU_PROCESS_ID": str(process_id),
        })
    return env


def initialize_from_env(device: str | torch.device | None = None) -> bool:
    """Child-side twin of :func:`child_process_env`: join the process group
    iff the launcher provided coordinates."""
    n = int(os.environ.get("FFTPU_NUM_PROCESSES", "1"))
    return initialize(
        coordinator_address=os.environ.get("FFTPU_COORDINATOR"),
        num_processes=n,
        process_id=int(os.environ.get("FFTPU_PROCESS_ID", "0")),
        device=device)


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               device: str | torch.device | None = None) -> bool:
    """``torch.distributed.init_process_group`` for multi-process serving
    over ``tcp://<coordinator_address>``: NCCL for a CUDA mesh (the
    default), gloo for ``device="cpu"``. A no-op returning False for a
    single process."""
    if not num_processes or num_processes <= 1:
        return False
    import torch.distributed as dist
    dev = resolve_device(device)
    if coordinator_address is None:
        raise ValueError("a multi-process mesh needs a coordinator address")
    dist.init_process_group(
        backend="nccl" if dev.type == "cuda" else "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id or 0)
    return True


def global_mesh(devices=None) -> Mesh:
    """This process's devices (every CUDA device unless given) on the docs
    axis, tagged with its rank in the default process group (rank 0 of 1
    when none is up)."""
    import torch.distributed as dist
    rank, world = 0, 1
    if dist.is_available() and dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
    return make_mesh(devices, rank=rank, world=world)


def local_docs(mesh: Mesh, num_docs: int) -> tuple[int, int]:
    """[start, stop) of the document rows THIS process feeds and owns:
    equal contiguous ranges in rank order (the whole range for one
    process), as the reference's addressable-shard map reports them for a
    1-D mesh laid out in order."""
    if num_docs % mesh.size:
        raise ValueError(
            f"{num_docs} docs do not divide over {mesh.size} shards")
    per = num_docs // mesh.world
    return mesh.rank * per, (mesh.rank + 1) * per


def feed(mesh: Mesh, tree, global_batch: int | None = None) -> list:
    """Place this host's rows (numpy arrays or tensors, ``local_docs``
    rows only) on its devices: a list of per-shard trees. No rows move
    between processes. ``global_batch`` pins the global doc count and is
    checked against the local slice."""
    from .mesh import tree_leaves
    rows = tree_leaves(tree)[0].shape[0]
    if global_batch is not None:
        lo, hi = local_docs(mesh, global_batch)
        if rows != hi - lo:
            raise ValueError(
                f"fed {rows} rows; this process owns {hi - lo} of "
                f"{global_batch}")
    return shard_state(tree, mesh)


__all__ = ["child_process_env", "initialize", "initialize_from_env",
           "global_mesh", "local_docs", "feed"]
