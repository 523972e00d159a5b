"""Starting the process world and placing each process's streams
(counterpart of super_tpu/parallel/multihost.py).

One process per mesh element: ``torchrun --nproc-per-node N`` sets the
standard environment (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
``RANK``, ``LOCAL_RANK``), or the caller gives an ``init_method``.  The
backend is the caller's choice: ``"nccl"`` when each process has a card
of its own, ``"gloo"`` on the CPU and for several processes on one card
(NCCL refuses two ranks on one device).  Streams are process-local
(video ingest is per host); only the shard group's sums cross processes,
and they are summed on CPU tensors (core/losses.py:all_reduce_sum, on
the card through pinned host buffers), so a mesh with two or more
shards needs gloo.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from super_tpu_torch.convert import tensor
from super_tpu_torch.utils.tree import tree_map


def initialize(backend: str, init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None) -> bool:
    """Start the ``torch.distributed`` world; True if one is running.

    Without ``init_method`` the world comes from torchrun's environment,
    and with no ``WORLD_SIZE`` there this is a no-op (one process, as the
    JAX package's ``initialize`` without a coordinator).  With ``nccl``
    each process takes the card ``LOCAL_RANK``."""
    if dist.is_initialized():
        return True
    if init_method is None and "WORLD_SIZE" not in os.environ:
        return False
    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None:  # not `or`: rank 0 is falsy
        rank = int(os.environ["RANK"])
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    return True


def mesh_device(mesh) -> torch.device:
    """This process's device in ``mesh``: its current card for a "cuda"
    mesh, else the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def stream_block(mesh, num_streams: int) -> slice:
    """This process's streams of a batch of ``num_streams``: the block at
    its coordinate on 'stream' (every process of a shard group holds the
    same streams)."""
    groups = mesh.size(mesh.mesh_dim_names.index("stream"))
    if num_streams % groups:
        raise ValueError(f"{num_streams} streams do not split over "
                         f"{groups} stream groups")
    local = num_streams // groups
    start = mesh.get_local_rank("stream") * local
    return slice(start, start + local)


def shard_stream_batch(mesh, local_batch):
    """Place a process's host-local stream batch (a tree of tensors, or of
    numpy arrays in the port's dtypes as convert.tensor makes them, with a
    leading stream axis) on its device in ``mesh``."""
    dev = mesh_device(mesh)
    return tree_map(lambda x: x.to(dev) if isinstance(x, torch.Tensor)
                    else tensor(x, dev), local_batch)
