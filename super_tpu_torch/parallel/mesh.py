"""The ('stream', 'shard') process mesh (counterpart of
super_tpu/parallel/mesh.py).

- ``stream``: data parallelism over concurrent surgical video streams;
  each stream's tracker state is independent, with no traffic between
  streams.
- ``shard``: the LM solve of one stream split over its surfel slots: each
  process sums the data term over its slice, and the normal equations and
  costs are summed over the shard group once an assembly
  (core/losses.py:all_reduce_sum), the only traffic between shards.

One process per mesh element, each in the ``torch.distributed`` world
that multihost.initialize starts; ranks are laid out row-major, as the
JAX package lays out its devices.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def mesh_shape(world: int, num_streams: Optional[int] = None,
               num_shards: Optional[int] = None):
    """(streams, shards) for ``world`` processes.  Defaults: every process
    on the stream axis, one shard."""
    if num_streams is None and num_shards is None:
        num_streams, num_shards = world, 1
    elif num_streams is None:
        num_streams = world // num_shards
    elif num_shards is None:
        num_shards = world // num_streams
    if num_streams * num_shards != world:
        raise ValueError(
            f"mesh {num_streams}x{num_shards} != {world} processes")
    return num_streams, num_shards


def make_mesh(num_streams: Optional[int] = None,
              num_shards: Optional[int] = None,
              device_type: str = "cuda") -> DeviceMesh:
    """A ('stream', 'shard') DeviceMesh over the processes of the started
    world (multihost.initialize): rank r at (r // shards, r % shards).
    ``device_type`` "cuda" or "cpu" is where the processes' tensors live;
    the group's backend was chosen when the world started."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; start one with "
                           "parallel.multihost.initialize")
    shape = mesh_shape(dist.get_world_size(), num_streams, num_shards)
    return DeviceMesh(device_type, torch.arange(shape[0] * shape[1]).reshape(
        shape), mesh_dim_names=("stream", "shard"))
