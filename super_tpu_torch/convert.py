"""Carry configuration and state between the JAX package and this port.

Into the port: the JAX package's config as ``dataclasses.asdict`` output,
and its ``Intrinsics``, ``FrameData`` and ``TrackerState`` as NamedTuples
(or mappings) whose leaves are numpy arrays.  Out of the port: any of this
package's NamedTuples with numpy leaves.  Nothing here imports JAX: the
caller turns JAX arrays into numpy (``np.asarray``) on its side.

Leaves are normalised to the port's types: floats to float32, integers to
int32, booleans stay booleans.  A stacked batch of B streams (the JAX
package's ``vmap`` layout, every leaf with a leading B) converts the same
way, into the port's stacked states and frames (parallel/sharded.py:
make_batched_step), and back.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from super_tpu_torch.config import SuPerConfig
from super_tpu_torch.core.state import (
    FrameData,
    GraphState,
    SurfelState,
    TrackerState,
    TrackState,
)
from super_tpu_torch.geometry.camera import Intrinsics


def config_from_dict(d: Mapping) -> SuPerConfig:
    return SuPerConfig.from_dict(d)


def tensor(x, device) -> torch.Tensor:
    """One numpy-like leaf as a tensor of the port's dtype on ``device``."""
    a = np.asarray(x)
    if a.dtype == np.bool_:
        pass
    elif np.issubdtype(a.dtype, np.floating):
        a = a.astype(np.float32)
    elif np.issubdtype(a.dtype, np.integer):
        a = a.astype(np.int32)
    else:
        raise TypeError(f"unsupported leaf dtype {a.dtype}")
    return torch.from_numpy(np.array(a)).to(device)


def _field(src: Any, name: str):
    return src[name] if isinstance(src, Mapping) else getattr(src, name)


def _named(cls, src, device, nested=None):
    nested = nested or {}
    kw = {}
    for name in cls._fields:
        v = _field(src, name)
        kw[name] = (_named(nested[name], v, device) if name in nested
                    else tensor(v, device))
    return cls(**kw)


def intrinsics_from_numpy(src, device="cuda") -> Intrinsics:
    return _named(Intrinsics, src, device)


def frame_from_numpy(src, device="cuda") -> FrameData:
    return _named(FrameData, src, device)


def tracker_state_from_numpy(src, device="cuda") -> TrackerState:
    return _named(TrackerState, src, device,
                  nested=dict(surfels=SurfelState, graph=GraphState,
                              track=TrackState))


def to_numpy(x):
    """A tensor, or a (nested) NamedTuple of tensors, with numpy leaves."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(to_numpy(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(to_numpy(v) for v in x)
    return x
