"""Tracker-state checkpoint and resume (counterpart of
super_tpu/utils/checkpoint.py), by ``torch.save``.

The reference can only load model checkpoints; its tracker state (surfels
and ED graph) is never saved, so a crash loses the whole sequence.  Here
the whole ``TrackerState`` goes to disk and comes back bit for bit.  It
is saved as a flat ``{field path: CPU tensor}`` dict (``"surfels.points"``,
..., ``"time"``), which ``torch.load`` reads with ``weights_only=True``
(that loader refuses NamedTuples), into ``<root>/step_<t:08d>/state.pt``.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch

STATE_FILE = "state.pt"


def _flatten(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    out = {}
    for name in tree._fields:
        value = getattr(tree, name)
        if isinstance(value, tuple):
            out.update(_flatten(value, f"{prefix}{name}."))
        else:
            out[prefix + name] = value
    return out


def _rebuild(reference, flat: Dict[str, torch.Tensor], prefix: str = ""):
    return type(reference)(*(
        _rebuild(v, flat, f"{prefix}{name}.") if isinstance(v, tuple)
        else flat[prefix + name].to(v.device)
        for name, v in zip(reference._fields, reference)))


def save_state(path: str, state, step: Optional[int] = None) -> str:
    """Save a TrackerState (into ``path/step_<step:08d>`` with ``step``);
    returns the checkpoint directory."""
    path = os.path.abspath(path)
    if step is not None:
        path = os.path.join(path, f"step_{step:08d}")
    os.makedirs(path, exist_ok=True)
    flat = {k: v.detach().to("cpu").clone() for k, v in
            _flatten(state).items()}
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save(flat, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    return path


def restore_state(path: str, reference_state):
    """The TrackerState saved at ``path``, its tensors on the devices of
    ``reference_state``'s (a state of the same config, e.g. from
    ``init_tracker`` on any frame).  Raises ValueError where a field is
    missing or extra, or its shape or dtype is not the reference's."""
    flat = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                      weights_only=True)
    ref = _flatten(reference_state)
    if set(flat) != set(ref):
        raise ValueError(f"checkpoint {path}: fields missing "
                         f"{sorted(set(ref) - set(flat))}, extra "
                         f"{sorted(set(flat) - set(ref))}")
    for name, want in ref.items():
        got = flat[name]
        if got.shape != want.shape or got.dtype != want.dtype:
            raise ValueError(f"checkpoint {path}: {name} is {got.dtype} "
                             f"{tuple(got.shape)}, the reference "
                             f"{want.dtype} {tuple(want.shape)}")
    return _rebuild(reference_state, flat)


def latest_checkpoint(root: str) -> Optional[str]:
    """The last ``step_*`` directory under ``root`` in name order (the
    steps are zero-padded), or None."""
    if not os.path.isdir(root):
        return None
    steps = [d for d in os.listdir(root) if d.startswith("step_")]
    if not steps:
        return None
    return os.path.join(root, sorted(steps)[-1])
