"""Binary morphology and semantic edge regions (counterpart of
super_tpu/ops/morphology.py)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _maxpool_same(mask, kernel: int):
    """k x k max pool of a (..., H, W) bool mask, stride 1, same padding
    (``kernel // 2`` before, the rest after, as ``lax.reduce_window``)."""
    pad = kernel // 2
    lead = mask.shape[:-2]
    x = mask.reshape((-1, 1) + mask.shape[-2:]).to(torch.float32)
    x = F.pad(x, (pad, kernel - 1 - pad, pad, kernel - 1 - pad))
    y = F.max_pool2d(x, kernel, stride=1)
    return (y > 0.5).reshape(lead + y.shape[-2:])


def dilate(mask, kernel: int = 11):
    return _maxpool_same(mask, kernel)


def erode(mask, kernel: int = 11):
    return ~_maxpool_same(~mask, kernel)


def find_edge_region(seg, num_classes: int, class_list=None, kernel: int = 11,
                     ignore_img_edge: bool = True):
    """(H, W) bool: pixels of a listed class whose k-neighbourhood holds
    another class, with a k-pixel image border cleared."""
    if class_list is None:
        class_list = list(range(num_classes))
    h, w = seg.shape
    edge = torch.zeros((h, w), dtype=torch.bool, device=seg.device)
    for cid in class_list:
        cmask = seg == cid
        edge = edge | (dilate(~cmask, kernel) & cmask)
    if ignore_img_edge:
        border = torch.zeros((h, w), dtype=torch.bool, device=seg.device)
        border[:kernel, :] = True
        border[-kernel:, :] = True
        border[:, :kernel] = True
        border[:, -kernel:] = True
        edge = edge & ~border
    return edge
