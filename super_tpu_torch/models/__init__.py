"""Perception nets in plain ``torch.nn`` (counterpart of super_tpu/models):
monodepth2 and RAFT-Stereo depth, the smp segmentation family and RAFT
optical flow.

Each model is NCHW and inference-only (batch norm on its running
statistics), and its parameter and buffer names are those of the
reference's torch checkpoint, so ``load_state_dict`` takes such a
checkpoint as it is.  :func:`init_random` gives a model seeded random
weights from an explicit generator, for runs without a checkpoint.
"""

from __future__ import annotations

import math

import torch
from torch import nn


@torch.no_grad()
def init_random(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights: PyTorch's default uniform bounds for every
    convolution and linear layer (1 / sqrt(fan_in)), and batch norms with
    random scales, shifts and running statistics (a fresh batch norm is
    the identity, which would hide a wrong fold).  Draws on the CPU in
    module order, so the weights do not depend on the device."""
    def uniform(t, bound):
        t.copy_(torch.rand(t.shape, generator=generator) * 2 * bound - bound)

    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            uniform(m.weight, bound)
            if m.bias is not None:
                uniform(m.bias, bound)
        elif isinstance(m, nn.BatchNorm2d):
            c = m.num_features
            m.weight.copy_(0.5 + torch.rand(c, generator=generator))
            m.bias.copy_(0.1 * torch.randn(c, generator=generator))
            m.running_mean.copy_(0.3 * torch.randn(c, generator=generator))
            m.running_var.copy_(0.5 + torch.rand(c, generator=generator))
    return module
