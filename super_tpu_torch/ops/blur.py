"""Separable Gaussian blur with torchvision's default sigma (counterpart of
super_tpu/ops/blur.py).

The reference smooths disparity maps with ``T.GaussianBlur(kernel)`` when
``depth_filter_kernel_size > 0``; torchvision's default sigma for kernel k
is 0.3 * ((k - 1) * 0.5 - 1) + 0.8.  Zero padding, as the JAX package's
convolution pads.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def gaussian_kernel1d(kernel: int, sigma: float | None = None, device=None):
    if sigma is None:
        sigma = 0.3 * ((kernel - 1) * 0.5 - 1) + 0.8
    x = torch.arange(kernel, dtype=torch.float32, device=device) \
        - (kernel - 1) / 2.0
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / torch.sum(k)


def gaussian_blur(img, kernel: int = 15, sigma: float | None = None):
    """Blur the last two (spatial) dims of a tensor of any leading shape."""
    k = gaussian_kernel1d(kernel, sigma, img.device).to(img.dtype)
    pad = kernel // 2
    lead = img.shape[:-2]
    h, w = img.shape[-2:]
    x = img.reshape(-1, 1, h, w)
    x = F.conv2d(x, k.reshape(1, 1, kernel, 1), padding=(pad, 0))
    x = F.conv2d(x, k.reshape(1, 1, 1, kernel), padding=(0, pad))
    return x.reshape(lead + (h, w))
