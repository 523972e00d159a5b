"""SSIM dissimilarity map, monodepth2's convention (counterpart of
super_tpu/ops/ssim.py).

Reflection-padded k x k mean pools, C1 = 0.01^2, C2 = 0.03^2, output
``clamp((1 - SSIM) / 2, 0, 1)``.  The render loss takes it with k = 11.
Every op's backward pass on the card is free of float atomics: the
reflection pad is built from flipped slices (PyTorch's reflection pad adds
its gradient with atomics), the mean pool is ``avg_pool2d``, whose backward
gathers.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_C1 = 0.01 ** 2
_C2 = 0.03 ** 2


def _avgpool_valid(x, kernel: int):
    """k x k mean pool, stride 1, no padding, over the last two dims."""
    lead = x.shape[:-2]
    y = F.avg_pool2d(x.reshape((-1, 1) + x.shape[-2:]), kernel, stride=1)
    return y.reshape(lead + y.shape[-2:])


def _reflect_pad(x, pad: int):
    """Reflection padding (the edge row not repeated) of the last two dims."""
    def pad_dim(t, dim):
        n = t.shape[dim]
        lo = t.narrow(dim, 1, pad).flip(dim)
        hi = t.narrow(dim, n - 1 - pad, pad).flip(dim)
        return torch.cat([lo, t, hi], dim=dim)

    return pad_dim(pad_dim(x, -2), -1)


def ssim(x, y, kernel: int = 3):
    """SSIM dissimilarity of two (..., H, W) images, same shape out."""
    pad = kernel // 2
    xp, yp = _reflect_pad(x, pad), _reflect_pad(y, pad)
    mu_x = _avgpool_valid(xp, kernel)
    mu_y = _avgpool_valid(yp, kernel)
    sig_x = _avgpool_valid(xp * xp, kernel) - mu_x * mu_x
    sig_y = _avgpool_valid(yp * yp, kernel) - mu_y * mu_y
    sig_xy = _avgpool_valid(xp * yp, kernel) - mu_x * mu_y
    num = (2 * mu_x * mu_y + _C1) * (2 * sig_xy + _C2)
    den = (mu_x * mu_x + mu_y * mu_y + _C1) * (sig_x + sig_y + _C2)
    d = (1 - num / den) / 2
    # jnp.clip's half gradient at the bounds (torch.clamp passes it all).
    return torch.minimum(torch.maximum(d, d.new_zeros(())), d.new_ones(()))
