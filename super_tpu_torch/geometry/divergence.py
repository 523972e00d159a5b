"""Distribution divergences for the semantic weights (counterpart of
super_tpu/geometry/divergence.py).

The reference's epsilon placement, ``P * log(P / (Q + eps) + eps)``, is
kept exactly: the JSD feeds softmax weights whose values matter for parity.
"""

from __future__ import annotations

import torch


def kld(p, q, eps: float = 1e-13, dim: int = -1):
    """KL(P || Q) with the reference's epsilon convention."""
    return torch.sum(p * torch.log(p / (q + eps) + eps), dim=dim)


def jsd(p, q, eps: float = 1e-13, dim: int = -1):
    """Jensen-Shannon divergence between P and Q."""
    m = 0.5 * (p + q)
    return 0.5 * (kld(p, m, eps=eps, dim=dim) + kld(q, m, eps=eps, dim=dim))
