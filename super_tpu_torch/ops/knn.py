"""K-nearest neighbours as a distance product plus ``torch.topk``
(counterpart of super_tpu/ops/knn.py).

Feature-major interface: point sets are (3, N), results (k, N).  Distances
are Euclidean.  The squared distance ``|q|^2 + |r|^2 - 2 q.r`` takes its
cross term from one matrix product per query chunk (full f32: TF32 is off,
see super_tpu_torch/__init__.py).
"""

from __future__ import annotations

import torch


def _pairwise_sqdist_fm(q, r):
    """(3, C) x (3, M) -> (C, M) squared distances."""
    qq = torch.sum(q * q, dim=0)[:, None]
    rr = torch.sum(r * r, dim=0)[None, :]
    cross = q.T @ r
    return torch.clamp(qq + rr - 2.0 * cross, min=0.0)


def masked_knn(queries, refs, k, *, query_mask=None, ref_mask=None,
               query_seg=None, ref_seg=None, chunk: int = 65536):
    """K nearest eligible refs per query.

    Invalid queries get dist=+inf and idx=0; invalid (or other-class)
    refs are never chosen while k eligible ones exist.
    Returns (dists (k, N), idx (k, N) int32).
    """
    n = queries.shape[-1]
    k = int(k)
    dists, idxs = [], []
    for s in range(0, n, chunk):
        q = queries[:, s:s + chunk]
        d2 = _pairwise_sqdist_fm(q, refs)
        eligible = None
        if ref_mask is not None:
            eligible = ref_mask[None, :]
        if query_seg is not None:
            same = ref_seg[None, :] == query_seg[s:s + chunk, None]
            eligible = same if eligible is None else eligible & same
        if eligible is not None:
            d2 = torch.where(eligible, d2, float("inf"))
        neg, idx = torch.topk(-d2, k, dim=1)
        dists.append(torch.sqrt(torch.clamp(-neg, min=0.0)).T)
        idxs.append(idx.to(torch.int32).T)
    dists = torch.cat(dists, dim=1)
    idx = torch.cat(idxs, dim=1)
    if query_mask is not None:
        dists = torch.where(query_mask[None, :], dists, float("inf"))
        idx = torch.where(query_mask[None, :], idx, 0)
    return dists, idx


def self_knn(points, k, *, mask=None, exclude_self: bool = True, seg=None):
    """KNN of a point set against itself; queries k+1 and drops the first
    column when ``exclude_self`` (the reference's update_ed pattern)."""
    kk = k + 1 if exclude_self else k
    dists, idx = masked_knn(points, points, kk, query_mask=mask,
                            ref_mask=mask, query_seg=seg, ref_seg=seg)
    if exclude_self:
        dists, idx = dists[1:], idx[1:]
    return dists, idx
