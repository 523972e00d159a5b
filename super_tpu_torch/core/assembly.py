"""Tuple-grouped JTJ layout and the pair-form reduction (counterpart of
super_tpu/core/assembly.py).

Per frame, surfels are sorted by anchor tuple and each tuple's run is padded
to a multiple of G, so every G-row block of the padded order lies inside one
tuple.  Per LM trip, the tuple-Gram kernel (kernels/gram.py) reduces the
gradient rows to per-tuple Grams, and :func:`reduce_pairs` folds those into
the distinct node-pair blocks the pair-sparse CG solve consumes, or
:func:`expand_pairs` writes them into the dense (7J, 7J) normal matrix of
the dense solvers.  Inactive surfels sort into the last tuple, a sink whose
slots are masked.  Rows that share a pair or a node are added by the
fixed-order segment sum (kernels/segsum.py), whose row order the layout
sorts once a frame (``pair_plan``, ``node_plan``).

The sorts reproduce the JAX package's total orders exactly: the tuple sort
is one stable sort of a composite int64 key (ties fall back to the slot id,
the JAX 3-key sort's last key), and the pair sort is stable on its key.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from super_tpu_torch.core.state import set_columns_drop
from super_tpu_torch.kernels.segsum import SegmentPlan, segment_plan, \
    segment_sum


class TupleLayout(NamedTuple):
    """Per-frame structure of the tuple-grouped assembly."""

    sort_perm: torch.Tensor     # (N,) surfel id per sorted position
    src_pos: torch.Tensor       # (Np,) sorted position per padded slot
    slot_valid: torch.Tensor    # (Np,) real surfel of a non-sink tuple
    block_tuple: torch.Tensor   # (Np / G,) tuple id of each G-block
    tuple_nodes: torch.Tensor   # (T, K) node ids of each tuple
    overflow_count: torch.Tensor  # () active surfels dropped into the sink
    pair_rank: Optional[torch.Tensor] = None    # (16T,)
    pair_scale: Optional[torch.Tensor] = None   # (16T,)
    pair_dest: Optional[torch.Tensor] = None    # (P, 2) [7 n1, 7 n2]
    pair_overflow: Optional[torch.Tensor] = None  # () pairs beyond pair_cap
    pair_key: Optional[torch.Tensor] = None     # (P,) sorted distinct keys
    pair_rank10: Optional[torch.Tensor] = None  # (10T,) rank per triu pair
    pair_swap10: Optional[torch.Tensor] = None  # (10T,) store transposed
    pair_scale10: Optional[torch.Tensor] = None  # (10T,) 0.5 diag, 0 ovf
    diag_rank: Optional[torch.Tensor] = None    # (J,) rank of pair (j, j)
    arap_rank: Optional[torch.Tensor] = None    # (J, K_ed, 3)
    arap_swap: Optional[torch.Tensor] = None    # (J, K_ed)
    live_end: Optional[torch.Tensor] = None     # () padded end of non-sink
    # The fixed-order sums of reduce_pairs, sorted once a frame: pair rows
    # by pair_rank10, tuple anchors' J^T r rows by node.
    pair_plan: Optional[SegmentPlan] = None
    node_plan: Optional[SegmentPlan] = None


def build_tuple_layout(knn_idx, active, node_cap: int, *, tuple_cap: int,
                       pad_group: int, chunk: int = 32768,
                       pair_cap: int = 0, extra_pairs=None) -> TupleLayout:
    """Sort surfels by anchor tuple and build the G-aligned padded layout.

    knn_idx: (K=4, N) anchor ids; active: (N,).  The last tuple id is the
    sink for overflow and for inactive surfels.
    """
    k, n = knn_idx.shape
    if k != 4:
        raise ValueError("tuple layout assumes K=4 anchors")
    if chunk % pad_group != 0:
        raise ValueError("chunk must be a multiple of pad_group")
    dev = knn_idx.device
    ki = knn_idx.long()
    big = node_cap * node_cap
    k1 = torch.where(active, ki[0] * node_cap + ki[1], big)
    k2 = torch.where(active, ki[2] * node_cap + ki[3], big)
    # (k1, k2, slot) lexicographic == stable sort of k1 * (big + 1) + k2.
    _, perm = torch.sort(k1 * (big + 1) + k2, stable=True)
    k1s, k2s = k1[perm], k2[perm]

    new_tuple = torch.ones((n,), dtype=torch.bool, device=dev)
    new_tuple[1:] = (k1s[1:] != k1s[:-1]) | (k2s[1:] != k2s[:-1])
    tid_raw = torch.cumsum(new_tuple, 0) - 1

    tids = torch.arange(tuple_cap, device=dev)
    first_pos = torch.searchsorted(tid_raw, tids)
    sizes = torch.diff(first_pos, append=torch.full_like(first_pos[:1], n))

    n_active = torch.sum(active)
    overflow_count = torch.clamp(
        n_active - torch.minimum(first_pos[tuple_cap - 1], n_active), min=0)

    padded = (sizes + pad_group - 1) // pad_group * pad_group
    pend = torch.cumsum(padded, 0)
    pbase = pend - padded
    np_cap = (n + tuple_cap * pad_group + chunk - 1) // chunk * chunk

    block_starts = torch.arange(np_cap // pad_group, device=dev) * pad_group
    block_tuple = torch.searchsorted(pend, block_starts, right=True)
    block_tuple = torch.clamp(block_tuple, 0, tuple_cap - 1)

    rank0 = block_starts - pbase[block_tuple]
    pos0 = first_pos[block_tuple] + rank0
    cnt = sizes[block_tuple]
    offs = torch.arange(pad_group, device=dev)
    rank = rank0[:, None] + offs[None, :]
    valid = (rank < cnt[:, None]) & (block_tuple[:, None] < tuple_cap - 1)
    pos = torch.clamp(pos0[:, None] + offs[None, :], 0, n - 1)

    last_pos = torch.clamp(first_pos + sizes - 1, 0, n - 1)
    member = perm[last_pos]
    tuple_nodes = torch.where(sizes[:, None] > 0, ki[:, member].T, 0)

    pair_fields = (None,) * 8
    pair_plan = None
    if pair_cap > 0:
        pair_fields = build_pair_layout(tuple_nodes, node_cap,
                                        pair_cap=pair_cap,
                                        extra_pairs=extra_pairs)
        pair_plan = segment_plan(pair_fields[5], pair_cap)
    i32 = torch.int32
    return TupleLayout(
        sort_perm=perm.to(i32), src_pos=pos.reshape(-1).to(i32),
        slot_valid=valid.reshape(-1), block_tuple=block_tuple.to(i32),
        tuple_nodes=tuple_nodes.to(i32), overflow_count=overflow_count.to(i32),
        pair_rank=pair_fields[0], pair_scale=pair_fields[1],
        pair_dest=pair_fields[2], pair_overflow=pair_fields[3],
        pair_key=pair_fields[4], pair_rank10=pair_fields[5],
        pair_swap10=pair_fields[6], pair_scale10=pair_fields[7],
        live_end=torch.clamp(pend[tuple_cap - 2], max=np_cap).to(i32),
        pair_plan=pair_plan, node_plan=segment_plan(tuple_nodes, node_cap))


def build_pair_layout(tuple_nodes, node_cap: int, *, pair_cap: int,
                      extra_pairs=None):
    """Distinct node-pair table of the tuples' triu anchor pairs (plus
    ``extra_pairs`` (M, 2), which claim slots but carry no source rows).

    Returns (rank_of_src (16T,), scale_of_src (16T,), dest (P, 2),
    overflow (), pair_key (P,), rank10 (10T,), swap10 (10T,),
    scale10 (10T,)).
    """
    dev = tuple_nodes.device
    t_cap, k = tuple_nodes.shape
    a_idx, b_idx = torch.triu_indices(k, k, device=dev)
    tn = tuple_nodes.long()
    n1 = tn[:, a_idx]
    n2 = tn[:, b_idx]
    key = (torch.minimum(n1, n2) * node_cap
           + torch.maximum(n1, n2)).reshape(-1)
    fwd = a_idx[None] * k + b_idx[None]
    rev = b_idx[None] * k + a_idx[None]
    base = torch.arange(t_cap, device=dev)[:, None] * (k * k)
    src = (base + torch.where(n1 <= n2, fwd, rev)).reshape(-1)
    n_src = t_cap * k * k
    n_src10 = t_cap * len(a_idx)
    src10 = torch.arange(n_src10, device=dev)
    if extra_pairs is not None:
        ep = extra_pairs.long()
        ekey = (torch.minimum(ep[:, 0], ep[:, 1]) * node_cap
                + torch.maximum(ep[:, 0], ep[:, 1]))
        key = torch.cat([key, ekey])
        src = torch.cat([src, torch.full_like(ekey, n_src)])
        src10 = torch.cat([src10, torch.full_like(ekey, n_src10)])
    swap10 = (n1 > n2).reshape(-1)

    key_s, order = torch.sort(key, stable=True)
    src_s, src10_s = src[order], src10[order]
    new_pair = torch.ones_like(key_s, dtype=torch.bool)
    new_pair[1:] = key_s[1:] != key_s[:-1]
    rank_raw = torch.cumsum(new_pair, 0) - 1
    in_range = rank_raw < pair_cap - 1
    rank = torch.clamp(rank_raw, 0, pair_cap - 1)
    pair_overflow = torch.sum(new_pair & ~in_range).to(torch.int32)

    kp1 = key_s // node_cap
    kp2 = key_s % node_cap
    dim = 7 * node_cap
    drop = torch.full_like(rank, pair_cap)
    # Every member of a key's run writes the same rank, dest and scale, so
    # repeated targets carry equal values.
    dest = set_columns_drop(
        torch.full((2, pair_cap), dim, dtype=torch.int64, device=dev),
        torch.where(in_range, rank, drop), torch.stack([7 * kp1, 7 * kp2])).T
    scale_s = torch.where(kp1 == kp2, 0.5, 1.0)
    scale_s = torch.where(in_range, scale_s, 0.0).to(torch.float32)

    sentinel = node_cap * node_cap + 1
    pair_key = torch.full((pair_cap,), sentinel, dtype=torch.int64,
                          device=dev)
    pair_key = set_columns_drop(
        pair_key, torch.where(in_range & new_pair, rank, drop), key_s)

    # Back to source-row order (src values are unique; extras drop).
    full = lambda m, v, dt: torch.full((m,), v, dtype=dt,  # noqa: E731
                                       device=dev)
    rank_of_src = set_columns_drop(full(n_src, pair_cap - 1, torch.int64),
                                   src_s, rank)
    scale_of_src = set_columns_drop(full(n_src, 0.0, torch.float32), src_s,
                                    scale_s)
    rank10 = set_columns_drop(full(n_src10, pair_cap - 1, torch.int64),
                              src10_s, rank)
    scale10 = set_columns_drop(full(n_src10, 0.0, torch.float32), src10_s,
                               scale_s)
    i32 = torch.int32
    return (rank_of_src.to(i32), scale_of_src, dest.to(i32), pair_overflow,
            pair_key.to(i32), rank10.to(i32), swap10, scale10)


def pair_rank_lookup(pair_key, node_cap: int, pairs):
    """Rank of each (n1, n2) pair (..., 2) in the distinct-pair table; pairs
    absent from the table map to the sink rank P-1."""
    p1 = torch.minimum(pairs[..., 0], pairs[..., 1]).long()
    p2 = torch.maximum(pairs[..., 0], pairs[..., 1]).long()
    key = (p1 * node_cap + p2).reshape(-1)
    pk = pair_key.long()
    pair_cap = pk.shape[0]
    r = torch.clamp(torch.searchsorted(pk, key), 0, pair_cap - 1)
    hit = pk[r] == key
    return torch.where(hit, r, pair_cap - 1).reshape(p1.shape).to(torch.int32)


def _triu_pair_rows(layout: TupleLayout, gram):
    """(10T, 49) pair source rows from the per-tuple Grams: each tuple's
    triu anchor-pair blocks, stored transposed where the node pair came out
    reversed, scales applied."""
    t_cap = gram.shape[0]
    k = layout.tuple_nodes.shape[1]
    a_idx, b_idx = torch.triu_indices(k, k, device=gram.device)
    g5 = gram.reshape(t_cap, k, 7, k, 7)
    blocks = g5[:, a_idx, :, b_idx, :].movedim(0, 1)      # (T, 10, 7, 7)
    swap = layout.pair_swap10.reshape(t_cap, len(a_idx))
    blocks = torch.where(swap[..., None, None], blocks.transpose(-1, -2),
                         blocks)
    return blocks.reshape(-1, 49) * layout.pair_scale10[:, None]


def reduce_pairs(layout: TupleLayout, gram, jtr_t, node_cap: int,
                 sum_dtype=None):
    """Per-tuple Grams -> sparse pair form: (P, 49) distinct-pair blocks
    (symmetric half, diagonal pairs halved: dense = S + S^T) and (J, 7)
    JTr."""
    t_cap = gram.shape[0]
    k = layout.tuple_nodes.shape[1]
    rows = _triu_pair_rows(layout, gram)
    acc = segment_sum(rows, layout.pair_plan, sum_dtype=sum_dtype)
    jtr = segment_sum(-jtr_t.reshape(t_cap * k, 7), layout.node_plan)
    return acc, jtr


def _scatter_blocks_set(dense, starts, blocks):
    """``dense.at[r, c].set(blocks, mode="drop")`` of (P, 7, 7) blocks at
    row/column ``starts`` (P, 2) into (dim, dim) ``dense``.  The distinct
    pairs' in-range targets are unique; the sink's out-of-range start goes
    to one scratch element past the end, which is sliced off."""
    dim = dense.shape[0]
    seven = torch.arange(7, device=dense.device)
    st = starts.long()
    r = st[:, 0, None, None] + seven[None, :, None]
    c = st[:, 1, None, None] + seven[None, None, :]
    flat = torch.where((r < dim) & (c < dim), r * dim + c, dim * dim)
    ext = torch.cat([dense.reshape(-1), dense.new_zeros((1,))])
    ext[flat.reshape(-1)] = blocks.reshape(-1).to(ext.dtype)
    return ext[:dim * dim].reshape(dim, dim)


def expand_pairs(layout: TupleLayout, gram, jtr_t, node_cap: int,
                 sum_dtype=None):
    """Per-tuple Grams -> dense (7J, 7J) JTJ and (J, 7) JTr through the pair
    layout: the symmetric-half pair sums of :func:`reduce_pairs`, set into
    S at each distinct pair's block, then JTJ = S + S^T."""
    acc, jtr = reduce_pairs(layout, gram, jtr_t, node_cap,
                            sum_dtype=sum_dtype)
    dim = 7 * node_cap
    s = _scatter_blocks_set(acc.new_zeros((dim, dim)), layout.pair_dest,
                            acc.reshape(-1, 7, 7))
    return s + s.T, jtr
