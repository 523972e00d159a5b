"""Parity of the port's fixed-order segmented sum (kernels/segsum.py: the
plain version the CPU path runs, and the order and offsets the kernel
reads) with the JAX package's segment sums (``assembly.
segment_sum_matmul`` and ``.at[].add``), and of a numpy model of the CUDA
kernel's partition (:func:`kernel_model`: its tiles, groups, carries and
tickets) on the sum's edge cases.  The kernel itself runs only on the card,
where chip_smoke.py holds it to the plain version."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_helpers  # noqa: F401  (two threads)
from torch_helpers import close

from super_tpu.core import assembly as jasm
from super_tpu_torch.kernels import segsum


def _case(seed, rows, segs, feat, sink=None, empty=()):
    """Unsorted segment ids over [0, segs), some segments left empty, and
    with ``sink`` a quarter of the rows piled on that segment."""
    rng = np.random.default_rng(seed)
    allowed = np.setdiff1d(np.arange(segs), np.asarray(empty, np.int64))
    ids = rng.choice(allowed, size=rows)
    if sink is not None:
        ids[rng.random(rows) < 0.25] = sink
    values = rng.normal(size=(rows,) + feat).astype(np.float32)
    return ids.astype(np.int32), values


CASES = {
    # (rows, segments, feature shape, sink, empty segments)
    "pairs": (3000, 97, (49,), 96, (3, 4, 50)),
    "nodes": (800, 64, (7,), 0, (63,)),
    "flat": (500, 1000, (), None, ()),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("sum_dtype", [None, "bf16"])
def test_plain_matches_jax(case, sum_dtype):
    rows, segs, feat, sink, empty = CASES[case]
    ids, values = _case(1, rows, segs, feat, sink, empty)
    plan = segsum.segment_plan(torch.as_tensor(ids), segs)
    got = segsum.segment_sum(torch.as_tensor(values), plan,
                             sum_dtype=sum_dtype)
    v2 = values.reshape(rows, -1)
    want = jasm.segment_sum_matmul(jnp.asarray(v2), jnp.asarray(ids), segs,
                                   sum_dtype=sum_dtype)
    want = np.asarray(want, np.float32).reshape((segs,) + feat)
    if sum_dtype is None:
        at_add = jnp.zeros((segs,) + feat, jnp.float32).at[ids].add(values)
        # The same f32 values summed in other orders (up to ~800 in the
        # sink): 1e-6 of the largest sum.
        close(at_add, got, atol=1e-6 * float(np.abs(want).max()),
              name="at_add")
    # The one-hot product on the CPU sums the same (rounded) values in f32
    # in another order: 1e-6 of the largest sum.
    close(want, got, atol=1e-6 * float(np.abs(want).max()), name="matmul")
    for s in empty:
        assert np.all(got.numpy()[s] == 0)


def test_base_is_added():
    ids, values = _case(2, 400, 30, (7,))
    base = np.random.default_rng(3).normal(size=(30, 7)).astype(np.float32)
    plan = segsum.segment_plan(torch.as_tensor(ids), 30)
    got = segsum.segment_sum(torch.as_tensor(values), plan,
                             base=torch.as_tensor(base))
    want = jnp.asarray(base).at[ids].add(values)
    close(want, got, atol=1e-6 * float(np.abs(np.asarray(want)).max()))


@pytest.mark.parametrize("case", sorted(CASES))
def test_plan_orders_rows_stably(case):
    """What the kernel reads: the rows of each segment, in ascending row
    order, between its offsets; rows outside [0, S) before offsets[0] or
    after offsets[S]."""
    rows, segs, feat, sink, empty = CASES[case]
    ids, _ = _case(4, rows, segs, feat, sink, empty)
    ids[:7] = [-1, segs, segs + 5, -3, 0, 1, segs]
    plan = segsum.segment_plan(torch.as_tensor(ids), segs)
    order = plan.order.numpy()
    off = plan.offsets.numpy()
    assert plan.order.dtype == torch.int32
    assert plan.offsets.dtype == torch.int32
    assert off.shape == (segs + 1,) and np.all(np.diff(off) >= 0)
    for s in range(segs):
        mine = order[off[s]:off[s + 1]]
        np.testing.assert_array_equal(mine, np.flatnonzero(ids == s))
    outside = np.concatenate([order[:off[0]], order[off[-1]:]])
    np.testing.assert_array_equal(
        np.sort(outside), np.flatnonzero((ids < 0) | (ids >= segs)))
    for s in empty:
        assert off[s] == off[s + 1]


def test_layout_plans_match_jax_sums():
    """The pair reduction's and the node J^T r sums' plans as the layout
    makes them, on a seeded pair table: the same sums as the JAX
    package's one-hot product over the layout's ranks."""
    from super_tpu_torch.core import assembly as tasm

    rng = np.random.default_rng(5)
    j_cap, t_cap, pair_cap = 24, 64, 256
    tn = np.sort(rng.integers(0, j_cap, size=(t_cap, 4)), axis=1)
    tn[40:] = 0       # unused tuples: their nodes are 0, as the layout's
    fields = tasm.build_pair_layout(torch.as_tensor(tn, dtype=torch.int32),
                                    j_cap, pair_cap=pair_cap)
    rank10 = fields[5]
    plan = segsum.segment_plan(rank10, pair_cap)
    rows = rng.normal(size=(rank10.shape[0], 49)).astype(np.float32)
    got = segsum.segment_sum(torch.as_tensor(rows), plan)
    want = jasm.segment_sum_matmul(jnp.asarray(rows),
                                   jnp.asarray(rank10.numpy()), pair_cap)
    close(want, got, atol=1e-6 * float(np.abs(np.asarray(want)).max()))
    node_plan = segsum.segment_plan(torch.as_tensor(tn), j_cap)
    jr = rng.normal(size=(t_cap * 4, 7)).astype(np.float32)
    got = segsum.segment_sum(torch.as_tensor(jr), node_plan)
    want = jnp.zeros((j_cap, 7), jnp.float32).at[tn.reshape(-1)].add(jr)
    close(want, got, atol=1e-6 * float(np.abs(np.asarray(want)).max()))


# Edge cases of the kernel's partition (csrc/segment_sum.cu), at the tile
# size the kernel takes at each width (kernels/segsum.py:tile_rows).  Values
# are integers in [-8, 8], so every partial sum is exact in f32 and in bf16
# and every order of adding gives the same bits.

def _lengths_case(rng, lengths, rows):
    """Ids of segments with the given lengths (the rest empty), rows in a
    seeded order."""
    ids = np.repeat(np.arange(len(lengths)), lengths)[:rows]
    return rng.permutation(ids), len(lengths)


def _edge_case(name, width, seed=7):
    """(ids, num_segments) of one edge case at ``width``."""
    rng = np.random.default_rng(seed)
    tile = segsum.tile_rows(width, 1)
    if name == "one_segment":            # every row in one segment, 10 tiles
        return np.zeros(10 * tile + 3, np.int64), 1
    if name == "own_segments":           # every row its own segment
        rows = 2 * tile + 3
        return rng.permutation(rows), rows
    if name == "tile_edges":             # segments of one tile; starts and
        # ends on tile edges; one that crosses two edges; singles around
        lengths = [tile, tile - 1, 1, tile, 2, tile - 2, 2 * tile + 1, 1,
                   tile - 1, 3]
        return _lengths_case(rng, lengths, sum(lengths))
    if name == "outside_ids":            # ids below 0 and at or above S
        segs = 40
        ids = rng.integers(0, segs, size=2 * tile + 9)
        ids[rng.random(ids.shape[0]) < 0.1] = -1
        ids[:3] = [-5, segs, segs + 7]
        ids[-2:] = [-2, segs]
        return ids, segs
    if name == "empty_segments":         # the first and last empty, runs of
        # empty segments between
        lengths = [0, 5, 0, 0, 0, tile + 3, 0, 1, 0, 0, 7, tile, 0, 2, 0, 0]
        return _lengths_case(rng, lengths, sum(lengths))
    if name == "short":                  # fewer rows than a tile
        return rng.integers(0, 6, size=min(tile - 1, 37)), 6
    if name == "sink":                   # half the rows in the last segment
        rows = 3 * tile + 5
        ids = rng.integers(0, 30, size=rows)
        ids[rng.random(rows) < 0.5] = 30
        return ids, 31
    raise ValueError(name)


EDGE_CASES = ("one_segment", "own_segments", "tile_edges", "outside_ids",
              "empty_segments", "short", "sink")


def _first_segment(offsets, q):
    """The largest s with offsets[s] <= q, by binary search."""
    lo, hi = 0, offsets.shape[0] - 1        # offsets[lo] <= q < offsets[hi]
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if offsets[mid] <= q:
            lo = mid
        else:
            hi = mid
    return lo


def kernel_model(values, order, offsets, *, base=None, bf16=False,
                 tile_order=None, tile=None):
    """csrc/segment_sum.cu's partition in numpy, f32: tiles of ``tile``
    (``tile_rows(F, R)``) sorted positions, t ``tile`` to (t + 1)
    ``tile``, each summing its rows in [offsets[0], offsets[S]); each
    tile's first segment by binary search and its segment starts from
    offsets; groups of 16 rows that write the segments they hold whole and
    hand on their rows before the first start (pre) and after the last
    (tail); a tile that writes the segments ending in it and hands on two
    carries, the segment it starts inside (head) and the one running on
    past its end (tail); and a ticket a segment, so that the last of its
    tiles to arrive (in ``tile_order``) adds its carries in tile order.
    Returns the sums and how often each segment was written (once, for
    every segment)."""
    r, width = values.shape
    num = offsets.shape[0] - 1
    tile = segsum.tile_rows(width, r) if tile is None else tile
    grp = segsum.GROUP_ROWS
    v = values.astype(np.float32)
    if bf16:
        v = torch.as_tensor(v).to(torch.bfloat16).float().numpy()
    zero = np.zeros(width, np.float32)
    b = zero[None].repeat(num, 0) if base is None else base
    out = np.zeros((num, width), np.float32)
    written = np.zeros(num, np.int64)

    def put(s, total):
        out[s] = b[s] + total
        written[s] += 1

    empty = offsets[1:] == offsets[:-1]
    out[empty] = b[empty]
    written[empty] += 1
    p0, p1 = int(offsets[0]), int(offsets[-1])
    n_tiles = -(-r // tile)
    head_carry, tail_carry, tickets = {}, {}, {}

    def tiles_of(s):
        return int(offsets[s]) // tile, (int(offsets[s + 1]) - 1) // tile

    def arrive(s):
        t0, t1 = tiles_of(s)
        tickets[t0] = tickets.get(t0, 0) + 1
        if tickets[t0] == t1 - t0 + 1:
            put(s, tail_carry[t0] + sum((head_carry[t] for t in
                                         range(t0 + 1, t1 + 1)), zero))

    for t in (range(n_tiles) if tile_order is None else tile_order):
        base = t * tile
        w0, w1 = max(base, p0), min(base + tile, p1)
        if w0 >= w1:
            continue
        s_first = _first_segment(offsets, w0)
        heads = {int(offsets[s]) - base: s for s in range(s_first, num)
                 if w0 <= offsets[s] < w1 and offsets[s + 1] > offsets[s]}
        rows = v[order[base:base + tile]]
        pre, tail, gseg = [], [], []
        for g0 in range(0, tile, grp):          # level 1
            acc, first, seg = zero, zero, -1
            for i in range(max(g0, w0 - base), min(g0 + grp, w1 - base)):
                if i in heads:
                    if seg >= 0:
                        put(seg, acc)
                    else:
                        first = acc
                    seg, acc = heads[i], zero
                acc = acc + rows[i]
            pre.append(first if seg >= 0 else acc)
            tail.append(acc)
            gseg.append(seg)
        hg = [g for g, s in enumerate(gseg) if s >= 0]   # level 2
        last = len(gseg) - 1
        run0_end = hg[0] if hg else last
        if s_first not in heads.values():
            head_carry[t] = sum(pre[:run0_end + 1], zero)
        for k, g in enumerate(hg):
            end = hg[k + 1] if k + 1 < len(hg) else last
            total = tail[g] + sum(pre[g + 1:end + 1], zero)
            s = gseg[g]
            if k + 1 < len(hg) or tiles_of(s)[1] == t:
                put(s, total)
            else:
                tail_carry[t] = total
        if s_first not in heads.values():      # level 3
            arrive(s_first)
        if hg and tiles_of(gseg[hg[-1]])[1] > t:
            arrive(gseg[hg[-1]])
    return out, written


def _jax_sums(ids, values, num, base, bf16):
    """The JAX package's one-hot segment matmul (rows outside [0, S)
    dropped) and .at[].add over the rows inside, plus base."""
    rounded = values
    if bf16:
        rounded = torch.as_tensor(values).to(torch.bfloat16).float().numpy()
    mm = np.asarray(jasm.segment_sum_matmul(
        jnp.asarray(values), jnp.asarray(ids.astype(np.int32)), num,
        sum_dtype="bf16" if bf16 else None), np.float32)
    inside = (ids >= 0) & (ids < num)
    b = np.zeros((num, values.shape[1]), np.float32) if base is None else base
    at_add = np.asarray(jnp.asarray(b).at[ids[inside]].add(
        jnp.asarray(rounded[inside])), np.float32)
    return b + mm, at_add


@pytest.mark.parametrize("variant", ["f32", "base", "bf16"])
@pytest.mark.parametrize("width", [1, 4, 7, 49])
@pytest.mark.parametrize("case", EDGE_CASES)
def test_edge_case_sums(case, width, variant):
    """The plain version and the model of the kernel's partition equal the
    JAX package's sums bit for bit on integer values."""
    ids, num = _edge_case(case, width)
    rng = np.random.default_rng(11)
    values = rng.integers(-8, 9, size=(ids.shape[0], width)).astype(
        np.float32)
    base = (rng.integers(-8, 9, size=(num, width)).astype(np.float32)
            if variant == "base" else None)
    bf16 = variant == "bf16"
    want_mm, want_at = _jax_sums(ids, values, num, base, bf16)
    np.testing.assert_array_equal(want_mm, want_at)

    plan = segsum.segment_plan(torch.as_tensor(ids), num)
    kw = dict(sum_dtype="bf16" if bf16 else None,
              base=None if base is None else torch.as_tensor(base))
    if case == "outside_ids":
        # The plain version's index_add_ takes no id outside [0, S).
        with pytest.raises((IndexError, RuntimeError)):
            segsum.segment_sum(torch.as_tensor(values), plan, **kw)
    else:
        got = segsum.segment_sum(torch.as_tensor(values), plan, **kw)
        np.testing.assert_array_equal(got.numpy(), want_mm)

    order, offsets = plan.order.numpy(), plan.offsets.numpy()
    # The kernel's tile at these rows, and the doubled tile of wide rows
    # that outnumber a wave of CTAs (summed in two halves).
    tiles = {segsum.tile_rows(width, ids.shape[0]),
             segsum.tile_rows(width, 10 ** 7)}
    for tile in sorted(tiles):
        n_tiles = -(-ids.shape[0] // tile)
        for tile_order in (None, rng.permutation(n_tiles)):
            got, written = kernel_model(values, order, offsets, base=base,
                                        bf16=bf16, tile_order=tile_order,
                                        tile=tile)
            np.testing.assert_array_equal(written, 1)
            np.testing.assert_array_equal(got, want_mm)


@pytest.mark.parametrize("width", [1, 2, 3, 4, 7, 49, 64, 65, 200])
def test_tile_rows(width):
    """A tile holds whole groups of 16 rows, at most 32, whose (group,
    column) pairs a 256-thread CTA walks in one pass; wide rows beyond a
    wave of tiles take twice the groups, two passes of whole groups; the
    units count tiles times 64-column slabs."""
    slab = min(width, segsum.SLAB_COLS)
    tile = segsum.tile_rows(width, 1)
    groups = tile // segsum.GROUP_ROWS
    assert tile % segsum.GROUP_ROWS == 0 and 1 <= groups <= 32
    assert groups * slab <= 256
    assert segsum.units(tile + 1, width) == 2 * -(-width // 64)
    wave = segsum.ONE_WAVE * tile
    assert segsum.tile_rows(width, wave) == tile
    big = segsum.tile_rows(width, wave + 1)
    assert big == (tile if groups == 32 else min(512, 2 * tile))
    assert (big // segsum.GROUP_ROWS // 2) * slab <= 256
