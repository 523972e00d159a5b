"""Parity of the port's fixed-order segmented sum (kernels/segsum.py: the
plain version the CPU path runs, and the order and offsets the kernel
reads) with the JAX package's segment sums (``assembly.
segment_sum_matmul`` and ``.at[].add``)."""

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
