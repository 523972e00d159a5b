"""Fixed-order segmented sum of the assembly, and its plain version.

``out[s] = base[s] + sum of values[i] over the rows i with ids[i] == s``,
in f32.  PyTorch's ``index_add_`` computes this with float atomics on the
card, in an order that changes from run to run; the JAX package sums in a
fixed order (``super_tpu/core/assembly.py:segment_sum_matmul``).  The
kernel, super_tpu_torch/csrc/segment_sum.cu (its bound and design are stated
there), sums in one launch with an association fixed by the plan and the
tile size (:func:`tile_rows`), and uses no float atomics, so the card path
repeats bit for bit.  It has no TPU kernel behind it.

The ids are fixed for a frame wherever the assembly sums (the layout's pair
ranks, the ARAP node ids, the dense block ids), so :func:`segment_plan`
sorts them once a frame and every LM trip reuses the plan.
:func:`segment_sum` takes the plain version (``index_add_``) for CPU
tensors only; for CUDA tensors it launches the kernel or raises.

The kernel's scratch (carries and ticket counters) is kept from call to
call; a captured step (core/compiled.py) keeps its own
(:func:`scratch_scope`), sized by its warm-up, so that no later call
replaces memory that its CUDA graph's launches point into.

The autograd path sums through the same kernel.  :func:`segment_gather`
gathers rows by id, and its backward pass, PyTorch's ``index_add_`` for a
plain gather, is the segment sum of the output's gradient under a plan
made once a frame (tuple nodes, ED neighbours, triangle corners), with the
scratch that was current at the forward pass: autograd runs a card's
backward pass on a thread of its own, outside the caller's
:func:`scratch_scope`.
:func:`segment_reduce` is the segment sum as a differentiable op (the soft
splat's per-pixel sums, planned at every evaluation because the pixels
move with the warp); its backward pass gathers.
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes
import functools
from typing import NamedTuple

import torch


class SegmentPlan(NamedTuple):
    """The rows' segments, sorted once for many sums."""

    ids: torch.Tensor      # (R,) int64 each row's segment (plain version)
    order: torch.Tensor    # (R,) int32 rows, stable by segment
    offsets: torch.Tensor  # (S + 1,) int32 each segment's first position

    @property
    def num_segments(self) -> int:
        return self.offsets.shape[0] - 1


def segment_plan(ids, num_segments: int) -> SegmentPlan:
    """Stable order and segment offsets of the rows' ids (any shape, read
    flat).  Rows with an id outside [0, num_segments) are left out of every
    sum on the card (the plain version's ``index_add_`` raises on them)."""
    ids = ids.reshape(-1).long()
    sorted_ids, order = torch.sort(ids, stable=True)
    bounds = torch.arange(num_segments + 1, device=ids.device)
    offsets = torch.searchsorted(sorted_ids, bounds)
    return SegmentPlan(ids=ids, order=order.to(torch.int32),
                       offsets=offsets.to(torch.int32))


# The kernel's partition (csrc/segment_sum.cu): a tile is GROUP_ROWS rows
# times the groups that a 256-thread CTA walks in one pass at a slab's
# width (at most 32), and rows wider than SLAB_COLS are cut into slabs of
# that many columns.  Where rows are wide and such tiles outnumber the
# CTAs a card holds at once (ONE_WAVE, 132 SMs of an H100 at 5 CTAs,
# rounded down), a tile takes twice the groups, summed in two halves.
GROUP_ROWS, MAX_GROUPS, SLAB_COLS, CTA_THREADS = 16, 32, 64, 256
ONE_WAVE = 512


def tile_rows(width: int, rows: int) -> int:
    """Sorted positions a tile of the kernel covers for ``rows`` rows of
    width ``width``; the association of the kernel's sums depends only on
    it and the plan."""
    g = max(1, min(MAX_GROUPS, CTA_THREADS // min(width, SLAB_COLS)))
    if g < MAX_GROUPS and -(-rows // (GROUP_ROWS * g)) > ONE_WAVE:
        g = min(MAX_GROUPS, 2 * g)
    return GROUP_ROWS * g


def units(rows: int, width: int) -> int:
    """Units of work (tiles times slabs) for ``rows`` rows: the kernel's
    carries and tickets."""
    return -(-rows // tile_rows(width, rows)) * -(-width // SLAB_COLS)


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signature of a build of csrc/segment_sum.cu."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.segment_sum_launch.argtypes = [vp] * 7 + [ci] * 5 + [vp]
    lib.segment_sum_launch.restype = ci
    return lib


@functools.cache
def _lib():
    """csrc/segment_sum.cu's library, built on first use."""
    from super_tpu_torch.kernels.build import load

    return declare(load("segment_sum"))


_scratch = {}
# The scratch that launches use: the module's, or a captured step's
# (:func:`scratch_scope`).
_scratch_store = contextvars.ContextVar("segsum_scratch", default=_scratch)


@contextlib.contextmanager
def scratch_scope(store: dict):
    """Launches in the block take their scratch from ``store`` ({device:
    scratch}), which its owner keeps: a captured step
    (core/compiled.py) holds its own, so that the raw pointers in its
    graph stay valid whatever other launches later need."""
    token = _scratch_store.set(store)
    try:
        yield store
    finally:
        _scratch_store.reset(token)


def _kernel_scratch(n_units: int, width: int, dev):
    """The kernel's scratch on ``dev`` for ``n_units`` units: the tiles'
    head and tail carries (2 n_units min(width, 64) floats) and a ticket
    counter a unit.  Kept from call to call and grown when short: the
    counters are zeroed when made and every launch leaves those it used at
    0.  Launches share it, so they must run in turn, on one stream, as the
    port's do.  While a CUDA graph is being captured it must not grow: the
    warm-up before the capture sizes it."""
    carry = 2 * n_units * min(width, SLAB_COLS)
    store = _scratch_store.get()
    have = store.get(dev)
    if have is None or have[0].numel() < carry or have[1].numel() < n_units:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("segment_sum: scratch short during a CUDA "
                               "graph capture (warm up at the captured "
                               "shapes first)")
        have = (torch.empty((max(carry, 1 << 16),), dtype=torch.float32,
                            device=dev),
                torch.zeros((max(n_units, 1 << 12),), dtype=torch.int32,
                            device=dev))
        store[dev] = have
    return have


def _check_sum_dtype(sum_dtype):
    if sum_dtype not in (None, "bf16"):
        raise ValueError(f"segment_sum: unknown sum_dtype {sum_dtype!r}")


def segment_sum_plain(values, plan: SegmentPlan, *, sum_dtype=None,
                      base=None):
    """:func:`segment_sum` by ``index_add_``: base (or zeros) plus the rows
    added at their ids."""
    _check_sum_dtype(sum_dtype)
    if sum_dtype == "bf16":
        values = values.to(torch.bfloat16).to(torch.float32)
    out = (values.new_zeros((plan.num_segments,) + tuple(values.shape[1:]))
           if base is None else base)
    return out.index_add(0, plan.ids, values)


def segment_sum(values, plan: SegmentPlan, *, sum_dtype=None, base=None):
    """Segment sums of the rows of ``values`` (R, ...) f32 by ``plan``:
    (S, ...) f32, plus ``base`` (S, ...) where given.  ``sum_dtype="bf16"``
    rounds each value to bf16 and still sums in f32 (the JAX package's bf16
    one-hot segment matmul)."""
    if values.device.type == "cpu":
        return segment_sum_plain(values, plan, sum_dtype=sum_dtype, base=base)
    if values.device.type != "cuda":
        raise ValueError(f"segment_sum: unsupported device {values.device}")
    _check_sum_dtype(sum_dtype)
    r = values.shape[0]
    s = plan.num_segments
    feat = tuple(values.shape[1:])
    f = 1
    for d in feat:
        f *= d
    dev = values.device
    if values.dtype != torch.float32 or r == 0 or s == 0 or f == 0 or \
            plan.order.shape != (r,) or plan.order.dtype != torch.int32 or \
            plan.offsets.dtype != torch.int32:
        raise ValueError(
            f"segment_sum: needs f32 values (R >= 1, ...), an int32 order "
            f"of R rows and int32 offsets of S + 1 >= 2; got {values.dtype} "
            f"{tuple(values.shape)}, order {plan.order.dtype} "
            f"{tuple(plan.order.shape)}, offsets {plan.offsets.dtype} "
            f"{tuple(plan.offsets.shape)}")
    if not (plan.order.device == plan.offsets.device == dev):
        raise ValueError("segment_sum: tensors on different devices")
    if base is not None:
        if base.shape != (s,) + feat or base.dtype != torch.float32 or \
                base.device != dev:
            raise ValueError(f"segment_sum: base must be f32 {(s,) + feat} "
                             f"on {dev}, got {base.dtype} "
                             f"{tuple(base.shape)} on {base.device}")
        base = base.contiguous()
    values = values.contiguous()
    carries, tickets = _kernel_scratch(units(r, f), f, dev)
    out = torch.empty((s,) + feat, dtype=torch.float32, device=dev)
    rc = _lib().segment_sum_launch(
        values.data_ptr(), plan.order.data_ptr(), plan.offsets.data_ptr(),
        None if base is None else base.data_ptr(), out.data_ptr(),
        carries.data_ptr(), tickets.data_ptr(), r, s, f, tile_rows(f, r),
        int(sum_dtype == "bf16"), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"segment_sum launch failed: cudaError {rc}")
    segment_sum.launches += 1
    return out


segment_sum.launches = 0


class _SegmentGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, plan):
        ctx.plan = plan
        ctx.store = _scratch_store.get()
        return x.index_select(0, plan.ids)

    @staticmethod
    def backward(ctx, grad):
        # Autograd may run this on its own device thread, where the
        # forward's scratch_scope is not current.
        with scratch_scope(ctx.store):
            return segment_sum(grad, ctx.plan), None


class _SegmentReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, plan):
        ctx.plan = plan
        return segment_sum(values, plan)

    @staticmethod
    def backward(ctx, grad):
        return grad.index_select(0, ctx.plan.ids), None


def segment_gather(x, plan: SegmentPlan):
    """Rows ``x[plan.ids]`` (R, ...) of ``x`` (S, ...), whose gradient is
    summed back into the S rows by :func:`segment_sum` (fixed order)."""
    return _SegmentGather.apply(x, plan)


def segment_reduce(values, plan: SegmentPlan):
    """:func:`segment_sum` of ``values`` (R, ...) as a differentiable op:
    (S, ...), with the gradient of each row gathered from its segment."""
    return _SegmentReduce.apply(values, plan)
