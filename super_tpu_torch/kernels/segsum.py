"""Fixed-order segmented sum of the assembly, and its plain version.

``out[s] = base[s] + sum of values[i] over the rows i with ids[i] == s``,
in f32.  PyTorch's ``index_add_`` computes this with float atomics on the
card, in an order that changes from run to run; the JAX package sums in a
fixed order (``super_tpu/core/assembly.py:segment_sum_matmul``).  The
kernel, super_tpu_torch/csrc/segment_sum.cu (its bound and design are stated
there), adds each segment's rows in ascending row order and uses no float
atomics, so the card path repeats bit for bit.  It has no TPU kernel behind
it.

The ids are fixed for a frame wherever the assembly sums (the layout's pair
ranks, the ARAP node ids, the dense block ids), so :func:`segment_plan`
sorts them once a frame and every LM trip reuses the plan.
:func:`segment_sum` takes the plain version (``index_add_``) for CPU
tensors only; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

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


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of a build of csrc/segment_sum.cu."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.segment_sum_launch.argtypes = [vp] * 6 + [ci] * 4 + [vp]
    lib.segment_sum_launch.restype = ci
    return lib


@functools.cache
def _lib():
    """csrc/segment_sum.cu's library, built on first use."""
    from super_tpu_torch.kernels.build import load

    return declare(load("segment_sum"))


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
    out = torch.empty((s,) + feat, dtype=torch.float32, device=dev)
    # The chunk totals (csrc/segment_sum.cu's L = 64 rows a chunk).  Freed
    # on return while the kernel may still run: the caching allocator hands
    # its memory only to work queued after it on this stream.
    chunks = torch.empty(((r + 63) // 64 * f,), dtype=torch.float32,
                         device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _lib().segment_sum_launch(
        values.data_ptr(), plan.order.data_ptr(), plan.offsets.data_ptr(),
        None if base is None else base.data_ptr(), out.data_ptr(),
        chunks.data_ptr(), r, s, f, int(sum_dtype == "bf16"), stream)
    if rc != 0:
        raise RuntimeError(f"segment_sum launch failed: cudaError {rc}")
    segment_sum.launches += 1
    return out


segment_sum.launches = 0
