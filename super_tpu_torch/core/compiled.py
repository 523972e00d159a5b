"""A step captured once and replayed: the port's counterpart of the
``jax.jit`` that the JAX package puts around its frame step
(super_tpu/core/tracker.py:make_jit_step, super_tpu/pipeline.py,
super_tpu/parallel/streams.py, the root bench's device-resident loop).

:class:`CapturedStep` holds a function ``fn(*args) -> outputs`` whose
arguments are trees (NamedTuples, tuples, None) of tensors, numpy arrays
or numbers.  On the card:

1. the first call copies the arguments into static device buffers and
   runs ``fn`` on them eagerly on a side stream (the warm-up: kernels
   build, their shared-memory attributes and occupancy are queried, the
   step's cached index tables are made, the segment sum's scratch is
   sized, and where ``fn`` runs backward passes, the autograd engine's
   device thread starts and cuBLAS and cuDNN set up their handles and
   workspaces on that stream), then captures ``fn`` once on that stream
   into a CUDA graph with its own memory pool, and returns the warm-up's
   outputs;
2. every later call copies the arguments into the same buffers and
   replays the graph: one launch from the host for the whole step.

With ``carry=(i, j)`` the graph ends by copying output ``j`` into the
buffers of argument ``i`` (the tracker state), so that :meth:`replay`
alone advances the state from frame to frame with no host work between
frames.  Every call returns copies of the outputs made after the replay:
no later replay writes them.

A capture that fails raises; nothing falls back to the eager step.  On
CPU tensors there is no graph: the same object runs ``fn`` eagerly on its
buffers every call, the plain counterpart, chosen by the tensors' device
as the kernel wrappers choose.  (A ``graph`` class may be given instead
of the CUDA graph; the tests give a stand-in.)  A step sharded over a
process group takes :class:`CutGraph` on the card
(parallel/sharded.py:make_multichip_step): its all-reduces run on the
host between graphs, one graph for each stretch between two of them.

A replay runs no Python, so it advances no kernel wrapper's ``launches``
counter by itself: the capture records each counter's advance and undoes
it (the capture ran no kernel), and every replay adds it, so that the
counters go on counting the kernels that the card ran, the launches of
a backward pass on autograd's own thread too.  The segment sum's scratch
(kernels/segsum.py) belongs to the step: its warm-up and capture use a
scratch of their own, backward passes included, which no later call
replaces while the graph lives; so do the pinned host buffers of its
all-reduces (core/losses.py:host_buffers).

A call is three spans (utils/profiling.py:span): ``graph.load``, the
arguments copied into the buffers; ``graph.run``, the replay's launch (the
eager run on the CPU and at the first call); ``graph.copy_out``, the
outputs' copies.  With ``stage_times`` every run also times the step's
stages (utils/profiling.py:STAGES) and the whole body with pairs of
timing events, which the capture records as event nodes of the graph;
:meth:`CapturedStep.stage_ms` reads the last run's.  Without it (the
default) the graph holds no such node.
"""

from __future__ import annotations

import contextlib
import gc
from typing import Optional, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from super_tpu_torch.core import losses
from super_tpu_torch.kernels import gram, pcg, segsum
from super_tpu_torch.utils import profiling
from super_tpu_torch.utils.profiling import span


def counted_kernels():
    """The kernel wrappers, each counting its launches on ``.launches``."""
    return (pcg.pairs_cg, pcg.pairs_cg_chunked, pcg.dense_cg,
            gram.tuple_gram, gram.data_gram, segsum.segment_sum)


def launch_counts():
    return [k.launches for k in counted_kernels()]


def _advance_counts(delta):
    for k, d in zip(counted_kernels(), delta):
        k.launches += d


class CudaGraph:
    """``body()`` captured on ``stream`` into a CUDA graph with its own
    memory pool; ``outputs`` are its results, rewritten by every
    :meth:`replay`."""

    def __init__(self, body, stream):
        self._graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self._graph, stream=stream):
            self.outputs = body()

    def replay(self):
        self._graph.replay()


class CutGraph:
    """``body()`` captured on ``stream`` as one CUDA graph for each stretch
    between two all-reduces (core/losses.py:all_reduce_sum), the graphs in
    one memory pool: at an all-reduce the stretch's graph ends with the
    copy of the packed sums into their pinned host buffer, and the next
    graph begins with the copy back.  A replay replays the graphs in their
    capture order on the current stream and, after each but the last,
    waits for its end (an event) and all-reduces its host buffer
    (core/losses.py:reduce_host): the step sharded over a process group,
    whose collective runs on the host, as graphs.  ``launches`` and
    ``reduces`` count the graphs replayed and the all-reduces run."""

    def __init__(self, body, stream):
        self._graphs, self._cuts = [], []
        self._pool = torch.cuda.graph_pool_handle()
        self._ended = torch.cuda.Event()
        self.launches = self.reduces = 0
        # As torch.cuda.graph: no work in flight, no stale cached blocks.
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
        with torch.cuda.stream(stream), losses.cut_at_reduces(self._cut):
            self._begin()
            try:
                self.outputs = body()
            finally:
                self._graphs[-1].capture_end()

    def _begin(self):
        # thread_local: only this thread's calls can break the capture (the
        # process group's threads make none on the card).
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin(pool=self._pool,
                            capture_error_mode="thread_local")
        self._graphs.append(graph)

    def _cut(self, host, group):
        self._graphs[-1].capture_end()
        self._cuts.append((host, group))
        self._begin()

    @property
    def segments(self) -> int:
        return len(self._graphs)

    def replay(self):
        for i, graph in enumerate(self._graphs):
            graph.replay()
            self.launches += 1
            if i < len(self._cuts):
                self._ended.record()
                self._ended.synchronize()
                losses.reduce_host(*self._cuts[i])
                self.reduces += 1


def _leaf_tensor(x, device):
    """An argument leaf as a tensor on ``device`` (numbers as 0-d float32
    or int32, numpy arrays as they are)."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, (bool, np.bool_)):
        return torch.full((), bool(x), dtype=torch.bool, device=device)
    if isinstance(x, (int, float, np.number)):
        dtype = torch.float32 if isinstance(x, (float, np.floating)) \
            else torch.int32
        return torch.full((), x, dtype=dtype, device=device)
    return torch.as_tensor(np.asarray(x), device=device)


def _span(t):
    return t.data_ptr(), t.data_ptr() + t.numel() * t.element_size()


class CapturedStep:
    """``fn(*args)`` captured once and replayed (see the module
    docstring).  ``carry=(i, j)``: output ``j`` is written back into the
    buffers of argument ``i`` at the end of every run.  ``device``: where
    the buffers live, else the device of the first tensor argument.
    ``stage_times``: time the step's stages in every run
    (:meth:`stage_ms`)."""

    def __init__(self, fn, *, carry: Optional[Tuple[int, int]] = None,
                 device=None, graph=None, stage_times: bool = False):
        self.fn = fn
        self.carry = carry
        self.stage_times = stage_times
        self._body_timer = None    # the StageTimer of the last body run
        self._timer = None         # the StageTimer of the last run
        self.device = None if device is None else torch.device(device)
        self._graph_type = graph
        self._graph = None
        self._args = None          # static buffers, as the argument trees
        self._spec = None
        self._delta = None         # counter advance of one run
        self._outputs = None       # the last run's (the graph's) outputs
        self._scratch = {}         # the segment sum's scratch of this step
        self._host = {}            # the all-reduces' pinned host buffers

    @property
    def captured(self) -> bool:
        return self._graph is not None

    @property
    def graph(self):
        """The capture (None before it): a CudaGraph, a CutGraph or the
        given class."""
        return self._graph

    @property
    def buffers(self):
        """The static buffers, as the argument trees (None before the
        first :meth:`load`)."""
        return self._args

    def _uses_graph(self) -> bool:
        return self._graph_type is not None or self.device.type == "cuda"

    def load(self, *args):
        """Copy ``args`` into the static buffers (made at the first call).
        The trees must keep the structure, shapes and dtypes of the first
        call's."""
        leaves, spec = pytree.tree_flatten(args)
        if self._args is None:
            if self.device is None:
                self.device = next(
                    (x.device for x in leaves if isinstance(x, torch.Tensor)),
                    torch.device("cpu"))
            bufs = [None if x is None else
                    _leaf_tensor(x, self.device).clone(
                        memory_format=torch.contiguous_format)
                    for x in leaves]
            self._spec = spec
            self._args = pytree.tree_unflatten(bufs, spec)
            return
        if spec != self._spec:
            raise ValueError(f"CapturedStep: arguments of another structure "
                             f"than at capture:\n{spec}\nvs\n{self._spec}")
        dsts, srcs = [], []
        for buf, x in zip(pytree.tree_leaves(self._args), leaves):
            if buf is None:
                continue
            if isinstance(x, torch.Tensor) and x.device == self.device:
                src = x
            elif isinstance(x, (bool, int, float, np.number, np.bool_)):
                buf.fill_(x)
                continue
            else:
                src = _leaf_tensor(x, self.device)
            if src.shape != buf.shape or src.dtype != buf.dtype:
                raise ValueError(f"CapturedStep: an argument of "
                                 f"{src.dtype} {tuple(src.shape)} where the "
                                 f"capture had {buf.dtype} "
                                 f"{tuple(buf.shape)}")
            if src.data_ptr() != buf.data_ptr():
                dsts.append(buf)
                srcs.append(src)
        if dsts:
            torch._foreach_copy_(dsts, srcs)

    def _write_back(self, out):
        """Output ``j`` into the buffers of argument ``i`` (``carry``).  A
        source that is its own destination is skipped; one that overlaps
        another destination is copied first."""
        if self.carry is None:
            return
        i, j = self.carry
        dsts = pytree.tree_leaves(self._args[i])
        srcs = pytree.tree_leaves(out[j])
        if len(dsts) != len(srcs):
            raise ValueError("CapturedStep: the carried output's structure "
                             "is not its argument's")
        spans = [_span(d) for d in dsts if d is not None and d.numel()]
        pairs = []
        for d, s in zip(dsts, srcs):
            if d is None or s.data_ptr() == d.data_ptr():
                continue
            lo, hi = _span(s)
            if any(a < hi and lo < b for a, b in spans):
                s = s.clone()
            pairs.append((d, s))
        if pairs:
            torch._foreach_copy_([d for d, _ in pairs], [s for _, s in pairs])

    def _body(self):
        with segsum.scratch_scope(self._scratch), \
                losses.host_buffers(self._host):
            if not self.stage_times:
                out = self.fn(*self._args)
                self._write_back(out)
                return out
            timer = profiling.StageTimer(self.device.type == "cuda")
            with profiling.stage_timing(timer), timer.stage(profiling.BODY):
                out = self.fn(*self._args)
                self._write_back(out)
            self._body_timer = timer
        return out

    def stage_ms(self) -> dict:
        """{stage: ms} of the last run (``stage_times``; empty without):
        device time between its events on the card, read after the
        caller's synchronisation; host time of the eager run on the
        CPU."""
        if self._timer is None:
            return {}
        ms = self._timer.ms()
        ms.pop(profiling.BODY)
        return ms

    def body_ms(self) -> Optional[float]:
        """ms of the last run's whole body (``stage_times``), the carry's
        write-back included; None without."""
        return None if self._timer is None else \
            self._timer.ms()[profiling.BODY]

    def run(self):
        """Run the step on the loaded buffers: the warm-up and the capture
        at the first run on the card, a replay after; on the CPU ``fn``
        eagerly.  Returns the outputs (a later run rewrites them)."""
        if self._args is None:
            raise RuntimeError("CapturedStep.run: nothing loaded")
        if not self._uses_graph():
            self._outputs = self._body()
            self._timer = self._body_timer
            return self._outputs
        if self._graph is not None:
            self.replay()
            return self._outputs
        side = (torch.cuda.Stream(self.device)
                if self.device.type == "cuda" else None)
        cur = torch.cuda.current_stream(self.device) if side else None
        if side is not None:
            side.wait_stream(cur)
        with torch.cuda.stream(side) if side else contextlib.nullcontext():
            out = self._body()
        warm_timer = self._body_timer
        if side is not None:
            cur.wait_stream(side)
            for x in pytree.tree_leaves(out):
                if isinstance(x, torch.Tensor):
                    x.record_stream(cur)
        before = launch_counts()
        graph_type = self._graph_type or CudaGraph
        self._graph = graph_type(self._body, side)
        self._delta = [b - a for a, b in zip(before, launch_counts())]
        _advance_counts([-d for d in self._delta])
        self._outputs = self._graph.outputs
        self._timer = warm_timer     # the capture ran nothing
        return out

    def replay(self):
        """One more run on the buffers as they stand: a replay of the
        graph on the current stream (on the CPU, ``fn`` eagerly)."""
        if not self._uses_graph():
            self.run()
            return
        if self._graph is None:
            raise RuntimeError("CapturedStep.replay: nothing captured yet")
        self._graph.replay()
        _advance_counts(self._delta)
        self._timer = self._body_timer   # the capture's events

    def result(self, out=None):
        """Copies of ``out`` (default: the last run's outputs)."""
        out = self._outputs if out is None else out
        return pytree.tree_map(
            lambda x: x.clone() if isinstance(x, torch.Tensor) else x, out)

    def __call__(self, *args):
        with span("graph.load"):
            self.load(*args)
        with span("graph.run"):
            out = self.run()
        with span("graph.copy_out"):
            return self.result(out)
