"""Timing and tracing helpers on CUDA (counterpart of
super_tpu/utils/profiling.py).

- :func:`chain_time`: seconds a call over a run of calls.  A CUDA stream
  runs its work in order, so consecutive calls are already serial and no
  dependency scalar is injected; the host reads the result (``probe``)
  and synchronises with the card before and after the timed calls.
- :func:`trace`: a ``torch.profiler`` context that writes a Chrome trace
  (open it in ``chrome://tracing`` or Perfetto; no TensorBoard plugin).
- :func:`loop_time`: ms an iteration over back-to-back calls chained
  through an accumulator, between CUDA events.
- :func:`kernel_spans`: the device work of a profiled window.
- :func:`span`: the port's one span mechanism.  Inside a
  ``torch.profiler`` window it opens a ``record_function`` range, so the
  program's spans share one clock with the device's timeline; outside one
  it is a flag check and a shared no-op context.  While a step captured
  with stage timing (:class:`StageTimer`, core/compiled.py) runs, the
  step's top-level stages (:data:`STAGES`) also record a pair of timing
  events each, nodes of the CUDA graph when captured.

What this does not amortise: the JAX ``loop_time`` runs its iterations in
one compiled ``fori_loop``, so dispatch is paid once.  Here each
iteration's kernels are launched from the host, and where the host
enqueues them more slowly than the card runs them the time is the
host's (PERF.md section 5: the port's step is host-bound).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import torch
from torch.autograd import DeviceType
from torch.autograd import profiler as _autograd_profiler

# The step's top-level stages (core/tracker.py:track_step), timed by a
# StageTimer: the LM path's, or the autograd fit's step.graph_fit.
STAGES = ("step.prepare_lm", "step.lm_solve", "step.graph_fit",
          "step.apply_deformation", "step.fuse_frame", "step.prune")
BODY = "body"                  # a StageTimer's bracket of the whole step

_OFF = contextlib.nullcontext()
_timer = None                  # the StageTimer of the step being run


def profiler_enabled() -> bool:
    """Whether a ``torch.profiler`` (or autograd profiler) window is open."""
    return _autograd_profiler._is_profiler_enabled


def span(name: str):
    """A context naming a stretch of the program: a ``record_function``
    range while a profiler is on, else a shared no-op context (no
    ``RecordFunction`` is made); a stage of :data:`STAGES` is also timed
    while a :class:`StageTimer` is active (:func:`stage_timing`)."""
    if _timer is not None and name in STAGES:
        return _timer.stage(name)
    if _autograd_profiler._is_profiler_enabled:
        return _autograd_profiler.record_function(name)
    return _OFF


class StageTimer:
    """Times the stages of one run of a step: on the card a pair of timing
    events around each (``external``, so that a capture records them as
    event nodes of its graph and every replay writes them again), on the
    CPU the host clock.  A stage met more than once in a run (the streams
    of a batched step) sums.  Read :meth:`ms` after the run has finished
    on the card (the caller's synchronisation)."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.marks = []            # (name, start, end)

    def _stamp(self):
        if not self.cuda:
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True, external=True)
        event.record()
        return event

    @contextlib.contextmanager
    def stage(self, name: str):
        start = self._stamp()
        if profiler_enabled():
            with _autograd_profiler.record_function(name):
                yield
        else:
            yield
        self.marks.append((name, start, self._stamp()))

    def ms(self) -> dict:
        """{stage: ms} of the run, :data:`BODY` the whole step's."""
        out = {}
        for name, a, b in self.marks:
            d = a.elapsed_time(b) if self.cuda else (b - a) * 1e3
            out[name] = out.get(name, 0.0) + d
        return out


@contextlib.contextmanager
def stage_timing(timer: StageTimer):
    """Time the stages met in the block with ``timer``."""
    global _timer
    prev, _timer = _timer, timer
    try:
        yield timer
    finally:
        _timer = prev


def kernel_spans(prof):
    """Sorted (start us, end us, name) of every device operation that
    ``prof`` (a finished ``torch.profiler.profile``) recorded: the device
    events, less each host range's span, which the device timeline also
    carries (a kernel's name is never a host event's).  This also catches
    kernels launched through ctypes, which have no PyTorch op as parent."""
    events = prof.events()
    host_names = {e.name for e in events if e.device_type == DeviceType.CPU}
    return sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in events if e.device_type == DeviceType.CUDA
                  and e.name not in host_names)


def _first_element(out) -> torch.Tensor:
    """The first element of the first tensor in ``out`` (a tensor, or
    nested tuples, lists and dicts of them)."""
    if isinstance(out, torch.Tensor):
        return out.reshape(-1)[0]
    items = out.values() if isinstance(out, dict) else out
    for item in items:
        found = _first_element(item)
        if found is not None:
            return found
    return None


def chain_time(fn: Callable, *args, probe: Callable = None, reps: int = 5,
               **kwargs) -> float:
    """Seconds a call of ``fn(*args, **kwargs)``, over ``reps`` calls after
    two warm-up calls (which build any kernel at first use).  ``probe``
    takes a result to a scalar tensor, read on the host (default: its
    first tensor's first element)."""
    probe = probe or _first_element

    def wait(out):
        float(probe(out))
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()

    for _ in range(2):
        out = fn(*args, **kwargs)
    wait(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args, **kwargs)
    wait(out)
    return (time.perf_counter() - t0) / reps


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block (host, and the card where there is one) and write
    its Chrome trace to ``logdir/trace.json``; yields the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def loop_time(make_fn: Callable, init: torch.Tensor, n_iter: int = 20,
              args: tuple = ()) -> float:
    """Milliseconds an iteration of ``acc = acc + make_fn(acc * 1e-30,
    *args) * 1e-30`` (``make_fn`` returns a scalar tensor), over ``n_iter``
    iterations after one warm-up: between CUDA events where ``init`` lies
    on the card, else on the host clock."""
    def body(acc):
        return acc + make_fn(acc * 1e-30, *args) * 1e-30

    acc = body(init)
    cuda = init.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(init.device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    else:
        t0 = time.perf_counter()
    for _ in range(n_iter):
        acc = body(acc)
    if cuda:
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / n_iter
    float(acc)
    return (time.perf_counter() - t0) * 1e3 / n_iter
