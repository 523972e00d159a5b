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
