"""What a traced stretch of the window holds, read from its
``torch.profiler`` trace: the device's operations, the host's waits on the
device, and the stretch's bounds (the harness's ``bench.frame_start``
marks).  The per-layer metrics (benchmark/metrics) read a :class:`Stretch`.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import NamedTuple

from torch.autograd import DeviceType

from benchmark import stats

# Host calls in which the host waits for the card (times in us).
SYNC_CALLS = ("cudaDeviceSynchronize", "cudaStreamSynchronize",
              "cudaEventSynchronize")
COPY_CALLS = ("cudaMemcpyAsync", "cudaMemcpy")


class Stretch(NamedTuple):
    lo: float                 # us, first mark (a frame's start)
    hi: float                 # us, last mark
    frames: int               # frames (batch steps) between the marks
    device: list              # (start, end, name) device operations
    host: list                # (start, end, name) host events
    streams: int              # streams a frame (batch step) tracks
    states: list              # one stream's tracker state, each stream's
                              # at the stretch's two ends
    config: object            # the port's SuPerConfig as run
    intr: tuple               # (fx, fy, cx, cy)
    context: dict             # the card's peaks and power limit; readers
                              # note what bounds a roofline under "bounds"


def kernel_spans(events):
    """Sorted (start us, end us, name) of every device operation in
    ``events``: the device events less each host range's span, which the
    device timeline also carries (a kernel's name is never a host event's).
    A copy of the port's ``utils/profiling.py:kernel_spans``; kernels
    launched through ctypes have no PyTorch op as parent and are caught
    too."""
    host_names = {e.name for e in events if e.device_type == DeviceType.CPU}
    return sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in events if e.device_type == DeviceType.CUDA
                  and e.name not in host_names)


def read(prof, streams: int, states: list, config, intr,
         context: dict) -> Stretch:
    events = prof.events()
    marks = sorted(e.time_range.start for e in events
                   if e.name == "bench.frame_start")
    lo, hi = marks[0], marks[-1]
    host = sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in events if e.device_type == DeviceType.CPU
                  and e.time_range.end > lo and e.time_range.start < hi)
    device = [s for s in kernel_spans(events) if s[1] > lo and s[0] < hi]
    return Stretch(lo, hi, len(marks) - 1, device, host, streams, states,
                   config, intr, context)


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def busy_us(st: Stretch) -> float:
    return stats.union([(s, e) for s, e, _ in st.device], st.lo, st.hi)


def wait_us(st: Stretch) -> float:
    """Host time in calls that wait for the card: synchronisations, and
    copies during which the card copies device memory to the host."""
    d2h = [(s, e) for s, e, n in st.device if "DtoH" in n]
    total = 0.0
    for s, e, n in st.host:
        if n in SYNC_CALLS or (n in COPY_CALLS and any(
                a < e and b > s for a, b in d2h)):
            total += min(e, st.hi) - max(s, st.lo)
    return total


def breakdown(st: Stretch, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps of the card by what the host was doing (the innermost host event
    over the gap's middle), in seconds."""
    by_op = defaultdict(float)
    for s, e, n in st.device:
        by_op[n] += (min(e, st.hi) - max(s, st.lo)) * 1e-6
    by_host = defaultdict(float)
    host = sorted(st.host)
    starts = [s for s, _, _ in host]
    long = [h for h in host if h[1] - h[0] >= 1000.0]
    for a, b in stats.gaps([(s, e) for s, e, _ in st.device], st.lo, st.hi):
        mid = 0.5 * (a + b)
        i = bisect.bisect_right(starts, mid)
        over = [(e - s, n) for s, e, n in host[max(0, i - 300):i] + long
                if s <= mid <= e]
        by_host[min(over)[1] if over else "host (no event)"] += \
            (b - a) * 1e-6
    return {"device_ops": sorted(([n, v] for n, v in by_op.items()),
                                 key=lambda x: -x[1])[:top],
            "idle_gaps": sorted(([n, v] for n, v in by_host.items()),
                                key=lambda x: -x[1])[:top]}
