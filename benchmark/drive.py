"""One run of a cell: the clip, the port's frame loop driven through a frame
source of the harness's own, the timed window, the traced stretch, and
what the comparison needs.

A frame is what the pipeline does for it: ``captured_preprocess`` from the
numpy frame, the replayed step, the GT binding and the tracked points read
to the host, the overflow counters and the synchronisation.  Neither
pipeline has a per-frame call, so ``run`` is handed sources that declare
more frames than any window reaches.  The first fetch of frame t (its
colour in ``SuPerPipeline``, its depth of stream 0 in
``MultiStreamPipeline``) is frame t's start and frame t-1's end: there the
harness takes the time, ends the window (by raising :class:`EndOfWindow`,
which it catches), starts and stops the profiler, and keeps the states
that the comparison needs.  Frame t is the clip's frame ``pingpong(t)`` at
time t, so the tissue is pulled and released while surfel ages run on.
The seed draws each stream's start time in the deformation and its
tracked pixels.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import clip as clipgen
from benchmark import stats


class EndOfWindow(Exception):
    """Raised at the first frame start past the window's end."""


def pingpong(t: int, n: int) -> int:
    """Frame t of a clip of n frames played forward and back."""
    k = t % (2 * n - 2)
    return k if k < n else 2 * n - 2 - k


def draw(seed: int, stream: int, traffic: dict, height: int, width: int):
    """The seed's choices for one stream: the clip's start time in the
    deformation and the tracked pixels (x, y)."""
    rng = np.random.default_rng([seed, stream])
    t0 = float(rng.uniform(*traffic["start_time"]))
    margin = min(40, width // 4, height // 4)
    xy = np.stack([rng.integers(margin, width - margin,
                                traffic["tracked_points"]),
                   rng.integers(margin, height - margin,
                                traffic["tracked_points"])], axis=-1)
    return t0, xy


def make_clips(seed: int, traffic: dict, cfg: dict, device) -> list:
    """Each stream's clip, made on the device and taken to host numpy once,
    as a camera delivers its frames: {depths (T, H, W), colors (T, H, W,
    3), gt_xy (T, P, 2), gt_valid (T, P), segs, seg_confs}."""
    h, w = cfg["height"], cfg["width"]
    classes = cfg["num_classes"] if cfg["load_seg"] else 0
    clips = []
    for s in range(traffic["streams"]):
        t0, xy = draw(seed, s, traffic, h, w)
        c = clipgen.make_clip(h, w, traffic["frames"], t0, xy,
                              num_classes=classes,
                              variant=traffic["variant"], device=device,
                              noise_seed=(seed * 7919 + s) % 2 ** 63)
        clips.append({k: None if v is None else v.cpu().numpy()
                      for k, v in c._asdict().items()})
    return clips


def stream_state(state, s: int):
    """Stream s of a stacked tracker state (the same NamedTuples)."""
    if isinstance(state, torch.Tensor):
        return state[s] if state.dim() else state
    return type(state)(*(stream_state(f, s) for f in state))


def frame_of(t: int, clip: dict) -> int:
    """The clip frame that frame t of the run serves."""
    return pingpong(t, clip["depths"].shape[0])


class Window:
    """Frame starts on the host clock, the window's bounds, the traced
    stretch and the states kept for the comparison."""

    def __init__(self, seconds: float, warmup: int, min_frames: int,
                 seed: int, checks: int, trace: Optional[dict] = None):
        self.seconds, self.warmup, self.min_frames = seconds, warmup, \
            min_frames
        self.starts = []             # host clock at each frame's start
        self.end = None              # index of the frame not run
        self.trace = trace           # {"frames": n, "skip": k}, or None
        self.prof = None
        self.trace_marks = []        # frame indices of the stretch
        self.trace_states = []       # the states before and after it
        self.rng = np.random.default_rng([seed, 1])
        self.checks = checks
        self.sample = []             # window frames kept for the check
        self.kept = {}               # t -> {"prev", "frames", "after"}
        self.kept[0] = {"prev": None, "frames": []}
        self.now = 0                 # frame being run
        self.failed_before = 0
        self.overflow_frames = []    # (t, counters grew during t)

    def start(self, t: int, state, overflow=None):
        """Frame t starts (its first fetch): ``state`` is the pipeline's
        state after frame t-1; ``overflow`` its overflow totals so far
        (SuPerPipeline's, by counter)."""
        now = time.perf_counter()
        self.starts.append(now)
        if t - 1 in self.kept:
            self.kept[t - 1]["after"] = state
        if overflow is not None:
            total = sum(overflow.values())
            if t >= 1:
                self.overflow_frames.append((t - 1,
                                             total > self.failed_before))
            self.failed_before = total
            if t == self.warmup:
                self.overflow_start = dict(overflow)
            self.overflow_now = dict(overflow)
        if t > self.warmup and now - self.starts[self.warmup] >= \
                self.seconds and t >= self.min_frames:
            self.end = t
            self._stop_trace()
            raise EndOfWindow
        self._trace_at(t, now, state)
        if t >= self.warmup:
            self._reservoir(t, state)
        self.now = t

    def _reservoir(self, t, state):
        """A uniform sample of ``checks`` window frames, drawn from the
        seed as the window goes (its length is not known before)."""
        n = t - self.warmup + 1
        if len(self.sample) < self.checks:
            slot = len(self.sample)
            self.sample.append(t)
        else:
            slot = int(self.rng.integers(0, n))
            if slot >= self.checks:
                return
            self.kept.pop(self.sample[slot], None)
            self.sample[slot] = t
        self.kept[t] = {"prev": state, "frames": []}

    def frame_out(self, frame):
        """The program's preprocessed frame of the frame being run (one
        call a stream)."""
        if self.now in self.kept:
            self.kept[self.now]["frames"].append(frame)

    def _trace_at(self, t, now, state):
        if self.trace is None:
            return
        if self.prof is None and not self.trace_marks and \
                t >= self.warmup and \
                now - self.starts[self.warmup] >= self.trace["after_s"]:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_initialized():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.start()
            self.trace_from = t + self.trace["skip"]
            # The tracker's state before the stretch and at its end set the
            # work the rooflines count (kept outside it: a state kept in
            # the stretch would make the allocator grow inside it).
            self.trace_states.append(state)
        if self.prof is not None and t >= self.trace_from:
            with record_function("bench.frame_start"):
                self.trace_marks.append(t)
            if len(self.trace_marks) > self.trace["frames"]:
                self._stop_trace()
                self.trace_states.append(state)

    def _stop_trace(self):
        if self.prof is not None:
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()
            self.prof.stop()
            self.finished_prof, self.prof = self.prof, None

    @property
    def frames(self) -> int:
        return self.end - self.warmup

    @property
    def wall_s(self) -> float:
        return self.starts[self.end] - self.starts[self.warmup]

    def frame_times(self):
        return stats.intervals(self.starts[self.warmup:self.end + 1])


class _Frames:
    """``run``'s view of one array of a stream's clip: frame t is the
    clip's frame pingpong(t); with ``on_start`` the first fetch of each
    frame is that frame's start."""

    def __init__(self, arr, on_start=None, length=10 ** 9):
        self.arr, self.on_start, self.length = arr, on_start, length
        self.seen = -1
        self.shape = (length,) + arr.shape[1:]

    def __len__(self):
        return self.length

    def __getitem__(self, t):
        if self.on_start is not None and t > self.seen:
            self.seen = t
            self.on_start(t)
        return self.arr[pingpong(t, self.arr.shape[0])]


def _spans(obj, name: str, label: str):
    """Wrap ``obj.name`` in a profiler range (traced runs)."""
    fn = getattr(obj, name)

    def wrapped(*a, **k):
        with record_function(label):
            return fn(*a, **k)

    setattr(obj, name, wrapped)


def run_single(cfg, intr, clip: dict, win: Window, device, traced: bool,
               patch=None):
    """``SuPerPipeline.run`` (compiled, GT given) over the clip until the
    window ends.  ``patch`` (tests) is called with the pipeline once it
    has chosen its loop.  Returns the pipeline."""
    from super_tpu_torch.pipeline import SuPerPipeline

    pipe = SuPerPipeline(cfg, intr, device=device, compiled=True)

    def on_start(t):
        if t == 0:
            # run has chosen its loop: wrap the captured preprocessing.
            pre = pipe._preprocess

            def recorded(*a):
                out = pre(*a)
                win.frame_out(out)
                return out
            pipe._preprocess = recorded
            if traced:
                _spans(pipe, "_preprocess", "bench.preprocess")
                _spans(pipe, "_step", "bench.step")
                _spans(pipe, "_eval_frame", "bench.gt_binding")
            if patch is not None:
                patch(pipe)
        win.start(t, pipe.state, pipe.overflow_totals)

    def view(key, on=None):
        return None if clip[key] is None else _Frames(clip[key], on)

    try:
        pipe.run(view("depths"), view("colors", on_start),
                 gt_xy=view("gt_xy"), gt_valid=view("gt_valid"),
                 segs=view("segs"), seg_confs=view("seg_confs"))
    except EndOfWindow:
        pass
    return pipe


def run_streams(cfg, intr, clips: list, win: Window, device, traced: bool,
                keep_tracks: int, patch=None):
    """``MultiStreamPipeline.run`` over the streams' clips until the window
    ends; the tracked points of the first ``keep_tracks`` frames are kept
    (device tensors, read after the window).  Returns the pipeline."""
    from super_tpu_torch.parallel.streams import MultiStreamPipeline

    pipe = MultiStreamPipeline(cfg, intr, device=device)
    pre = pipe._preprocess

    def recorded(*a):
        out = pre(*a)
        win.frame_out(out)
        return out
    pipe._preprocess = recorded
    if traced:
        _spans(pipe, "_frame", "bench.preprocess")
        _spans(pipe, "_step", "bench.step")
        _spans(pipe, "_eval_frame", "bench.gt_binding")
    if patch is not None:
        patch(pipe)
    pipe.kept_tracks = []

    def on_start(t):
        if 1 <= t <= keep_tracks:
            pipe.kept_tracks.append(pipe.states.track)
        win.start(t, pipe.states)

    class Stream:
        def __init__(self, key):
            self.views = [_Frames(c[key], on_start if key == "depths" and
                                  s == 0 else None)
                          for s, c in enumerate(clips)]
            self.shape = (len(clips),) + self.views[0].shape

        def __getitem__(self, s):
            return self.views[s]

    try:
        pipe.run(Stream("depths"), Stream("colors"),
                 gt_xy=Stream("gt_xy"), gt_valid=Stream("gt_valid"))
    except EndOfWindow:
        pass
    return pipe
