"""Where the time of a path of the tracking step goes, on one CUDA card.

    python -m super_tpu_torch.profile_step [--workload lm] [--frames 4]
                                           [--seed 0] [--captured]

Runs a path of the tracking step at 480 x 640 (config.workload_config):
``lm``, the headline (mesh step 30, J = 384, pair-sparse CG by K1);
``dense16``, the dense ED graph (mesh step 16, J = 1216, K1b);
``pcg_pallas``, ``cholesky`` or ``pcg``, the headline with that
dense-matrix solver (K3 for ``pcg_pallas``); ``per_iteration``, the
headline with the moving-target association (K1, K2's memory form);
``semantic``, the autograd Semantic-SuPer fit (Adam, 10 steps) on frames
with the generator's two-class segmentations; ``e2e_depth``, the headline
with each frame's depth inferred by monodepth2 (seeded random weights,
flip post-processing) under a ``perception.depth`` range, then
preprocessed under ``step.preprocess``; the option paths
``hypotheses`` (3 damping hypotheses a trip, K1 three times),
``hypotheses_dense`` (``pcg_pallas`` with 2, K3 twice), ``scatter`` (the
scatter assembly, Cholesky), ``expand_blocks`` (the tuple Grams summed
into node-pair blocks, Cholesky) and ``bf16_pcg`` (the dense graph with
a bf16 matrix and PCG).
Frame 0 initialises, one frame warms up, one runs under CUDA's sync debug
mode to find any host sync in the step, then ``--frames`` frames run with
tracing off, each timed on the host clock around a synchronised step, and
the same number of frames under ``torch.profiler``.  Prints one JSON line:
the card, ms per frame untraced, and from the traced run the host and
device ms and the kernel launches per frame of each ``step.*``,
``lm.*`` and ``graph_fit.*`` range (a range holds the kernels launched
from its thread; the autograd engine launches the fit's backward pass
from its own, so those kernels lie in no range and are counted as
``device_ms_in_no_range``), the kernels' device ms and launches per frame
and busy share of the traced window, and the kernels with the most device
time.

With ``--captured`` it profiles the step as the pipelines run it: the
path's ``make_jit_step`` captured as a CUDA graph, built with
``stage_times`` (timing events around each ``step.*`` stage, nodes of the
graph; core/compiled.py:CapturedStep.stage_ms), beside the same path
captured without them.  Frame 0 initialises, frame 1 warms up and
captures each; then both replay ``2 * --frames`` frames in turns, once to
settle the card and once each timed on the host clock around a
synchronised replay and between CUDA events; then the timed step replays
the last ``--frames`` of them under ``torch.profiler``.  It prints each
stage's device ms a frame (their sum beside the whole body's and the
traced replays' device busy ms), the replay's ms between CUDA events with
the stage events and without, and of the traced replays the kernels,
device busy ms, the span from the first kernel's start to the last's end
(which the stage events, read in the same replays, sum to), and the top
kernels.  Tracing slows a replay (the profiler's per-kernel records); the
untraced stage times are the step's.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import json
import statistics
import subprocess
import time
import traceback
import warnings

import numpy as np
import torch
from torch.autograd import DeviceType

import super_tpu_torch  # noqa: F401  (TF32 off)
from super_tpu_torch.config import WORKLOADS, workload_config
from super_tpu_torch.core.preprocess import preprocess_frame
from super_tpu_torch.core.tracker import (
    init_tracker,
    make_jit_step,
    track_step,
)
from super_tpu_torch.data.synthetic import default_intrinsics, generate
from super_tpu_torch.utils.profiling import kernel_spans, span

RANGES = ("perception.depth", "step.preprocess", "step.prepare_lm",
          "step.lm_solve", "step.graph_fit", "step.apply_deformation",
          "step.fuse_frame", "step.prune",
          "lm.associate", "lm.assemble", "lm.solve", "lm.cost",
          "lm.final_cost",
          "graph_fit.prepare", "graph_fit.loss", "graph_fit.backward",
          "graph_fit.step")


def _count_syncs(step, state):
    """One ``step(state)`` under CUDA's sync debug mode: where it waits for
    the card (the innermost frames of this package, for each synchronising
    call)."""
    sites = []

    def hook(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            ours = [f"{f.filename.rsplit('/', 2)[-1]}:{f.lineno}"
                    for f in traceback.extract_stack()[:-1]
                    if "super_tpu_torch" in f.filename]
            sites.append(ours[-3:] + [f"{filename}:{lineno}"])

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")   # (itself warns once)
        warnings.showwarning = hook
        try:
            state, _ = step(state)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return state, sites


def _union_us(spans) -> float:
    """Length of the union of (start, end) spans."""
    total, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def _top(kernels, frames, count=15):
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for k0, k1, kname in kernels:
        by_name[kname][0] += 1
        by_name[kname][1] += k1 - k0
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:count]
    return [dict(name=kname[:90], calls_per_frame=c / frames,
                 device_ms_per_frame=t / 1e3 / frames)
            for kname, (c, t) in top]


def _replay(step, intr, frame, events=None):
    """Load ``frame`` (the state stays in the step's buffers, carried by
    the last replay), then one synchronised replay, between ``events``
    where given: (host ms of the replay, its ms between the events)."""
    step.load(intr, step.buffers[1], frame)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with span("profile.replay"):
        if events:
            events[0].record()
        step.replay()
        if events:
            events[1].record()
        torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    return host_ms, events[0].elapsed_time(events[1]) if events else None


def _stages(step):
    return dict(step.stage_ms(), body=step.body_ms())


def _mean_stages(rows):
    mean = {k: statistics.fmean(r[k] for r in rows) for k in rows[0]}
    body = mean.pop("body")
    return mean, sum(mean.values()), body


def captured(cfg, intr, frame_of, frames: int) -> dict:
    """``--captured``: the captured step's stage times, trace and the stage
    events' cost (the module docstring)."""
    steps = {"timed": make_jit_step(cfg, stage_times=True),
             "plain": make_jit_step(cfg)}
    state = init_tracker(cfg, frame_of(0))
    for step in steps.values():
        step(intr, state, frame_of(1))                    # warm-up, capture
    run = range(3, 3 + 2 * frames)
    events = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
    host = {name: [] for name in steps}
    replay = {name: [] for name in steps}
    rows = []
    # Replays of both steps in turns: a round to settle the card's clocks
    # and caches, then a round between CUDA events (the stage events'
    # cost), the timed step's stages read after each.
    for timing in (False, True):
        for t in run:
            order = list(steps.items())
            for name, step in (order if t % 2 else order[::-1]):
                host_ms, ms = _replay(step, intr, frame_of(t),
                                      events if timing else None)
                if timing:
                    host[name].append(host_ms)
                    replay[name].append(ms)
                    if name == "timed":
                        rows.append(_stages(step))
    step = steps["timed"]

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    traced_rows = []
    with torch.profiler.profile(activities=acts) as prof:
        for t in run[frames:]:
            _replay(step, intr, frame_of(t))
            traced_rows.append(_stages(step))
    replays = sorted((e.time_range.start, e.time_range.end)
                     for e in prof.events()
                     if e.device_type == DeviceType.CPU
                     and e.name == "profile.replay")
    kernels = [k for k in kernel_spans(prof)
               if any(a <= k[0] <= b for a, b in replays)]
    busy_ms = _union_us([(k0, k1) for k0, k1, _ in kernels]) / 1e3 / frames
    span_ms = statistics.fmean(
        max(k1 for k0, k1, _ in kernels if a <= k0 <= b)
        - min(k0 for k0, _, _ in kernels if a <= k0 <= b)
        for a, b in replays) / 1e3

    stages, stage_sum, body = _mean_stages(rows)
    t_stages, t_sum, t_body = _mean_stages(traced_rows)
    timed_ms = statistics.median(replay["timed"])
    plain_ms = statistics.median(replay["plain"])
    return dict(
        captured=True,
        host_ms_per_replay=host["timed"],
        host_median_ms=statistics.median(host["timed"]),
        stage_ms=stages, stage_sum_ms=stage_sum, body_ms=body,
        stage_sum_over_busy=stage_sum / busy_ms,
        replay_ms_with_stage_events=timed_ms, replay_ms_without=plain_ms,
        stage_events_cost=timed_ms / plain_ms - 1,
        replay_ms_each=replay,
        replay_device_busy_ms=busy_ms, replay_device_span_ms=span_ms,
        kernels_per_frame=len(kernels) / frames,
        traced_stage_ms=t_stages, traced_stage_sum_ms=t_sum,
        traced_body_ms=t_body,
        traced_stage_sum_over_span=t_sum / span_ms,
        traced_stage_ms_per_frame=traced_rows,
        top_kernels=_top(kernels, frames))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", choices=WORKLOADS, default="lm")
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--captured", action="store_true",
                    help="profile the captured step (make_jit_step with "
                    "stage_times): stage device ms, trace, events' cost")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: no CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()

    cfg = workload_config(args.workload)
    intr = default_intrinsics(cfg.height, cfg.width, device=dev)
    n = 3 + 2 * args.frames
    semantic = cfg.method == "semantic-super"
    seq = generate(n, cfg.height, cfg.width, intr=intr, seed=args.seed,
                   num_classes=cfg.num_classes if semantic else 0)
    colors = np.ascontiguousarray(seq.colors.transpose(0, 3, 1, 2))
    if cfg.depth_model is None:
        frames = [preprocess_frame(
            cfg, intr, seq.depths[t], colors[t], float(t),
            seg=seq.segs[t] if semantic else None,
            seg_conf=seq.seg_confs[t] if semantic else None, device=dev)
            for t in range(n)]
        frame_of = frames.__getitem__
    else:
        from super_tpu_torch.factory import build_models, predict_frame_inputs

        models = build_models(cfg, seed=args.seed, device=dev)
        colors_dev = torch.as_tensor(colors, device=dev)

        def frame_of(t):
            with span("perception.depth"):
                depth = predict_frame_inputs(cfg, models,
                                             colors_dev[t])["depth"]
            with span("step.preprocess"):
                return preprocess_frame(cfg, intr, depth, colors_dev[t],
                                        float(t), device=dev)

    head = dict(card=card, workload=args.workload,
                linear_solver=cfg.solver.linear_solver,
                optimizer=(None if cfg.solver.use_derived_gradient
                           else cfg.solver.optimizer),
                node_capacity=cfg.capacity.node_capacity,
                frames=args.frames, seed=args.seed)
    if args.captured:
        print(json.dumps(dict(head, **captured(cfg, intr, frame_of,
                                               args.frames))))
        return

    def step(state, t):
        return track_step(cfg, intr, state, frame_of(t))

    state = init_tracker(cfg, frame_of(0))
    state, _ = step(state, 1)                                 # warm-up
    state, syncs = _count_syncs(lambda st: step(st, 2), state)

    untraced = []
    for t in range(3, 3 + args.frames):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = step(state, t)
        torch.cuda.synchronize()
        untraced.append((time.perf_counter() - t0) * 1e3)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(3 + args.frames, n):
            state, _ = step(state, t)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3

    # Device-side events: the kernels, and one interval per range on the
    # device timeline.  A kernel counts toward a range when it ran inside
    # that interval.
    dev_events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
    kernels = kernel_spans(prof)
    starts = [k[0] for k in kernels]
    per = 1e3 * args.frames
    ranges = {}
    spans = []
    for name in RANGES:
        host = [e for e in prof.events()
                if e.device_type == DeviceType.CPU and e.name == name]
        dev_ms, n_kernels = 0.0, 0
        for e in dev_events:
            if e.name != name:
                continue
            spans.append((e.time_range.start, e.time_range.end))
            lo = bisect.bisect_left(starts, e.time_range.start)
            for k0, k1, _ in kernels[lo:]:
                if k0 >= e.time_range.end:
                    break
                if k1 <= e.time_range.end:
                    dev_ms += k1 - k0
                    n_kernels += 1
        ranges[name] = dict(
            calls_per_frame=len(host) / args.frames,
            host_ms=sum(e.cpu_time_total for e in host) / per,
            device_ms=dev_ms / per,
            kernels_per_frame=n_kernels / args.frames)
    device_ms = sum(k1 - k0 for k0, k1, _ in kernels) / 1e3
    merged = []                       # the ranges' union, disjoint spans
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    merged_starts = [a for a, _ in merged]
    no_range_us = 0.0
    for k0, k1, _ in kernels:
        i = bisect.bisect_right(merged_starts, k0) - 1
        if i < 0 or k1 > merged[i][1]:
            no_range_us += k1 - k0
    print(json.dumps(dict(
        head,
        host_syncs_per_frame=len(syncs), host_sync_sites=syncs[:10],
        untraced_ms_per_frame=untraced,
        untraced_median_ms=statistics.median(untraced),
        traced_ms_per_frame=window_ms / args.frames,
        device_ms_per_frame=device_ms / args.frames,
        kernels_per_frame=len(kernels) / args.frames,
        device_busy_share_traced=device_ms / window_ms,
        device_ms_in_no_range=no_range_us / per,
        ranges=ranges,
        top_kernels=_top(kernels, args.frames))))


if __name__ == "__main__":
    main()
