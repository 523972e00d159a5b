"""Frames per second of the port's tracking step, in the root bench's JSON
line.

    python -m super_tpu_torch.bench [--reps 30] [--no_dense] [--cpu]
                                    [--mode step|lm] [--streams 1]
                                    [--association per_frame|per_iteration]
                                    [--sol] [--host_loop]
                                    [--height 480 --width 640
                                     --mesh_step_size 30]

The workloads of the JAX package's bench (bench.py, ``build_workload``)
as the port runs them (config.lm_workload_config,
config.semantic_workload_config): the headline with the per-frame
association (``value``), the same with the per-iteration (moving-target)
association (``per_iteration_hz``), the dense ED graph, mesh step 16
(``dense_mesh16_hz``, unless ``--no_dense``), and the autograd
Semantic-SuPer fit with the generator's two-class segmentations
(``semantic_hz``), and the live path with monodepth2's depth in the loop
(``e2e_depth_hz``, config.e2e_depth_workload_config).  Each alternates
synthetic frames 1 and 2: ``n`` frames from the frame-0 state converge the
map (warm-up), then ``n`` more are timed, with ``n`` the root bench's:
``reps``, ``max(6, reps // 5)`` for the dense graph and ``max(6, reps //
3)`` for the semantic fit and the live path, never more than ``reps``.
The live path infers every frame's depth, frame 0's too.  The perception
nets alone, with seeded random weights, as the root bench's
``measure_perception`` runs them: ``depth_mono_hz`` (monodepth2 with the
flip post-processing), ``depth_raft_hz`` (RAFT-Stereo, 32 GRU iterations)
and ``seg_hz`` (DeepLabV3+, two classes), on a constant left image of 0.5
(and a right one of 0.4), one warm-up call and then ``min(reps, 20)``
calls (``max(4, that // 2)`` for RAFT-Stereo).  The frame loop is the
root bench's device-resident one (``"loop": "device"``): the step, the
choice of frame 1 or 2 by a device index that the step flips, and the
overflow maxima are captured as one CUDA graph (core/compiled.py), the
live path's nets and preprocessing in it too, and the semantic path's
autograd fit (its forward and backward passes and Adam's updates), and
each frame is one replay, with one synchronisation at the end of the
timed frames and no host work between them.  ``--host_loop`` runs the
eager step a frame instead, one synchronisation at the end, everywhere,
as the root bench's flag does.  ``loops`` names each rate's loop.  On the CPU the captured loop runs eagerly on
its buffers (a check of the loop, not a measurement).  The overflow
counters' maxima over the timed frames ride along (``overflow``), so that
a run
which drops residuals cannot pass for a faster one.  Beside the headline,
as the root bench has them, the start-up transient: ``cold_start_hz``, a
second run of ``reps`` frames from the frame-0 state (the first run built
each kernel at first use), and its deferred adds, ``cold_add_deferred``.

``--association`` measures the headline with that association alone (no
sweep).  ``--mode lm`` measures LM frame-solves/s: ``prepare_lm`` once on
frame 1, then ``lm_solve`` ``reps`` times.  ``--sol`` adds the root
bench's per-stage speed-of-light block (``sol``, utils/sol.py): the
headline's ``prepare_lm``, identity ``associate``, one assembly, one K1
solve and one fusion, each a stage, its ``ms`` the device time alone (the
kernels' sum under ``torch.profiler``, over the calls: ``device_ms``)
beside the time between CUDA events (``events_ms``); on the CPU the host
clock's (``host_ms``).  It writes no file.  On the card unless ``--cpu``.

``--streams B`` tracks B copies of the stream at once, as the root
bench's ``--streams`` does: the headline, ``per_iteration_hz`` and
``dense_mesh16_hz`` (and ``--mode lm``) run B streams through
parallel/sharded.py:make_batched_step (B solves a trip for ``--mode
lm``); ``value`` and ``cold_start_hz`` are all B streams' frames a
second, ``per_stream_hz`` (and ``vs_baseline``) a stream's, and the
sweep's two other rates a stream's too.  The other workloads run one
stream.  ``--streams 1`` is the single-stream loop itself.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import subprocess
import time

import numpy as np
import torch

METRIC = "tracked frames/s per chip (full step: 10-iter LM + fusion)"
LM_METRIC = "LM frame-solves/s per chip (10 damped GN iterations)"
OVERFLOW = (("tuple", "tuple_overflow"), ("pair", "pair_overflow"),
            ("add_deferred", "add_overflow"), ("free", "free_exhausted"))


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _workload(cfg, device, seed: int = 0):
    """(intr, frame_of): the synthetic sequence's three frames, and with a
    ``depth_model`` in ``cfg`` each frame's depth from that net (seeded
    random weights) inferred at each call."""
    return _workload_parts(cfg, device, seed)[:2]


def _workload_parts(cfg, device, seed: int = 0):
    """(intr, frame_of, inputs2, frame_fn): :func:`_workload`'s, and the
    device-resident loop's source of frames 1 and 2: ``inputs2`` stacked
    over the two frames (their FrameData, or with a depth model their
    colours), ``frame_fn(one, t)`` a frame from one of them at time ``t``
    (a 0-d tensor), inside the captured loop."""
    import super_tpu_torch  # noqa: F401  (TF32 off)
    from super_tpu_torch.core.preprocess import preprocess_frame
    from super_tpu_torch.data.synthetic import default_intrinsics, generate
    from super_tpu_torch.utils.tree import stack

    h, w = cfg.height, cfg.width
    intr = default_intrinsics(h, w, device=device)
    semantic = cfg.method == "semantic-super"
    seq = generate(3, h, w, intr=intr, seed=seed,
                   num_classes=cfg.num_classes if semantic else 0)
    colors = np.ascontiguousarray(seq.colors.transpose(0, 3, 1, 2))
    if cfg.depth_model is None:
        frames = [preprocess_frame(
            cfg, intr, seq.depths[t], colors[t], float(t),
            seg=seq.segs[t] if semantic else None,
            seg_conf=seq.seg_confs[t] if semantic else None, device=device)
            for t in range(3)]
        return (intr, frames.__getitem__, stack(frames[1:]),
                lambda frame, t: frame)
    from super_tpu_torch.factory import build_models, predict_frame_inputs

    models = build_models(cfg, seed=seed, device=device)
    colors_dev = torch.as_tensor(colors, device=device)

    def frame_fn(color, t):
        depth = predict_frame_inputs(cfg, models, color)["depth"]
        return preprocess_frame(cfg, intr, depth, color, t, device=device)

    return (intr, lambda t: frame_fn(colors_dev[t], float(t)),
            colors_dev[1:], frame_fn)


def _overflow(outs, streams):
    """The overflow counters of a step's outputs (maxima over the
    streams), int64 (4,)."""
    d = torch.stack([getattr(outs, n).to(torch.int64) for _, n in OVERFLOW])
    return d.amax(dim=1) if streams > 1 else d


def loop_of(host_loop: bool = False) -> str:
    """The frame loop that :func:`measure_step` runs: ``"device"``,
    replays of the captured step, unless ``host_loop`` asks for
    ``"host"``, the eager step a frame."""
    return "host" if host_loop else "device"


def measure_step(cfg, reps: int, device, seed: int = 0, cold: bool = False,
                 streams: int = 1, host_loop: bool = False):
    """(frames/s of the timed pass, all streams', overflow maxima over it).
    With ``cold`` the overflow dict also holds ``cold_start_hz`` and
    ``cold_add_deferred``: a third run, from the frame-0 state again.
    ``streams`` > 1 tracks that many copies of the stream through
    make_batched_step.  The loop is :func:`loop_of`'s: the device-resident
    loop (the root bench's ``lax.scan``) captures the step, the frame's
    choice between frames 1 and 2 (a device index the step flips) and the
    overflow maxima in one graph (core/compiled.py), and each frame is one
    replay with no host work between frames; the host loop calls the
    eager step a frame."""
    from super_tpu_torch.core.tracker import init_tracker, track_step
    from super_tpu_torch.parallel.sharded import make_batched_step

    intr, frame_of, inputs2, frame_fn = _workload_parts(cfg, device, seed)
    state0 = init_tracker(cfg, frame_of(0))
    step = functools.partial(track_step, cfg, intr)
    if streams > 1:
        if cfg.depth_model is not None:
            raise ValueError("measure_step: streams with a depth net")
        # The stream broadcast B times (views), as the root bench's
        # jnp.broadcast_to: the step writes none of its inputs.
        step = make_batched_step(cfg, intr, compiled=False)
        inputs2 = _broadcast(inputs2, streams, axis=1)
        state0 = _broadcast(state0, streams)
    if not host_loop:
        run = _device_loop(step, state0, inputs2, frame_fn, streams, device)
    else:
        run = _host_loop(step, state0, frame_of, inputs2, cfg, streams,
                         device)
    # Warm-up: builds, converges.  track_step makes new tensors and writes
    # none of its input state's (tests/test_torch_bench.py), so state0
    # serves the cold run too.
    run(reps, True)
    diag, dt = run(reps, False)
    keys = [k for k, _ in OVERFLOW]
    overflow = dict(zip(keys, diag.tolist()))
    if cold:
        diag_c, dt_c = run(reps, True)
        overflow["cold_start_hz"] = round(streams * reps / dt_c, 3)
        overflow["cold_add_deferred"] = dict(zip(keys, diag_c.tolist()))[
            "add_deferred"]
    return streams * reps / dt, overflow


def _host_loop(step, state0, frame_of, inputs2, cfg, streams, device):
    """``run(n, from_start)``: n eager steps a frame, from ``state0`` or
    on from the last run's state; (overflow maxima, seconds between
    synchronisations)."""
    from super_tpu_torch.utils.tree import tree_map

    state = state0

    def frame_at(i):
        if cfg.depth_model is not None:
            return frame_of(1 + i % 2)
        return tree_map(lambda a: a[i % 2], inputs2)

    def run(n, from_start):
        nonlocal state
        if from_start:
            state = state0
        _sync(device)
        tic = time.perf_counter()
        diag = None
        for i in range(n):
            state, outs = step(state, frame_at(i))
            d = _overflow(outs, streams)
            diag = d if diag is None else torch.maximum(diag, d)
        _sync(device)
        return diag, time.perf_counter() - tic

    return run


def _device_loop(step, state0, inputs2, frame_fn, streams, device):
    """``run(n, from_start)`` as :func:`_host_loop`'s, on the captured
    loop: the step, frame 1 or 2 picked by a device index that the step
    flips, and the overflow maxima, captured at the first run (after its
    eager warm-up frame) and replayed once a frame."""
    from super_tpu_torch.core.compiled import CapturedStep
    from super_tpu_torch.utils.tree import tree_map

    def body(carry, inputs):
        state, ix, diag = carry
        one = tree_map(lambda a: a.index_select(0, ix)[0], inputs)
        state, outs = step(state, frame_fn(one, (ix[0] + 1).float()))
        return (state, 1 - ix, torch.maximum(diag, _overflow(outs, streams))
                ), outs.lm_cost

    captured = CapturedStep(body, carry=(0, 0), device=device)
    start = (state0, torch.zeros((1,), dtype=torch.int64, device=device),
             torch.zeros((len(OVERFLOW),), dtype=torch.int64, device=device))

    def run(n, from_start):
        if from_start:
            captured.load(start, inputs2)
        for x in captured.buffers[0][1:]:      # frame 1 next, no maxima
            x.zero_()
        _sync(device)
        tic = time.perf_counter()
        if not captured.captured:
            captured.run()                     # the warm-up, the capture
            n -= 1
        for _ in range(n):
            captured.replay()
        _sync(device)
        return captured.buffers[0][2].clone(), time.perf_counter() - tic

    return run


def _broadcast(tree, b: int, axis: int = 0):
    """A state or frame as a stacked batch of ``b`` streams (views); at
    ``axis`` 1, a stack of such (the two frames of the loop)."""
    from super_tpu_torch.utils.tree import tree_map

    return tree_map(lambda x: x.unsqueeze(axis).expand(
        x.shape[:axis] + (b,) + x.shape[axis:]), tree)


def measure_lm(cfg, reps: int, device, seed: int = 0,
               streams: int = 1) -> float:
    """LM frame-solves/s, all streams': ``prepare_lm`` once on frame 1
    from the frame-0 state, then ``lm_solve`` ``reps`` times after one
    warm-up solve, each time once per stream."""
    from super_tpu_torch.core.lm import lm_solve
    from super_tpu_torch.core.losses import prepare_lm
    from super_tpu_torch.core.tracker import init_tracker

    intr, frame_of = _workload(cfg, device, seed)
    state0 = init_tracker(cfg, frame_of(0))
    ctx = prepare_lm(cfg, state0.surfels, state0.graph, frame_of(1))
    lm_solve(cfg, ctx, intr)
    _sync(device)
    tic = time.perf_counter()
    for _ in range(reps * streams):
        lm_solve(cfg, ctx, intr)
    _sync(device)
    return streams * reps / (time.perf_counter() - tic)


def _stage_ms(fn, reps: int, device) -> dict:
    """ms a call over ``reps`` calls after two warm-up calls: on the card
    the device work alone (``device_ms``) and the time between CUDA
    events (``events_ms``); on the CPU the host clock's (``host_ms``)."""
    from super_tpu_torch.utils.profiling import kernel_spans

    for _ in range(2):
        fn()
    _sync(device)
    if torch.device(device).type != "cuda":
        tic = time.perf_counter()
        for _ in range(reps):
            fn()
        return dict(host_ms=(time.perf_counter() - tic) * 1e3 / reps)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        _sync(device)
    device_us = sum(k1 - k0 for k0, k1, _ in kernel_spans(prof))
    return dict(device_ms=device_us / 1e3 / reps,
                events_ms=start.elapsed_time(end) / reps)


def measure_sol(cfg, reps: int, device, seed: int = 0) -> dict:
    """The root bench's ``measure_sol`` on the port: each hot stage of the
    headline workload timed alone on frame 1's inputs, against its floor
    (utils/sol.py).  {"stages": sol_report's entries, achieved = the
    device time alone on the card, the host clock's on the CPU, with
    _stage_ms's unrounded times beside; "floors": every floor in ms}."""
    from super_tpu_torch.core import fusion
    from super_tpu_torch.core.lm import _pairs_fused_solve
    from super_tpu_torch.core.losses import (
        assemble_normal_equations,
        associate,
        prepare_lm,
    )
    from super_tpu_torch.core.tracker import init_tracker
    from super_tpu_torch.utils import sol

    intr, frame_of = _workload(cfg, device, seed)
    state0 = init_tracker(cfg, frame_of(0))
    frame1 = frame_of(1)
    ctx = prepare_lm(cfg, state0.surfels, state0.graph, frame1)
    j_cap = cfg.capacity.node_capacity
    beta0 = torch.zeros((j_cap, 7), device=device)
    beta0[:, 0] = 1.0
    assoc = associate(cfg, ctx, intr)
    acc, jtr, _ = assemble_normal_equations(cfg, ctx, beta0, intr, assoc)
    u = torch.tensor(10.0, device=device)
    stages = {
        "prepare": lambda: prepare_lm(cfg, state0.surfels, state0.graph,
                                      frame1),
        "assoc": lambda: associate(cfg, ctx, intr),
        "assemble": lambda: assemble_normal_equations(cfg, ctx, beta0, intr,
                                                      assoc),
        "solve": lambda: _pairs_fused_solve(cfg, ctx.layout, acc, jtr, u,
                                            j_cap),
        "fuse": lambda: fusion.fuse_frame(cfg, intr, state0.surfels,
                                          state0.graph, frame1),
    }
    times = {name: _stage_ms(fn, reps, device) for name, fn in stages.items()}
    np_cap = cfg.capacity.surfel_capacity
    floors = sol.stage_floors(
        np_cap=np_cap, p=cfg.image_pixels, j=j_cap,
        t_cap=cfg.solver.assembly_tuple_cap,
        a_cap=cfg.capacity.new_surfel_capacity,
        pcg_iters=cfg.solver.pcg_iterations,
        num_lm_iters=cfg.solver.num_iterations,
        pair_cap=cfg.solver.assembly_pair_cap)
    report = sol.sol_report(
        {k: v.get("device_ms", v.get("host_ms")) for k, v in times.items()},
        floors, mxu_flops={"assemble": np_cap * 28 * 29 * 2})
    for name, t in times.items():
        report.setdefault(name, {}).update(t)
    return dict(stages=report, floors=floors)


def measure_perception(reps: int, device, height: int, width: int) -> dict:
    """Calls per second of each perception net alone (the root bench's
    ``measure_perception``)."""
    from super_tpu_torch.config import SuPerConfig
    from super_tpu_torch.factory import build_models, predict_frame_inputs

    h, w = height, width
    color = torch.full((3, h, w), 0.5, device=device)
    right = torch.full((3, h, w), 0.4, device=device)
    n = min(reps, 20)

    def rate(cfg, calls, **kw):
        models = build_models(cfg, device=device)
        predict_frame_inputs(cfg, models, color, **kw)       # warm-up
        _sync(device)
        tic = time.perf_counter()
        for _ in range(calls):
            predict_frame_inputs(cfg, models, color, **kw)
        _sync(device)
        return round(calls / (time.perf_counter() - tic), 3)

    return dict(
        depth_mono_hz=rate(SuPerConfig(height=h, width=w,
                                       depth_model="monodepth2_stereo",
                                       post_process=True), n),
        depth_raft_hz=rate(SuPerConfig(height=h, width=w,
                                       depth_model="raft_stereo"),
                           max(4, n // 2), right_color_chw=right),
        seg_hz=rate(SuPerConfig(height=h, width=w, seg_model="deeplabv3+",
                                num_classes=2), n))


def _device_fields(device) -> dict:
    if torch.device(device).type != "cuda":
        return dict(device="cpu")
    return dict(device=torch.cuda.get_device_name(device),
                card=subprocess.run(
                    ["nvidia-smi", "--query-gpu=name,power.limit",
                     "--format=csv,noheader"], capture_output=True,
                    text=True, check=True).stdout.strip().splitlines()[0])


def _line(metric: str, hz: float, streams: int = 1,
          loop: str = "host") -> dict:
    """The line's leading fields for ``hz``, all streams' rate, measured
    by ``loop``."""
    per_stream = hz / streams
    return dict(metric=metric, value=round(hz, 3), unit="frames/s/chip",
                vs_baseline=round(per_stream / 30.0, 4), streams=streams,
                per_stream_hz=round(per_stream, 3), loop=loop)


def measure(reps: int = 30, device="cuda", height: int = 480,
            width: int = 640, mesh_step: int = 30, dense: bool = True,
            association=None, sol: bool = False, streams: int = 1,
            host_loop: bool = False):
    """The JSON line's fields.  With ``association`` only the headline,
    with that association; with ``sol`` also the ``sol`` block;
    ``streams`` as ``--streams``, ``host_loop`` as ``--host_loop``.
    ``loop`` is the headline's loop (:func:`loop_of`), ``loops`` each
    rate's."""
    from super_tpu_torch.config import e2e_depth_workload_config, \
        lm_workload_config, semantic_workload_config

    cfg = lm_workload_config(height, width, mesh_step)
    if association is not None:
        cfg = cfg.replace(solver=dataclasses.replace(
            cfg.solver, association=association))
    hz, overflow = measure_step(cfg, reps, device, cold=True,
                                streams=streams, host_loop=host_loop)
    loop = loop_of(host_loop)
    out = _line(METRIC, hz, streams, loop)
    loops = {"value": loop}
    out["cold_start_hz"] = overflow.pop("cold_start_hz")
    out["cold_add_deferred"] = overflow.pop("cold_add_deferred")
    out["overflow"] = overflow
    if association is None:
        per_it = cfg.replace(solver=dataclasses.replace(
            cfg.solver, association="per_iteration"))
        hz_it, overflow_it = measure_step(per_it, reps, device,
                                          streams=streams,
                                          host_loop=host_loop)
        out["per_iteration_hz"] = round(hz_it / streams, 3)
        out["per_iteration_overflow"] = overflow_it
        loops["per_iteration_hz"] = loop
        if dense:
            # The root bench's max(6, reps // 5) frames, never more than
            # reps.
            dense_cfg = lm_workload_config(height, width, 16)
            hz_d, overflow_d = measure_step(
                dense_cfg, min(reps, max(6, reps // 5)), device,
                streams=streams, host_loop=host_loop)
            out["dense_mesh16_hz"] = round(hz_d / streams, 3)
            out["dense_overflow"] = overflow_d
            loops["dense_mesh16_hz"] = loop
        # The root bench's max(6, reps // 3) frames, never more than reps.
        sem_cfg = semantic_workload_config(height, width, mesh_step)
        hz_s, overflow_s = measure_step(
            sem_cfg, min(reps, max(6, reps // 3)), device,
            host_loop=host_loop)
        out["semantic_hz"] = round(hz_s, 3)
        out["semantic_overflow"] = overflow_s
        loops["semantic_hz"] = loop
        out.update(measure_perception(reps, device, height, width))
        e2e_cfg = e2e_depth_workload_config(height, width, mesh_step)
        hz_e, overflow_e = measure_step(
            e2e_cfg, min(reps, max(6, reps // 3)), device,
            host_loop=host_loop)
        out["e2e_depth_hz"] = round(hz_e, 3)
        out["e2e_depth_overflow"] = overflow_e
        loops["e2e_depth_hz"] = loop
    out["loops"] = loops
    if sol:
        # The root bench's 40 calls a stage.
        out["sol"] = measure_sol(lm_workload_config(height, width,
                                                    mesh_step), 40, device)
    out.update(_device_fields(device))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--mesh_step_size", type=int, default=30)
    ap.add_argument("--no_dense", action="store_true",
                    help="skip the dense mesh-16 workload")
    ap.add_argument("--mode", default="step", choices=["step", "lm"])
    ap.add_argument("--streams", type=int, default=1,
                    help="concurrent copies of the stream (the root "
                         "bench's --streams)")
    ap.add_argument("--association", default=None,
                    choices=["per_frame", "per_iteration"],
                    help="measure the headline with this association only "
                         "(default: per_frame, and the sweep)")
    ap.add_argument("--sol", action="store_true",
                    help="add the per-stage speed-of-light block")
    ap.add_argument("--host_loop", action="store_true",
                    help="time the eager step a frame instead of replays "
                         "of the captured step (the root bench's flag)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (a check of the loop, not a "
                         "measurement of the card)")
    args = ap.parse_args()
    if args.streams < 1:
        ap.error("--streams must be at least 1")
    if args.cpu:
        device = torch.device("cpu")
    elif torch.cuda.is_available():
        device = torch.device("cuda", 0)
    else:
        raise SystemExit("bench: no CUDA device (pass --cpu to run on the "
                         "CPU)")
    if args.mode == "lm":
        from super_tpu_torch.config import lm_workload_config

        cfg = lm_workload_config(args.height, args.width, args.mesh_step_size)
        cfg = cfg.replace(solver=dataclasses.replace(
            cfg.solver, association=args.association or "per_frame"))
        out = dict(_line(LM_METRIC, measure_lm(cfg, args.reps, device,
                                               streams=args.streams),
                         args.streams), **_device_fields(device))
    else:
        out = measure(args.reps, device, args.height, args.width,
                      args.mesh_step_size, not args.no_dense,
                      args.association, args.sol, args.streams,
                      args.host_loop)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
