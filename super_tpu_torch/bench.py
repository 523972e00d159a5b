"""Frames per second of the port's tracking step, in the root bench's JSON
line.

    python -m super_tpu_torch.bench [--reps 30] [--no_dense] [--cpu]
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
calls (``max(4, that // 2)`` for RAFT-Stereo).  The port has no
device-resident frame loop yet, so each loop runs on the host with one
synchronisation at the end (``"loop": "host"``).  The overflow counters'
maxima over the timed frames ride along (``overflow``), so that a run
which drops residuals cannot pass for a faster one.  On the card unless
``--cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time

import numpy as np
import torch

METRIC = "tracked frames/s per chip (full step: 10-iter LM + fusion)"
OVERFLOW = (("tuple", "tuple_overflow"), ("pair", "pair_overflow"),
            ("add_deferred", "add_overflow"), ("free", "free_exhausted"))


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def measure_step(cfg, reps: int, device, seed: int = 0):
    """(frames/s of the timed pass, overflow maxima over it).  With a
    ``depth_model`` in ``cfg`` each frame's depth comes from that net
    (seeded random weights) on the card, inside the timed loop."""
    import super_tpu_torch  # noqa: F401  (TF32 off)
    from super_tpu_torch.core.preprocess import preprocess_frame
    from super_tpu_torch.core.tracker import init_tracker, track_step
    from super_tpu_torch.data.synthetic import default_intrinsics, generate

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
        frame_of = frames.__getitem__
    else:
        from super_tpu_torch.factory import build_models, predict_frame_inputs

        models = build_models(cfg, seed=seed, device=device)
        colors_dev = torch.as_tensor(colors, device=device)

        def frame_of(t):
            depth = predict_frame_inputs(cfg, models, colors_dev[t])["depth"]
            return preprocess_frame(cfg, intr, depth, colors_dev[t],
                                    float(t), device=device)

    def run(state):
        diag = None
        for i in range(reps):
            state, outs = track_step(cfg, intr, state, frame_of(1 + i % 2))
            d = torch.stack([getattr(outs, n).to(torch.int64)
                             for _, n in OVERFLOW])
            diag = d if diag is None else torch.maximum(diag, d)
        return state, diag

    state, _ = run(init_tracker(cfg, frame_of(0)))   # warm-up, converges
    _sync(device)
    tic = time.perf_counter()
    state, diag = run(state)
    _sync(device)
    dt = time.perf_counter() - tic
    overflow = dict(zip((k for k, _ in OVERFLOW), diag.tolist()))
    return reps / dt, overflow


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


def measure(reps: int = 30, device="cuda", height: int = 480,
            width: int = 640, mesh_step: int = 30, dense: bool = True):
    """The JSON line's fields."""
    from super_tpu_torch.config import e2e_depth_workload_config, \
        lm_workload_config, semantic_workload_config

    cfg = lm_workload_config(height, width, mesh_step)
    hz, overflow = measure_step(cfg, reps, device)
    out = dict(metric=METRIC, value=round(hz, 3), unit="frames/s/chip",
               vs_baseline=round(hz / 30.0, 4), streams=1,
               per_stream_hz=round(hz, 3), loop="host", overflow=overflow)
    per_it = cfg.replace(solver=dataclasses.replace(
        cfg.solver, association="per_iteration"))
    hz_it, overflow_it = measure_step(per_it, reps, device)
    out["per_iteration_hz"] = round(hz_it, 3)
    out["per_iteration_overflow"] = overflow_it
    if dense:
        # The root bench's max(6, reps // 5) frames, never more than reps.
        hz_d, overflow_d = measure_step(
            lm_workload_config(height, width, 16),
            min(reps, max(6, reps // 5)), device)
        out["dense_mesh16_hz"] = round(hz_d, 3)
        out["dense_overflow"] = overflow_d
    # The root bench's max(6, reps // 3) frames, never more than reps.
    hz_s, overflow_s = measure_step(
        semantic_workload_config(height, width, mesh_step),
        min(reps, max(6, reps // 3)), device)
    out["semantic_hz"] = round(hz_s, 3)
    out["semantic_overflow"] = overflow_s
    out.update(measure_perception(reps, device, height, width))
    hz_e, overflow_e = measure_step(
        e2e_depth_workload_config(height, width, mesh_step),
        min(reps, max(6, reps // 3)), device)
    out["e2e_depth_hz"] = round(hz_e, 3)
    out["e2e_depth_overflow"] = overflow_e
    if torch.device(device).type == "cuda":
        out["device"] = torch.cuda.get_device_name(device)
        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    else:
        out["device"] = "cpu"
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--mesh_step_size", type=int, default=30)
    ap.add_argument("--no_dense", action="store_true",
                    help="skip the dense mesh-16 workload")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (a check of the loop, not a "
                         "measurement of the card)")
    args = ap.parse_args()
    if args.cpu:
        device = torch.device("cpu")
    elif torch.cuda.is_available():
        device = torch.device("cuda", 0)
    else:
        raise SystemExit("bench: no CUDA device (pass --cpu to run on the "
                         "CPU)")
    print(json.dumps(measure(args.reps, device, args.height, args.width,
                             args.mesh_step_size, not args.no_dense)))


if __name__ == "__main__":
    main()
