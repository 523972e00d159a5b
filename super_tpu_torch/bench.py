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
(``semantic_hz``).  Each alternates synthetic frames 1 and 2: ``n``
frames from the frame-0 state converge the map (warm-up), then ``n``
more are timed, with ``n`` the root bench's: ``reps``, ``max(6, reps //
5)`` for the dense graph and ``max(6, reps // 3)`` for the semantic fit,
never more than ``reps``.  The port has no device-resident frame loop yet, so the
loop runs on the host with one synchronisation at the end (``"loop":
"host"``).  The overflow counters' maxima over the timed frames ride along
(``overflow``), so that a run which drops residuals cannot pass for a
faster one.  The paths the port has not ported write an error key, as the
root bench does.  On the card unless ``--cpu``.
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
NOT_PORTED = ("perception_error", "e2e_depth_error")
OVERFLOW = (("tuple", "tuple_overflow"), ("pair", "pair_overflow"),
            ("add_deferred", "add_overflow"), ("free", "free_exhausted"))


def measure_step(cfg, reps: int, device, seed: int = 0):
    """(frames/s of the timed pass, overflow maxima over it)."""
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
    frames = [preprocess_frame(
        cfg, intr, seq.depths[t], colors[t], float(t),
        seg=seq.segs[t] if semantic else None,
        seg_conf=seq.seg_confs[t] if semantic else None, device=device)
        for t in range(3)]

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)

    def run(state):
        diag = None
        for i in range(reps):
            state, outs = track_step(cfg, intr, state, frames[1 + i % 2])
            d = torch.stack([getattr(outs, n).to(torch.int64)
                             for _, n in OVERFLOW])
            diag = d if diag is None else torch.maximum(diag, d)
        return state, diag

    state, _ = run(init_tracker(cfg, frames[0]))   # warm-up, converges
    sync()
    tic = time.perf_counter()
    state, diag = run(state)
    sync()
    dt = time.perf_counter() - tic
    overflow = dict(zip((k for k, _ in OVERFLOW), diag.tolist()))
    return reps / dt, overflow


def measure(reps: int = 30, device="cuda", height: int = 480,
            width: int = 640, mesh_step: int = 30, dense: bool = True):
    """The JSON line's fields."""
    from super_tpu_torch.config import lm_workload_config, \
        semantic_workload_config

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
    for key in NOT_PORTED:
        out[key] = "NotImplementedError"
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
