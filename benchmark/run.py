"""Run one cell of the port's benchmark once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

from the root of a checkout, on a machine with the cell's cards.  The
stages: read the cell's configuration and traffic (found by their names in
``BENCHMARK.json``), make the seeded clip on the card and take it to host
numpy once, build the kernels, warm up (the pipeline's first frames: init,
capture, replays), measure whole frames for ``--seconds``, then compare the
window's own outputs with the plain reference that the configuration
names and print one JSON line:
``correct``, ``attempted``, ``failed``, ``metrics`` (the end-to-end
metrics, or with ``--trace 1`` the per-layer ones, read over a steady
stretch of the window from ``torch.profiler``), ``device``, with
``--trace 1`` ``breakdown``, and last ``check``, each compared number
beside its limit (also the last lines on standard error).

It exits non-zero with no result without the cards the cell asks for, and
when JAX or the JAX package (``super_tpu``) is loaded once the window has
closed.  It runs only on the card; the tests drive :func:`run_cell` on the
CPU at small sizes.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import sys
import time

import numpy as np

from benchmark import guard, spec


def process_start_wall() -> float:
    """Wall-clock time at which this process started (Linux ``/proc``)."""
    with open("/proc/self/stat") as f:
        after_name = f.read().rsplit(")", 1)[1].split()
    ticks = int(after_name[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))


def run_cell(conf: dict, traffic: dict, seed: int, seconds: float,
             trace: bool, device: str = "cuda", t_start: float = None,
             per_layer=(), end_to_end=(), patch=None,
             control: bool = False) -> dict:
    """One run; returns the result line as a dict.  ``per_layer`` and
    ``end_to_end`` are the cell's metric entries.  ``patch`` (tests) is
    called with the pipeline before the window, to break the timed path;
    ``control`` (benchmark/calibrate.py) also compares the control, the
    reference computed with its state in bfloat16, with the reference, under
    ``control``, and gives each checked frame's distributions under
    ``diag``.  The reference is the one the configuration names; a run
    stops before the clip is built where it is missing or does not cover
    the configuration."""
    R = spec.load_reference(conf)
    why = R.covers(conf["config"])
    if why:
        raise SystemExit(f"the reference {spec.reference_name(conf)} cannot "
                         f"check this configuration: {'; '.join(why)}")
    import torch

    from benchmark import compare, drive, evaluation, roofline, stats
    from benchmark import trace as tr
    from super_tpu_torch.config import SuPerConfig
    from super_tpu_torch.geometry.camera import Intrinsics

    cuda = device == "cuda"
    dev = torch.device(device)
    cfg = SuPerConfig.from_dict(conf["config"])
    rdict = conf["config"]
    h, w = cfg.height, cfg.width
    streams = traffic["streams"]
    if cuda:
        from super_tpu_torch.kernels import build

        build.build(conf["kernels"])
    clips = drive.make_clips(seed, traffic, rdict, dev)
    intr_f = tuple(float(np.float32(x)) for x in
                   drive.clipgen.intrinsics(h, w))
    intr = Intrinsics.make(*intr_f, device=dev)
    plan = None
    if trace:
        plan = {"after_s": seconds / 3, "skip": traffic["trace_skip"],
                "frames": traffic["trace_frames"]}
    win = drive.Window(seconds, traffic["warmup_frames"],
                       traffic["reproj_frames"], seed, traffic["checks"],
                       plan)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    run = drive.run_single if streams == 1 else drive.run_streams
    kwargs = {} if streams == 1 else {"keep_tracks":
                                      traffic["reproj_frames"]}
    pipe = run(cfg, intr, clips[0] if streams == 1 else clips, win, dev,
               trace, patch=patch, **kwargs)
    if cuda:
        torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    # Attempted and failed frames, tracked points of the first frames.
    attempted = win.frames * streams
    n_rep = traffic["reproj_frames"]
    errors = []
    if streams == 1:
        failed = sum(1 for t, grew in win.overflow_frames
                     if win.warmup <= t < win.end and grew)
        overflow = {k: v - win.overflow_start.get(k, 0)
                    for k, v in win.overflow_now.items()}
        for t in range(n_rep):
            est = pipe.track_results[t]
            c = clips[0]
            k = drive.frame_of(t, c)
            errors.append(evaluation.reprojection_errors(
                c["gt_xy"][k], c["gt_valid"][k], est[:, :2], est[:, 2] > 0))
    else:
        from super_tpu_torch.pipeline import OVERFLOW_COUNTERS

        outs = pipe.outputs[win.warmup - 1:win.end - 1]
        over = torch.stack([torch.stack([getattr(o, n).reshape(-1)
                                         for n in OVERFLOW_COUNTERS])
                            for o in outs]).cpu().numpy()
        failed = int((over > 0).any(axis=1).sum())
        overflow = dict(zip(OVERFLOW_COUNTERS,
                            over.sum(axis=(0, 2)).tolist()))
        coords = torch.stack([k.coords for k in pipe.kept_tracks]).cpu()
        valid = torch.stack([k.coord_valid for k in pipe.kept_tracks]).cpu()
        for t in range(n_rep):
            for s, c in enumerate(clips):
                k = drive.frame_of(t, c)
                errors.append(evaluation.reprojection_errors(
                    c["gt_xy"][k], c["gt_valid"][k], coords[t, s].numpy(),
                    valid[t, s].numpy()))
    reproj = evaluation.mean_error(errors)
    now = time.perf_counter()
    setup_s = (time.time() - (now - win.starts[win.warmup])) - t_start \
        if t_start is not None else float("nan")

    # The traced stretch.
    metrics, breakdown, dev_extra = {}, None, {}
    context = {"peak": roofline.PEAKS.get(
        torch.cuda.get_device_name(dev) if cuda else "",
        roofline.DEFAULT_PEAK), "power_limit": _power_limit() if cuda
        else None}
    if trace:
        states = [state if streams == 1 else drive.stream_state(state, s)
                  for state in win.trace_states for s in range(streams)]
        st = tr.read(win.finished_prof, streams, states, cfg, intr_f,
                     context)
        for m in per_layer:
            value = spec.load_metric(m["name"]).read(st)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
                by = context.get("bounds", {}).get(m["name"])
                if by:
                    metrics[m["name"]]["bound_by"] = by
        breakdown = tr.breakdown(st)
        dev_extra = {"busy_s": tr.busy_us(st) * 1e-6,
                     "window_s": (st.hi - st.lo) * 1e-6}
    else:
        values = {
            "frames_per_s": stats.rate(win.frames * streams, win.wall_s),
            "frame_ms.p95": stats.percentile(win.frame_times(), 95) * 1e3,
            "reproj_px": reproj, "setup_s": setup_s}
        for m in end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}

    # The comparison, once the program's state is freed.
    kept = win.kept
    del pipe, win
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    rcfg = dict(rdict, _intr=intr_f)
    rows, control_rows, diags = [], [], []
    for t in sorted(kept):
        k = kept[t]
        if "after" not in k or len(k["frames"]) != streams:
            continue
        for s in range(streams):
            c = clips[s]
            f = drive.frame_of(t, c)
            raw = {"depth": torch.as_tensor(c["depths"][f], device=dev),
                   "color": torch.as_tensor(c["colors"][f], device=dev),
                   "gt_xy": c["gt_xy"][f], "gt_valid": c["gt_valid"][f],
                   "time": float(t)}
            prev = None if k["prev"] is None else (
                k["prev"] if streams == 1 else
                drive.stream_state(k["prev"], s))
            after = k["after"] if streams == 1 else \
                drive.stream_state(k["after"], s)
            ref = compare.reference_frame(R, rcfg, intr_f, raw, prev)
            prev_id = None if prev is None else prev.track.track_id
            rows.append(compare.frame_numbers(
                k["frames"][s]._asdict(), compare.state_dict(after), *ref,
                prev_id, diag=control))
            if control:
                diags.append(dict(rows[-1].pop("diag"), frame=t, stream=s))
                ctl = compare.reference_frame(R, rcfg, intr_f, raw, prev,
                                              R.CONTROL)
                control_rows.append(compare.frame_numbers(
                    {"valid": ctl[0]["valid"], "points": ctl[0]["points"],
                     "norms": ctl[0]["norms"]},
                    {"surfels": ctl[1], "graph": ctl[2], "track": ctl[3]},
                    *ref, prev_id))
    numbers = compare.worst(rows)
    correct, lines = compare.verdict(numbers, conf["limits"])
    correct = correct and bool(rows)
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu",
                         "kind": torch.cuda.get_device_name(dev) if cuda
                         else "cpu", "count": 1,
                         "memory_peak_bytes": int(peak), **dev_extra,
                         "power_limit": context["power_limit"]}}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["overflow"] = {k: v for k, v in overflow.items() if v}
    result["checked_frames"] = len(rows)
    if control_rows:
        result["control"] = {n: _num(v) for n, v in
                             compare.worst(control_rows).items()}
        result["diag"] = diags
    result["check"] = {n: [_num(v), lim] for n, v, lim in lines}
    return result


def _num(v):
    return v if math.isfinite(v) else str(v)


def _power_limit():
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30)
        return float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def main(argv=None) -> int:
    t_start = process_start_wall()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = spec.load_benchmark()
    cell = spec.cell(bench, args.workload)
    # One host thread a run: the frame loop's host work is serial, and an
    # idle thread pool only adds to the runs' spread.
    os.environ["OMP_NUM_THREADS"] = "1"
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    result = run_cell(spec.load_config(cell["config"]),
                      spec.load_traffic(cell["traffic"]), args.seed,
                      args.seconds, bool(args.trace), "cuda", t_start,
                      spec.cell_metrics(bench, args.workload, True),
                      spec.cell_metrics(bench, args.workload, False))
    found = guard.forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, (value, limit) in result["check"].items():
        print(f"check {name} {value} limit {limit}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
