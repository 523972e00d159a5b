#!/usr/bin/env python
"""Smoke check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--parent-segsum PATH]

Builds the port's hand-written CUDA kernels from super_tpu_torch/csrc, holds
each against its plain PyTorch version on the card at the shapes of the
paths that run it, then drives the paths of the tracking step at 480 x 640
(synthetic frames -> preprocess_frame -> init_tracker -> track_step; on
the live path the frames' depth from monodepth2) and checks that each went
through its kernels and that its results are right:

- main: the headline workload, ``lm_workload_config(480, 640, 30)``
  (J = 384, pair-sparse CG by K1, the data term's tuple Grams by K2 with
  the rows computed in the kernel, ``data_gram``);
- dense: the dense ED graph, ``lm_workload_config(480, 640, 16)``
  (J = 1216, pair-sparse CG by K1b, ``data_gram``);
- solvers: the headline workload with the dense-matrix solvers,
  ``linear_solver="pcg_pallas"`` (K3, ``data_gram``), then ``"cholesky"``
  and ``"pcg"``;
- per_iteration: the headline with the moving-target association (K1 and
  K2's memory form, ``tuple_gram``: the rows written to memory);
- semantic: the autograd Semantic-SuPer fit, ``workload_config("semantic")``
  (Adam, 10 steps a frame, soft-seg ICP, face, rotation and boundary-morph
  losses, the generator's two-class segmentations), which runs no TPU
  kernel's counterpart;
- the option paths (``OPTION_PATHS``, 3 frames each): ``hypotheses`` (the
  headline with 3 damping hypotheses a trip: K1 3 times a trip),
  ``hypotheses_dense`` (``pcg_pallas`` with 2: K3 twice a trip),
  ``scatter`` (the scatter assembly with Cholesky: no K2, the segment sum
  once a chunk of slots and 3 more times a trip), ``expand_blocks`` (the
  tuple Grams summed into node-pair blocks, Cholesky) and ``bf16_pcg``
  (the dense graph with a bf16 matrix and PCG); each also tracks frame 1
  twice, bitwise, and ``option_reference`` holds its frame-1 solve to the
  CPU path's.  ``segsum_scatter`` holds the segment sum to its plain
  version on the scatter assembly's slot blocks and J^T r rows, and
  ``proj_map_scatter`` requires fusion's scatter projection maps (and a
  fusion in that mode) to equal the sort maps on the headline.

Every LM path sums its assembly's shared destinations with the fixed-order
segment sum (``csrc/segment_sum.cu``) four times a trip, and the node radii
once at frame 0; the semantic path sums its backward pass's rows into the
nodes with it twice a fit step (``semantic``: 3 frames; ``segsum_semantic``
holds it to its plain version on those sums and on the soft splat's pixel
sums; ``repeat_semantic`` tracks 3 frames twice, bitwise;
``semantic_reference`` holds frame 1's losses, gradients and fit to the
CPU path).

K2's two forms, one template (rows from memory, ``tuple_gram``, and rows
from the data term, ``data_gram``), are each checked on the headline's and
the dense graph's frame-1 context (phases ``k2``, ``k2_dense``,
``k2_fused``, ``k2_fused_dense``): two launches compared bitwise, Grams
exactly symmetric; the fused phases also print the distribution of tuple
run lengths.  K1 and K1b (one cooperative grid over all SMs each) are also
checked on
the adversarial pair systems of ``core/lm.py:adversarial_pair_system``
(shuffled pairs with sinks between them, a hub node, duplicate pairs,
J = 64), each launch pair compared bitwise, and timed on the band system of
their path's own frame 1 (phases ``path_main`` and ``path_dense``).  K3
(one cooperative grid, the matrix's nonzero chunks kept in shared memory)
is checked and timed on a seeded J = 384 system (``k3``), a fully dense SPD
matrix whose rows mostly take the overflow route (``k3_full``), a system
with one node's rows and columns NaN (``k3_nan``: x all non-finite, as the
plain version's), J = 15 (``k3_small``, dim 105: rows not 16-byte aligned,
fewer rows than SMs), the dense graph's J = 1216 (``k3_dense``, dim 8512) and
the ``pcg_pallas`` path's own frame-1 system (``path_pcg_pallas``).  The
segment sum is checked on each sum of the headline's, the dense graph's
and the pcg_pallas path's frame-1 assembly (``segsum``), and on its edge
cases at full size (``segsum_cases``: one segment of every row, the soft
splat's shape with half its rows in one pixel, every row its own segment,
segments on tile edges, ids outside [0, S), a million mostly empty
segments, fewer rows than a tile; widths 1, 4, 7 and 49, with base and
bf16; exact against an f64 ``index_add_`` on integer values, within 1e-6
of the largest sum on normal values, bitwise across launches).  With
``--parent-segsum PATH`` (an earlier tree's ``csrc/segment_sum.cu`` with
the same C interface as the two-launch kernel that took a chunk-totals
scratch, e.g. from ``git show``) that source is
built with the same nvcc line in a temporary directory and timed beside
the kernel on every segment-sum shape.  ``repeat``
tracks 5 headline frames twice with the GT points bound and requires both
to agree bit for bit; ``pipeline`` runs SuPerPipeline on 30 frames with
ground truth for five configurations, the per-iteration one also with
its Grams nudged by f32 roundings and on two other draws of the GT
points, and requires each to track (reprojection error against the
static error), then the semantic workload (below the static error, as
tests/test_semantic.py asks), tests/test_semantic.py's configuration with
the render loss and ``semantic_super_config()`` (SGD) at full size;
``bench`` prints ``python -m super_tpu_torch.bench``'s line at 6 frames,
``semantic_hz``, the perception nets' rates and ``e2e_depth_hz`` with it.

The perception nets (seeded random weights, random batch-norm
statistics): ``perception`` runs monodepth2 (flip post-process, blur 5),
RAFT-Stereo, DeepLabV3+, U-Net and RAFT flow at 480 x 640 on the card and
on the CPU path and holds them together with TF32 off (1e-4 of the
largest magnitude, the RAFTs 1e-3 at 4 GRU iterations), requires a second
card run bitwise equal, and reports the TF32 gap, each net's device ms at
its published iterations (TF32 off and on) and its device operations a
call; ``e2e_depth``, this slice's main path, tracks 3 frames of
``workload_config("e2e_depth")`` with each frame's depth from monodepth2
(K1 and ``data_gram`` once an LM trip, the segment sum 4 times a trip),
holds frame 1's depth to the CPU path's and a second track bitwise;
``semantic_models`` tracks 3 frames of the semantic workload with
DeepLabV3+ segmentations and RAFT's ``sf_corr`` flow (the corr face
nonzero on every frame, a repeat bitwise), then one frame with the flow
of the render.

The stereo SSIM confidence and the entry points: ``ssim_conf`` tracks 3
headline frames with ``disable_ssim_conf=False`` (launches as the
headline's, frame 1 twice bitwise; the confidence map's time, device
operations, out-of-image share, mean and range) and
``ssim_conf_reference`` holds frame 1's map and solve to the CPU path.
After ``bench``, ``cli_data`` writes a superv1 trial (8 frames, the C++
SuPer baseline 1.5 px off the GT) and a superv2 trial with label PNGs at
480 x 640 into a temporary directory, rendered with each layout's
intrinsics, and decodes them with every decoder the machine has (the
native loader, PIL, data/png.py), each bitwise against the written RGB;
``cli_super`` runs ``python -m super_tpu_torch.run_super``'s ``main`` in
this process three times (the root defaults: ``tuple_gram``; the
headline's solver flags: K1 and ``data_gram``; ``--synthetic``) and
``cli_semantic`` runs ``run_semantic_super``'s on the superv2 trial, each
with its launches, finite metrics, every frame evaluated and (LM) a
reprojection error below 0.75 of the static error.  The kernels line's
``launches_cli`` are those runs'.

Observation, checkpoints and the speed-of-light model: ``resume`` tracks
the headline to frame 2, saves the state (utils/checkpoint.py), restores
it into a state built on the card and goes on to frame 5, bitwise equal
to an uninterrupted run; ``zbuffer`` renders the headline's 425,984-slot
map after frame 1 with ``render_zbuffer``, bitwise the CPU path's;
``observe`` runs SuPerPipeline on 6 headline frames with a logger and
checkpoints every 2nd frame in a temporary directory (launches a frame as
the headline's, every scalar finite, every PNG 480 x 640, the render's
covered share, the checkpoints, each observation's host ms beside the
frame p50; the kernels line's ``launches_observe``); ``sol`` measures the
primitive costs that utils/sol.py's H100 constants came from and prints
``bench.measure_sol``'s stages (device ms alone, events ms, floor,
sol_frac); ``bench`` also prints the headline's ``cold_start_hz`` and
``cold_add_deferred`` and the ``--mode lm`` rate at 6 solves.

Streams and devices (the main path of the last slice): ``streams`` tracks
4 streams at 480 x 640 (four 6-frame time windows of the synthetic
sequence, with the GT points) through ``MultiStreamPipeline``, whose
batched step loops over the streams: each stream's outputs and final map
bitwise its single-stream track, stream 0 bitwise ``SuPerPipeline``,
launches four streams' (K1 and ``data_gram`` 200, the segment sum 804),
the batch p50 and aggregate frames/s beside the single stream's.
``sharded`` and ``stream_mesh`` run in two processes on the one card,
started with torch.multiprocessing's spawn, loading the kernels
``phase_build`` built, in one gloo world: mesh ('stream' 1, 'shard' 2)
splits the headline's 720,896 slots in two (frame 1's assembly and K2's
partial Grams against one process, frame 2's LM solve, 3 frames of
``track_step_sharded`` against one process, both ranks bitwise equal,
each launching one process's kernels; the all-reduce's time a trip and
its bytes), then mesh ('stream' 2, 'shard' 1) tracks each rank's stream
through ``shard_stream_batch`` and ``make_multichip_step``, bitwise the
single-stream track run in this process.  ``bench_streams`` prints the
bench's headline line with ``--streams 4`` and with 1.  The kernels
line's launches of K1, ``data_gram`` and the segment sum are the
``streams`` run's, each earlier path's beside (``launches_e2e_depth``,
the captured sharded and stream-mesh replays' per process).

The mesh's step in the graph (the main path of this slice), in the same
two processes: ``sharded`` runs the same frames through
``make_multichip_step`` on ('stream' 1, 'shard' 2), captured as graphs
cut at the all-reduces (core/compiled.py:CutGraph): each replay bitwise
the eager ``track_step_sharded`` frame on its rank, the ranks bitwise
each other, the launches a replay (K1 10, ``data_gram`` 10, the segment
sum 40) by counter with the counts zeroed just before the replays, 11
all-reduces and 12 graph launches a frame by the cut graph's counts, no
sync flagged in a replay by CUDA's sync debug mode (the syncs of the
eager frames by the line that made them), eager and captured ms a frame
in turns, the first call's ms, peak memory, the all-reduce alone on its
pinned host buffer, and one classic-schedule frame (20 cuts) bitwise
its eager frame.  ``stream_mesh``'s ('stream' 2, 'shard' 1) step is one
CUDA graph: its replays' launches one process's, and
``MultiStreamPipeline(mesh=)`` reports ``loop`` "graph", bitwise the
step.

The compiled step (the main path of the last two slices): ``graph`` runs
``make_jit_step``, ``track_step`` captured as a CUDA graph and replayed.
The headline: 2 eager frames, the capture, then 5 replays from that
state, each frame's state and outputs bitwise the eager step's; 20 more
replays of the first, bitwise, and the segment sum's tickets 0 after;
the launches a replay (K1 10, ``data_gram`` 10, the segment sum 40) by
the counters and by a profiler trace of one replay; the untraced
ms/frame of the eager and the captured step in turns, 3 each; the
device busy share, device ms and kernels of a traced replay and a
traced eager frame; peak memory.  Every other LM path of
``config.WORKLOADS`` (``dense16`` K1b, ``pcg_pallas`` K3,
``per_iteration`` ``tuple_gram``, ``cholesky``, ``pcg``, ``e2e_depth``'s
step and the option paths): 3 replays from the frame-0 state, bitwise
the eager frames, their launches the eager step's.  Four streams in one
graph (``make_batched_step``), each bitwise its eager single track;
``SuPerPipeline`` compiled against eager (tracks, errors, final state
bitwise; both p50s).  The autograd fit in the graph (this slice's main
path): the bench's semantic workload as the headline (1 eager frame, the
capture, 3 replays bitwise, 5 repeats bitwise, tickets 0, the segment
sum 20 a replay and no other kernel by counter and by trace, ms in
turns, busy share, peak memory); the render-loss variant (2 replays,
the segment sum 30 a replay), ``semantic_super_config()`` (SGD, 1
replay), the sf_corr step with RAFT's flow from the previous frame's
colour (2 replays) and from the render at every evaluation (1 replay),
each bitwise its eager frames; 2 semantic streams in one graph; the
semantic ``SuPerPipeline`` compiled against eager on 6 frames.  Last the
bench's headline and ``semantic_hz`` on the device-resident loop and on
``--host_loop``.  The pipelines, the stream batch, the CLIs (their
metrics' ``loop`` must be ``"graph"``) and the bench of the other phases
run the compiled steps too.  The kernels line's ``launches_graph`` are
the ``graph`` phase's replays, the segment sum's semantic replays' in
``launches_graph_semantic``.

Launch counts are set to 0 just before a path runs and read just after.
Each phase prints one JSON line; any failure raises and exits non-zero.  The
run ends with a ``{"kernels": [...]}`` summary line, the card's name and
power limit as nvidia-smi reports them, and ``{"ok": true, "device": ...}``.

Needs a CUDA card and nvcc; imports nothing of the JAX package.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import json
import math
import multiprocessing
import os
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch

H100_HBM_BYTES_PER_S = 3.35e12     # HBM3, H100 SXM data sheet
H100_F32_FLOP_PER_S = 67e12        # f32 outside the tensor cores
MAIN_FRAMES = 5                    # tracked frames after frame 0
PATH_FRAMES = 3                    # tracked frames of the dense and solvers paths
SEED = 0
# csrc/<name>.cu
SOURCES = ("pairs_cg", "tuple_gram", "dense_cg", "segment_sum")
PIPELINE_FRAMES = 30               # the JAX README's accuracy run
PIPELINE_SEEDS = (1, 2)            # other draws of the 20 GT points
# The fixed-order sums of a step: per LM trip the pair reduction's pair
# rows and tuple J^T r rows, the ARAP J^T r rows and the graph terms' pair
# rows (or dense blocks); once a track, the node radii at frame 0.
SEGSUM_PER_TRIP, SEGSUM_AT_INIT = 4, 1
# The semantic workload's classes.  The generator's depths, colours and GT
# points do not depend on them, so every path reads one sequence.
SEMANTIC_CLASSES = 2
# Per iteration of the semantic fit, the backward pass's sums of the
# G-blocks' anchor rows and of the triangle corners into the nodes (with
# the render loss also the soft splat's pixel sums, forward).
SEGSUM_PER_FIT_STEP = 2
OPTION_FRAMES = 3                  # tracked frames of each option path
# The option paths (config.WORKLOADS): {kernel: launches per LM trip}
# beside the segment sum's (option_segsum_per_trip).
OPTION_PATHS = (("hypotheses", {"pairs_cg": 3, "data_gram": 1}),
                ("hypotheses_dense", {"dense_cg": 2, "data_gram": 1}),
                ("scatter", {}),
                ("expand_blocks", {"data_gram": 1}),
                ("bf16_pcg", {"data_gram": 1}))
# Frame 1's beta on the card against the CPU path: the main path's 1e-4,
# but for the hypotheses, which take the least of H candidate costs that
# agree to ~1e-7 at convergence, as the rounding decides (the JAX
# package's own jit and eager runs end 1.3e-4 apart on the tiny scene,
# tests/test_torch_hypotheses.py).
OPTION_BETA_TOL = {"hypotheses": 1e-3, "hypotheses_dense": 1e-3}


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2, queued: bool = False) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back runs.  With
    ``queued`` the card first spins for ~10 ms, so that all ``reps`` runs
    are queued before the first starts: the events then time the device
    alone, not also the host's enqueueing where it is slower."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps: int) -> float:
    """Mean host time to enqueue ``fn`` (no synchronisation inside)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return t


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / H100_HBM_BYTES_PER_S * 1e3
    t_ops = flops / H100_F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def phase_build(parent_segsum=None):
    """Builds the kernels, and with ``parent_segsum`` (an earlier tree's
    csrc/segment_sum.cu, the two-launch kernel with a chunk-totals
    scratch) that source too, with the same nvcc line, in a temporary
    directory outside the checkout; the parent is loaded into
    PARENT_SEGSUM for timing beside the kernel."""
    import ctypes

    from super_tpu_torch.kernels import build

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="segsum_parent_") as tmp:
        parent = None
        if parent_segsum is not None:
            so = f"{tmp}/segment_sum_parent.so"
            parent = subprocess.Popen(
                [build._nvcc(), *build.NVCC_FLAGS, "-o", so, parent_segsum],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        logs = build.build(SOURCES)   # one nvcc per source, all at once
        if parent is not None:
            log, _ = parent.communicate()
            if parent.returncode != 0:
                raise RuntimeError(f"parent segment_sum build failed:\n{log}")
            logs["segment_sum_parent"] = log
            lib = ctypes.CDLL(so)
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.segment_sum_launch.argtypes = [vp] * 6 + [ci] * 4 + [vp]
            lib.segment_sum_launch.restype = ci
            PARENT_SEGSUM["lib"] = lib
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, log in logs.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "arch": "sm_90a", "ptxas": ptxas, "parent_segsum": parent_segsum})


# The parent tree's segment-sum library, where chip_smoke.py is given one
# (--parent-segsum); timed beside the kernel on every segment-sum shape.
PARENT_SEGSUM = {}


def _parent_sum(values, plan, kw):
    """The parent's two-launch kernel on the same sum: its 64-row chunk
    totals, then the segments."""
    r, s_ = values.shape[0], plan.num_segments
    f = values.numel() // r
    base = kw.get("base")
    out = torch.empty((s_,) + tuple(values.shape[1:]), dtype=torch.float32,
                      device=values.device)
    chunks = torch.empty(((r + 63) // 64 * f,), dtype=torch.float32,
                         device=values.device)
    rc = PARENT_SEGSUM["lib"].segment_sum_launch(
        values.data_ptr(), plan.order.data_ptr(), plan.offsets.data_ptr(),
        None if base is None else base.data_ptr(), out.data_ptr(),
        chunks.data_ptr(), r, s_, f, int(kw.get("sum_dtype") == "bf16"),
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"parent segment_sum launch failed: cudaError {rc}")
    return out


def _parent_times(values, plan, kw, out):
    """The parent kernel's time and device time alone on the same sum, and
    its largest difference from ``out`` (nulls without a parent)."""
    if "lib" not in PARENT_SEGSUM:
        return dict(parent_ms=None, parent_ms_device=None,
                    parent_max_abs_diff=None)
    diff = float(torch.max(torch.abs(_parent_sum(values, plan, kw) - out)))
    return dict(
        parent_ms=cuda_ms(lambda: _parent_sum(values, plan, kw), reps=20),
        parent_ms_device=cuda_ms(lambda: _parent_sum(values, plan, kw),
                                 reps=20, queued=True),
        parent_max_abs_diff=diff)


def _pair_matrix(layout, acc, u, j, dev):
    """The damped pair system S + S^T + u I as a dense f64 matrix."""
    p = acc.shape[0]
    n12 = (layout.pair_dest.long() // 7)
    dense = torch.zeros((7 * j + 7, 7 * j + 7), dtype=torch.float64,
                        device=dev)
    rows = (7 * n12[:, 0, None, None] + torch.arange(7, device=dev)[:, None])
    cols = (7 * n12[:, 1, None, None] + torch.arange(7, device=dev)[None, :])
    dense.index_put_((rows.expand(p, 7, 7), cols.expand(p, 7, 7)),
                     acc.reshape(p, 7, 7).double(), accumulate=True)
    dense = dense[:7 * j, :7 * j]
    return dense + dense.T + float(u) * torch.eye(7 * j, dtype=torch.float64,
                                                  device=dev)


PAIR_ITERS = 32
# (J, P) of the adversarial pair systems that do not take the kernel's
# seeded shapes: J = 64, below the SM count.
PAIR_CASE_SIZES = {"few_nodes": (64, 1024)}


def _pair_check(dev, name, system, layout, acc, rhs, u, j, x0, kernel, plain,
                round_acc, timed=False):
    """A pair-sparse CG kernel (K1 or K1b) against its plain version on one
    pair system, 32 iterations: relative error, residuals, three launches
    compared bitwise, and the list entries of the fullest CTA (with how many
    of them overflow its shared memory).  With ``timed``: the kernel's time
    (as every kernel is timed here), its device time alone at 32 and at 0
    iterations and at 32 and 0 on the same system with every pair a sink
    (an iteration's floor: barriers and sums), the host's time to enqueue
    it, the plain version's time, and the bound."""
    from super_tpu_torch.core.lm import pairs_band_system
    from super_tpu_torch.kernels.pcg import pair_cg_capacity, pair_cg_entries

    chunked = name == "k1b"
    args = pairs_band_system(layout, acc, rhs, u, j, x0)
    x_k = kernel(*args, iterations=PAIR_ITERS)
    x_k2 = kernel(*args, iterations=PAIR_ITERS)
    x_k3, entries = pair_cg_entries(chunked, *args, iterations=PAIR_ITERS)
    x_p = plain(*args, iterations=PAIR_ITERS)
    torch.cuda.synchronize()
    bitwise = bool(torch.equal(x_k, x_k2) and torch.equal(x_k, x_k3))

    # The system each version solves (K1b's with its blocks in bf16), for
    # the residuals.
    a = _pair_matrix(layout, round_acc(acc), u, j, dev)
    b = rhs.double()

    def resid(x_fm):
        x = x_fm.T.reshape(-1).double()
        return float(torch.linalg.norm(a @ x - b) / torch.linalg.norm(b))

    err = float(torch.max(torch.abs(x_k - x_p)))
    rel = err / float(torch.max(torch.abs(x_p)))
    res_k, res_p = resid(x_k), resid(x_p)
    del a
    n1, n2 = args[2], args[3]
    p = n1.shape[0]
    cap = pair_cg_capacity(chunked, j, p)
    e_max = int(entries.max())
    p_valid = int(((n1 >= 0) & (n1 < j) & (n2 >= 0) & (n2 < j)).sum())
    out = dict(phase=name, system=system, j=j, p=p, pairs_valid=p_valid,
               iterations=PAIR_ITERS, max_abs_err=err, max_rel_err=rel,
               residual_kernel=res_k, residual_plain=res_p, bitwise=bitwise,
               entries_max=e_max, ctas_with_entries=int((entries > 0).sum()),
               capacity=cap, overflow=max(e_max - cap, 0))
    # The kernel is right if it agrees with the plain recurrence to f32
    # reassociation (32 iterations): 1e-4 relative to |x|; both solve the
    # system to the same residual; and it repeats to the bit.
    if not (math.isfinite(rel) and rel < 1e-4 and res_k < 2 * res_p + 1e-5
            and bitwise):
        emit(out)
        raise RuntimeError(f"{name} disagrees on {system}: rel {rel}, "
                           f"residuals {res_k} vs {res_p}, bitwise {bitwise}")
    if timed:
        def dev_ms(a, iterations):
            return cuda_ms(lambda: kernel(*a, iterations=iterations),
                           reps=20, queued=True)

        sinks = args[:2] + (torch.full_like(n1, j),) * 2 + args[4:]
        ms = cuda_ms(lambda: kernel(*args, iterations=PAIR_ITERS), reps=20)
        ms_dev, ms0 = dev_ms(args, PAIR_ITERS), dev_ms(args, 0)
        floor = (dev_ms(sinks, PAIR_ITERS) - dev_ms(sinks, 0)) / PAIR_ITERS
        enqueue_ms = host_ms(lambda: kernel(*args, iterations=PAIR_ITERS),
                             reps=20)
        plain_ms = cuda_ms(lambda: plain(*args, iterations=PAIR_ITERS), reps=3)
        # Work of this run: each valid pair costs two 7x7 block products
        # per matvec; the preconditioner one per node; dots and updates ~10
        # per vector entry.  Bytes the function needs, each read once: the
        # 49 used rows of both band tables for the valid pairs (bf16 in K1b,
        # which computes on the rounded blocks), n1 and n2, the 49 used rows
        # of the preconditioner table, b, x0 and u; the solution written.
        band = 2 if name == "k1b" else 4
        flops = (PAIR_ITERS + 1) * (2 * 2 * 49 * p_valid + 2 * 49 * j
                                    + 10 * 7 * j)
        nbytes = (2 * 49 * p_valid * band + 2 * p * 4 + 49 * j * 4
                  + 3 * 7 * j * 4 + 4)
        b_ms, b_by = bound(nbytes, flops)
        out.update(ms=ms, ms_device=ms_dev, ms_iterations0_device=ms0,
                   ms_per_iteration=(ms_dev - ms0) / PAIR_ITERS,
                   ms_per_iteration_all_sinks=floor,
                   host_enqueue_ms=enqueue_ms, plain_ms=plain_ms,
                   bound_ms=b_ms, bound_by=b_by, bytes=nbytes, flops=flops)
    emit(out)
    return out


def _pair_cg_phase(dev, name, j, p, kernel, plain, round_acc):
    """A pair-sparse CG kernel (K1 or K1b) against its plain version: timed
    on a seeded well-posed system of J nodes and P pairs, all in use, then
    checked on the adversarial systems (core/lm.py:adversarial_pair_system).
    Returns the seeded system's record."""
    from super_tpu_torch.core.lm import PAIR_CASES, adversarial_pair_system, \
        example_pair_system

    layout, acc, rhs, u, x0 = example_pair_system(j, p, SEED, device=dev)
    out = _pair_check(dev, name, "seeded", layout, acc, rhs, u, j, x0, kernel,
                      plain, round_acc, timed=True)
    for case in PAIR_CASES:
        jc, pc = PAIR_CASE_SIZES.get(case, (j, p))
        layout, acc, rhs, u, x0 = adversarial_pair_system(case, jc, pc, SEED,
                                                          device=dev)
        _pair_check(dev, name, case, layout, acc, rhs, u, jc, x0, kernel,
                    plain, round_acc)
    return out


def phase_k1(dev):
    """K1 at the headline shapes: J = 384, P = 4096."""
    from super_tpu_torch.kernels.pcg import pairs_cg, pairs_cg_plain

    return _pair_cg_phase(dev, "k1", 384, 4096, pairs_cg, pairs_cg_plain,
                          lambda acc: acc)


def phase_k1b(dev):
    """K1b at the dense graph's shapes: J = 1216, P = 19,456."""
    from super_tpu_torch.kernels.pcg import (
        _bf16,
        pairs_cg_chunked,
        pairs_cg_chunked_plain,
        uses_chunked,
    )

    if not uses_chunked(1216, 19456):
        raise RuntimeError("the dense graph's pair system must take K1b")
    return _pair_cg_phase(dev, "k1b", 1216, 19456, pairs_cg_chunked,
                          pairs_cg_chunked_plain, _bf16)


def phase_pair_path(dev, name, cfg, ctx, assoc, intr):
    """The path's pair kernel (K1 on the headline, K1b on the dense graph)
    on the path's own band system: frame 1's normal equations at beta0 with
    the initial damping, as the first LM trip solves them."""
    from super_tpu_torch.core.losses import assemble_normal_equations
    from super_tpu_torch.geometry.quaternion import identity_dq
    from super_tpu_torch.kernels.pcg import (
        _bf16,
        pairs_cg,
        pairs_cg_chunked,
        pairs_cg_chunked_plain,
        pairs_cg_plain,
        uses_chunked,
    )

    j = cfg.capacity.node_capacity
    beta = identity_dq(dev)[None].repeat(j, 1)
    jtj, jtr, _ = assemble_normal_equations(cfg, ctx, beta, intr, assoc)
    u = torch.full((), cfg.solver.lm_damping_init, device=dev)
    chunked = uses_chunked(j, jtj.shape[0])
    kernel, plain, round_acc = ((pairs_cg_chunked, pairs_cg_chunked_plain,
                                 _bf16) if chunked else
                                (pairs_cg, pairs_cg_plain, lambda a: a))
    return _pair_check(dev, "k1b" if chunked else "k1", name, ctx.layout,
                       jtj, jtr, u, j, None, kernel, plain, round_acc,
                       timed=True)


K3_ITERS = 32


def _nonzero_chunks(a):
    """Each row's 16-byte chunks (4 columns, zero past the last) that are
    not all +-0 (a NaN is not zero): what K3 keeps of the row."""
    n = a.shape[0]
    chunks = torch.nn.functional.pad(a, (0, -n % 4)).reshape(n, -1, 4)
    return (chunks != 0).any(dim=2).sum(dim=1)


def _dense_check(name, system, a_hat, b_hat, finite=True):
    """K3 against its plain version on one dense system, 32 iterations:
    relative error, residuals, three launches compared bitwise (with
    ``finite`` false instead: the kernel's x is all non-finite, as the
    plain version's is), the chunk fill, each CTA's chunks kept in shared
    memory and rows on the overflow route; the kernel's time (as every
    kernel is timed here), its device time alone at 32 and at 0 iterations,
    the host's time to enqueue it, the plain version's time, the bound and
    the bytes the kernel reads from global memory an iteration."""
    from super_tpu_torch.kernels.pcg import dense_cg, dense_cg_capacity, \
        dense_cg_plain, dense_cg_stats

    iters = K3_ITERS
    n = a_hat.shape[0]
    x_k = dense_cg(a_hat, b_hat, iterations=iters)
    x_k2 = dense_cg(a_hat, b_hat, iterations=iters)
    x_k3, stats = dense_cg_stats(a_hat, b_hat, iterations=iters)
    x_p = dense_cg_plain(a_hat, b_hat, iterations=iters)
    torch.cuda.synchronize()
    row_chunks = _nonzero_chunks(a_hat)
    nz_chunks = int(row_chunks.sum())
    kept, rows_over = (int(v) for v in stats.sum(dim=0))
    ctas = stats.shape[0]
    out = dict(phase=name, system=system, dim=n, iterations=iters,
               chunk_fill=nz_chunks / (n * -(-n // 4)),
               chunks_per_row_mean=nz_chunks / n,
               chunks_per_row_max=int(row_chunks.max()),
               chunks_kept=kept, chunks_kept_max_cta=int(stats[:, 0].max()),
               capacity_per_cta=dense_cg_capacity(n), ctas=ctas,
               rows_overflow=rows_over)
    if finite:
        a64, b64 = a_hat.double(), b_hat.double()

        def resid(x):
            return float(torch.linalg.norm(a64 @ x.double() - b64)
                         / torch.linalg.norm(b64))

        err = float(torch.max(torch.abs(x_k - x_p)))
        rel = err / float(torch.max(torch.abs(x_p)))
        res_k, res_p = resid(x_k), resid(x_p)
        del a64
        bitwise = bool(torch.equal(x_k, x_k2) and torch.equal(x_k, x_k3))
        out.update(max_abs_err=err, max_rel_err=rel, residual_kernel=res_k,
                   residual_plain=res_p, bitwise=bitwise)
        # f32 CG, 32 iterations, sums in other orders: 1e-4 relative to
        # |x|, and the same residual; the same bits from launch to launch;
        # with no row on the overflow route, every nonzero chunk kept.
        ok = (math.isfinite(rel) and rel < 1e-4 and res_k < 2 * res_p + 1e-5
              and bitwise and (rows_over > 0 or kept == nz_chunks))
    else:
        fin = [int(torch.isfinite(x).sum()) for x in (x_k, x_k2, x_k3, x_p)]
        out.update(finite_entries_kernel=fin[:3], finite_entries_plain=fin[3])
        ok = fin == [0, 0, 0, 0]
    if not ok:
        emit(out)
        raise RuntimeError(f"{name}: K3 disagrees with its plain version on "
                           f"{system}")

    def run(iterations):
        return lambda: dense_cg(a_hat, b_hat, iterations=iterations)

    ms = cuda_ms(run(iters), reps=50)
    ms_dev, ms0 = (cuda_ms(run(it), reps=20, queued=True)
                   for it in (iters, 0))
    enqueue_ms = host_ms(run(iters), reps=20)
    plain_ms = cuda_ms(lambda: dense_cg_plain(a_hat, b_hat, iterations=iters),
                       reps=5)
    # Work this run's data needs: a matvec over the nonzero entries and ~10
    # operations per vector entry an iteration.  Bytes: the matrix (every
    # entry must be read to know it is zero) and b read once, x written.
    nnz = int((a_hat != 0).sum())
    flops = iters * (2 * nnz + 10 * n)
    nbytes = (n * n + 2 * n) * 4
    b_ms, b_by = bound(nbytes, flops)
    # Global memory an iteration: every CTA reads all of A p and the CTAs'
    # partials and its overflow rows whole; A p and the partials written.
    global_bytes = (ctas * (n + ctas) + rows_over * n + n + ctas) * 4
    out.update(ms=ms, ms_device=ms_dev, ms_iterations0_device=ms0,
               ms_per_iteration=(ms_dev - ms0) / iters,
               host_enqueue_ms=enqueue_ms, plain_ms=plain_ms, bound_ms=b_ms,
               bound_by=b_by, bytes=nbytes, flops=flops, nonzeros=nnz,
               global_bytes_per_iteration=global_bytes)
    emit(out)
    return out


def _pair_hat(dev, j, p, seed, failed_node=None):
    """A seeded normal-equation-shaped system (the damped pair system of
    ``example_pair_system`` as a dense matrix) block-preconditioned as the
    LM step does it; with ``failed_node`` that node's diagonal block is
    made indefinite, so its rows and columns of A-hat are NaN, as a failed
    block Cholesky leaves them."""
    from super_tpu_torch.core.lm import block_precondition, \
        example_pair_system

    layout, acc, rhs, u, _ = example_pair_system(j, p, seed, device=dev)
    a = _pair_matrix(layout, acc, u, j, dev).float()
    if failed_node is not None:
        blk = slice(7 * failed_node, 7 * failed_node + 7)
        a[blk, blk] = -torch.eye(7, device=dev)
    a_hat, b_hat, _ = block_precondition(a, rhs, j)
    return a_hat, b_hat


def phase_k3(dev):
    """K3 at path B's shapes (J = 384, P = 4096: dim 2688) on a seeded
    system."""
    return _dense_check("k3", "seeded", *_pair_hat(dev, 384, 4096, SEED + 1))


def phase_k3_cases(dev):
    """K3 on a fully dense SPD matrix at dim 2688 (rows on the overflow
    route), on a system with one node's rows and columns NaN, at J = 15
    (dim 105: rows not 16-byte aligned, fewer rows than SMs), and at the
    dense graph's shapes (J = 1216, P = 19,456: dim 8512, a 290 MB
    matrix)."""
    n = 7 * 384
    gen = torch.Generator(device=dev).manual_seed(SEED)
    m = torch.randn((n, n), generator=gen, device=dev)
    a = m @ m.T / n + torch.eye(n, device=dev)
    a = (a + a.T) / 2                   # exactly symmetric
    b = torch.randn((n,), generator=gen, device=dev)
    _dense_check("k3_full", "dense_spd", a, b)
    del m, a
    _dense_check("k3_nan", "failed_block",
                 *_pair_hat(dev, 384, 4096, SEED + 1, failed_node=100),
                 finite=False)
    _dense_check("k3_small", "seeded", *_pair_hat(dev, 15, 60, SEED + 2))
    _dense_check("k3_dense", "seeded", *_pair_hat(dev, 1216, 19456, SEED + 1))


def phase_dense_path(dev, intr, frames):
    """K3 on the ``pcg_pallas`` path's own system: frame 1's normal
    equations at beta0, damped by the initial damping and
    block-preconditioned, as the first LM trip solves them."""
    from super_tpu_torch.config import workload_config
    from super_tpu_torch.core.lm import block_precondition
    from super_tpu_torch.core.losses import assemble_normal_equations, \
        associate, prepare_lm
    from super_tpu_torch.core.tracker import init_tracker
    from super_tpu_torch.geometry.quaternion import identity_dq

    cfg = workload_config("pcg_pallas")
    j = cfg.capacity.node_capacity
    state = init_tracker(cfg, frames[0])
    ctx = prepare_lm(cfg, state.surfels, state.graph, frames[1])
    assoc = associate(cfg, ctx, intr)
    beta = identity_dq(dev)[None].repeat(j, 1)
    jtj, jtr, _ = assemble_normal_equations(cfg, ctx, beta, intr, assoc)
    a = torch.diagonal_scatter(jtj, jtj.diagonal()
                               + cfg.solver.lm_damping_init)
    a_hat, b_hat, _ = block_precondition(a, jtr, j)
    return _dense_check("path_pcg_pallas", "frame1", a_hat, b_hat)


def phase_k2(dev, cfg, ctx, assoc, name="k2", rows=None):
    """K2 against its plain version on a path's own rows (a real
    block_tuple from build_tuple_layout on synthetic 480 x 640 frames):
    the data term's rows against ``assoc`` at a perturbed beta, or
    ``rows`` (h, r) as given."""
    from super_tpu_torch.core.losses import data_rows
    from super_tpu_torch.kernels.gram import tuple_gram, tuple_gram_plain

    if rows is None:
        rows = data_rows(ctx, _perturbed_beta(cfg, dev),
                         cfg.losses.sf_point_plane_weight, assoc)
    h, r = rows
    bt = ctx.layout.block_tuple
    kw = dict(tuple_cap=ctx.layout.tuple_nodes.shape[0],
              block=cfg.solver.assembly_pad_group)
    g_k, j_k = tuple_gram(h, r, bt, **kw)
    g_k2, j_k2 = tuple_gram(h, r, bt, **kw)
    g_p, j_p = tuple_gram_plain(h, r, bt, **kw)
    torch.cuda.synchronize()
    bitwise = bool(torch.equal(g_k, g_k2) and torch.equal(j_k, j_k2))
    err = max(float(torch.max(torch.abs(g_k - g_p))),
              float(torch.max(torch.abs(j_k - j_p))))
    scale = max(float(torch.max(torch.abs(g_p))),
                float(torch.max(torch.abs(j_p))))
    sym = float(torch.max(torch.abs(g_k - g_k.transpose(1, 2))))
    ms = cuda_ms(lambda: tuple_gram(h, r, bt, **kw), reps=20)
    ms_dev = cuda_ms(lambda: tuple_gram(h, r, bt, **kw), reps=20, queued=True)
    enqueue_ms = host_ms(lambda: tuple_gram(h, r, bt, **kw), reps=20)
    plain_ms = cuda_ms(lambda: tuple_gram_plain(h, r, bt, **kw), reps=5)
    np_cap = h.shape[0]
    t_cap = kw["tuple_cap"]
    flops = 2 * np_cap * 28 * 29
    nbytes = (h.numel() + r.numel() + bt.numel() + t_cap * 28 * 29) * 4
    b_ms, b_by = bound(nbytes, flops)
    # f32 sums of the same products in other orders (64 rows, then the
    # blocks of a tuple): 1e-5 relative to the largest entry.  The kernel
    # writes (i, j) and (j, i) from one sum: its Grams are exactly
    # symmetric; its sums have fixed orders: two launches agree bitwise.
    if not (math.isfinite(err) and err <= 1e-5 * scale and sym == 0.0
            and bitwise):
        raise RuntimeError(f"K2 disagrees: err {err} (scale {scale}), "
                           f"asymmetry {sym}, bitwise {bitwise}")
    # The pair table this frame fills (the pair CG's P in use).
    j_cap = cfg.capacity.node_capacity
    pairs = int((ctx.layout.pair_dest[:, 0] < 7 * j_cap).sum())
    out = dict(phase=name, np=np_cap, tuples=t_cap, pairs_in_use=pairs,
               blocks=int(bt.numel()), max_abs_err=err, scale=scale,
               asymmetry=sym, bitwise=bitwise, ms=ms, ms_device=ms_dev,
               host_enqueue_ms=enqueue_ms, plain_ms=plain_ms, bound_ms=b_ms,
               bound_by=b_by, bytes=nbytes, flops=flops)
    emit(out)
    return out


# Operations of the data term per slot whose masks are both set, counted
# from the kernel's row math (csrc/tuple_gram.cu, store_rows: the blended
# warp, the residual and the 28 weighted row entries of 4 anchors) and from
# the Gram's upper triangle and jtr column (406 + 28 multiply-adds).
ROW_FLOPS = 470
GRAM_FLOPS = 2 * (28 * 29 // 2 + 28)


def _run_lengths(layout, ctx, assoc, block):
    """The layout's G-block runs per visited tuple (sink excluded), the
    sink's blocks and the blocks whose slots are all masked."""
    bt = layout.block_tuple.long()
    t_cap = layout.tuple_nodes.shape[0]
    live = bt < t_cap - 1
    runs = torch.bincount(bt[live], minlength=t_cap)
    runs = runs[runs > 0].double()
    masked = ~(ctx.sf_mask & assoc.mask).reshape(-1, block).any(dim=1)
    q = torch.quantile(runs, torch.tensor([0.5, 0.9, 0.99], device=runs.device,
                                          dtype=runs.dtype)).tolist()
    return dict(tuples_visited=int(runs.numel()),
                live_blocks=int(live.sum()),
                sink_blocks=int((~live).sum()),
                live_blocks_all_masked=int((masked & live).sum()),
                run_blocks_min=int(runs.min()), run_blocks_median=q[0],
                run_blocks_p90=q[1], run_blocks_p99=q[2],
                run_blocks_max=int(runs.max()))


def phase_k2_fused(dev, cfg, ctx, assoc, name="k2_fused"):
    """K2 with the rows computed in the kernel (``data_gram``) against its
    plain version (``data_rows``, then ``tuple_gram_plain``) on a path's
    own frame-1 context and association, at a perturbed beta."""
    from super_tpu_torch.geometry.quaternion import identity_dq
    from super_tpu_torch.kernels.gram import _scratch_floats, data_gram, \
        data_gram_plain

    gen = torch.Generator(device="cpu").manual_seed(SEED)
    j_cap = cfg.capacity.node_capacity
    beta = identity_dq(dev)[None].repeat(j_cap, 1)
    beta = beta + 1e-3 * torch.randn((j_cap, 7), generator=gen).to(dev)
    weight = cfg.losses.sf_point_plane_weight
    g = cfg.solver.assembly_pad_group

    def kernel():
        return data_gram(ctx, beta, weight, assoc, block=g)

    def plain():
        return data_gram_plain(ctx, beta, weight, assoc, block=g)

    out_k, out_k2, out_p = kernel(), kernel(), plain()
    torch.cuda.synchronize()
    (g_k, j_k, c_k), (g_p, j_p, c_p) = out_k, out_p
    bitwise = all(torch.equal(a, b) for a, b in zip(out_k, out_k2))
    g_scale = float(torch.max(torch.abs(g_p)))
    j_scale = float(torch.max(torch.abs(j_p)))
    g_err = float(torch.max(torch.abs(g_k - g_p)))
    j_err = float(torch.max(torch.abs(j_k - j_p)))
    cost_rel = abs(float(c_k) - float(c_p)) / float(c_p)
    sym = float(torch.max(torch.abs(g_k - g_k.transpose(1, 2))))
    ms = cuda_ms(kernel, reps=20)
    ms_dev = cuda_ms(kernel, reps=20, queued=True)
    enqueue_ms = host_ms(kernel, reps=20)
    plain_ms = cuda_ms(plain, reps=3)

    # Bytes and operations this frame's data needs.  Every slot of a live
    # (non-sink) block is read as far as its masks: sf_mask, then the
    # association's mask where sf_mask is set, then its point, anchor
    # weights, target point and normal (52 bytes) where both are.
    # block_tuple and, for each visited tuple, its 4 node ids, their
    # 7-parameter betas and 12 anchor coordinates; the Grams, jtr and the
    # cost written once.
    layout = ctx.layout
    t_cap = layout.tuple_nodes.shape[0]
    runs = _run_lengths(layout, ctx, assoc, g)
    live_slots = runs["live_blocks"] * g
    sf = ctx.sf_mask.reshape(-1, g)[:runs["live_blocks"]]
    both = sf & assoc.mask.reshape(-1, g)[:runs["live_blocks"]]
    n_sf, n_both = int(sf.sum()), int(both.sum())
    nbytes = (live_slots + n_sf + 52 * n_both + 4 * layout.block_tuple.numel()
              + runs["tuples_visited"] * (4 + 28 + 12) * 4
              + t_cap * (28 * 28 + 28) * 4 + 4)
    flops = n_both * (ROW_FLOPS + GRAM_FLOPS + 2)
    b_ms, b_by = bound(nbytes, flops)
    ctas = _scratch_floats(True) // (2 * (28 * 28 + 28) + 1)
    out = dict(phase=name, np=ctx.sf_mask.numel(), tuples=t_cap, block=g,
               slots_live=live_slots, slots_masked_in=n_both, ctas=ctas,
               blocks_per_cta=runs["live_blocks"] / ctas, **runs,
               gram_max_abs_err=g_err, gram_scale=g_scale,
               jtr_max_abs_err=j_err, jtr_scale=j_scale,
               max_abs_err=max(g_err, j_err), cost_rel_err=cost_rel,
               asymmetry=sym, bitwise=bitwise, ms=ms, ms_device=ms_dev,
               host_enqueue_ms=enqueue_ms, plain_ms=plain_ms, bound_ms=b_ms,
               bound_by=b_by, bytes=nbytes, flops=flops)
    emit(out)
    # The same rows summed in other orders (f32, fused multiply-adds in the
    # row math): Gram and jtr within 1e-5 of their largest entries, the
    # cost within 1e-5 relative; exactly symmetric; bitwise repeatable.
    if not (math.isfinite(g_err) and math.isfinite(j_err)
            and g_err <= 1e-5 * g_scale and j_err <= 1e-5 * j_scale
            and cost_rel <= 1e-5 and sym == 0.0 and bitwise):
        raise RuntimeError(f"{name}: data_gram disagrees with its plain "
                           f"version: {out}")
    return out


_SEQUENCES = {}


def _camera(intr):
    """The intrinsics' values as floats: what the synthetic generator reads,
    in a form a worker process can take."""
    return types.SimpleNamespace(**{k: float(getattr(intr, k))
                                    for k in ("fx", "fy", "cx", "cy")})


def _sequence(cfg, intr, n, seed=SEED):
    """The synthetic sequence's first ``n`` frames.  Generated once at the
    longest length any phase needs (PIPELINE_FRAMES at 480 x 640): a
    frame does not depend on the sequence's length."""
    from super_tpu_torch.data.synthetic import generate

    key = (cfg.height, cfg.width, seed)
    if key not in _SEQUENCES or len(_SEQUENCES[key].depths) < n:
        full = max(n, PIPELINE_FRAMES if key[:2] == (480, 640) else n)
        _SEQUENCES[key] = generate(full, cfg.height, cfg.width,
                                   intr=_camera(intr), seed=seed,
                                   num_classes=SEMANTIC_CLASSES)
    return _SEQUENCES[key]


def _start_sequences(intr, seeds):
    """The pipeline phase's sequences of other GT point draws (``seeds``;
    the clean scene's frames do not depend on the seed, only the 20 tracked
    points do), generated in worker processes while the card works:
    (executor, {seed: future})."""
    from super_tpu_torch.data.synthetic import generate

    pool = concurrent.futures.ProcessPoolExecutor(
        len(seeds), mp_context=multiprocessing.get_context("spawn"))
    return pool, {s: pool.submit(generate, PIPELINE_FRAMES, 480, 640,
                                 intr=_camera(intr), seed=s) for s in seeds}


def _frames(cfg, intr, n, dev, seed=SEED):
    from super_tpu_torch.core.preprocess import preprocess_frame

    seq = _sequence(cfg, intr, n, seed)
    colors = np.ascontiguousarray(seq.colors[:n].transpose(0, 3, 1, 2))
    sem = cfg.method == "semantic-super"
    return [preprocess_frame(cfg, intr, seq.depths[t], colors[t], float(t),
                             seg=seq.segs[t] if sem else None,
                             seg_conf=seq.seg_confs[t] if sem else None,
                             device=dev) for t in range(n)]


def _track(cfg, intr, frames, timed=False):
    """init_tracker on frame 0, track_step on the rest.  With ``timed``
    (on the card) each step runs under CUDA's sync debug mode set to
    "error": a step that waits for the card on the host fails the run."""
    from super_tpu_torch.convert import to_numpy
    from super_tpu_torch.core.tracker import init_tracker, track_step

    state = init_tracker(cfg, frames[0])
    outs, times = [], []
    for f in frames[1:]:
        if timed:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        t0 = time.perf_counter()
        try:
            state, o = track_step(cfg, intr, state, f)
        finally:
            if timed:
                torch.cuda.set_sync_debug_mode("default")
        if timed:
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        outs.append(to_numpy(o))
    return state, outs, times


def _launch_counts():
    from super_tpu_torch.kernels import gram, pcg, segsum

    return {"pairs_cg": pcg.pairs_cg, "pairs_cg_chunked": pcg.pairs_cg_chunked,
            "tuple_gram": gram.tuple_gram, "data_gram": gram.data_gram,
            "dense_cg": pcg.dense_cg, "segment_sum": segsum.segment_sum}


def _run_path(name, cfg, intr, frames, per_trip):
    """Track ``frames`` (frame 0 initialises) with every step under sync
    debug mode "error", the launch counts zeroed just before and read just
    after.  ``per_trip``: {kernel: launches per LM trip}; the segment sum
    must launch SEGSUM_PER_TRIP times a trip and SEGSUM_AT_INIT at frame 0;
    every other kernel must not launch."""
    wrappers = _launch_counts()
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
    state, outs, times = _track(cfg, intr, frames, timed=True)
    launches = {k: w.launches for k, w in wrappers.items()}

    counters = ("tuple_overflow", "pair_overflow", "proj_overflow",
                "add_overflow", "free_exhausted", "dup_skipped")
    per_frame = [dict(frame=i + 1, ms=t, lm_cost=float(o.lm_cost),
                      lm_damping=float(o.lm_damping),
                      num_surfels=int(o.num_surfels),
                      num_nodes=int(o.num_nodes),
                      **{c: int(getattr(o, c)) for c in counters})
                 for i, (o, t) in enumerate(zip(outs, times))]
    trips = cfg.solver.num_iterations * (len(frames) - 1)
    per_trip = {"segment_sum": SEGSUM_PER_TRIP, **per_trip}
    want = {k: trips * per_trip.get(k, 0) for k in wrappers}
    want["segment_sum"] += SEGSUM_AT_INIT
    ok = (all(math.isfinite(f["lm_cost"]) for f in per_frame)
          and all(f["num_surfels"] > 0 for f in per_frame)
          and launches == want)
    steady = times[1:] or times
    emit(dict(phase=name, height=cfg.height, width=cfg.width,
              linear_solver=cfg.solver.linear_solver,
              nodes=per_frame[0]["num_nodes"],
              node_capacity=cfg.capacity.node_capacity,
              surfel_capacity=cfg.capacity.surfel_capacity,
              tuple_cap=cfg.solver.assembly_tuple_cap,
              pair_cap=cfg.solver.assembly_pair_cap,
              lm_trips=trips, launches=launches,
              ms_per_frame_steady=sum(steady) / len(steady),
              peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
              frames=per_frame))
    if not ok:
        raise RuntimeError(f"{name} path check failed (finite cost, surfels, "
                           f"launches {launches}, want {want})")
    return launches


def phase_main(dev):
    """The main path at 480 x 640: K1 and K2 (``data_gram``) once per LM
    trip."""
    from super_tpu_torch.config import workload_config
    from super_tpu_torch.data.synthetic import default_intrinsics

    cfg = workload_config("lm")
    intr = default_intrinsics(cfg.height, cfg.width, device=dev)
    t0 = time.perf_counter()
    frames = _frames(cfg, intr, MAIN_FRAMES + 1, dev)
    torch.cuda.synchronize()
    emit(dict(phase="setup", frames=len(frames),
              seconds=time.perf_counter() - t0))
    launches = _run_path("main", cfg, intr, frames,
                         {"pairs_cg": 1, "data_gram": 1})
    return cfg, intr, frames, launches


def phase_dense(dev, intr, frames):
    """Path A, the dense ED graph (mesh step 16, J = 1216): K1b and K2
    (``data_gram``) once per LM trip, K1 never.  The synthetic frames do
    not depend on the mesh step, so the main path's are reused."""
    from super_tpu_torch.config import workload_config

    cfg = workload_config("dense16")
    launches = _run_path("dense", cfg, intr, frames[:PATH_FRAMES + 1],
                         {"pairs_cg_chunked": 1, "data_gram": 1})
    return cfg, launches


def phase_solvers(dev, intr, frames):
    """Path B, the dense-matrix solvers on the headline workload: K3 and K2
    (``data_gram``) once per LM trip with "pcg_pallas"; then "cholesky" and
    "pcg" (K2 only) for one frame each."""
    from super_tpu_torch.config import workload_config

    launches = _run_path("solvers", workload_config("pcg_pallas"), intr,
                         frames[:PATH_FRAMES + 1],
                         {"dense_cg": 1, "data_gram": 1})
    for solver in ("cholesky", "pcg"):
        _run_path(f"solvers_{solver}", workload_config(solver), intr,
                  frames[:2], {"data_gram": 1})
    return launches


def option_segsum_per_trip(cfg):
    """Segment-sum launches of an LM trip: SEGSUM_PER_TRIP, or with the
    scatter assembly one a chunk of slots, and the slots' J^T r rows, the
    ARAP rows and the graph blocks."""
    from super_tpu_torch.core.losses import assembly_chunk_size

    if cfg.solver.assembly_mode == "tuple":
        return SEGSUM_PER_TRIP
    n = cfg.capacity.surfel_capacity
    return n // assembly_chunk_size(n, cfg.solver.assembly_chunk) + 3


def phase_options(dev, intr, frames):
    """The option paths at 480 x 640 (OPTION_PATHS): OPTION_FRAMES tracked
    frames each through ``_run_path`` with the path's own launches a trip,
    then frame 1 tracked twice from the same state, bitwise.  Returns
    {path: launches}."""
    from super_tpu_torch.config import workload_config
    from super_tpu_torch.core.tracker import init_tracker, track_step

    out = {}
    for name, per_trip in OPTION_PATHS:
        cfg = workload_config(name)
        per_trip = dict(per_trip, segment_sum=option_segsum_per_trip(cfg))
        out[name] = _run_path(name, cfg, intr, frames[:OPTION_FRAMES + 1],
                              per_trip)
        state = init_tracker(cfg, frames[0])
        a = track_step(cfg, intr, state, frames[1])
        b = track_step(cfg, intr, state, frames[1])
        torch.cuda.synchronize()
        same = _same(a, b)
        emit(dict(phase=f"{name}_repeat", bitwise=same))
        if not same:
            raise RuntimeError(f"{name}: frame 1 does not repeat bitwise")
        del state, a, b
    return out


def phase_option_reference(intr, frames):
    """Frame 1 of each option path on the card against the CPU path from
    identical inputs: beta within OPTION_BETA_TOL (else the main path's
    1e-4), the cost within 1e-2."""
    from super_tpu_torch.config import workload_config

    out = {}
    for name, _ in OPTION_PATHS:
        res_c, res_h, cpu_s = _frame1_vs_cpu(workload_config(name), intr,
                                             frames)
        beta_err, cost_err = _solve_diff(res_c, res_h)
        out[name] = dict(beta_max_abs_err=beta_err,
                         cost_rel_err=cost_err / float(res_h.cost),
                         cost=float(res_c.cost), cpu_s=cpu_s,
                         beta_tol=OPTION_BETA_TOL.get(name, 1e-4))
    emit(dict(phase="option_reference", frame1=out))
    bad = {k: v for k, v in out.items()
           if not (v["beta_max_abs_err"] < v["beta_tol"]
                   and v["cost_rel_err"] < 1e-2)}
    if bad:
        raise RuntimeError(f"frame 1 disagrees with the CPU path: {bad}")


def phase_segsum_scatter(dev, intr, frames):
    """The segment sum on the scatter assembly's frame-1 sums at a
    perturbed beta (``_segsum_check`` against the plain version in f64):
    a chunk of slot blocks onto the running sums (32,768 slots x 16 blocks
    of 49, 147,457 segments), and the slots' J^T r rows (1,703,936 rows,
    the sink's 485,284 and the nodes' up to ~2 x 10^4).  Returns the
    blocks' record."""
    from super_tpu_torch.config import workload_config
    from super_tpu_torch.core.losses import associate, prepare_lm
    from super_tpu_torch.core.tracker import init_tracker

    cfg = workload_config("scatter")
    state = init_tracker(cfg, frames[0])
    ctx = prepare_lm(cfg, state.surfels, state.graph, frames[1])
    calls, _ = _capture_sums(cfg, ctx, _perturbed_beta(cfg, dev), intr,
                             associate(cfg, ctx, intr))
    nc = len(ctx.chunk_plans)
    rec = _segsum_check("scatter", "slot_blocks", *calls[1], f64=True)
    _segsum_check("scatter", "slot_jtr", *calls[nc], f64=True)
    return rec


def phase_proj_map_scatter(dev, cfg, intr, frames):
    """Fusion's ``proj_map_mode="scatter"`` on the headline after 2 tracked
    frames: the layer maps equal the sort mode's, entry for entry, and a
    fusion of frame 3 in each mode gives bitwise equal surfels, remap and
    counters; both maps' device ms."""
    from super_tpu_torch.core.fusion import build_projection_maps, fuse_frame
    from super_tpu_torch.core.tracker import init_tracker, track_step

    state = init_tracker(cfg, frames[0])
    for f in frames[1:3]:
        state, _ = track_step(cfg, intr, state, f)
    modes = {m: cfg.replace(proj_map_mode=m) for m in ("sort", "scatter")}
    maps = {m: build_projection_maps(c, intr, state.surfels)
            for m, c in modes.items()}
    fused = {m: fuse_frame(c, intr, state.surfels, state.graph, frames[3])
             for m, c in modes.items()}
    ms = {m: cuda_ms(lambda c=c: build_projection_maps(c, intr,
                                                       state.surfels),
                     reps=10) for m, c in modes.items()}
    torch.cuda.synchronize()
    depth_l = cfg.capacity.proj_map_depth
    lay = maps["sort"][1]
    rec = dict(phase="proj_map_scatter", maps_equal=_same(maps["sort"],
                                                          maps["scatter"]),
               fusion_equal=_same(fused["sort"], fused["scatter"]),
               multi_layer_pixels=int((maps["sort"][0][1] >= 0).sum()),
               overflow=int((lay == depth_l).sum()),
               sort_ms=ms["sort"], scatter_ms=ms["scatter"])
    emit(rec)
    if not (rec["maps_equal"] and rec["fusion_equal"]):
        raise RuntimeError(f"scatter projection maps differ: {rec}")


def _to(x, d):
    """A tensor, or a NamedTuple tree of them, on device ``d``."""
    if isinstance(x, torch.Tensor):
        return x.to(d)
    return type(x)(*(_to(v, d) for v in x))


def _frame1_solve(cfg, intr, state, frame, dev):
    """Frame 1's LM solve from ``state`` (init_tracker's on frame 0), every
    input moved to ``dev``."""
    from super_tpu_torch.core.lm import lm_solve
    from super_tpu_torch.core.losses import prepare_lm

    state, frame, intr = _to(state, dev), _to(frame, dev), _to(intr, dev)
    return lm_solve(cfg, prepare_lm(cfg, state.surfels, state.graph, frame),
                    intr)


def _frame1_vs_cpu(cfg, intr, frames):
    """Frame 1's LM solve at full size on the card and on the CPU path from
    identical inputs: (card's LMResult, CPU's LMResult, CPU seconds)."""
    from super_tpu_torch.core.tracker import init_tracker

    state = init_tracker(cfg, frames[0])
    res_c = _frame1_solve(cfg, intr, state, frames[1],
                          frames[1].points.device)
    t0 = time.perf_counter()
    res_h = _frame1_solve(cfg, intr, state, frames[1], torch.device("cpu"))
    return res_c, res_h, time.perf_counter() - t0


def _solve_diff(a, b):
    """(max |beta| difference, |cost difference|) of two LM results."""
    return (float(torch.max(torch.abs(a.beta.cpu() - b.beta.cpu()))),
            abs(float(a.cost) - float(b.cost)))


def phase_path_reference(intr, frames):
    """Frame 1 of path A and of path B's "pcg_pallas" and "cholesky" against
    the CPU path (same tolerances as the main path's frame 1)."""
    from super_tpu_torch.config import workload_config

    out = {}
    for name in ("dense16", "pcg_pallas", "cholesky"):
        res_c, res_h, cpu_s = _frame1_vs_cpu(workload_config(name), intr,
                                             frames)
        beta_err, cost_err = _solve_diff(res_c, res_h)
        out[name] = dict(beta_max_abs_err=beta_err,
                         cost_rel_err=cost_err / float(res_h.cost),
                         cost=float(res_c.cost), cpu_s=cpu_s)
    emit(dict(phase="path_reference", frame1=out))
    bad = {k: v for k, v in out.items()
           if not (v["beta_max_abs_err"] < 1e-4 and v["cost_rel_err"] < 1e-2)}
    if bad:
        raise RuntimeError(f"frame 1 disagrees with the CPU path: {bad}")


def phase_reference(dev, cfg, intr, frames):
    """Results against the port's plain path on the CPU, which the CPU
    tests hold against the JAX package: (a) frame 1's LM solve at full size
    from identical inputs; (b) a 4-frame tiny scene (48 x 64, mesh step 8)
    tracked on the card and on the CPU."""
    from super_tpu_torch.config import CapacityConfig, SolverConfig, \
        SuPerConfig
    from super_tpu_torch.data.synthetic import default_intrinsics

    cpu = torch.device("cpu")
    res_c, res_h, cpu_s = _frame1_vs_cpu(cfg, intr, frames)
    beta_err, cost_err = _solve_diff(res_c, res_h)
    cost, cost_rel = float(res_c.cost), cost_err / float(res_h.cost)

    tiny = SuPerConfig(
        height=48, width=64, mesh_step_size=8,
        solver=SolverConfig(
            assembly_tuple_cap=1024, assembly_pad_group=8,
            assembly_chunk=4096, association="per_frame",
            linear_solver="pairs_fused", pcg_iterations=32,
            gram_sum_dtype="bf16", assembly_backend="pallas"),
        capacity=CapacityConfig(
            surfel_capacity=2 * 48 * 64, node_capacity=64, edge_capacity=256,
            triangle_capacity=128, new_surfel_capacity=48 * 64))
    tiny_c = _track(tiny, default_intrinsics(48, 64, dev),
                    _frames(tiny, default_intrinsics(48, 64, dev), 5, dev))[1]
    tiny_h = _track(tiny, default_intrinsics(48, 64, cpu),
                    _frames(tiny, default_intrinsics(48, 64, cpu), 5, cpu))[1]
    cost_rels = [abs(float(a.lm_cost) - float(b.lm_cost)) / float(b.lm_cost)
                 for a, b in zip(tiny_c, tiny_h)]
    surf = [(int(a.num_surfels), int(b.num_surfels))
            for a, b in zip(tiny_c, tiny_h)]
    emit(dict(phase="reference", frame1_beta_max_abs_err=beta_err,
              frame1_cost_rel_err=cost_rel, frame1_cost=cost,
              frame1_cpu_s=cpu_s, tiny_cost_rel_err=cost_rels,
              tiny_num_surfels=surf))
    # Frame 1 from identical inputs: the same solve up to f32 sum order
    # (tests/test_torch_lm.py holds the CPU path to the JAX package at
    # 1e-5 on beta, 1e-3 on the cost).  The tiny track is chaotic at the
    # f32 rounding level: the tolerances of tests/test_torch_track.py.
    if not (beta_err < 1e-4 and cost_rel < 1e-2
            and all(c < 0.15 for c in cost_rels)
            and all(abs(a - b) <= 0.01 * b for a, b in surf)):
        raise RuntimeError("results disagree with the CPU reference")


def _same(a, b):
    """Bitwise equal tensors (NaN where the other is NaN), or trees of
    them."""
    if isinstance(a, torch.Tensor):
        if a.is_floating_point():
            return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())
        return bool(torch.equal(a, b))
    return all(_same(x, y) for x, y in zip(a, b))


def _capture_sums(cfg, ctx, beta, intr, assoc):
    """One assemble_normal_equations and its fixed-order sums as the step
    gives them: ([(values, plan, keywords)] in call order, (jtj, jtr,
    cost))."""
    from super_tpu_torch.core import assembly, losses
    from super_tpu_torch.kernels import segsum

    calls = []
    real = segsum.segment_sum

    def spy(values, plan, **kw):
        calls.append((values, plan, kw))
        return real(values, plan, **kw)

    assembly.segment_sum = losses.segment_sum = spy
    try:
        out = losses.assemble_normal_equations(cfg, ctx, beta, intr, assoc)
    finally:
        assembly.segment_sum = losses.segment_sum = real
    return calls, out


def _perturbed_beta(cfg, dev):
    from super_tpu_torch.geometry.quaternion import identity_dq

    gen = torch.Generator(device="cpu").manual_seed(SEED)
    j_cap = cfg.capacity.node_capacity
    beta = identity_dq(dev)[None].repeat(j_cap, 1)
    return beta + 1e-3 * torch.randn((j_cap, 7), generator=gen).to(dev)


def phase_segsum(dev, path, cfg, ctx, assoc, intr, only=None):
    """The fixed-order segment sum against its plain version (index_add_)
    on the sums of one path's frame-1 assembly at a perturbed beta, at the
    shapes the path gives them (the pair rows in bf16, the tuples' and the
    ARAP term's J^T r rows, and the graph terms' pair rows or, on the
    dense-matrix paths, the graph blocks; ``only``: the names to hold):
    max abs error <= 1e-6 of the largest sum, two launches bitwise equal;
    the kernel's time, the plain version's, index_add_'s alone and the
    bound (:func:`_segsum_check`).  Returns {name: record}."""
    last = ("graph_rows" if cfg.solver.linear_solver == "pairs_fused"
            else "dense_blocks")
    calls, _ = _capture_sums(cfg, ctx, _perturbed_beta(cfg, dev), intr,
                             assoc)
    cases = [c for c in zip(("pair_rows", "node_jtr", "arap_jtr", last),
                            calls) if only is None or c[0] in only]
    return {name: _segsum_check(path, name, values, plan, kw)
            for name, (values, plan, kw) in cases}


def _segsum_bound(values, plan, kw):
    """(bound ms, what bounds it, bytes) of one segment sum: the rows, the
    order, the offsets and out (with base, base too) each moved once; one
    add an entry."""
    r, s_ = values.shape[0], plan.num_segments
    f = values.numel() // r
    nbytes = (values.numel() + r + s_ + 1
              + s_ * f * (2 if kw.get("base") is not None else 1)) * 4
    return bound(nbytes, values.numel()) + (nbytes,)


def _segsum_check(path, name, values, plan, kw, f64=False):
    """One sum by the kernel against its plain version: max abs error <=
    1e-6 of the largest sum, two launches bitwise equal; the kernel's time,
    the plain version's, index_add_'s alone and the bound.  With ``f64``
    the error is taken against the plain version in f64 (f32 values,
    exact sums): on segments of 10^4 to 10^5 rows index_add_'s own f32
    error nears 1e-6.  Returns the record."""
    from super_tpu_torch.kernels.segsum import segment_sum, segment_sum_plain

    values = values.detach()
    out_k, out_k2 = segment_sum(values, plan, **kw), \
        segment_sum(values, plan, **kw)
    if f64:
        base = kw.get("base")
        out_p = segment_sum_plain(
            values.double(), plan,
            base=None if base is None else base.double())
    else:
        out_p = segment_sum_plain(values, plan, **kw)
    torch.cuda.synchronize()
    err = float(torch.max(torch.abs(out_k.double() - out_p.double())))
    scale = float(torch.max(torch.abs(out_p)))
    bitwise = bool(torch.equal(out_k, out_k2))
    acc = torch.zeros_like(out_k)
    ms = cuda_ms(lambda: segment_sum(values, plan, **kw), reps=20)
    ms_dev = cuda_ms(lambda: segment_sum(values, plan, **kw), reps=20,
                     queued=True)
    enqueue_ms = host_ms(lambda: segment_sum(values, plan, **kw), reps=20)
    plain_ms = cuda_ms(lambda: segment_sum_plain(values, plan, **kw),
                       reps=20)
    library_ms = cuda_ms(lambda: acc.index_add_(0, plan.ids, values),
                         reps=20)
    r, s_ = values.shape[0], plan.num_segments
    b_ms, b_by, nbytes = _segsum_bound(values, plan, kw)
    seg_len = torch.diff(plan.offsets)
    rec = dict(phase="segsum", path=path, sum=name, rows=r, segments=s_,
               width=values.numel() // r, sum_dtype=kw.get("sum_dtype"),
               base=kw.get("base") is not None,
               longest_segment=int(seg_len.max()),
               empty_segments=int((seg_len == 0).sum()),
               reference="f64" if f64 else "f32", max_abs_err=err,
               scale=scale, bitwise=bitwise, ms=ms,
               ms_device=ms_dev, host_enqueue_ms=enqueue_ms,
               plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms,
               bound_by=b_by, bytes=nbytes,
               **_parent_times(values, plan, kw, out_k))
    emit(rec)
    # One f32 sum per output in another order than index_add_'s atomics
    # (the kernel adds a long segment's tiles as a tree): 1e-6 of the
    # largest sum; a fixed order: the same bits every launch.
    if not (math.isfinite(err) and err <= 1e-6 * scale and bitwise):
        raise RuntimeError(f"segment_sum disagrees on {path} {name}: {rec}")
    return rec


# The segment sum's edge cases at full size: (case, rows, width, segments,
# base, sum_dtype).  Beside the call sites' shapes (``segsum``): one
# segment holding every row, the soft splat's shape with half its rows in
# the last pixel, the pair rows' shapes (the dense graph's tiles summed in
# two halves), every row its own segment, segments of one tile and
# segments that start or end on tile edges, ids outside [0, S) at both
# ends of the sort, a million segments mostly empty (the dense solvers'
# blocks), fewer rows than a tile, and the pair rows' shape in bf16.
SEGSUM_CASES = (
    ("one_segment", 2_097_152, 4, 1, False, None),
    ("one_segment", 262_144, 1, 1, False, None),
    ("one_segment", 131_072, 7, 1, True, None),
    ("one_segment", 40_960, 49, 1, False, "bf16"),
    ("sink", 2_097_152, 4, 307_201, False, None),
    ("sink", 40_960, 49, 4_096, False, "bf16"),
    ("sink", 97_280, 49, 19_456, False, "bf16"),
    ("own_segments", 65_536, 7, 65_536, False, None),
    ("own_segments", 16_384, 49, 16_384, True, None),
    ("tile_edges", 40_960, 49, None, False, None),
    ("tile_edges", 97_280, 49, None, True, None),
    ("tile_edges", 262_144, 4, None, True, "bf16"),
    ("tile_edges", 65_536, 1, None, False, None),
    ("outside_ids", 65_536, 7, 384, False, None),
    ("outside_ids", 40_960, 49, 4_096, True, "bf16"),
    ("empty_segments", 88_064, 7, 1_032_192, True, None),
    ("empty_segments", 20_000, 4, 1_000_000, False, None),
    ("short", 37, 49, 6, True, None),
    ("short", 500, 4, 9, False, "bf16"),
)


def _segsum_case_ids(case, rows, width, segs, rng):
    """(ids, segments) of one edge case, seeded."""
    from super_tpu_torch.kernels.segsum import tile_rows

    tile = tile_rows(width, rows)
    if case == "one_segment":
        return np.zeros(rows, np.int64), 1
    if case == "own_segments":
        return rng.permutation(rows), rows
    if case == "sink":
        ids = rng.integers(0, segs - 1, size=rows)
        ids[rng.random(rows) < 0.5] = segs - 1
        return ids, segs
    if case == "tile_edges":
        pattern = [tile, tile - 1, 1, tile, 2, tile - 2, 2 * tile + 1, 1,
                   tile - 1, 3]
        lengths = pattern * -(-rows // sum(pattern))
        ids = np.repeat(np.arange(len(lengths)), lengths)[:rows]
        return rng.permutation(ids), len(lengths)
    if case == "outside_ids":
        ids = rng.integers(0, segs, size=rows)
        ids[rng.random(rows) < 0.05] = -1
        ids[rng.random(rows) < 0.05] = segs + 3
        return ids, segs
    if case == "empty_segments":
        hit = rng.choice(np.arange(1, segs - 1), size=rows // 4,
                         replace=False)
        return rng.choice(hit, size=rows), segs
    if case == "short":
        return rng.integers(0, segs, size=rows), segs
    raise ValueError(case)


def phase_segsum_cases(dev):
    """The segment sum on its edge cases at full size (SEGSUM_CASES),
    against an f64 index_add_ of the rows inside [0, S): on integer values
    in [-8, 8] (every partial sum exact in f32 and bf16) equal, on seeded
    normal values within 1e-6 of the largest sum (f32 index_add_'s own
    error beside: its atomics add a 2M-row segment in series); bitwise
    across two launches.  Timed on the normal values beside the parent
    kernel (where given) and index_add_."""
    from super_tpu_torch.kernels import segsum

    rng = np.random.default_rng(SEED)
    for case, rows, width, segs, with_base, sum_dtype in SEGSUM_CASES:
        ids_np, segs = _segsum_case_ids(case, rows, width, segs, rng)
        ids = torch.as_tensor(ids_np, device=dev)
        plan = segsum.segment_plan(ids, segs)
        inside = (ids >= 0) & (ids < segs)
        rec = dict(phase="segsum_cases", case=case, rows=rows, width=width,
                   segments=segs, base=with_base, sum_dtype=sum_dtype,
                   tile_rows=segsum.tile_rows(width, rows),
                   longest_segment=int(torch.diff(plan.offsets).max()),
                   empty_segments=int((torch.diff(plan.offsets) == 0).sum()),
                   rows_outside=int((~inside).sum()))
        ok = True
        for data in ("integer", "normal"):
            if data == "integer":
                values = torch.as_tensor(rng.integers(
                    -8, 9, size=(rows, width)).astype(np.float32), device=dev)
                base = (torch.as_tensor(rng.integers(
                    -8, 9, size=(segs, width)).astype(np.float32), device=dev)
                    if with_base else None)
            else:
                values = torch.as_tensor(rng.normal(size=(rows, width)).astype(
                    np.float32), device=dev)
                base = (torch.as_tensor(rng.normal(size=(segs, width)).astype(
                    np.float32), device=dev) if with_base else None)
            kw = dict(sum_dtype=sum_dtype, base=base)
            out, out2 = (segsum.segment_sum(values, plan, **kw),
                         segsum.segment_sum(values, plan, **kw))
            rounded = (values.to(torch.bfloat16).float() if sum_dtype
                       else values)

            def index_add(dt):
                ref = (torch.zeros((segs, width), dtype=dt, device=dev)
                       if base is None else base.to(dt).clone())
                return ref.index_add_(0, ids[inside], rounded[inside].to(dt))

            ref = index_add(torch.float64)
            torch.cuda.synchronize()
            bitwise = bool(torch.equal(out, out2))
            err = float(torch.max(torch.abs(out.double() - ref)))
            scale = float(torch.max(torch.abs(ref)))
            rec[data] = dict(
                max_abs_err=err, scale=scale, bitwise=bitwise,
                library_err=float(torch.max(torch.abs(
                    index_add(torch.float32).double() - ref))))
            ok &= bitwise and (err == 0 if data == "integer"
                               else math.isfinite(err) and err <= 1e-6 * scale)
        acc = torch.zeros((segs, width), device=dev)
        vin, iin = values[inside], ids[inside]
        b_ms, b_by, nbytes = _segsum_bound(values, plan, kw)
        rec.update(
            ms=cuda_ms(lambda: segsum.segment_sum(values, plan, **kw),
                       reps=20),
            ms_device=cuda_ms(lambda: segsum.segment_sum(values, plan, **kw),
                              reps=20, queued=True),
            library_ms=cuda_ms(lambda: acc.index_add_(0, iin, vin), reps=20),
            bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
            **_parent_times(values, plan, kw, out))
        emit(rec)
        if not ok:
            raise RuntimeError(f"segment_sum disagrees on case {case}: {rec}")


def phase_repeat(dev, cfg, intr, frames):
    """Two 5-frame headline tracks from the same frames, with the 20 GT
    points bound and read every frame: bitwise equal surfels, graph,
    lm_cost per frame and track ids; and frame 1's normal equations
    assembled twice, with the per-frame association and with none."""
    from super_tpu_torch.core.losses import assemble_normal_equations, \
        associate, prepare_lm
    from super_tpu_torch.core.track_points import assign_track_points, \
        record_track_coords
    from super_tpu_torch.core.tracker import init_tracker, track_step

    seq = _sequence(cfg, intr, len(frames))
    gt_xy = torch.as_tensor(seq.gt_xy[:len(frames)].astype(np.int32),
                            device=dev)
    gt_valid = torch.as_tensor(seq.gt_valid[:len(frames)], device=dev)

    def bind(state, t):
        track = assign_track_points(cfg, state.surfels, frames[t],
                                    state.track, gt_xy[t], gt_valid[t])
        return state._replace(track=record_track_coords(state.surfels, track))

    def track():
        state = bind(init_tracker(cfg, frames[0]), 0)
        costs, ids = [], []
        for t in range(1, len(frames)):
            state, outs = track_step(cfg, intr, state, frames[t])
            state = bind(state, t)
            costs.append(outs.lm_cost)
            ids.append(state.track.track_id)
        return state, torch.stack(costs), torch.stack(ids)

    (s1, c1, i1), (s2, c2, i2) = track(), track()
    torch.cuda.synchronize()
    same = dict(surfels=_same(s1.surfels, s2.surfels),
                graph=_same(s1.graph, s2.graph), lm_cost=_same(c1, c2),
                track_ids=_same(i1, i2),
                track_coords=_same(s1.track.coords, s2.track.coords))
    state = init_tracker(cfg, frames[0])
    ctx = prepare_lm(cfg, state.surfels, state.graph, frames[1])
    beta = _perturbed_beta(cfg, dev)
    for name, assoc in (("per_frame", associate(cfg, ctx, intr)),
                        ("per_iteration", None)):
        a = assemble_normal_equations(cfg, ctx, beta, intr, assoc)
        b = assemble_normal_equations(cfg, ctx, beta, intr, assoc)
        same[f"frame1_assembly_{name}"] = _same(a, b)
    emit(dict(phase="repeat", frames=len(frames), bitwise=same,
              lm_cost=c1.tolist(), tracked=int((i1[-1] >= 0).sum())))
    if not all(same.values()):
        raise RuntimeError(f"the card path does not repeat: {same}")


@contextlib.contextmanager
def _gram_scaled(scale):
    """Every tuple Gram of the moving target scaled by ``scale`` (1 +- a
    few f32 roundings): a nudge the size of a change of sum order."""
    from super_tpu_torch.core import losses

    real = losses.tuple_gram

    def nudged(*args, **kw):
        gram, jtr = real(*args, **kw)
        return gram * scale, jtr

    losses.tuple_gram = nudged
    try:
        yield
    finally:
        losses.tuple_gram = real


def _bf16_assembly(cfg, ctx, ctx_h, beta, intr, intr_h):
    """The moving-target normal equations as the path assembles them (pair
    sums of bf16-rounded rows), card against CPU.  The pair rows before
    rounding are the same sums in other f32 orders; where the two sides
    straddle a bf16 rounding boundary they round a bf16 step apart.  So
    each entry of jtj may differ by the sum of its rows' rounding
    differences plus the f32 tolerance, 1e-5 of the largest entry
    (``jtj_over_limit`` <= 0); the rows before rounding, jtr and the cost
    are held to 1e-5."""
    from super_tpu_torch.kernels.segsum import segment_sum_plain

    calls_c, (jtj_c, jtr_c, cost_c) = _capture_sums(cfg, ctx, beta, intr,
                                                    None)
    calls_h, (jtj_h, jtr_h, cost_h) = _capture_sums(cfg, ctx_h, beta.cpu(),
                                                    intr_h, None)
    (v_c, plan_c, kw), (v_h, plan_h, _) = calls_c[0], calls_h[0]
    if kw.get("sum_dtype") != "bf16" or \
            not torch.equal(plan_c.ids.cpu(), plan_h.ids):
        raise RuntimeError("per_iteration: the pair sums are not bf16 sums "
                           "of one layout on both sides")
    v_c = v_c.cpu()
    steps = torch.abs(v_c.to(torch.bfloat16).float()
                      - v_h.to(torch.bfloat16).float())
    scale = float(torch.max(torch.abs(jtj_h)))
    diff = torch.abs(jtj_c.cpu() - jtj_h)
    limit = segment_sum_plain(steps, plan_h) + 1e-5 * scale
    return dict(
        rows_err=float(torch.max(torch.abs(v_c - v_h)))
        / float(torch.max(torch.abs(v_h))),
        rounding_flips=int((steps > 0).sum()), flip_max=float(steps.max()),
        jtj_err=float(diff.max()) / scale,
        jtj_over_limit=float((diff - limit).max()),
        jtr_err=float(torch.max(torch.abs(jtr_c.cpu() - jtr_h)))
        / float(torch.max(torch.abs(jtr_h))),
        cost_rel_err=abs(float(cost_c) - float(cost_h)) / float(cost_h))


# The nudges of the per-iteration path's witnesses: every tuple Gram scaled
# by 1 +- 2e-7, about two f32 roundings.
NUDGES = (1 + 2e-7, 1 - 2e-7)


def phase_per_iteration(dev, intr, frames):
    """The per-iteration (moving-target) path: K1 and K2's memory form
    (``tuple_gram``) once per LM trip, ``data_gram`` never; K2 timed on the
    rows of frame 1's first trip; then frame 1 against the CPU path.

    The normal equations at the identity and at a perturbed beta (what a
    trip assembles), with the pair sums in f32, are held to 1e-5 of their
    largest entry, and with the path's bf16 pair sums to that plus the
    bf16 steps where the two sides round apart (:func:`_bf16_assembly`).
    The LM solve is chaotic at f32 rounding: each trip re-samples the
    target, and a sample within an ULP of a pixel line switches its
    bilinear cell, and with it the sampling gradient, which jumps at a
    depth edge.  So the solve is held to the spread of the same solve
    under nudges of f32 rounding size (:data:`NUDGES`, on the card, and
    1 + 2e-7 on the CPU), measured in this run: the card's beta within
    twice the largest beta change a nudge makes, its cost within the
    largest cost change.
    """
    from super_tpu_torch.config import workload_config
    from super_tpu_torch.core.losses import assemble_normal_equations, \
        moving_rows, prepare_lm
    from super_tpu_torch.core.tracker import init_tracker
    from super_tpu_torch.geometry.quaternion import identity_dq

    cfg = workload_config("per_iteration")
    launches = _run_path("per_iteration", cfg, intr, frames[:PATH_FRAMES + 1],
                         {"pairs_cg": 1, "tuple_gram": 1})
    cpu = torch.device("cpu")
    j = cfg.capacity.node_capacity

    state = init_tracker(cfg, frames[0])
    ctx = prepare_lm(cfg, state.surfels, state.graph, frames[1])
    # K2's memory form on the moving rows frame 1's first trip writes.
    k2 = phase_k2(dev, cfg, ctx, None, name="k2_per_iteration",
                  rows=moving_rows(cfg, ctx, identity_dq(dev)[None].repeat(
                      j, 1), intr, cfg.losses.sf_point_plane_weight))
    state_h, intr_h = _to(state, cpu), _to(intr, cpu)
    ctx_h = prepare_lm(cfg, state_h.surfels, state_h.graph,
                       _to(frames[1], cpu))
    cfg32 = cfg.replace(solver=dataclasses.replace(cfg.solver,
                                                   gram_sum_dtype="f32"))
    out = {}
    for name, beta in (("identity", identity_dq(dev)[None].repeat(j, 1)),
                       ("perturbed", _perturbed_beta(cfg, dev))):
        a = assemble_normal_equations(cfg32, ctx, beta, intr, None)
        b = assemble_normal_equations(cfg32, ctx_h, beta.cpu(), intr_h, None)
        out[name] = dict(
            jtj_err=float(torch.max(torch.abs(a[0].cpu() - b[0])))
            / float(torch.max(torch.abs(b[0]))),
            jtr_err=float(torch.max(torch.abs(a[1].cpu() - b[1])))
            / float(torch.max(torch.abs(b[1]))),
            cost_rel_err=abs(float(a[2]) - float(b[2])) / float(b[2]))
        out[name + "_bf16"] = _bf16_assembly(cfg, ctx, ctx_h, beta, intr,
                                             intr_h)
    del ctx, ctx_h

    res_c, res_h, cpu_s = _frame1_vs_cpu(cfg, intr, frames)
    nudged = []
    for scale in NUDGES:
        with _gram_scaled(scale):
            res = _frame1_solve(cfg, intr, state, frames[1], dev)
        nudged.append(dict(device="card", scale=scale,
                           **dict(zip(("beta_max_abs_diff", "cost_diff"),
                                      _solve_diff(res, res_c)))))
    with _gram_scaled(NUDGES[0]):
        res = _frame1_solve(cfg, intr, state, frames[1], cpu)
    nudged.append(dict(device="cpu", scale=NUDGES[0],
                       **dict(zip(("beta_max_abs_diff", "cost_diff"),
                                  _solve_diff(res, res_h)))))
    beta_spread = max(n["beta_max_abs_diff"] for n in nudged)
    cost_spread = max(n["cost_diff"] for n in nudged)
    beta_err, cost_err = _solve_diff(res_c, res_h)
    cost = float(res_c.cost)
    rec = dict(phase="per_iteration_reference", assembly=out,
               frame1_beta_max_abs_err=beta_err, frame1_cost_diff=cost_err,
               frame1_cost=cost, frame1_cpu_cost=float(res_h.cost),
               frame1_cpu_s=cpu_s, nudged=nudged,
               beta_limit=2 * beta_spread, cost_limit=cost_spread)
    emit(rec)
    ok = all(v["jtr_err"] <= 1e-5 and v["cost_rel_err"] <= 1e-5 and (
        v["rows_err"] <= 1e-5 and v["jtj_over_limit"] <= 0.0
        if k.endswith("_bf16") else v["jtj_err"] <= 1e-5)
        for k, v in out.items())
    if not (ok and math.isfinite(cost) and beta_err <= 2 * beta_spread
            and cost_err <= cost_spread):
        raise RuntimeError(f"per_iteration frame 1 disagrees with the CPU "
                           f"path: {rec}")
    return launches, k2


def phase_semantic(dev, intr):
    """The semantic path (the autograd fit, Adam, 10 steps a frame) at
    480 x 640 on 3 frames with the generator's segmentations: the segment
    sum SEGSUM_PER_FIT_STEP times a fit step and once at frame 0, no other
    kernel.  Returns (config, frames, launches)."""
    from super_tpu_torch.config import workload_config

    cfg = workload_config("semantic")
    frames = _frames(cfg, intr, PATH_FRAMES + 1, dev)
    launches = _run_path("semantic", cfg, intr, frames,
                         {"segment_sum": SEGSUM_PER_FIT_STEP})
    return cfg, frames, launches


def _deform(cfg, dev, seed=None):
    """The fit's identity deformation (J+1, 7), or 1e-3 off it."""
    from super_tpu_torch.geometry.quaternion import identity_dq

    d = identity_dq(dev)[None].repeat(cfg.capacity.node_capacity + 1, 1)
    if seed is not None:
        gen = torch.Generator(device="cpu").manual_seed(seed)
        d = d + 1e-3 * torch.randn(d.shape, generator=gen).to(dev)
    return d


def _sides(cfg, intr, frames, dev):
    """Frame 1's autograd context on the card and on the CPU from the same
    frame-0 state: {side: (state, intr, context)}."""
    from super_tpu_torch.core.optimizer import prepare_autograd
    from super_tpu_torch.core.tracker import init_tracker

    state = init_tracker(cfg, frames[0])
    out = {}
    for side, d in (("card", dev), ("cpu", torch.device("cpu"))):
        st, fr, it = _to(state, d), _to(frames[1], d), _to(intr, d)
        out[side] = (st, it, prepare_autograd(cfg, st.surfels, st.graph, fr))
    return out


def _total_and_grad(cfg, side, deform):
    from super_tpu_torch.core.optimizer import autograd_total

    st, it, ctx = side
    d = deform.detach().to(st.graph.points.device).clone().requires_grad_(
        True)
    total, parts = autograd_total(cfg, ctx, st.graph, d, it)
    total.backward()
    return (float(total.detach()),
            {k: float(v.detach()) for k, v in parts.items()}, d.grad.cpu())


def _rel(a, b):
    """max |a - b| over max |b| (tensors on any device)."""
    a, b = a.detach().cpu(), b.detach().cpu()
    return float(torch.max(torch.abs(a - b))) / max(
        float(torch.max(torch.abs(b))), 1e-30)


def _surfel_faces(cfg, side, warped):
    """The faces that read the warped surfels, on given warped points."""
    from super_tpu_torch.core import semantic as sem
    from super_tpu_torch.core.optimizer import point_plane_autograd

    st, it, ctx = side
    los = cfg.losses
    return (los.sf_point_plane_weight * point_plane_autograd(
        cfg, ctx, None, it, warped=warped)
        + los.sf_bn_morph_weight * sem.bn_morph_loss(
            cfg, ctx.extras, warped, ctx.sf_seg, ctx.base.sf_mask, it))


@contextlib.contextmanager
def _grad_nudged(scale):
    """Every entry of every gradient of the fit moved by (scale - 1) s
    times the gradient's largest entry, with s a seeded +-1 pattern over
    the deformation's entries: the size of a change of sum order (the
    card's and the CPU's gradients differ by ~1e-7 of the largest entry),
    entry by entry.  Near-zero entries change sign, as they do between sum
    orders; a relative nudge would not (Adam's first step is the sign of
    each entry, and it divides out a common scale).  Exact zeros (the
    inactive nodes' rows) stay zero."""
    from super_tpu_torch.core import optimizer

    real = optimizer.autograd_total

    def nudged(cfg, ctx, graph, deform, intr, **kw):
        gen = torch.Generator(device="cpu").manual_seed(SEED)
        sign = (torch.randint(0, 2, deform.shape, generator=gen) * 2
                - 1).to(deform.device, torch.float32)
        d = deform * 1.0
        # Entries that are exactly 0 (inactive nodes) stay 0, as they do
        # in every sum order.
        d.register_hook(lambda g: g + torch.where(
            g != 0, (scale - 1.0) * sign * torch.max(torch.abs(g)), 0.0))
        return real(cfg, ctx, graph, d, intr, **kw)

    optimizer.autograd_total = nudged
    try:
        yield
    finally:
        optimizer.autograd_total = real


def phase_semantic_reference(dev, cfg, intr, frames):
    """Frame 1 of the semantic path, card against the CPU path from the
    same inputs (the CPU tests hold the CPU path to the JAX package).

    At a seeded deformation 1e-3 off the identity: the total within 1e-5,
    the gradient within 1e-4 of its largest entry.  At the identity the
    surfels, frame-0 pixels, project onto pixel centres within an f32
    rounding, so a warped point an ULP apart samples another cell: there
    the surfel faces and their gradient are held on the CPU's warped
    points, and the warp's backward pass on a shared cotangent, each at
    the same tolerances; end to end too where the two warps agree bit for
    bit.  The 10-step fit is chaotic at rounding (Adam's first step is a
    sign): the card's deformation must lie within twice the largest change
    that gradient nudges of +-2e-7 of the largest entry make
    (:func:`_grad_nudged`, NUDGES, on the card, and +2e-7 on the CPU), its
    loss within the largest loss change."""
    from super_tpu_torch.core.optimizer import _warp_all, graph_fit

    sides = _sides(cfg, intr, frames, dev)
    rec, ok = {}, True
    for name, seed in (("perturbed", SEED), ("identity", None)):
        d = _deform(cfg, dev, seed)
        (tc, pc, gc), (th, ph, gh) = (_total_and_grad(cfg, sides[s], d)
                                      for s in ("card", "cpu"))
        r = dict(total=tc, total_rel_err=abs(tc - th) / th, parts=pc,
                 grad_rel_err=_rel(gc, gh), grad_max=float(gh.abs().max()))
        if name == "identity":
            (sc, ic, cc), (sh, ih, ch) = sides["card"], sides["cpu"]
            dc = d.detach().clone().requires_grad_(True)
            dh = d.detach().cpu().clone().requires_grad_(True)
            wc, wh = _warp_all(cfg, cc, dc), _warp_all(cfg, ch, dh)
            cot = torch.randn(wh.shape, generator=torch.Generator(
                device="cpu").manual_seed(SEED))
            torch.sum(wc * cot.to(dev)).backward()
            torch.sum(wh * cot).backward()
            r["warp_coords_apart"] = int((wc.detach().cpu() != wh).sum())
            r["warp_vjp_rel_err"] = _rel(dc.grad, dh.grad)
            on_c = wh.detach().to(dev).requires_grad_(True)
            on_h = wh.detach().clone().requires_grad_(True)
            fc, fh = (_surfel_faces(cfg, sides[s], w)
                      for s, w in (("card", on_c), ("cpu", on_h)))
            fc.backward()
            fh.backward()
            fc, fh = float(fc.detach()), float(fh.detach())
            r["faces_rel_err"] = abs(fc - fh) / fh
            r["faces_grad_rel_err"] = _rel(on_c.grad, on_h.grad)
            ok &= (r["warp_vjp_rel_err"] <= 1e-4
                   and r["faces_rel_err"] <= 1e-5
                   and r["faces_grad_rel_err"] <= 1e-4)
            end_to_end = r["warp_coords_apart"] == 0
        else:
            end_to_end = True
        if end_to_end:
            ok &= r["total_rel_err"] <= 1e-5 and r["grad_rel_err"] <= 1e-4
        rec[name] = r

    def fit(side, scale=None):
        st, it, _ = sides[side]
        fr = _to(frames[1], st.graph.points.device)
        with _grad_nudged(scale) if scale else contextlib.nullcontext():
            d, loss = graph_fit(cfg, st.surfels, st.graph, fr, it)
        return d.cpu(), float(loss)

    d_c, l_c = fit("card")
    t0 = time.perf_counter()
    d_h, l_h = fit("cpu")
    cpu_s = time.perf_counter() - t0
    nudged = []
    for side, scale, (d_ref, l_ref) in (
            ("card", NUDGES[0], (d_c, l_c)), ("card", NUDGES[1], (d_c, l_c)),
            ("cpu", NUDGES[0], (d_h, l_h))):
        d_n, l_n = fit(side, scale)
        nudged.append(dict(device=side, scale=scale,
                           deform_max_abs_diff=float(
                               torch.max(torch.abs(d_n - d_ref))),
                           loss_diff=abs(l_n - l_ref)))
    d_spread = max(n["deform_max_abs_diff"] for n in nudged)
    l_spread = max(n["loss_diff"] for n in nudged)
    d_err = float(torch.max(torch.abs(d_c - d_h)))
    emit(dict(phase="semantic_reference", frame1=rec, fit_loss=l_c,
              fit_cpu_loss=l_h, fit_deform_max_abs_err=d_err,
              fit_loss_diff=abs(l_c - l_h), fit_cpu_s=cpu_s, nudged=nudged,
              deform_limit=2 * d_spread, loss_limit=l_spread))
    if not (ok and math.isfinite(l_c) and d_err <= 2 * d_spread
            and abs(l_c - l_h) <= l_spread):
        raise RuntimeError(f"semantic frame 1 disagrees with the CPU path: "
                           f"{rec}, fit {d_err} / {2 * d_spread}, loss "
                           f"{abs(l_c - l_h)} / {l_spread}")


def phase_segsum_semantic(dev, intr, frames):
    """The segment sum against its plain version on the semantic path's
    own sums: frame 1's backward pass at a seeded deformation (the
    G-blocks' anchor rows, 65,536 x 7 into the 384 nodes, and the
    triangle corners), and the soft splat's pixel sums of the render loss
    (4 Np x 4 into H W + 1 pixels, planned at that call).  Returns the
    anchor rows' record."""
    from super_tpu_torch.config import workload_config
    from super_tpu_torch.core.optimizer import _warp_all, autograd_total
    from super_tpu_torch.kernels import segsum
    from super_tpu_torch.render import splat

    cfg = workload_config("semantic")
    (st, it, ctx) = _sides(cfg, intr, frames, dev)["card"]
    calls = []
    real = segsum.segment_sum

    def spy(values, plan, **kw):
        calls.append((values.detach(), plan, kw))
        return real(values, plan, **kw)

    # The kernel's body counts on its module name: these comparison
    # launches count on the spy, not on the path's counter.
    spy.launches = 0
    segsum.segment_sum = spy
    try:
        d = _deform(cfg, dev, SEED).requires_grad_(True)
        autograd_total(cfg, ctx, st.graph, d, it)[0].backward()
        names = {id(ctx.block_plan): "anchor_rows",
                 id(ctx.tri_plan): "triangle_corners"}
        sums = [(names[id(p)], v, p, kw) for v, p, kw in calls]
        calls.clear()
        with torch.no_grad():
            warped = _warp_all(cfg, ctx, d)
            splat.render_soft(warped, ctx.sf_colors, ctx.base.sf_mask, it,
                              cfg.height, cfg.width)
        sums.append(("splat_pixels",) + calls[0])
    finally:
        segsum.segment_sum = real
    recs = {name: _segsum_check("semantic", name, v, p, kw)
            for name, v, p, kw in sums}
    # The splat plans its sum at every evaluation: the sort of its ids.
    plan = sums[-1][2]
    emit(dict(phase="segsum_semantic_plan", sum="splat_pixels",
              rows=plan.ids.shape[0], segments=plan.num_segments,
              plan_ms=cuda_ms(lambda: segsum.segment_plan(
                  plan.ids, plan.num_segments), reps=20),
              sum_ms=recs["splat_pixels"]["ms"]))
    return recs["anchor_rows"]


def phase_repeat_semantic(dev, cfg, intr, frames):
    """Two 3-frame semantic tracks from the same frames: bitwise equal
    surfels, graph and fit loss per frame."""
    from super_tpu_torch.core.tracker import init_tracker, track_step

    def track():
        state = init_tracker(cfg, frames[0])
        losses = []
        for f in frames[1:]:
            state, outs = track_step(cfg, intr, state, f)
            losses.append(outs.lm_cost)
        return state, torch.stack(losses)

    (s1, l1), (s2, l2) = track(), track()
    torch.cuda.synchronize()
    same = dict(surfels=_same(s1.surfels, s2.surfels),
                graph=_same(s1.graph, s2.graph), loss=_same(l1, l2))
    emit(dict(phase="repeat_semantic", frames=len(frames), bitwise=same,
              loss=l1.tolist()))
    if not all(same.values()):
        raise RuntimeError(f"the semantic path does not repeat: {same}")


# The perception nets' tolerances against the CPU path (largest error over
# the output's largest magnitude, TF32 off): the feed-forward nets, and
# the recurrent RAFTs at the JAX package's own RAFT parity tolerance
# (tests/test_raft_parity.py), compared at PERCEPTION_COMPARE_ITERS GRU
# iterations (iterations are depth, not width).
NET_TOL, RAFT_TOL = 1e-4, 1e-3
PERCEPTION_COMPARE_ITERS = 4
PERCEPTION_TIMED_RUNS = 10


def _cudnn(tf32):
    """cuDNN with TF32 convolutions on or off, every other flag as the
    package leaves it (no benchmark search, the default algorithms)."""
    return torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                      deterministic=False, allow_tf32=tf32)


def _device_ops(fn):
    """Device operations (kernels, copies, memsets) one call of ``fn``
    launches, from a torch.profiler trace (utils/profiling.py's, its
    Chrome trace written to a temporary directory)."""
    from super_tpu_torch.utils.profiling import kernel_spans, trace

    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as d:
        with trace(d) as prof:
            fn()
            torch.cuda.synchronize()
    return len(kernel_spans(prof))


def _perception_nets():
    """[(name, model, run(model, left, right, iters), tolerance, published
    GRU iterations or None)] of the nets the slice's paths run."""
    from super_tpu_torch.models.monodepth2 import Monodepth2, predict_depth
    from super_tpu_torch.models.raft_flow import RAFTFlow
    from super_tpu_torch.models.raft_stereo import RAFTStereo
    from super_tpu_torch.models.segmentation import build_seg_model

    def mono(m, a, b, it):
        return predict_depth(m, a, 0.1, 80.0, post_process=True,
                             filter_kernel=5)[1]

    def pair(m, a, b, it):
        return m(a[None], b[None], iters=it)[0]

    def seg(m, a, b, it):
        return m(a[None])[0]

    return [("monodepth2_r18", Monodepth2(18), mono, NET_TOL, None),
            ("raft_stereo", RAFTStereo(32), pair, RAFT_TOL, 32),
            ("deeplabv3plus_r18", build_seg_model("deeplabv3plus", 2), seg,
             NET_TOL, None),
            ("unet_r18", build_seg_model("unet", 2), seg, NET_TOL, None),
            ("raft_flow", RAFTFlow(12), pair, RAFT_TOL, 12)]


def phase_perception(dev, intr):
    """Each perception net at 480 x 640 (seeded random weights, random
    batch-norm statistics) on frames 0 and 1 of the synthetic sequence
    (left and right, or the flow's pair): the card against the CPU path
    with TF32 off (at PERCEPTION_COMPARE_ITERS GRU iterations for the
    RAFTs), a second card run bitwise equal to the first, the TF32 gap,
    and the device time at the published iterations, mean of
    PERCEPTION_TIMED_RUNS runs between CUDA events, TF32 off and on, with
    the device operations of one call."""
    import copy

    from super_tpu_torch.config import workload_config
    from super_tpu_torch.models import init_random

    seq = _sequence(workload_config("lm"), intr, 2)
    left, right = (torch.from_numpy(np.ascontiguousarray(
        seq.colors[t].transpose(2, 0, 1))) for t in (0, 1))
    lc, rc = left.to(dev), right.to(dev)
    recs, bad = [], []
    for i, (name, model, run, tol, iters) in enumerate(_perception_nets()):
        init_random(model, torch.Generator().manual_seed(SEED + i))
        card = copy.deepcopy(model).to(dev)
        cmp_iters = iters and PERCEPTION_COMPARE_ITERS
        with torch.no_grad():
            t0 = time.perf_counter()
            ref = run(model, left, right, cmp_iters)
            cpu_s = time.perf_counter() - t0
            with _cudnn(False):
                out1 = run(card, lc, rc, cmp_iters)
                out2 = run(card, lc, rc, cmp_iters)
                ms = cuda_ms(lambda: run(card, lc, rc, iters),
                             PERCEPTION_TIMED_RUNS)
                ops = _device_ops(lambda: run(card, lc, rc, iters))
            with _cudnn(True):
                out_tf = run(card, lc, rc, cmp_iters)
                ms_tf = cuda_ms(lambda: run(card, lc, rc, iters),
                                PERCEPTION_TIMED_RUNS)
        torch.cuda.synchronize()
        rec = dict(net=name, shape=list(out1.shape), compare_iters=cmp_iters,
                   iters=iters, tol=tol, max_abs_err=float(torch.max(
                       torch.abs(out1.cpu() - ref))),
                   scale=float(torch.max(torch.abs(ref))),
                   rel_err=_rel(out1, ref), tf32_rel_err=_rel(out_tf, ref),
                   bitwise=_same(out1, out2),
                   finite=bool(torch.isfinite(out1).all()), ms=ms,
                   ms_tf32=ms_tf, device_ops=ops, cpu_s=cpu_s)
        emit(dict(phase="perception", **rec))
        recs.append(rec)
        if not (rec["rel_err"] <= tol and rec["bitwise"] and rec["finite"]):
            bad.append(name)
        del model, card
    if bad:
        raise RuntimeError(f"perception nets that fail on the card: {bad}")
    return recs


def _track_with_models(cfg, intr, models, colors, depths=None):
    """The live path on ``colors`` (T, 3, H, W) on the card: each frame's
    inputs from the nets (the depth from ``depths`` where given), then
    preprocess_frame, then init_tracker (frame 0) or track_step (with the
    flow of the previous frame's colour where ``models`` has a flow net),
    the nets, the preprocessing and the step under CUDA's sync debug mode
    "error": a host sync fails the run.  (the state after each frame,
    per-frame step outputs as numpy, net + preprocess ms, step ms,
    frames)."""
    from super_tpu_torch.convert import to_numpy
    from super_tpu_torch.core.preprocess import preprocess_frame
    from super_tpu_torch.core.tracker import init_tracker, track_step
    from super_tpu_torch.factory import predict_frame_inputs

    state, prev = None, None
    states, outs, net_ms, step_ms, frames = [], [], [], [], []
    for t in range(len(colors)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            pred = predict_frame_inputs(cfg, models, colors[t])
            frame = preprocess_frame(
                cfg, intr, pred["depth"] if depths is None else depths[t],
                colors[t], float(t), seg=pred.get("seg"),
                seg_conf=pred.get("seg_conf"), device="cuda")
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        if state is None:
            state = init_tracker(cfg, frame)
        else:
            torch.cuda.set_sync_debug_mode("error")
            try:
                state, o = track_step(
                    cfg, intr, state, frame, models=models,
                    prev_color=prev if models.flow_model is not None
                    else None)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            outs.append(to_numpy(o))
        torch.cuda.synchronize()
        net_ms.append((t1 - t0) * 1e3)
        step_ms.append((time.perf_counter() - t1) * 1e3)
        prev = frame.color_image
        frames.append(frame)
        states.append(state)
    return states, outs, net_ms, step_ms, frames


def _colors(cfg, intr, n, dev):
    seq = _sequence(cfg, intr, n)
    return torch.as_tensor(np.ascontiguousarray(
        seq.colors[:n].transpose(0, 3, 1, 2)), device=dev), seq


def phase_e2e_depth(dev, intr):
    """This slice's main path, the live path of the root bench's
    e2e_depth_hz (``workload_config("e2e_depth")``): PATH_FRAMES tracked
    frames, each frame's depth from monodepth2 (seeded random weights,
    flip post-processing), with the launch counts zeroed just before and
    read just after: K1 and ``data_gram`` once an LM trip, the segment sum
    SEGSUM_PER_TRIP times a trip and once at frame 0.  Costs finite,
    surfels alive, frame 1's depth against the CPU path's, and a second
    track bitwise equal.  Returns the launches."""
    from super_tpu_torch.config import workload_config
    from super_tpu_torch.factory import build_models, predict_frame_inputs

    cfg = workload_config("e2e_depth")
    models = build_models(cfg, seed=SEED, device=dev)
    colors, _ = _colors(cfg, intr, PATH_FRAMES + 1, dev)
    wrappers = _launch_counts()
    for w in wrappers.values():
        w.launches = 0
    states, outs, net_ms, step_ms, frames = _track_with_models(
        cfg, intr, models, colors)
    launches = {k: w.launches for k, w in wrappers.items()}
    trips = cfg.solver.num_iterations * PATH_FRAMES
    want = {k: 0 for k in wrappers}
    want.update(pairs_cg=trips, data_gram=trips,
                segment_sum=SEGSUM_PER_TRIP * trips + SEGSUM_AT_INIT)
    states2, _, _, _, frames2 = _track_with_models(cfg, intr, models,
                                                   colors)
    state, state2 = states[-1], states2[-1]
    cpu = build_models(cfg, seed=SEED, device="cpu")
    with torch.no_grad():
        depth_cpu = predict_frame_inputs(cfg, cpu, colors[1].cpu())["depth"]
        depth_card = predict_frame_inputs(cfg, models, colors[1])["depth"]
    depth_rel = _rel(depth_card, depth_cpu)
    bitwise = dict(surfels=_same(state.surfels, state2.surfels),
                   graph=_same(state.graph, state2.graph),
                   frames=all(_same(a, b) for a, b in zip(frames, frames2)))
    costs = [float(o.lm_cost) for o in outs]
    surfels = [int(o.num_surfels) for o in outs]
    ok = (launches == want and all(math.isfinite(c) for c in costs)
          and all(n > 0 for n in surfels) and depth_rel <= NET_TOL
          and all(bitwise.values()))
    emit(dict(phase="e2e_depth", height=cfg.height, width=cfg.width,
              frames=PATH_FRAMES, launches=launches,
              launches_per_frame={k: v / PATH_FRAMES
                                  for k, v in launches.items() if v},
              lm_cost=costs, num_surfels=surfels,
              num_nodes=[int(o.num_nodes) for o in outs],
              net_preprocess_ms=net_ms, step_ms=step_ms,
              depth_frame1=dict(rel_err=depth_rel, tol=NET_TOL,
                                min=float(depth_card.min()),
                                max=float(depth_card.max())),
              bitwise=bitwise))
    if not ok:
        raise RuntimeError(f"e2e_depth path check failed (launches "
                           f"{launches}, want {want}; costs {costs}; "
                           f"depth {depth_rel}; bitwise {bitwise})")
    return launches


def _semantic_models_config(match_renderimg=False):
    from super_tpu_torch.config import workload_config

    cfg = workload_config("semantic").replace(seg_model="deeplabv3plus")
    return cfg.replace(losses=dataclasses.replace(
        cfg.losses, sf_corr=True, sf_corr_match_renderimg=match_renderimg))


def phase_semantic_models(dev, intr):
    """The semantic workload with its models: DeepLabV3+ segmentations in
    place of the given ones and the sf_corr term with RAFT's flow from the
    previous frame's colour (seeded random weights), PATH_FRAMES tracked
    frames of the generator's depths: the segment sum SEGSUM_PER_FIT_STEP
    times a fit step and once at frame 0, no other kernel; every fit loss
    finite; the corr face nonzero on every tracked frame; a repeat bitwise
    equal; then one frame with the flow re-inferred from the render
    (``sf_corr_match_renderimg``)."""
    from super_tpu_torch.core.optimizer import autograd_total, \
        prepare_autograd
    from super_tpu_torch.factory import build_models

    cfg = _semantic_models_config()
    models = build_models(cfg, seed=SEED, device=dev)
    colors, seq = _colors(cfg, intr, PATH_FRAMES + 1, dev)
    depths = torch.as_tensor(seq.depths[:PATH_FRAMES + 1], device=dev)
    wrappers = _launch_counts()
    for w in wrappers.values():
        w.launches = 0
    states, outs, net_ms, step_ms, frames = _track_with_models(
        cfg, intr, models, colors, depths=depths)
    launches = {k: w.launches for k, w in wrappers.items()}
    want = {k: 0 for k in wrappers}
    want["segment_sum"] = (SEGSUM_PER_FIT_STEP * cfg.solver.num_iterations
                           * PATH_FRAMES + SEGSUM_AT_INIT)
    states2, outs2, _, _, _ = _track_with_models(cfg, intr, models, colors,
                                                 depths=depths)
    state, state2 = states[-1], states2[-1]
    bitwise = dict(surfels=_same(state.surfels, state2.surfels),
                   graph=_same(state.graph, state2.graph),
                   loss=[float(a.lm_cost) for a in outs]
                   == [float(b.lm_cost) for b in outs2])
    # The faces at the identity of each tracked frame's fit, from the
    # state before it.
    corr = []
    ident = _deform(cfg, dev)
    with torch.no_grad():
        for t in range(1, len(frames)):
            st = states[t - 1]
            flow = models.flow_model(frames[t - 1].color_image[None],
                                     frames[t].color_image[None])[0]
            ctx = prepare_autograd(cfg, st.surfels, st.graph, frames[t],
                                   flow=flow, intr=intr)
            parts = autograd_total(cfg, ctx, st.graph, ident, intr)[1]
            corr.append({k: float(v) for k, v in parts.items()})
    mcfg = _semantic_models_config(match_renderimg=True)
    _, mouts, _, mstep_ms, _ = _track_with_models(
        mcfg, intr, models, colors[:2], depths=depths[:2])
    costs = [float(o.lm_cost) for o in outs]
    ok = (launches == want and all(math.isfinite(c) for c in costs)
          and all(int(o.num_surfels) > 0 for o in outs)
          and all(p["corr"] > 0 and all(map(math.isfinite, p.values()))
                  for p in corr)
          and all(bitwise.values())
          and math.isfinite(float(mouts[0].lm_cost)))
    emit(dict(phase="semantic_models", frames=PATH_FRAMES,
              launches=launches, fit_loss=costs,
              num_surfels=[int(o.num_surfels) for o in outs],
              faces_at_identity=corr, net_preprocess_ms=net_ms,
              step_ms=step_ms, bitwise=bitwise,
              match_renderimg=dict(fit_loss=float(mouts[0].lm_cost),
                                   step_ms=mstep_ms[1])))
    if not ok:
        raise RuntimeError(f"semantic_models path check failed (launches "
                           f"{launches}, want {want}; losses {costs}; "
                           f"corr {corr}; bitwise {bitwise})")
    return launches


# The JAX README's accuracy table (480 x 640, 30 synthetic frames, 20
# points), recorded by the JAX package: a reference beside the port's
# numbers, not a gate.
JAX_README_PX = {"lm": 0.37, "per_iteration": 2.92,
                 "per_iteration_frozen": 0.57, "semantic": 15.4}


def _pipeline_run(name, cfg, seq, dev, intr, seed=SEED, scale=None,
                  limit=0.75):
    """SuPerPipeline over ``seq``'s PIPELINE_FRAMES frames with its GT
    points (and its segmentations on the semantic method; every tuple Gram
    scaled by ``scale`` where given): the summary's record, and whether it
    tracks (a finite mean reprojection error below ``limit`` times the
    static error of the same GT, no tracking at all, with more than 60% of
    the point-frames valid: tests/test_pipeline.py's criterion at 0.75,
    tests/test_semantic.py's at 1)."""
    from super_tpu_torch.pipeline import SuPerPipeline

    n = PIPELINE_FRAMES
    gt = seq.gt_xy[:n]
    static = float(np.mean([np.linalg.norm(gt[t] - gt[0], axis=1).mean()
                            for t in range(1, n)]))
    segs = {}
    if cfg.method == "semantic-super":
        segs = dict(segs=seq.segs[:n], seg_confs=seq.seg_confs[:n])
    t0 = time.perf_counter()
    with _gram_scaled(scale) if scale else contextlib.nullcontext():
        m = SuPerPipeline(cfg, intr, device=dev).run(
            seq.depths[:n], seq.colors[:n], gt_xy=gt,
            gt_valid=seq.gt_valid[:n], **segs)
    tracks = (math.isfinite(m["reproj_mean"]) and m["frac_valid"] > 0.6
              and m["reproj_mean"] < limit * static)
    sol = cfg.solver
    rec = dict(phase="pipeline", run=name, seed=seed, gram_scale=scale,
               frames=n, association=sol.association,
               linear_solver=(sol.linear_solver if sol.use_derived_gradient
                              else f"autograd {sol.optimizer}"),
               reproj_mean=m["reproj_mean"], reproj_std=m["reproj_std"],
               frac_valid=m["frac_valid"], p50_frame_ms=m["p50_frame_ms"],
               mean_frame_ms=m["mean_frame_ms"],
               num_surfels=m["num_surfels"], num_nodes=m["num_nodes"],
               overflow={k: v for k, v in m.items()
                         if k.startswith("overflow_")},
               static_error=static, limit=limit, tracks=tracks,
               jax_readme_px=JAX_README_PX.get(name),
               seconds=time.perf_counter() - t0)
    emit(rec)
    return rec, tracks


def _semantic_runs():
    """The semantic configurations of the pipeline phase at 480 x 640, with
    the semantic workload's capacities: (name, config, gated)."""
    from super_tpu_torch.config import semantic_super_config, \
        workload_config

    bench = workload_config("semantic")
    # tests/test_semantic.py's configuration: the bench's with the render
    # loss, on superv2 data.
    render = bench.replace(data="superv2", losses=dataclasses.replace(
        bench.losses, render_loss=True))
    ssc = semantic_super_config(
        num_classes=SEMANTIC_CLASSES, load_seg=True, height=bench.height,
        width=bench.width, mesh_step_size=bench.mesh_step_size,
        capacity=bench.capacity)
    return [("semantic", bench, True), ("semantic_render", render, False),
            ("semantic_super_config", ssc, False)]


def phase_pipeline(dev, intr, sequences):
    """SuPerPipeline on PIPELINE_FRAMES synthetic 480 x 640 frames with the
    20 GT points, for the headline, the dense graph, pcg_pallas, the
    per-iteration association and the headline with the per-iteration-
    frozen association; each must track (:func:`_pipeline_run`).  Then
    the witnesses of the per-iteration path's spread: the same run with
    every tuple Gram nudged (:data:`NUDGES`), and the headline and the
    per-iteration path on the other draws of the GT points
    (``sequences``: {seed: future of the sequence}); each must track
    too.  Last the semantic configurations (:func:`_semantic_runs`): the
    bench's must track by tests/test_semantic.py's criterion, the other
    two are recorded beside it."""
    from super_tpu_torch.config import workload_config

    lm = workload_config("lm")
    per_it = workload_config("per_iteration")
    runs = [(name, workload_config(name), SEED, None) for name in
            ("lm", "dense16", "pcg_pallas", "per_iteration")]
    runs.append(("per_iteration_frozen", lm.replace(
        solver=dataclasses.replace(lm.solver,
                                   association="per_iteration_frozen")),
        SEED, None))
    runs += [("per_iteration", per_it, SEED, scale) for scale in NUDGES]
    for seed in sequences:
        runs += [("lm", lm, seed, None), ("per_iteration", per_it, seed, None)]
    results, bad = [], []
    for name, cfg, seed, scale in runs:
        if seed in sequences:
            _SEQUENCES[(480, 640, seed)] = sequences[seed].result()
        rec, ok = _pipeline_run(name, cfg, _sequence(lm, intr, PIPELINE_FRAMES,
                                                     seed),
                                dev, intr, seed=seed, scale=scale)
        results.append(rec)
        if not ok:
            bad.append((name, seed, scale))
    for name, cfg, gated in _semantic_runs():
        rec, ok = _pipeline_run(name, cfg, _sequence(lm, intr,
                                                     PIPELINE_FRAMES),
                                dev, intr, limit=1.0)
        results.append(rec)
        if gated and not ok:
            bad.append((name, SEED, None))
    spread = {}
    for name in ("lm", "per_iteration"):
        px = [r["reproj_mean"] for r in results if r["run"] == name]
        spread[name] = dict(runs=len(px), min=min(px), max=max(px),
                            jax_readme_px=JAX_README_PX[name])
    emit(dict(phase="pipeline_spread", **spread))
    if bad:
        raise RuntimeError(f"pipeline runs that do not track: {bad}")
    return results


def phase_bench(dev):
    """python -m super_tpu_torch.bench's measurement at 6 frames, with the
    headline's cold start, and its ``--mode lm`` rate at 6 solves
    (``lm_solves_hz``)."""
    from super_tpu_torch import bench
    from super_tpu_torch.config import workload_config

    out = bench.measure(reps=6, device=dev)
    out["lm_solves_hz"] = round(bench.measure_lm(workload_config("lm"), 6,
                                                 dev), 3)
    print(json.dumps(out), flush=True)
    if not (out["cold_start_hz"] > 0 and out["lm_solves_hz"] > 0):
        raise RuntimeError(f"bench: {out}")
    return out


# ---------------------------------------------------------------------------
# Streams and devices: the stream batch, the surfel-sharded solve over a
# process group, the ('stream', 'shard') mesh.

STREAMS = 4                        # concurrent streams of the streams phase
STREAM_FRAMES = 6                  # frames of each (frame 0 initialises)
SHARD_FRAMES = 3                   # tracked frames of the sharded step
MESH_FRAMES = 4                    # frames of each stream_mesh stream
PARALLEL_TIMEOUT = 600             # s the two spawned processes may take
# The sharded assembly against one process (tests/test_parallel.py's
# tolerances): jtj and jtr within ASSEMBLY_TOL of their largest magnitude,
# the cost within rtol 1e-5.  With bf16 pair sums each shard rounds its
# part of the tuple that the slice edge cuts to bf16 apart: that tuple's
# blocks then differ by a few bf16 rounding steps, 2^-6 of the largest
# entry at most.
ASSEMBLY_TOL = {"f32": 2e-5, "bf16": 2.0 ** -6}


def _window_frames(cfg, intr, seq, window, dev):
    """The frames of one stream: a time window of ``seq``, timed from 0."""
    from super_tpu_torch.core.preprocess import preprocess_frame

    colors = np.ascontiguousarray(seq.colors[window].transpose(0, 3, 1, 2))
    return [preprocess_frame(cfg, intr, d, c, float(t), device=dev)
            for t, (d, c) in enumerate(zip(seq.depths[window], colors))]


def _np_same(a, b):
    """Bitwise equal numpy trees (NaN where the other is NaN)."""
    from super_tpu_torch.utils.tree import leaves

    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(
        np.array_equal(np.asarray(x), np.asarray(y), equal_nan=np.asarray(
            x).dtype.kind == "f") for x, y in zip(la, lb))


def _digests(state):
    """sha256 of each surfel and graph tensor of a state, in field order."""
    import hashlib

    from super_tpu_torch.utils.tree import leaves

    return [hashlib.sha256(x.detach().cpu().numpy().tobytes()).hexdigest()
            for x in leaves(state.surfels) + leaves(state.graph)]


def phase_streams(dev, cfg, intr):
    """STREAMS streams at 480 x 640 through MultiStreamPipeline (the stream
    batch: make_batched_step), STREAM_FRAMES frames each with the GT
    points: four time windows of the synthetic sequence.  Each stream's
    outputs per frame and final surfels and graph bitwise its
    single-stream track (``_track``); stream 0 bitwise SuPerPipeline on
    the same frames, tracked points included; the four maps different;
    the launches four streams' (counts zeroed just before the run);
    timings beside the single stream's."""
    from super_tpu_torch.convert import to_numpy
    from super_tpu_torch.parallel.streams import MultiStreamPipeline
    from super_tpu_torch.pipeline import SuPerPipeline
    from super_tpu_torch.utils.tree import tree_map

    seq = _sequence(cfg, intr, STREAMS * STREAM_FRAMES)
    wins = [slice(s * STREAM_FRAMES, (s + 1) * STREAM_FRAMES)
            for s in range(STREAMS)]
    data = {k: np.stack([getattr(seq, k)[w] for w in wins])
            for k in ("depths", "colors", "gt_xy", "gt_valid")}
    single = SuPerPipeline(cfg, intr, device=dev)
    single_m = single.run(data["depths"][0], data["colors"][0],
                          gt_xy=data["gt_xy"][0], gt_valid=data["gt_valid"][0])

    wrappers = _launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
    pipe = MultiStreamPipeline(cfg, intr, device=dev)
    m = pipe.run(**data)
    launches = {k: w.launches for k, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()

    tracks = [_track(cfg, intr, _window_frames(cfg, intr, seq, w, dev))
              for w in wins]
    same = {}
    for s, (state, outs, _) in enumerate(tracks):
        mine = tree_map(lambda x, s=s: x[s], pipe.states)
        same[f"stream{s}_outputs"] = all(
            _np_same(to_numpy(tree_map(lambda x, s=s: x[s], o)), want)
            for o, want in zip(pipe.outputs, outs))
        same[f"stream{s}_state"] = (_same(mine.surfels, state.surfels)
                                    and _same(mine.graph, state.graph))
    mine = tree_map(lambda x: x[0], pipe.states)
    same["stream0_pipeline"] = (_same(mine.surfels, single.state.surfels)
                                and _same(mine.graph, single.state.graph)
                                and _same(mine.track, single.state.track))
    points = pipe.states.surfels.points
    differ = all(not torch.equal(points[a], points[b])
                 for a in range(STREAMS) for b in range(a + 1, STREAMS))
    trips = cfg.solver.num_iterations * (STREAM_FRAMES - 1) * STREAMS
    want = {k: 0 for k in wrappers}
    want.update(pairs_cg=trips, data_gram=trips,
                segment_sum=STREAMS * SEGSUM_AT_INIT
                + SEGSUM_PER_TRIP * trips)
    out = dict(phase="streams", streams=STREAMS, frames=STREAM_FRAMES,
               height=cfg.height, width=cfg.width, launches=launches,
               bitwise=same, streams_differ=differ,
               p50_batch_ms=m["p50_batch_ms"],
               aggregate_fps=m["aggregate_fps"],
               per_stream_fps=m["aggregate_fps"] / STREAMS,
               single_p50_frame_ms=single_m["p50_frame_ms"],
               single_fps=single_m["fps"],
               batch_over_single=m["p50_batch_ms"]
               / single_m["p50_frame_ms"],
               reproj_mean=m["reproj_mean"],
               reproj_mean_worst_stream=m["reproj_mean_worst_stream"],
               reproj_per_stream=pipe.stream_means(),
               single_reproj_mean=single_m["reproj_mean"],
               peak_mem_gb=peak / 1e9,
               batch_ms=[t * 1e3 for t in pipe.frame_times],
               single_ms=[t * 1e3 for t in single.frame_times])
    emit(out)
    if not (all(same.values()) and differ and launches == want
            and math.isfinite(m["reproj_mean"])):
        raise RuntimeError(f"streams check failed (launches want {want})")
    return launches


def _parallel_child(rank, world, store, cfg, depths, colors, out_dir,
                    device_type):
    """One of the two processes of phase_parallel, on cuda:0 (with
    ``device_type`` "cuda"): the sharded checks on mesh ('stream' 1,
    'shard' 2), then its stream on mesh ('stream' 2, 'shard' 1); results
    pickled to ``out_dir``."""
    import pickle

    import torch.distributed as dist

    from super_tpu_torch.data.synthetic import default_intrinsics
    from super_tpu_torch.kernels import build
    from super_tpu_torch.parallel import multihost

    dev = torch.device(device_type)
    if dev.type == "cuda":
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
    missing = [n for n in SOURCES if not build.library_path(n).exists()]
    if missing:   # phase_build built them; a child must not compile
        raise RuntimeError(f"rank {rank}: kernels not built: {missing}")
    import super_tpu_torch  # noqa: F401  (TF32 off)

    multihost.initialize("gloo", init_method=f"file://{store}",
                         world_size=world, rank=rank)
    try:
        intr = default_intrinsics(cfg.height, cfg.width, device=dev)
        seq = types.SimpleNamespace(depths=depths, colors=colors)
        res = dict(sharded=_child_sharded(rank, cfg, intr, seq, dev),
                   stream_mesh=_child_stream_mesh(cfg, intr, seq, dev))
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


@contextlib.contextmanager
def _stderr_lines():
    """The lines written to file descriptor 2 (by any thread, C++ warnings
    included) while the context is open, in the list it yields."""
    lines = []
    sys.stderr.flush()
    saved = os.dup(2)
    with tempfile.TemporaryFile(mode="w+") as f:
        os.dup2(f.fileno(), 2)
        try:
            yield lines
        finally:
            sys.stderr.flush()
            os.dup2(saved, 2)
            os.close(saved)
            f.seek(0)
            lines += f.read().splitlines()


def _child_sharded(rank, cfg, intr, seq, dev):
    import hashlib

    from super_tpu_torch.convert import to_numpy
    from super_tpu_torch.core import losses
    from super_tpu_torch.core.lm import lm_solve
    from super_tpu_torch.core.losses import assemble_normal_equations, \
        associate, prepare_lm, total_cost
    from super_tpu_torch.core.tracker import init_tracker
    from super_tpu_torch.kernels.gram import data_gram
    from super_tpu_torch.parallel.mesh import make_mesh
    from super_tpu_torch.parallel.sharded import shard_ctx, \
        track_step_sharded

    mesh = make_mesh(num_streams=1, num_shards=2, device_type=dev.type)
    group = mesh.get_group("shard")
    out = dict(mesh=mesh.mesh.tolist(), coordinate=list(
        mesh.get_coordinate()))
    frames = _window_frames(cfg, intr, seq, slice(0, SHARD_FRAMES + 1), dev)
    state0 = init_tracker(cfg, frames[0])
    j = cfg.capacity.node_capacity
    ident = torch.zeros((j, 7), device=dev)
    ident[:, 0] = 1.0
    # Frame 1's assembly, with the headline's bf16 pair sums and in f32.
    for sums in ("bf16", "f32"):
        c = cfg.replace(solver=dataclasses.replace(
            cfg.solver, gram_sum_dtype=sums))
        ctx = prepare_lm(c, state0.surfels, state0.graph, frames[1])
        local = shard_ctx(ctx, rank, 2)
        assoc, assoc_l = associate(c, ctx, intr), associate(c, local, intr)
        for name, beta in (("identity", ident),
                           ("perturbed", _perturbed_beta(c, dev))):
            a = assemble_normal_equations(c, ctx, beta, intr, assoc)
            b = assemble_normal_equations(c, local, beta, intr, assoc_l,
                                          group=group)
            out[f"assembly_{sums}_{name}"] = dict(
                jtj_err=_rel(b[0], a[0]), jtr_err=_rel(b[1], a[1]),
                cost_rel=abs(float(b[2]) / float(a[2]) - 1))
    # K2 on the slice: the shard's partial tuple Grams sum to the whole.
    w = cfg.losses.sf_point_plane_weight
    g = cfg.solver.assembly_pad_group
    whole = data_gram(ctx, ident, w, assoc, block=g)
    part = losses.all_reduce_sum(
        data_gram(local, ident, w, assoc_l, block=g), group)
    out["k2_slice"] = dict(slots=local.sf_mask.shape[0],
                           blocks=local.layout.block_tuple.shape[0],
                           gram_err=_rel(part[0], whole[0]),
                           jtr_err=_rel(part[1], whole[1]),
                           cost_rel=abs(float(part[2]) / float(whole[2]) - 1))
    # The LM solve of frame 2 (tests/test_parallel.py:87's checks).
    ctx = prepare_lm(cfg, state0.surfels, state0.graph, frames[2])
    ref = lm_solve(cfg, ctx, intr)
    sh = lm_solve(cfg, shard_ctx(ctx, rank, 2), intr, group=group)
    out["lm"] = dict(
        ref_cost=float(ref.cost), cost=float(sh.cost),
        cost_of_sharded_beta=float(total_cost(
            cfg, ctx, sh.beta, intr, associate(cfg, ctx, intr))),
        beta_err=_rel(sh.beta, ref.beta),
        ref_trans=float(torch.max(torch.abs(ref.beta[:, 4:]))),
        beta_sha=hashlib.sha256(sh.beta.cpu().numpy().tobytes()).hexdigest())
    # SHARD_FRAMES tracked frames, launches counted, every all-reduce
    # counted, and the syncs that CUDA's sync debug mode "warn" flags: in
    # this thread as Python warnings (by the file and line that called the
    # op), in other threads as lines on the process's standard error.
    calls = [0]
    reduce = losses.all_reduce_sum

    def counted(tensors, grp):
        calls[0] += 1
        return reduce(tensors, grp)

    wrappers = _launch_counts()
    state, outs, times, syncs, eager = state0, [], [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses.all_reduce_sum = counted
    for wr in wrappers.values():
        wr.launches = 0
    try:
        for f in frames[1:]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with _syncs_flagged() as flagged:
                state, o = track_step_sharded(cfg, intr, 2, state, f,
                                              group=group)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            syncs.append(flagged)
            outs.append(to_numpy(o))
            eager.append((state, o))
    finally:
        losses.all_reduce_sum = reduce
    out.update(track=outs, track_ms=times, syncs=syncs,
               all_reduces=calls[0],
               launches={k: wr.launches for k, wr in wrappers.items()},
               track_digests=_digests(state),
               peak_gb_eager=torch.cuda.max_memory_allocated() / 1e9)
    out["captured"] = _sharded_captured(cfg, intr, mesh, group, state0,
                                        frames[1:], eager)
    del eager
    # One trip's all-reduce alone: the pair-form jtj, jtr and cost packed
    # into one buffer, between CUDA events and on the host clock.
    p = cfg.solver.assembly_pair_cap
    bufs = (torch.ones((p, 49), device=dev), torch.ones((7 * j,), device=dev),
            torch.ones((), device=dev))
    for _ in range(3):
        losses.all_reduce_sum(bufs, group)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    reps = 20
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        losses.all_reduce_sum(bufs, group)
    end.record()
    end.synchronize()
    out["all_reduce"] = dict(bytes=4 * (49 * p + 7 * j + 1),
                             events_ms=start.elapsed_time(end) / reps,
                             host_ms=(time.perf_counter() - t0) * 1e3 / reps)
    return out


@contextlib.contextmanager
def _syncs_flagged():
    """The syncs that CUDA's sync debug mode "warn" flags in the block, in
    the dict it yields: ``this_thread`` a warning each, counted in
    ``sites`` by the innermost line of this checkout on the stack that
    made the op (beside the line of the library that made it),
    ``other_threads`` the warnings that other threads print on the
    standard error."""
    import traceback
    import warnings

    root = os.path.dirname(os.path.abspath(__file__))
    sites = {}

    def show(message, category, filename, lineno, file=None, line=None):
        # (Not the mode's own one-time "prototype feature" notice.)
        if "synchronizing CUDA operation" not in str(message):
            return
        mine = [f for f in traceback.extract_stack()[:-1]
                if f.filename.startswith(root)]
        site = (f"{os.path.relpath(mine[-1].filename, root)}:"
                f"{mine[-1].lineno}" if mine else "?") + \
            f" ({os.path.basename(filename)}:{lineno})"
        sites[site] = sites.get(site, 0) + 1

    flagged = {}
    with warnings.catch_warnings(), _stderr_lines() as lines:
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield flagged
        finally:
            torch.cuda.set_sync_debug_mode("default")
    flagged.update(this_thread=sum(sites.values()), sites=sites)
    flagged["other_threads"] = sum("synchronizing CUDA operation" in ln
                                   for ln in lines)


def _sharded_captured(cfg, intr, mesh, group, state0, frames, eager):
    """make_multichip_step on the ('stream' 1, 'shard' 2) mesh: graphs cut
    at the all-reduces (core/compiled.py:CutGraph).  The first call (the
    eager warm-up and the capture) on ``frames[0]`` from ``state0``, a
    replay a frame after it, and ``frames[0]`` from ``state0`` again as a
    replay: each frame bitwise the eager track_step_sharded frame of
    ``eager`` ((state, outputs) each).  The replays' launches by counter,
    graph launches and all-reduces by the cut graph's counts, syncs
    flagged; eager and captured ms in turns; capture ms, peak memory; one
    classic-schedule frame the same way."""
    from super_tpu_torch.convert import to_numpy
    from super_tpu_torch.core import losses
    from super_tpu_torch.core.compiled import CutGraph
    from super_tpu_torch.parallel.sharded import make_multichip_step, \
        track_step_sharded
    from super_tpu_torch.utils.tree import stack, unstack

    def call(step, state, frame):
        states, outs = step(stack([state]), stack([frame]))
        return unstack(states)[0], unstack(outs)[0]

    step = make_multichip_step(cfg, intr, mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    got = [call(step, state0, frames[0])]
    torch.cuda.synchronize()
    capture_ms = (time.perf_counter() - t0) * 1e3
    graph = step.graph
    wrappers = _zero_counts()
    launches0, reduces0 = graph.launches, graph.reduces
    syncs = []
    for f in frames[1:] + frames[:1]:
        state = got[-1][0] if len(got) < len(frames) else state0
        with _syncs_flagged() as flagged:
            got.append(call(step, state, f))
        torch.cuda.synchronize()
        syncs.append(flagged)
    replays = len(frames)
    launches = _counts(wrappers)
    graph_launches = (graph.launches - launches0) / replays
    all_reduces = (graph.reduces - reduces0) / replays
    peak = torch.cuda.max_memory_allocated()
    want = eager + eager[:1]
    bitwise = [_bits(g, w) for g, w in zip(got, want)]

    # The all-reduce alone as a replay runs it: the pair-form sums in a
    # pinned host buffer, through gloo.
    p = cfg.solver.assembly_pair_cap
    host = torch.ones(49 * p + 7 * cfg.capacity.node_capacity + 1,
                      pin_memory=True)
    for _ in range(3):
        losses.reduce_host(host, group)
    t0 = time.perf_counter()
    for _ in range(20):
        losses.reduce_host(host, group)
    reduce_ms = (time.perf_counter() - t0) * 1e3 / 20

    def eager_one():
        track_step_sharded(cfg, intr, 2, state0, frames[0], group=group)

    def graph_one():
        call(step, state0, frames[0])

    turns = {"eager": [], "graph": []}
    for _ in range(GRAPH_TURNS):
        for kind, one in (("eager", eager_one), ("graph", graph_one)):
            turns[kind].append(_ms(one))
    # A replay and an eager frame traced: this process's kernels (the
    # other process's share the card meanwhile).
    trace = {}
    for kind, one in (("graph", graph_one), ("eager", eager_one)):
        by, n, device_ms, window_ms = _trace_counts(one)
        trace[kind] = dict(launches=by, kernels=n, device_ms=device_ms,
                           window_ms=window_ms, busy=device_ms / window_ms)

    # One classic-schedule frame: the eager step, then the step's first
    # call and a replay on the same frame.
    classic = cfg.replace(solver=dataclasses.replace(
        cfg.solver, lm_schedule="classic"))
    want_c = track_step_sharded(classic, intr, 2, state0, frames[0],
                                group=group)
    cstep = make_multichip_step(classic, intr, mesh)
    first_c = call(cstep, state0, frames[0])
    r0 = cstep.graph.reduces
    replay_c = call(cstep, state0, frames[0])
    torch.cuda.synchronize()
    return dict(
        cut_graph=isinstance(graph, CutGraph), segments=graph.segments,
        frames_bitwise=bitwise, replays=replays, launches=launches,
        launches_per_replay={k: v / replays for k, v in launches.items()},
        graph_launches_per_replay=graph_launches,
        all_reduces_per_replay=all_reduces,
        syncs=syncs, capture_ms=capture_ms, peak_gb=peak / 1e9,
        ms_eager=turns["eager"], ms_graph=turns["graph"],
        host_reduce_ms=reduce_ms, trace=trace,
        digests=_digests(got[-2][0]),
        outs=[to_numpy(o) for _, o in got],
        classic=dict(cut_graph=isinstance(cstep.graph, CutGraph),
                     segments=cstep.graph.segments,
                     all_reduces_per_replay=cstep.graph.reduces - r0,
                     first_bitwise=_bits(first_c, want_c),
                     replay_bitwise=_bits(replay_c, want_c)))


def _child_stream_mesh(cfg, intr, seq, dev):
    """This rank's stream on mesh ('stream' 2, 'shard' 1) through
    make_multichip_step (one CUDA graph: the first call the warm-up and
    the capture, a replay a frame after it; the replays' launches
    counted), then both streams through MultiStreamPipeline(mesh=)."""
    from super_tpu_torch.convert import to_numpy
    from super_tpu_torch.core.compiled import CudaGraph
    from super_tpu_torch.core.tracker import init_tracker
    from super_tpu_torch.parallel import multihost
    from super_tpu_torch.parallel.mesh import make_mesh
    from super_tpu_torch.parallel.sharded import make_multichip_step
    from super_tpu_torch.parallel.streams import MultiStreamPipeline
    from super_tpu_torch.utils.tree import stack, tree_map

    mesh = make_mesh(device_type=dev.type)     # ('stream' 2, 'shard' 1)
    s = range(2)[multihost.stream_block(mesh, 2)][0]
    wins = [slice(w * MESH_FRAMES, (w + 1) * MESH_FRAMES) for w in range(2)]
    frames = _window_frames(cfg, intr, seq, wins[s], dev)
    # Host-local streams placed on the device, as a multi-host run does.
    states = multihost.shard_stream_batch(mesh, to_numpy(stack(
        [init_tracker(cfg, frames[0])])))
    step = make_multichip_step(cfg, intr, mesh)
    outs = []
    for t, f in enumerate(frames[1:]):
        if t == 1:          # the replays' launches
            wrappers = _zero_counts()
        fb = multihost.shard_stream_batch(mesh, to_numpy(stack([f])))
        states, o = step(states, fb)
        outs.append(to_numpy(tree_map(lambda x: x[0], o)))
    launches = _counts(wrappers)
    digests = _digests(tree_map(lambda x: x[0], states))
    pipe = MultiStreamPipeline(cfg, intr, mesh=mesh, device=dev)
    m = pipe.run(np.stack([seq.depths[w] for w in wins]),
                 np.stack([seq.colors[w] for w in wins]))
    return dict(mesh=mesh.mesh.tolist(),
                coordinate=list(mesh.get_coordinate()), stream=s, outs=outs,
                launches=launches, replays=len(frames) - 2,
                one_graph=step.captured and isinstance(step.graph,
                                                       CudaGraph),
                digests=digests, pipe_loop=pipe.loop,
                pipe_digests=_digests(tree_map(lambda x: x[0],
                                               pipe.states)),
                pipe_batch_ms=m["p50_batch_ms"])


def phase_parallel(dev, cfg, intr):
    """Two processes on cuda:0 (gloo: NCCL refuses two ranks on one
    device), started here with torch.multiprocessing's spawn; each loads
    the kernels phase_build built.  ``sharded``: mesh ('stream' 1, 'shard'
    2) on the headline, Np = 720,896 slots in two slices; frame 1's
    assembly and K2's partial Grams against one process, frame 2's LM
    solve, SHARD_FRAMES frames of track_step_sharded against this
    process's single track, both ranks bitwise equal, each rank's launches
    one process's; then make_multichip_step captured on the same frames
    (:func:`_sharded_captured`).  ``stream_mesh``: mesh ('stream' 2,
    'shard' 1), each rank's stream through shard_stream_batch and
    make_multichip_step (one CUDA graph), bitwise the single-stream track
    run here, and MultiStreamPipeline(mesh=) on both streams.  Returns
    the captured replays' launches of each."""
    import pickle

    import torch.multiprocessing as tmp

    seq = _sequence(cfg, intr, 2 * MESH_FRAMES)
    n = max(2 * MESH_FRAMES, SHARD_FRAMES + 1)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_parallel_") as d:
        ctx = tmp.spawn(_parallel_child, args=(
            2, os.path.join(d, "store"), cfg, seq.depths[:n], seq.colors[:n],
            d, dev.type), nprocs=2, join=False)
        deadline = time.perf_counter() + PARALLEL_TIMEOUT
        try:
            while not ctx.join(timeout=max(deadline - time.perf_counter(),
                                           0.0)):
                if time.perf_counter() >= deadline:
                    raise RuntimeError("parallel: the processes did not end "
                                       f"within {PARALLEL_TIMEOUT} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        res = []
        for r in range(2):
            with open(os.path.join(d, f"rank{r}.pkl"), "rb") as f:
                res.append(pickle.load(f))
    spawn_s = time.perf_counter() - t0

    # sharded
    a, b = (r["sharded"] for r in res)
    _, single, single_ms = _track(cfg, intr, _window_frames(
        cfg, intr, seq, slice(0, SHARD_FRAMES + 1), dev))
    trips = cfg.solver.num_iterations * SHARD_FRAMES
    want = {k: 0 for k in a["launches"]}
    want.update(pairs_cg=trips, data_gram=trips,
                segment_sum=SEGSUM_PER_TRIP * trips)
    cost_rels = [abs(float(x.lm_cost) / float(y.lm_cost) - 1)
                 for x, y in zip(a["track"], single)]
    surf = [(int(x.num_surfels), int(y.num_surfels))
            for x, y in zip(a["track"], single)]
    assembly = {k: v for k, v in a.items() if k.startswith("assembly_")}
    ok_assembly = all(
        v["jtj_err"] <= ASSEMBLY_TOL[k.split("_")[1]]
        and v["jtr_err"] <= ASSEMBLY_TOL[k.split("_")[1]]
        and v["cost_rel"] <= 1e-5 for k, v in assembly.items())
    k2 = a["k2_slice"]
    lm = a["lm"]
    ranks_bitwise = dict(
        lm_beta=a["lm"]["beta_sha"] == b["lm"]["beta_sha"],
        track_outputs=_np_same(a["track"], b["track"]),
        track_state=a["track_digests"] == b["track_digests"],
        captured_outputs=_np_same(a["captured"]["outs"],
                                  b["captured"]["outs"]),
        captured_state=a["captured"]["digests"] == b["captured"][
            "digests"])
    # The captured step: every frame bitwise the eager one on its rank,
    # one trip's kernels a replay, 11 all-reduces and 12 graphs a frame,
    # no sync flagged in the step's thread during a replay but the event
    # waits between its graphs (core/compiled.py).
    per_frame = {k: v / SHARD_FRAMES for k, v in want.items()}
    cuts = cfg.solver.num_iterations + 1
    captured = [r_["sharded"]["captured"] for r_ in res]
    classic_cuts = 2 * cfg.solver.num_iterations

    def quiet(syncs):
        return all(n == 0 or site.startswith(
            "super_tpu_torch/core/compiled.py:")
            for x in syncs for site, n in x["sites"].items())

    captured_ok = dict(
        cut_graph=all(c["cut_graph"] and c["segments"] == cuts + 1
                      for c in captured),
        frames_bitwise=all(all(c["frames_bitwise"]) for c in captured),
        launches_per_replay=all(c["launches_per_replay"] == per_frame
                                for c in captured),
        all_reduces_per_frame=all(c["all_reduces_per_replay"] == cuts
                                  for c in captured),
        graph_launches_per_frame=all(
            c["graph_launches_per_replay"] == cuts + 1 for c in captured),
        replay_syncs=all(quiet(c["syncs"]) for c in captured),
        classic=all(c["classic"]["cut_graph"]
                    and c["classic"]["segments"] == classic_cuts + 1
                    and c["classic"]["all_reduces_per_replay"]
                    == classic_cuts and c["classic"]["first_bitwise"]
                    and c["classic"]["replay_bitwise"] for c in captured))
    checks = dict(
        mesh=[a["mesh"], b["mesh"]] == [[[0, 1]]] * 2
        and [a["coordinate"], b["coordinate"]] == [[0, 0], [0, 1]],
        assembly=ok_assembly,
        k2_slice=k2["gram_err"] <= 2e-5 and k2["jtr_err"] <= 2e-5
        and k2["cost_rel"] <= 1e-5,
        lm=(abs(lm["cost"] / lm["ref_cost"] - 1) <= 1e-3
            and lm["cost_of_sharded_beta"] <= lm["ref_cost"] * (1 + 1e-3)
            and lm["beta_err"] <= 5e-3 and lm["ref_trans"] > 1e-4),
        track=(all(c < 0.15 for c in cost_rels)
               and all(abs(x - y) <= 0.01 * y for x, y in surf)),
        launches=a["launches"] == want and b["launches"] == want,
        ranks_bitwise=all(ranks_bitwise.values()),
        captured=all(captured_ok.values()))
    emit(dict(phase="sharded", processes=2, backend="gloo",
              slots=2 * k2["slots"], slots_per_shard=k2["slots"],
              blocks_per_shard=k2["blocks"], assembly=assembly, k2_slice=k2,
              lm=lm, track_cost_rel_err=cost_rels, track_num_surfels=surf,
              track_ms=[a["track_ms"], b["track_ms"]],
              single_track_ms=single_ms, launches=[a["launches"],
                                                   b["launches"]],
              all_reduces_per_frame=a["all_reduces"] / SHARD_FRAMES,
              syncs_flagged=[a["syncs"], b["syncs"]],
              all_reduce=[a["all_reduce"], b["all_reduce"]],
              peak_gb_eager=[a["peak_gb_eager"], b["peak_gb_eager"]],
              captured={k: [c[k] for c in captured] for k in (
                  "segments", "frames_bitwise", "replays",
                  "launches_per_replay", "all_reduces_per_replay",
                  "graph_launches_per_replay", "syncs", "capture_ms",
                  "peak_gb", "ms_eager", "ms_graph", "host_reduce_ms",
                  "trace", "classic")},
              captured_checks=captured_ok,
              ranks_bitwise=ranks_bitwise, checks=checks,
              spawn_seconds=spawn_s))
    if not all(checks.values()):
        raise RuntimeError(f"sharded check failed: {checks} "
                           f"{captured_ok}")

    # stream_mesh
    same = {}
    for r, out in enumerate(r_["stream_mesh"] for r_ in res):
        s = out["stream"]
        state, outs, _ = _track(cfg, intr, _window_frames(
            cfg, intr, seq, slice(s * MESH_FRAMES, (s + 1) * MESH_FRAMES),
            dev))
        same[f"rank{r}"] = dict(
            stream=s == r, outputs=_np_same(out["outs"], outs),
            state=out["digests"] == _digests(state))
    sm = [r_["stream_mesh"] for r_ in res]
    for r, out in enumerate(sm):
        same[f"rank{r}"].update(one_graph=out["one_graph"],
                                pipeline_loop=out["pipe_loop"] == "graph",
                                pipeline=out["pipe_digests"]
                                == out["digests"])
    # The replays' launches: one process's trips.
    trips = cfg.solver.num_iterations * sm[0]["replays"]
    want = {k: 0 for k in sm[0]["launches"]}
    want.update(pairs_cg=trips, data_gram=trips,
                segment_sum=SEGSUM_PER_TRIP * trips)
    ok = (all(all(v.values()) for v in same.values())
          and sm[0]["digests"] != sm[1]["digests"]
          and [x["mesh"] for x in sm] == [[[0], [1]]] * 2
          and all(x["launches"] == want for x in sm))
    emit(dict(phase="stream_mesh", processes=2, mesh=sm[0]["mesh"],
              bitwise=same, launches=[x["launches"] for x in sm],
              replays=sm[0]["replays"],
              pipe_batch_ms=[x["pipe_batch_ms"] for x in sm],
              streams_differ=sm[0]["digests"] != sm[1]["digests"]))
    if not ok:
        raise RuntimeError(f"stream_mesh check failed: {same}")
    return captured[0]["launches"], sm[0]["launches"]


def phase_bench_streams(dev):
    """The bench's line with ``--streams 4`` on the headline alone (reps
    small), ``--streams 1`` beside it."""
    from super_tpu_torch import bench

    lines = {}
    for streams in (1, STREAMS):
        out = bench.measure(reps=4, device=dev, association="per_frame",
                            streams=streams)
        print(json.dumps(out), flush=True)
        lines[streams] = out
    four = lines[STREAMS]
    ok = (four["streams"] == STREAMS and lines[1]["streams"] == 1
          and abs(four["value"] - STREAMS * four["per_stream_hz"])
          <= STREAMS * 5e-4 + 5e-4
          and lines[1]["value"] == lines[1]["per_stream_hz"])
    emit(dict(phase="bench_streams", aggregate_hz=four["value"],
              per_stream_hz=four["per_stream_hz"],
              single_hz=lines[1]["value"],
              aggregate_over_single=four["value"] / lines[1]["value"]))
    if not ok:
        raise RuntimeError(f"bench_streams: {lines}")


# ---------------------------------------------------------------------------
# Observation, checkpoints and the speed-of-light model.

OBSERVE_FRAMES = 6                 # frames of the observed pipeline
OBSERVE_FREQ = 2                   # its save_sample_freq
RESUME_AT, RESUME_TO = 2, 5        # resume: save after frame k, go to k + m
SOL_ROWS = (8, 17, 28)             # gather widths of the calibration
SOL_N = 393216                     # the calibration's indices and elements


def phase_zbuffer(dev, cfg, intr, frames):
    """render_zbuffer of the headline's map after frame 1 (425,984 slots)
    on the card, bitwise against the CPU path on the same inputs; its ms a
    call and device ms alone, and utils/profiling.py's ``chain_time`` and
    ``loop_time`` of it."""
    from super_tpu_torch.core.tracker import init_tracker, track_step
    from super_tpu_torch.render.splat import render_zbuffer
    from super_tpu_torch.utils import profiling

    state, _ = track_step(cfg, intr, init_tracker(cfg, frames[0]), frames[1])
    sf = state.surfels

    def render():
        return render_zbuffer(sf.points, sf.colors, sf.active, intr,
                              cfg.height, cfg.width)

    img = render()
    cpu = torch.device("cpu")
    want = render_zbuffer(sf.points.to(cpu), sf.colors.to(cpu),
                          sf.active.to(cpu), _to(intr, cpu), cfg.height,
                          cfg.width)
    same = bool(torch.equal(img.cpu(), want))
    covered = float((img != 0).any(dim=0).float().mean())
    # utils/profiling.py's timers beside chip_smoke's own.
    rec = dict(phase="zbuffer", slots=sf.points.shape[1],
               active=int(sf.active.sum()), bitwise_cpu=same,
               covered_share=covered, ms=cuda_ms(render, 20),
               device_ms=cuda_ms(render, 20, queued=True),
               chain_time_ms=profiling.chain_time(render, reps=20) * 1e3,
               loop_time_ms=profiling.loop_time(
                   lambda acc: render().sum(), torch.zeros((), device=dev),
                   n_iter=20),
               device_ops=_device_ops(render))
    emit(rec)
    if not (same and covered > 0.5):
        raise RuntimeError(f"zbuffer: {rec}")


def phase_resume(dev, cfg, intr, frames):
    """Track to frame RESUME_AT, save the state, restore it into a state
    built on the card from frame 0, and go on to RESUME_TO: the state and
    every later lm_cost bitwise those of an uninterrupted run."""
    from super_tpu_torch.core.tracker import init_tracker, track_step
    from super_tpu_torch.utils.checkpoint import restore_state, save_state

    def go(state, t0, t1):
        costs = []
        for t in range(t0, t1 + 1):
            state, outs = track_step(cfg, intr, state, frames[t])
            costs.append(outs.lm_cost)
        return state, torch.stack(costs)

    state0 = init_tracker(cfg, frames[0])
    mid, _ = go(state0, 1, RESUME_AT)
    full, costs = go(mid, RESUME_AT + 1, RESUME_TO)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as root:
        t0 = time.perf_counter()
        path = save_state(root, mid, step=RESUME_AT)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        restored = restore_state(path, init_tracker(cfg, frames[0]))
        restore_s = time.perf_counter() - t0
        size = sum(os.path.getsize(os.path.join(path, f))
                   for f in os.listdir(path))
    on_card = all(x.device == dev
                  for x in torch.utils._pytree.tree_leaves(restored))
    resumed, costs_r = go(restored, RESUME_AT + 1, RESUME_TO)
    torch.cuda.synchronize()
    rec = dict(phase="resume", saved_after=RESUME_AT, resumed_to=RESUME_TO,
               bitwise_state=_same(resumed, full),
               bitwise_lm_cost=_same(costs_r, costs), restored_on_card=on_card,
               checkpoint_mb=size / 1e6, save_s=save_s, restore_s=restore_s,
               lm_cost=costs.tolist())
    emit(rec)
    if not (rec["bitwise_state"] and rec["bitwise_lm_cost"] and on_card):
        raise RuntimeError(f"resume: {rec}")


def phase_observe(dev, intr):
    """SuPerPipeline on the headline at 480 x 640 with a logger and
    checkpoints in a temporary directory, OBSERVE_FRAMES frames with the GT
    points, observed every OBSERVE_FREQ: launches a tracked frame as the
    headline's, each scalar line finite, every PNG 480 x 640, the render's
    covered share, the checkpoints, and each observation's host ms beside
    the frame p50."""
    from super_tpu_torch.config import workload_config
    from super_tpu_torch.data.png import read_png
    from super_tpu_torch.pipeline import SuPerPipeline

    cfg = workload_config("lm").replace(save_sample_freq=OBSERVE_FREQ)
    seq = _sequence(cfg, intr, OBSERVE_FRAMES)
    n = OBSERVE_FRAMES
    wrappers = _launch_counts()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_observe_") as root:
        logdir = os.path.join(root, "logs")
        ckdir = os.path.join(root, "ckpt")
        pipe = SuPerPipeline(cfg, intr, logdir=logdir, checkpoint_dir=ckdir,
                             device=dev)
        for w in wrappers.values():
            w.launches = 0
        summary = pipe.run(seq.depths[:n], seq.colors[:n],
                           gt_xy=seq.gt_xy[:n], gt_valid=seq.gt_valid[:n])
        launches = {k: w.launches for k, w in wrappers.items()}
        with open(os.path.join(logdir, "scalars.jsonl")) as f:
            lines = [json.loads(line) for line in f]
        steps = list(range(0, n, OBSERVE_FREQ))
        shapes = {}
        for tag in ("raw", "disparity", "render", "uncertainty"):
            for step in steps:
                img = read_png(os.path.join(logdir, "visualization", tag,
                                            f"{step:08d}.png"))
                shapes[f"{tag}/{step}"] = list(img.shape)
                if tag == "render":
                    covered = float((img != 0).any(axis=-1).mean())
        checkpoints = sorted(os.listdir(ckdir))
        plots = sorted(os.listdir(os.path.join(logdir, "plots")))
    trips = cfg.solver.num_iterations * (n - 1)
    want = {k: 0 for k in wrappers}
    want.update(pairs_cg=trips, data_gram=trips,
                segment_sum=SEGSUM_PER_TRIP * trips + SEGSUM_AT_INIT)
    tags = {s: sorted(d["tag"] for d in lines if d["step"] == s)
            for s in steps}
    rec = dict(phase="observe", frames=n, save_sample_freq=OBSERVE_FREQ,
               launches=launches, scalar_lines=len(lines),
               scalars_per_step={s: len(v) for s, v in tags.items()},
               png_shapes=shapes, render_covered_share=covered,
               checkpoints=checkpoints, plots=plots,
               observe_ms=[t * 1e3 for t in pipe.observe_times],
               p50_frame_ms=summary["p50_frame_ms"],
               reproj_mean=summary["reproj_mean"],
               frac_valid=summary["frac_valid"])
    emit(rec)
    ok = (launches == want
          and all(math.isfinite(d["value"]) for d in lines)
          and tags[0] == ["reprojerr/mean", "reprojerr/std"]
          and all(len(tags[s]) == 13 for s in steps[1:])
          and all(v == [cfg.height, cfg.width, 3] for v in shapes.values())
          and covered > 0.5
          and checkpoints == [f"step_{s:08d}" for s in steps]
          and plots == ["reproj_over_time", "reproj_per_point",
                        "trajectories"]
          and len(pipe.observe_times) == len(steps))
    if not ok:
        raise RuntimeError(f"observe: {rec}, launches want {want}")
    return launches


def phase_sol(dev):
    """The H100 constants of utils/sol.py, measured (device time alone,
    back-to-back calls): the (F, SOL_N) f32 gather at SOL_N random indices
    for F in SOL_ROWS, fitted to a fixed cost plus bytes at a random-access
    rate; a scatter of SOL_N f32 elements to random places; a sort of SOL_N
    int64 keys packing three; one launch of a one-element kernel.  Then
    ``bench.measure_sol`` on the headline: each stage's device ms alone,
    its events ms, floor and sol_frac."""
    from super_tpu_torch import bench
    from super_tpu_torch.config import workload_config
    from super_tpu_torch.utils import sol

    g = torch.Generator(device=dev).manual_seed(SEED)
    idx = torch.randint(0, SOL_N, (SOL_N,), device=dev, generator=g)
    gather = {}
    for f in SOL_ROWS:
        src = torch.rand((f, SOL_N), device=dev, generator=g)
        gather[f] = cuda_ms(lambda: torch.index_select(src, 1, idx), 20,
                            queued=True)
    x = np.array(SOL_ROWS, float)
    y = np.array([gather[f] for f in SOL_ROWS])
    slope, fixed = np.polyfit(x, y, 1)           # ms a row, ms
    rate = SOL_N * 4 / (slope * 1e6)             # GB/s
    dst = torch.zeros(SOL_N, device=dev)
    vals = torch.rand(SOL_N, device=dev, generator=g)
    scatter = cuda_ms(lambda: dst.scatter_(0, idx, vals), 20, queued=True)
    keys = torch.randint(0, 2 ** 60, (SOL_N,), device=dev, generator=g)
    sort = cuda_ms(lambda: torch.sort(keys), 20, queued=True)
    one = torch.zeros(1, device=dev)
    launch = cuda_ms(lambda: one.add_(1.0), 200, queued=True)
    calib = dict(gather_ms={str(f): gather[f] for f in SOL_ROWS},
                 gather_fixed_ms=float(fixed), rand_gather_gbps=float(rate),
                 scatter_ns_per_elem=scatter * 1e6 / SOL_N,
                 sort3_ms_per_393k=sort * 393216 / SOL_N, launch_ms=launch)
    module = dict(gather_fixed_ms=sol.GATHER_FIXED_MS,
                  rand_gather_gbps=sol.RAND_GATHER_GBPS,
                  scatter_ns_per_elem=sol.SCATTER_NS_PER_ELEM,
                  sort3_ms_per_393k=sol.SORT3_MS_PER_393K,
                  launch_ms=sol.LAUNCH_MS)
    report = bench.measure_sol(workload_config("lm"), 40, dev)
    rec = dict(phase="sol", calibration=calib, module_constants=module,
               stages=report["stages"], floors=report["floors"])
    emit(rec)
    stages = report["stages"]
    if not (rate > 0 and all(k in stages and stages[k]["device_ms"] > 0
                             for k in ("prepare", "assoc", "assemble",
                                       "solve", "fuse"))):
        raise RuntimeError(f"sol: {rec}")


# ---------------------------------------------------------------------------
# The stereo SSIM confidence and the entry points.

# The confidence map, card against CPU path: SSIM's variances are
# E[x^2] - mu^2 over nine f32 terms, which the two paths sum in other
# orders (a few ULPs of 1, ~5e-7); over C2 = 9e-4 in a flat window that
# is ~6e-4 of num / den, and so of the confidence.
SSIM_CONF_TOL = 1e-3
CLI_FRAMES = 8                     # frames of the V1-layout directory
CLI_SEMANTIC_FRAMES = 6
CLI_SIZE = (480, 640)
CLI_MESH_STEP = 30
# The trials' fixed intrinsics (super_tpu_torch/geometry/camera.py), which
# the loader assumes for each layout: the directories are rendered with
# them.
CLI_CAMERAS = {"superv1": (883.0, 883.0, 445.06, 190.24),
               "superv2": (768.98551924, 768.98551924, 292.8861567,
                           291.61479526)}
CPP_OFFSET_PX = 1.5                # the super_cpp trajectory's offset
CLI_ITERATIONS = 10                # the CLIs' --num_optimize_iterations


def _ssim_conf_config():
    from super_tpu_torch.config import lm_workload_config

    return lm_workload_config(480, 640, 30).replace(disable_ssim_conf=False)


def _masked_points(cfg, intr, depth):
    """preprocess_frame's points: invalid depth NaN, backprojected."""
    from super_tpu_torch.core.preprocess import compute_invalid_mask
    from super_tpu_torch.geometry.camera import backproject_depth

    depth = torch.as_tensor(depth, device=intr.fx.device)
    depth = torch.where(compute_invalid_mask(cfg, depth), float("nan"), depth)
    return backproject_depth(depth, intr)


def phase_ssim_conf(dev, intr):
    """The headline with ``disable_ssim_conf=False``: the stereo SSIM
    confidence of frame 1 on the card (its ms a call, device ms alone and
    device operations, the share of pixels whose warped sample left the
    image, its mean and range), PATH_FRAMES tracked frames through
    ``_run_path`` (K1 and ``data_gram`` once a trip, the segment sum 4
    times a trip and once at frame 0), and frame 1 tracked twice, bitwise.  Returns (cfg, frames,
    launches); :func:`phase_ssim_reference` takes the first two."""
    from super_tpu_torch.core.preprocess import stereo_ssim_confidence
    from super_tpu_torch.core.tracker import init_tracker, track_step
    from super_tpu_torch.geometry.camera import warp_stereo_coords

    cfg = _ssim_conf_config()
    seq = _sequence(cfg, intr, PATH_FRAMES + 1)
    color = torch.as_tensor(np.ascontiguousarray(
        seq.colors[1].transpose(2, 0, 1)), device=dev)
    pts = _masked_points(cfg, intr, seq.depths[1])
    conf = stereo_ssim_confidence(cfg, intr, pts, color)
    ms = cuda_ms(lambda: stereo_ssim_confidence(cfg, intr, pts, color), 20)
    device_ms = cuda_ms(lambda: stereo_ssim_confidence(cfg, intr, pts, color),
                        20, queued=True)
    ops = _device_ops(lambda: stereo_ssim_confidence(cfg, intr, pts, color))
    grid = warp_stereo_coords(pts, intr, -0.1, cfg.height, cfg.width)
    u = (grid[..., 0] + 1.0) * 0.5 * (cfg.width - 1)
    v = (grid[..., 1] + 1.0) * 0.5 * (cfg.height - 1)
    valid = ~torch.isnan(pts[2])
    outside = valid & ((u < 0) | (u > cfg.width - 1) | (v < 0)
                       | (v > cfg.height - 1))
    frames = _frames(cfg, intr, PATH_FRAMES + 1, dev)
    launches = _run_path("ssim_conf", cfg, intr, frames,
                         {"pairs_cg": 1, "data_gram": 1})
    state = init_tracker(cfg, frames[0])
    a = track_step(cfg, intr, state, frames[1])
    b = track_step(cfg, intr, state, frames[1])
    torch.cuda.synchronize()
    same = _same(a, b)
    blended = frames[1].confs
    rec = dict(phase="ssim_conf_map", pixels=cfg.height * cfg.width,
               ms=ms, device_ms=device_ms, device_ops=ops, valid_share=float(valid.float().mean()),
               outside_share_of_valid=float(outside.sum() / valid.sum()),
               conf_mean=float(conf.mean()), conf_min=float(conf.min()),
               conf_max=float(conf.max()),
               blended_mean=float(blended.mean()),
               blended_min=float(blended.min()),
               blended_max=float(blended.max()), repeat_bitwise=same)
    emit(rec)
    if not (same and bool(torch.isfinite(conf).all())):
        raise RuntimeError(f"ssim_conf: {rec}")
    return cfg, frames, launches


def phase_ssim_reference(intr, cfg, frames):
    """Frame 1 of the ssim_conf path against the CPU path from identical
    inputs: the confidence map (SSIM_CONF_TOL), then the LM solve (the
    main path's 1e-4 on beta, 1e-2 on the cost)."""
    from super_tpu_torch.core.preprocess import stereo_ssim_confidence

    seq = _sequence(cfg, intr, 2)
    color = np.ascontiguousarray(seq.colors[1].transpose(2, 0, 1))
    cpu = torch.device("cpu")
    maps = []
    for d in (intr.fx.device, cpu):
        di = _to(intr, d)
        maps.append(stereo_ssim_confidence(
            cfg, di, _masked_points(cfg, di, seq.depths[1]),
            torch.as_tensor(color, device=d)).cpu())
    map_err = float(torch.max(torch.abs(maps[0] - maps[1])))
    res_c, res_h, cpu_s = _frame1_vs_cpu(cfg, intr, frames)
    beta_err, cost_err = _solve_diff(res_c, res_h)
    rec = dict(phase="ssim_conf_reference", conf_max_abs_err=map_err,
               conf_tol=SSIM_CONF_TOL, frame1_beta_max_abs_err=beta_err,
               frame1_cost_rel_err=cost_err / float(res_h.cost),
               cpu_s=cpu_s)
    emit(rec)
    if not (map_err <= SSIM_CONF_TOL and beta_err < 1e-4
            and rec["frame1_cost_rel_err"] < 1e-2):
        raise RuntimeError(f"ssim_conf disagrees with the CPU path: {rec}")


def _start_cli_sequences(pool):
    """The CLI directories' sequences, rendered with each layout's
    intrinsics in ``pool``: {layout: future}."""
    from super_tpu_torch.data.synthetic import generate

    h, w = CLI_SIZE
    return {layout: pool.submit(
        generate, CLI_FRAMES, h, w,
        intr=types.SimpleNamespace(fx=fx, fy=fy, cx=cx, cy=cy), seed=SEED,
        num_classes=SEMANTIC_CLASSES)
        for layout, (fx, fy, cx, cy) in CLI_CAMERAS.items()}


def _write_trial_dir(root, seq, seg):
    """A SuPer-layout trial of ``seq``'s frames 0..CLI_FRAMES-1, its PNGs
    written by data/png.py: rgb/%06d-left.png, depth/%06d.npy (the sigmoid
    disparity that disp_to_depth turns back into the depth), with ``seg``
    seg/%06d-left.png labels, and left_pts.npy with the GT points and a
    ``super_cpp`` trajectory CPP_OFFSET_PX off in x and y.  Returns the
    written RGB (T, H, W, 3) uint8 and disparities (T, H, W) f32."""

    from super_tpu_torch.data.png import write_png

    for sub in ("rgb", "depth") + (("seg",) if seg else ()):
        os.makedirs(os.path.join(root, sub))
    min_disp, max_disp = 1.0 / 80.0, 1.0 / 0.1
    gt, cpp, rgbs, disps = {}, {}, [], []
    for fid in range(CLI_FRAMES):
        name = f"{fid:06d}"
        rgb = (np.clip(seq.colors[fid], 0, 1) * 255).astype(np.uint8)
        write_png(os.path.join(root, "rgb", f"{name}-left.png"), rgb)
        disp = ((1.0 / np.maximum(seq.depths[fid], 1e-6) - min_disp)
                / (max_disp - min_disp)).astype(np.float32)
        np.save(os.path.join(root, "depth", f"{name}.npy"), disp)
        if seg:
            write_png(os.path.join(root, "seg", f"{name}-left.png"),
                      seq.segs[fid].astype(np.uint8))
        p3 = np.concatenate([seq.gt_xy[fid], seq.gt_valid[fid][:, None]
                             .astype(np.float32)], axis=1)
        gt[name] = p3
        est = p3.copy()
        est[:, 0:2] += CPP_OFFSET_PX
        cpp[name] = est
        rgbs.append(rgb)
        disps.append(disp)
    np.save(os.path.join(root, "left_pts.npy"),
            np.array({"gt": gt, "super_cpp": cpp}, dtype=object))
    return np.stack(rgbs), np.stack(disps)


def _decoder_probe():
    """What the machine has for PNG decoding: PIL, libpng's header, the
    shared libpng (ldconfig -p) and whether the native loader builds."""
    from super_tpu_torch.data.superv1 import python_decoder
    from super_tpu_torch.runtime import native_toolchain

    try:
        ldconfig = subprocess.run(["ldconfig", "-p"], capture_output=True,
                                  text=True).stdout
    except FileNotFoundError:
        ldconfig = ""
    return dict(pil=python_decoder() == "pil",
                native_toolchain=native_toolchain() or "ok",
                libpng=sorted({ln.split()[0] for ln in ldconfig.splitlines()
                               if "libpng" in ln}))


def phase_cli_data(root, sequences):
    """Writes the superv1 and superv2 trials of ``sequences`` ({layout:
    sequence}) under ``root`` and decodes the superv1 frames with every
    decoder present: the RGB must equal the written frames bit for bit,
    the depth disp_to_depth's to float32 rounding (2e-6 relative).
    Returns {layout: (dir, sequence, (written RGB, disparities))}."""

    from super_tpu_torch.core.preprocess import disp_to_depth
    from super_tpu_torch.data.superv1 import load_image, python_decoder
    from super_tpu_torch.runtime import NativeSequenceLoader, native_available

    emit(dict(phase="cli_probe", **_decoder_probe()))
    dirs = {}
    t0 = time.perf_counter()
    for layout, seq in sequences.items():
        path = os.path.join(root, layout)
        written = _write_trial_dir(path, seq, seg=layout == "superv2")
        dirs[layout] = (path, seq, written)
    write_s = time.perf_counter() - t0
    path, _, (rgbs, disps) = dirs["superv1"]
    h, w = CLI_SIZE
    want_rgb = rgbs.astype(np.float32) / 255.0
    _, want_depth = disp_to_depth(disps, 0.1, 80.0)
    rgb_paths = [os.path.join(path, "rgb", f"{i:06d}-left.png")
                 for i in range(CLI_FRAMES)]
    dep_paths = [os.path.join(path, "depth", f"{i:06d}.npy")
                 for i in range(CLI_FRAMES)]
    decoders, bad = {}, []
    names = ["zlib"] + (["pil"] if python_decoder() == "pil" else []) + \
        (["native"] if native_available() else [])
    for name in names:
        t1 = time.perf_counter()
        if name == "native":
            with NativeSequenceLoader(dep_paths, rgb_paths, h, w) as ld:
                out = [(d, r.transpose(1, 2, 0)) for _, d, r in ld]
        else:
            out = [(disp_to_depth(np.load(d).astype(np.float32), 0.1,
                                  80.0)[1], load_image(r, name))
                   for d, r in zip(dep_paths, rgb_paths)]
        ms = (time.perf_counter() - t1) * 1e3 / CLI_FRAMES
        depth = np.stack([d for d, _ in out])
        rgb = np.stack([r for _, r in out])
        rgb_equal = rgb.dtype == np.float32 and np.array_equal(rgb, want_rgb)
        depth_rel = float(np.max(np.abs(depth - want_depth) / want_depth))
        decoders[name] = dict(ms_per_frame=ms, frames=len(out),
                              rgb_bitwise=rgb_equal, depth_max_rel=depth_rel)
        if not (len(out) == CLI_FRAMES and rgb_equal and depth_rel <= 2e-6):
            bad.append(name)
    emit(dict(phase="cli_data", height=h, width=w, frames=CLI_FRAMES,
              write_s=write_s, decoders=decoders))
    if bad:
        raise RuntimeError(f"decoders disagree with the written frames: {bad}")
    return dirs


def _cli_run(name, module, argv, out_json, static, per_trip, frames,
             fit_steps=False):
    """``module.main(argv)`` in this process with the launch counts zeroed
    just before and read just after.  ``per_trip``: {kernel: launches per
    LM trip} beside the segment sum's SEGSUM_PER_TRIP a trip (or, with
    ``fit_steps``, SEGSUM_PER_FIT_STEP a step of the autograd fit, which
    takes CLI_ITERATIONS steps a frame) and SEGSUM_AT_INIT;
    every other kernel must not launch.  Requires finite metrics, every
    frame evaluated and, where ``static`` is given, a mean reprojection
    error below 0.75 of it.  Returns (metrics, launches)."""
    wrappers = _launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for wr in wrappers.values():
        wr.launches = 0
    t0 = time.perf_counter()
    rc = module.main(argv + ["--output_json", out_json])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: wr.launches for k, wr in wrappers.items()}
    with open(out_json) as f:
        m = json.load(f)
    trips = CLI_ITERATIONS * (frames - 1)
    if fit_steps:
        want = {k: 0 for k in wrappers}
        want["segment_sum"] = SEGSUM_PER_FIT_STEP * trips + SEGSUM_AT_INIT
    else:
        per_trip = {"segment_sum": SEGSUM_PER_TRIP, **per_trip}
        want = {k: trips * per_trip.get(k, 0) for k in wrappers}
        want["segment_sum"] += SEGSUM_AT_INIT
    finite = all(math.isfinite(v) for v in m.values()
                 if isinstance(v, float))
    tracks = static is None or m["reproj_mean"] < 0.75 * static
    rec = dict(phase=name, argv=argv, rc=rc, loader=m.get("loader"),
               p50_frame_ms=m["p50_frame_ms"],
               mean_frame_ms=m["mean_frame_ms"], seconds=seconds,
               launches=launches,
               launches_per_frame={k: v / (frames - 1)
                                   for k, v in launches.items() if v},
               reproj_mean=m["reproj_mean"], frac_valid=m["frac_valid"],
               loop=m.get("loop"),
               static_error=static, num_eval_frames=m["num_eval_frames"],
               num_surfels=m["num_surfels"], num_nodes=m["num_nodes"],
               super_cpp_mean=m.get("super_cpp_mean"),
               overflow={k: v for k, v in m.items()
                         if k.startswith("overflow_")},
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    emit(rec)
    ok = (rc == 0 and finite and tracks and launches == want
          and m["num_eval_frames"] == frames and m["num_surfels"] > 0
          and m.get("loop") == "graph")
    if not ok:
        raise RuntimeError(f"{name}: launches {launches}, want {want}; "
                           f"finite {finite}; tracks {tracks}; {m}")
    return m, launches


def _static_error(gt_xy):
    return float(np.mean([np.linalg.norm(gt_xy[t] - gt_xy[0], axis=1).mean()
                          for t in range(1, len(gt_xy))]))


def phase_cli_super(root, dirs, intr):
    """``python -m super_tpu_torch.run_super`` in process, three times: the
    root CLI's defaults on the superv1 trial (the moving-target association
    with Cholesky: K2's memory form, ``tuple_gram``, once a trip), the
    headline's solver flags on it (K1 and ``data_gram`` once a trip), and
    ``--synthetic``.  Each: the launches, finite metrics, every frame
    evaluated, tracking (below 0.75 of the static error); on the trial the
    C++-SuPer baseline at hypot(1.5, 1.5).  Returns {run: launches}."""

    from super_tpu_torch import run_super

    path, seq, _ = dirs["superv1"]
    size = ["--height", str(CLI_SIZE[0]), "--width", str(CLI_SIZE[1]),
            "--mesh_step_size", str(CLI_MESH_STEP)]
    data = size + ["--data_dir", path, "--start_id", "0", "--end_id",
                   str(CLI_FRAMES), "--tracking_gt_file", "left_pts.npy"]
    static = _static_error(seq.gt_xy[:CLI_FRAMES])
    synthetic = _sequence(_ssim_conf_config(), intr, CLI_FRAMES)
    runs = (("cli_super_default", data, {"tuple_gram": 1}, static),
            ("cli_super_pairs", data + [
                "--association", "per_frame", "--linear_solver",
                "pairs_fused", "--pcg_iterations", "32",
                "--gram_sum_dtype", "bf16"],
             {"pairs_cg": 1, "data_gram": 1}, static),
            ("cli_super_synthetic", size + ["--synthetic", "--num_frames",
                                            str(CLI_FRAMES)],
             {"tuple_gram": 1},
             _static_error(synthetic.gt_xy[:CLI_FRAMES])))
    out = {}
    for name, argv, per_trip, static_px in runs:
        m, out[name] = _cli_run(name, run_super, argv,
                                os.path.join(root, f"{name}.json"),
                                static_px, per_trip, CLI_FRAMES)
        if "--data_dir" in argv:
            cpp = m.get("super_cpp_mean")
            if cpp is None or abs(cpp - math.hypot(CPP_OFFSET_PX,
                                                   CPP_OFFSET_PX)) > \
                    1e-5 * math.hypot(CPP_OFFSET_PX, CPP_OFFSET_PX):
                raise RuntimeError(f"{name}: super_cpp_mean {cpp}")
    return out


def phase_cli_semantic(root, dirs):
    """``python -m super_tpu_torch.run_semantic_super`` in process on the
    superv2 trial, CLI_SEMANTIC_FRAMES frames with their label PNGs: no TPU
    kernel's counterpart, the segment sum twice a fit step (10 a frame)
    and once at frame 0; finite metrics, live surfels, and the peak memory
    of its 1,048,576 surfel slots.  Returns the launches."""

    from super_tpu_torch import run_semantic_super

    path, _, _ = dirs["superv2"]
    _, launches = _cli_run(
        "cli_semantic", run_semantic_super,
        ["--height", str(CLI_SIZE[0]), "--width", str(CLI_SIZE[1]),
         "--mesh_step_size", str(CLI_MESH_STEP), "--data_dir", path,
         "--start_id", "0", "--end_id", str(CLI_SEMANTIC_FRAMES),
         "--tracking_gt_file", "left_pts.npy"],
        os.path.join(root, "cli_semantic.json"), None, {},
        CLI_SEMANTIC_FRAMES, fit_steps=True)
    return launches


# ---------------------------------------------------------------------------
# The compiled step: make_jit_step's CUDA graph of track_step, replayed by
# the pipeline, the stream batch and the bench's device-resident loop.

GRAPH_WARM = 2                     # eager frames before the capture
GRAPH_FRAMES = 5                   # replayed frames held to the eager step
GRAPH_REPEATS = 20                 # more replays of one frame, bitwise
GRAPH_TURNS = 3                    # timing turns, eager and captured
GRAPH_PATH_FRAMES = 3              # replayed frames of every other LM path
GRAPH_STREAM_FRAMES = 2            # replayed batches of the streams check
GRAPH_PIPELINE_FRAMES = 8          # SuPerPipeline frames, graph and eager
GRAPH_SEMANTIC_REPEATS = 5         # more replays of one semantic frame
GRAPH_SEMANTIC_STREAMS = 2         # semantic streams in one graph
GRAPH_SEMANTIC_PIPELINE_FRAMES = 6
GRAPH_SEMANTIC_BENCH_FRAMES = 6    # semantic_hz's frames, each loop
# The kernels of a trace, by a piece of their (demangled) names.
TRACE_KERNELS = {"pairs_cg": "pairs_cg_kernel<float>",
                 "pairs_cg_chunked": "pairs_cg_kernel<__nv_bfloat16>",
                 "data_gram": "gram_kernel<(anonymous namespace)::Data>",
                 "tuple_gram": "gram_kernel<(anonymous namespace)::Memory>",
                 "dense_cg": "dense_cg_kernel",
                 "segment_sum": "segment_sum_kernel"}


def _bits(a, b):
    """Bit for bit equal trees of tensors (floats compared as integers of
    their width: NaN payloads and signed zeros too)."""
    from torch.utils import _pytree as pytree

    la, lb = pytree.tree_leaves(a), pytree.tree_leaves(b)
    if len(la) != len(lb):
        return False
    for x, y in zip(la, lb):
        if x.dtype != y.dtype or x.shape != y.shape:
            return False
        if x.is_floating_point():
            width = {2: torch.int16, 4: torch.int32, 8: torch.int64}
            x, y = x.view(width[x.element_size()]), y.view(
                width[y.element_size()])
        if not torch.equal(x, y):
            return False
    return True


def _zero_counts():
    wrappers = _launch_counts()
    for w in wrappers.values():
        w.launches = 0
    return wrappers


def _counts(wrappers):
    return {k: w.launches for k, w in wrappers.items()}


def _trace_counts(fn):
    """(kernels of one ``fn()`` by TRACE_KERNELS name, kernels in all,
    their device ms, the host ms of the traced window) from a profiler
    trace: independent of the wrappers' counters."""
    from super_tpu_torch.utils.profiling import kernel_spans

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    spans = kernel_spans(prof)
    by = {k: sum(piece in name for _, _, name in spans)
          for k, piece in TRACE_KERNELS.items()}
    device_ms = sum(k1 - k0 for k0, k1, _ in spans) / 1e3
    return by, len(spans), device_ms, window_ms


def _ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _step_args(cfg, models, intr, state, frame, prev):
    """make_jit_step's arguments: ``prev`` (the previous frame's colour)
    for the sf_corr step with ``models``."""
    from super_tpu_torch.core.tracker import jit_step_takes_prev

    return (intr, state, frame) + (
        (prev,) if jit_step_takes_prev(cfg, models) else ())


def _graph_full(name, cfg, dev, intr, warm_frames, n, repeats, want):
    """``name``'s step through make_jit_step (see :func:`phase_graph`):
    ``warm_frames`` eager frames, the capture, ``n`` replays bitwise the
    eager frames, ``repeats`` more replays of the first bitwise, the
    launches a replay ``want`` by counter and by trace, eager and
    captured ms in turns, busy share, peak memory."""
    from super_tpu_torch.core.tracker import init_tracker, make_jit_step, \
        track_step

    frames = _frames(cfg, intr, warm_frames + n + 1, dev)
    state = init_tracker(cfg, frames[0])
    for f in frames[1:warm_frames + 1]:
        state, _ = track_step(cfg, intr, state, f)
    warm, rest = state, frames[warm_frames + 1:]

    def eager_run():
        st, out = warm, []
        for f in rest:
            st, o = track_step(cfg, intr, st, f)
            out.append((st, o))
        return out

    wrappers = _zero_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eager = eager_run()
    torch.cuda.synchronize()
    eager_launches = _counts(wrappers)
    eager_peak = torch.cuda.max_memory_allocated()

    step = make_jit_step(cfg)
    torch.cuda.reset_peak_memory_stats()
    capture_ms = _ms(lambda: step(intr, warm, rest[0]))

    def graph_run():
        st, out = warm, []
        for f in rest:
            st, o = step(intr, st, f)
            out.append((st, o))
        return out

    wrappers = _zero_counts()
    got = graph_run()
    torch.cuda.synchronize()
    launches = _counts(wrappers)
    graph_peak = torch.cuda.max_memory_allocated()
    frames_bitwise = [_bits(g, e) for g, e in zip(got, eager)]
    first = got[0]
    again = [_bits(step(intr, warm, rest[0]), first) for _ in range(repeats)]
    tickets = [t for _, t in step._scratch.values()]
    tickets_zero = all(bool((t == 0).all()) for t in tickets)

    # One frame traced, the replay and the eager step.
    def replay_one():
        step(intr, warm, rest[0])

    def eager_one():
        track_step(cfg, intr, warm, rest[0])

    wrappers = _zero_counts()
    by_trace, n_graph, dev_graph, win_graph = _trace_counts(replay_one)
    by_counter = _counts(wrappers)
    by_trace_e, n_eager, dev_eager, win_eager = _trace_counts(eager_one)

    turns = {"eager": [], "graph": []}
    for _ in range(GRAPH_TURNS):
        for kind, one in (("eager", eager_one), ("graph", replay_one)):
            turns[kind].append(float(np.median([_ms(one) for _ in rest])))
    want = {**{k: 0 for k in wrappers}, **want}
    per_frame = {k: v // n for k, v in launches.items()}
    rec = dict(
        path=name, warm_frames=warm_frames, frames=len(rest),
        frames_bitwise=frames_bitwise, repeats=len(again),
        repeats_bitwise=all(again), tickets_zero=tickets_zero,
        launches=launches, eager_launches=eager_launches,
        launches_per_replay=per_frame, launches_trace=by_trace,
        launches_counter_one_replay=by_counter,
        launches_trace_eager=by_trace_e,
        kernels_per_frame_trace=n_graph, kernels_per_frame_eager=n_eager,
        device_ms_graph=dev_graph, device_ms_eager=dev_eager,
        busy_graph=dev_graph / win_graph, busy_eager=dev_eager / win_eager,
        traced_ms_graph=win_graph, traced_ms_eager=win_eager,
        ms_eager=turns["eager"], ms_graph=turns["graph"],
        capture_ms=capture_ms, peak_gb_graph=graph_peak / 1e9,
        peak_gb_eager=eager_peak / 1e9)
    ok = (all(frames_bitwise) and all(again) and tickets_zero
          and launches == eager_launches
          and all(launches[k] == n * want[k] for k in want)
          and by_counter == want
          and {k: by_trace[k] for k in want} == want)
    return rec, ok, launches


def _graph_headline(dev, intr):
    """The headline through make_jit_step: K1 and data_gram once an LM
    trip, the segment sum SEGSUM_PER_TRIP times."""
    from super_tpu_torch.config import workload_config

    cfg = workload_config("lm")
    trips = cfg.solver.num_iterations
    return _graph_full("lm", cfg, dev, intr, GRAPH_WARM, GRAPH_FRAMES,
                       GRAPH_REPEATS,
                       dict(pairs_cg=trips, data_gram=trips,
                            segment_sum=SEGSUM_PER_TRIP * trips))


def _graph_path(name, cfg, dev, intr, n=GRAPH_PATH_FRAMES, models=None,
                want=None):
    """``cfg``'s step through make_jit_step (with ``models``, the sf_corr
    step's flow net), ``n`` replays from the frame-0 state against as many
    eager frames: bitwise, the launches the eager step's (and ``want`` a
    replay where given)."""
    from super_tpu_torch.core.tracker import init_tracker, make_jit_step, \
        track_step

    frames = _frames(cfg, intr, n + 1, dev)
    state0 = init_tracker(cfg, frames[0])
    wrappers = _zero_counts()
    st, eager = state0, []
    for t, f in enumerate(frames[1:], 1):
        st, o = track_step(cfg, intr, st, f, models=models,
                           prev_color=frames[t - 1].color_image)
        eager.append((st, o))
    eager_launches = _counts(wrappers)
    rec = dict(path=name, frames=n,
               solver=(cfg.solver.linear_solver
                       if cfg.solver.use_derived_gradient
                       else f"autograd {cfg.solver.optimizer}"),
               association=cfg.solver.association)
    try:
        step = make_jit_step(cfg, models)
        step(*_step_args(cfg, models, intr, state0, frames[1],
                         frames[0].color_image))      # warm-up, capture
    except Exception as e:         # recorded: the phase fails below
        rec.update(captured=False, error=f"{type(e).__name__}: {e}"[:600])
        return rec, False, eager_launches
    wrappers = _zero_counts()
    st, got, times = state0, [], []
    for t, f in enumerate(frames[1:], 1):
        t0 = time.perf_counter()
        st, o = step(*_step_args(cfg, models, intr, st, f,
                                 frames[t - 1].color_image))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        got.append((st, o))
    launches = _counts(wrappers)
    bitwise = [_bits(g, e) for g, e in zip(got, eager)]
    rec.update(captured=True, frames_bitwise=bitwise, launches=launches,
               eager_launches=eager_launches, ms_graph=times)
    ok = all(bitwise) and launches == eager_launches
    if want is not None:
        want = {**{k: 0 for k in wrappers}, **want}
        rec["launches_want_per_replay"] = want
        ok &= all(launches[k] == n * want[k] for k in want)
    return rec, ok, launches


def _graph_streams(dev, intr, name="lm", streams=STREAMS):
    """``streams`` streams of ``name``'s workload in one graph
    (make_batched_step): stream s starts from frame s and steps on frames
    s + 1, s + 2; each bitwise its eager single track, launches those of
    the single tracks."""
    from super_tpu_torch.config import workload_config
    from super_tpu_torch.core.tracker import init_tracker, track_step
    from super_tpu_torch.parallel.sharded import make_batched_step
    from super_tpu_torch.utils.tree import stack, unstack

    cfg = workload_config(name)
    n = GRAPH_STREAM_FRAMES
    frames = _frames(cfg, intr, streams + n, dev)
    wrappers = _zero_counts()
    singles = []
    for s in range(streams):
        st, out = init_tracker(cfg, frames[s]), []
        for f in frames[s + 1:s + 1 + n]:
            st, o = track_step(cfg, intr, st, f)
            out.append((st, o))
        singles.append(out)
    single_launches = _counts(wrappers)
    single_launches["segment_sum"] -= streams * SEGSUM_AT_INIT
    states0 = stack([init_tracker(cfg, frames[s]) for s in range(streams)])
    batch = [stack([frames[s + 1 + t] for s in range(streams)])
             for t in range(n)]
    step = make_batched_step(cfg, intr)
    step(states0, batch[0])                          # warm-up, capture
    wrappers = _zero_counts()
    st, got, times = states0, [], []
    for b in batch:
        t0 = time.perf_counter()
        st, o = step(st, b)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        got.append((st, o))
    launches = _counts(wrappers)
    bitwise = [[_bits((unstack(g[0])[s], unstack(g[1])[s]), singles[s][t])
                for t, g in enumerate(got)] for s in range(streams)]
    rec = dict(path=f"streams_{name}", streams=streams, frames=n,
               bitwise=bitwise, launches=launches,
               single_launches=single_launches, ms_batch_graph=times,
               captured=step.captured)
    return rec, (all(all(b) for b in bitwise)
                 and launches == single_launches and step.captured)


def _graph_pipeline(dev, intr, name="lm", n=GRAPH_PIPELINE_FRAMES):
    """SuPerPipeline on ``name``'s workload with GT (and the sequence's
    segmentations on the semantic method), compiled (the graphs) and
    eager: tracks, errors and final state bitwise; p50 of both."""
    from super_tpu_torch.config import workload_config
    from super_tpu_torch.pipeline import SuPerPipeline

    cfg = workload_config(name)
    seq = _sequence(cfg, intr, n)
    segs = {}
    if cfg.method == "semantic-super":
        segs = dict(segs=seq.segs[:n], seg_confs=seq.seg_confs[:n])
    runs = {}
    for compiled in (True, False):
        pipe = SuPerPipeline(cfg, intr, device=dev, compiled=compiled)
        m = pipe.run(seq.depths[:n], seq.colors[:n], gt_xy=seq.gt_xy[:n],
                     gt_valid=seq.gt_valid[:n], **segs)
        runs[compiled] = (pipe, m)
    (g, gm), (e, em) = runs[True], runs[False]
    tracks = all(np.array_equal(g.track_results[t], e.track_results[t])
                 for t in e.track_results)
    errors = all(np.array_equal(g.errors[t], e.errors[t]) for t in e.errors)
    state = _bits(g.state, e.state)
    rec = dict(path=f"pipeline_{name}", frames=n, loop_graph=g.loop,
               loop_eager=e.loop, tracks_bitwise=tracks,
               errors_bitwise=errors, state_bitwise=state,
               p50_ms_graph=gm["p50_frame_ms"],
               p50_ms_eager=em["p50_frame_ms"],
               reproj_mean=gm["reproj_mean"],
               ms_graph=[t * 1e3 for t in g.frame_times],
               ms_eager=[t * 1e3 for t in e.frame_times])
    return rec, (tracks and errors and state and g.loop == "graph"
                 and e.loop == "eager")


def _graph_bench(dev):
    """The bench's headline rate on the device-resident loop and on the
    host loop (6 frames, the cold start beside), and its semantic_hz on
    both loops (GRAPH_SEMANTIC_BENCH_FRAMES frames)."""
    from super_tpu_torch import bench
    from super_tpu_torch.config import workload_config

    lines = {}
    for host_loop in (False, True):
        out = bench.measure(reps=6, device=dev, association="per_frame",
                            host_loop=host_loop)
        print(json.dumps(out), flush=True)
        lines["host" if host_loop else "device"] = out
    sem = workload_config("semantic")
    semantic = {}
    for host_loop in (False, True):
        hz, overflow = bench.measure_step(sem, GRAPH_SEMANTIC_BENCH_FRAMES,
                                          dev, host_loop=host_loop)
        semantic[bench.loop_of(host_loop)] = dict(hz=hz,
                                                       overflow=overflow)
    rec = dict(path="bench", device_hz=lines["device"]["value"],
               host_hz=lines["host"]["value"],
               device_cold_hz=lines["device"]["cold_start_hz"],
               host_cold_hz=lines["host"]["cold_start_hz"],
               device_over_host=lines["device"]["value"]
               / lines["host"]["value"],
               loops=[lines["device"]["loop"], lines["host"]["loop"]],
               semantic_frames=GRAPH_SEMANTIC_BENCH_FRAMES,
               semantic_hz=semantic)
    return rec, (rec["loops"] == ["device", "host"] and rec["device_hz"] > 0
                 and sorted(semantic) == ["device", "host"]
                 and all(v["hz"] > 0 for v in semantic.values()))


def _graph_semantic(dev, intr):
    """The semantic part of :func:`phase_graph`: (records, failed)."""
    from super_tpu_torch.config import workload_config
    from super_tpu_torch.factory import build_models

    iters = workload_config("semantic").solver.num_iterations
    fit = SEGSUM_PER_FIT_STEP * iters
    render = (SEGSUM_PER_FIT_STEP + 1) * iters
    records, bad = [], []

    def note(rec, ok):
        emit(dict(phase="graph", **rec, ok=ok))
        records.append(rec)
        if not ok:
            bad.append(rec["path"])

    rec, ok, launches = _graph_full(
        "semantic", workload_config("semantic"), dev, intr, 1,
        GRAPH_PATH_FRAMES, GRAPH_SEMANTIC_REPEATS, dict(segment_sum=fit))
    note(rec, ok)
    _, (_, render_cfg, _), (_, sgd_cfg, _) = _semantic_runs()
    note(*_graph_path("semantic_render", render_cfg, dev, intr, n=2,
                      want=dict(segment_sum=render))[:2])
    note(*_graph_path("semantic_super_config", sgd_cfg, dev, intr, n=1,
                      want=dict(segment_sum=render))[:2])
    cfg = _semantic_models_config()
    models = build_models(cfg, seed=SEED, device=dev)
    note(*_graph_path("semantic_sf_corr", cfg, dev, intr, n=2,
                      models=models, want=dict(segment_sum=fit))[:2])
    note(*_graph_path("semantic_sf_corr_match_renderimg",
                      _semantic_models_config(match_renderimg=True), dev,
                      intr, n=1, models=models,
                      want=dict(segment_sum=render))[:2])
    del models
    note(*_graph_streams(dev, intr, "semantic", GRAPH_SEMANTIC_STREAMS))
    note(*_graph_pipeline(dev, intr, "semantic",
                          GRAPH_SEMANTIC_PIPELINE_FRAMES))
    return records, bad, launches


def phase_graph(dev, intr):
    """make_jit_step at 480 x 640.  The headline: GRAPH_WARM eager frames,
    then the capture, then GRAPH_FRAMES replays from that state, each
    frame's state and outputs bitwise the eager step's; GRAPH_REPEATS more
    replays of the first, bitwise (the segment sum's tickets and scratch),
    its tickets 0 after; the launches a replay by the counters and by a
    profiler trace of one replay (K1 10, data_gram 10, the segment sum
    40); the untraced ms/frame of the eager and the captured step in
    turns, GRAPH_TURNS each; device busy share, device ms and kernels of
    a traced replay and a traced eager frame; peak memory.  Then every
    other LM path of config.WORKLOADS, GRAPH_PATH_FRAMES replays each,
    bitwise the eager step, launches the eager step's; STREAMS streams in
    one graph; SuPerPipeline compiled against eager.  Then the autograd
    fit (:func:`_graph_semantic`): the bench's semantic workload as the
    headline (one eager frame, GRAPH_PATH_FRAMES replays,
    GRAPH_SEMANTIC_REPEATS repeats, the segment sum 20 a replay and no
    other kernel), the render-loss variant (2 replays, 30 a replay), SGD
    (``semantic_super_config()``, 1 replay), the sf_corr step with RAFT's
    flow once a frame (2 replays) and from the render at every evaluation
    (1 replay), GRAPH_SEMANTIC_STREAMS semantic streams in one graph and
    SuPerPipeline on GRAPH_SEMANTIC_PIPELINE_FRAMES semantic frames,
    compiled against eager, all bitwise.  Last the bench's headline and
    semantic_hz on both loops.  Returns the launches of the kernels'
    replays (``segment_sum_semantic``: the semantic replays')."""
    from super_tpu_torch.config import WORKLOADS, workload_config

    t0 = time.perf_counter()
    records, bad = [], []
    rec, ok, head = _graph_headline(dev, intr)
    emit(dict(phase="graph", **rec, ok=ok))
    records.append(rec)
    if not ok:
        bad.append("lm")
    launches = dict(head)
    paths = [n for n in WORKLOADS if n != "lm"
             and workload_config(n).solver.use_derived_gradient]
    for name in paths:
        rec, ok, got = _graph_path(name, workload_config(name), dev, intr)
        emit(dict(phase="graph", **rec, ok=ok))
        if not ok:
            bad.append(name)
        for k in ("pairs_cg_chunked", "tuple_gram", "dense_cg"):
            if name == {"pairs_cg_chunked": "dense16",
                        "tuple_gram": "per_iteration",
                        "dense_cg": "pcg_pallas"}[k]:
                launches[k] = got[k]
    for part in (_graph_streams, _graph_pipeline):
        rec, ok = part(dev, intr)
        emit(dict(phase="graph", **rec, ok=ok))
        if not ok:
            bad.append(rec["path"])
    sem_records, sem_bad, sem = _graph_semantic(dev, intr)
    bad += sem_bad
    launches["segment_sum_semantic"] = sem["segment_sum"]
    rec, ok = _graph_bench(dev)
    emit(dict(phase="graph", **rec, ok=ok))
    if not ok:
        bad.append("bench")
    emit(dict(phase="graph_summary",
              paths=["lm"] + paths + [r["path"] for r in sem_records],
              failed=bad, launches_graph=launches,
              seconds=time.perf_counter() - t0))
    if bad:
        raise RuntimeError(f"graph phase failed on {bad}")
    return launches


def _kernel_entry(name, source, replaces, launches, phase):
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=launches, max_abs_err=phase["max_abs_err"],
                ms=phase["ms"], plain_ms=phase["plain_ms"],
                bound_ms=phase["bound_ms"], bound_by=phase["bound_by"],
                library_ms=phase.get("library_ms"))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    import super_tpu_torch  # noqa: F401  (TF32 off, see its docstring)
    from super_tpu_torch.config import workload_config
    from super_tpu_torch.core.losses import associate, prepare_lm
    from super_tpu_torch.core.tracker import init_tracker

    parent_segsum = None
    if "--parent-segsum" in sys.argv:
        parent_segsum = sys.argv[sys.argv.index("--parent-segsum") + 1]
    card = card_line()
    phase_build(parent_segsum)
    k1 = phase_k1(dev)
    k1b = phase_k1b(dev)
    k3 = phase_k3(dev)
    phase_k3_cases(dev)
    cfg, intr, frames, launches = phase_main(dev)
    state = init_tracker(cfg, frames[0])
    ctx = prepare_lm(cfg, state.surfels, state.graph, frames[1])
    assoc = associate(cfg, ctx, intr)
    k2 = phase_k2(dev, cfg, ctx, assoc)
    k2_fused = phase_k2_fused(dev, cfg, ctx, assoc)
    phase_pair_path(dev, "path_main", cfg, ctx, assoc, intr)
    segsum = phase_segsum(dev, "lm", cfg, ctx, assoc, intr)["pair_rows"]
    phase_segsum_cases(dev)
    pcg_cfg = workload_config("pcg_pallas")
    pcg_ctx = prepare_lm(pcg_cfg, state.surfels, state.graph, frames[1])
    phase_segsum(dev, "pcg_pallas", pcg_cfg, pcg_ctx,
                 associate(pcg_cfg, pcg_ctx, intr), intr,
                 only=("dense_blocks",))
    del state, ctx, pcg_ctx
    phase_repeat(dev, cfg, intr, frames)
    phase_resume(dev, cfg, intr, frames)
    phase_zbuffer(dev, cfg, intr, frames)
    phase_reference(dev, cfg, intr, frames)
    dense_cfg, dense_launches = phase_dense(dev, intr, frames)
    state = init_tracker(dense_cfg, frames[0])
    ctx = prepare_lm(dense_cfg, state.surfels, state.graph, frames[1])
    assoc = associate(dense_cfg, ctx, intr)
    phase_k2(dev, dense_cfg, ctx, assoc, name="k2_dense")
    phase_k2_fused(dev, dense_cfg, ctx, assoc, name="k2_fused_dense")
    phase_pair_path(dev, "path_dense", dense_cfg, ctx, assoc, intr)
    phase_segsum(dev, "dense16", dense_cfg, ctx, assoc, intr)
    del state, ctx, assoc
    solver_launches = phase_solvers(dev, intr, frames)
    phase_dense_path(dev, intr, frames)
    option_launches = phase_options(dev, intr, frames)
    segsum_scatter = phase_segsum_scatter(dev, intr, frames)
    phase_proj_map_scatter(dev, cfg, intr, frames)
    sem_cfg, sem_frames, sem_launches = phase_semantic(dev, intr)
    segsum_sem = phase_segsum_semantic(dev, intr, sem_frames)
    phase_repeat_semantic(dev, sem_cfg, intr, sem_frames)
    phase_perception(dev, intr)
    e2e_launches = phase_e2e_depth(dev, intr)
    phase_semantic_models(dev, intr)
    ssim_cfg, ssim_frames, ssim_launches = phase_ssim_conf(dev, intr)
    observe_launches = phase_observe(dev, intr)
    phase_sol(dev)
    # The stream batch; then the sharded step and the stream mesh in two
    # processes, eager and (this slice's main path) captured by
    # make_multichip_step; and the bench's --streams.
    stream_launches = phase_streams(dev, cfg, intr)
    sharded_launches, mesh_launches = phase_parallel(dev, cfg, intr)
    phase_bench_streams(dev)
    # This slice's main path: the compiled step.
    graph_launches = phase_graph(dev, intr)
    # The timed phases are done: the workers' CPU load costs only the
    # CPU reference solves time from here on.
    pool, sequences = _start_sequences(intr, PIPELINE_SEEDS)
    cli_sequences = _start_cli_sequences(pool)
    try:
        phase_path_reference(intr, frames)
        phase_option_reference(intr, frames)
        phase_ssim_reference(intr, ssim_cfg, ssim_frames)
        del ssim_frames
        per_it_launches, k2_per_it = phase_per_iteration(dev, intr, frames)
        phase_semantic_reference(dev, sem_cfg, intr, sem_frames)
        phase_pipeline(dev, intr, sequences)
        cli_sequences = {k: f.result() for k, f in cli_sequences.items()}
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    phase_bench(dev)
    # This slice's entry points, on trials written to a temporary directory
    # (the pool is idle: the CLIs' frame times are the host's own).
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as root:
        dirs = phase_cli_data(root, cli_sequences)
        cli_launches = phase_cli_super(root, dirs, intr)
        cli_sem_launches = phase_cli_semantic(root, dirs)

    # The launches of K1, data_gram and the segment sum are those of this
    # slice's main path, the stream batch (STREAMS streams); each earlier
    # path's count rides beside, and the captured sharded step's and
    # stream mesh's replays per process.  The segment sum's time is that of the semantic
    # fit's anchor rows, with the headline's pair rows beside.
    def slice_counts(name):
        return dict(launches_graph=graph_launches[name],
                    launches_e2e_depth=e2e_launches[name],
                    launches_sharded_per_process=sharded_launches[name],
                    launches_stream_mesh_per_process=mesh_launches[name])

    segsum_entry = _kernel_entry(
        "segment_sum", "super_tpu_torch/csrc/segment_sum.cu", None,
        stream_launches["segment_sum"], segsum_sem)
    segsum_entry.update(slice_counts("segment_sum"))
    segsum_entry["launches_graph_semantic"] = graph_launches[
        "segment_sum_semantic"]
    # launches_cli: the CLI runs' (cli_super_default for tuple_gram and
    # the segment sum, cli_super_pairs for K1 and data_gram, beside the
    # segment sum's cli_semantic count).
    default_cli = cli_launches["cli_super_default"]
    pairs_cli = cli_launches["cli_super_pairs"]
    segsum_entry.update(launches_lm=launches["segment_sum"],
                        launches_semantic=sem_launches["segment_sum"],
                        launches_scatter=option_launches["scatter"][
                            "segment_sum"],
                        launches_ssim_conf=ssim_launches["segment_sum"],
                        launches_observe=observe_launches["segment_sum"],
                        launches_cli=default_cli["segment_sum"],
                        launches_cli_semantic=cli_sem_launches[
                            "segment_sum"],
                        lm_pair_rows_ms=segsum["ms"],
                        scatter_blocks_ms=segsum_scatter["ms"])
    k1_entry = _kernel_entry("pairs_cg", "super_tpu_torch/csrc/pairs_cg.cu",
                             "super_tpu/pallas_kernels/pcg.py:92",
                             stream_launches["pairs_cg"], k1)
    k1_entry.update(slice_counts("pairs_cg"))
    k1_entry.update(launches_lm=launches["pairs_cg"],
                    launches_hypotheses=option_launches["hypotheses"][
                        "pairs_cg"],
                    launches_ssim_conf=ssim_launches["pairs_cg"],
                    launches_observe=observe_launches["pairs_cg"],
                    launches_cli=pairs_cli["pairs_cg"])
    k2_entry = _kernel_entry("data_gram", "super_tpu_torch/csrc/tuple_gram.cu",
                             "super_tpu/pallas_kernels/gram.py:33",
                             stream_launches["data_gram"], k2_fused)
    k2_entry.update(slice_counts("data_gram"))
    k2_entry.update(launches_lm=launches["data_gram"],
                    launches_ssim_conf=ssim_launches["data_gram"],
                    launches_observe=observe_launches["data_gram"],
                    launches_cli=pairs_cli["data_gram"])
    emit({"kernels": [
        k1_entry,
        dict(_kernel_entry("pairs_cg_chunked",
                           "super_tpu_torch/csrc/pairs_cg.cu",
                           "super_tpu/pallas_kernels/pcg.py:177",
                           dense_launches["pairs_cg_chunked"], k1b),
             launches_graph=graph_launches["pairs_cg_chunked"]),
        dict(_kernel_entry("tuple_gram", "super_tpu_torch/csrc/tuple_gram.cu",
                           "super_tpu/pallas_kernels/gram.py:33",
                           per_it_launches["tuple_gram"], k2_per_it),
             launches_cli=default_cli["tuple_gram"],
             launches_graph=graph_launches["tuple_gram"]),
        k2_entry,
        dict(_kernel_entry("dense_cg", "super_tpu_torch/csrc/dense_cg.cu",
                           "super_tpu/pallas_kernels/pcg.py:32",
                           solver_launches["dense_cg"], k3),
             launches_hypotheses=option_launches["hypotheses_dense"][
                 "dense_cg"],
             launches_graph=graph_launches["dense_cg"]),
        segsum_entry,
    ]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
