#!/usr/bin/env python
"""Smoke check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

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
  kernel's counterpart.

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
and the pcg_pallas path's frame-1 assembly (``segsum``).  ``repeat``
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
of the render.  The kernels line's launches of K1, ``data_gram`` and the
segment sum are ``e2e_depth``'s, each earlier path's beside.

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
import subprocess
import sys
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


def phase_build():
    from super_tpu_torch.kernels import build

    t0 = time.perf_counter()
    logs = build.build(SOURCES)   # one nvcc per source, all at once
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, log in logs.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "arch": "sm_90a", "ptxas": ptxas})


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


def _segsum_check(path, name, values, plan, kw):
    """One sum by the kernel against its plain version: max abs error <=
    1e-6 of the largest sum, two launches bitwise equal; the kernel's time,
    the plain version's, index_add_'s alone and the bound.  Returns the
    record."""
    from super_tpu_torch.kernels.segsum import segment_sum, segment_sum_plain

    values = values.detach()
    out_k, out_k2 = segment_sum(values, plan, **kw), \
        segment_sum(values, plan, **kw)
    out_p = segment_sum_plain(values, plan, **kw)
    torch.cuda.synchronize()
    err = float(torch.max(torch.abs(out_k - out_p)))
    scale = float(torch.max(torch.abs(out_p)))
    bitwise = bool(torch.equal(out_k, out_k2))
    acc = torch.zeros_like(out_p)
    ms = cuda_ms(lambda: segment_sum(values, plan, **kw), reps=20)
    ms_dev = cuda_ms(lambda: segment_sum(values, plan, **kw), reps=20,
                     queued=True)
    enqueue_ms = host_ms(lambda: segment_sum(values, plan, **kw), reps=20)
    plain_ms = cuda_ms(lambda: segment_sum_plain(values, plan, **kw),
                       reps=20)
    library_ms = cuda_ms(lambda: acc.index_add_(0, plan.ids, values),
                         reps=20)
    r, s_ = values.shape[0], plan.num_segments
    base = kw.get("base") is not None
    nbytes = (values.numel() + r + s_ + 1
              + out_p.numel() * (2 if base else 1)) * 4
    b_ms, b_by = bound(nbytes, values.numel())
    seg_len = torch.diff(plan.offsets)
    rec = dict(phase="segsum", path=path, sum=name, rows=r, segments=s_,
               width=values.numel() // r, sum_dtype=kw.get("sum_dtype"),
               base=base, longest_segment=int(seg_len.max()),
               empty_segments=int((seg_len == 0).sum()),
               max_abs_err=err, scale=scale, bitwise=bitwise, ms=ms,
               ms_device=ms_dev, host_enqueue_ms=enqueue_ms,
               plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms,
               bound_by=b_by, bytes=nbytes)
    emit(rec)
    # One f32 sum per output in another order than index_add_'s atomics (a
    # long segment adds its chunks' totals): 1e-6 of the largest sum; a
    # fixed order: the same bits every launch.
    if not (math.isfinite(err) and err <= 1e-6 * scale and bitwise):
        raise RuntimeError(f"segment_sum disagrees on {path} {name}: {rec}")
    return rec


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
    launches, from a torch.profiler trace."""
    from torch.autograd import DeviceType

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    # The device timeline also mirrors host ranges; a kernel's name is
    # never a host event's.
    host = {e.name for e in prof.events() if e.device_type == DeviceType.CPU}
    return sum(1 for e in prof.events()
               if e.device_type == DeviceType.CUDA and e.name not in host)


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
    """python -m super_tpu_torch.bench's measurement at 6 frames."""
    from super_tpu_torch import bench

    out = bench.measure(reps=6, device=dev)
    print(json.dumps(out), flush=True)
    return out


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

    card = card_line()
    phase_build()
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
    pcg_cfg = workload_config("pcg_pallas")
    pcg_ctx = prepare_lm(pcg_cfg, state.surfels, state.graph, frames[1])
    phase_segsum(dev, "pcg_pallas", pcg_cfg, pcg_ctx,
                 associate(pcg_cfg, pcg_ctx, intr), intr,
                 only=("dense_blocks",))
    del state, ctx, pcg_ctx
    phase_repeat(dev, cfg, intr, frames)
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
    sem_cfg, sem_frames, sem_launches = phase_semantic(dev, intr)
    segsum_sem = phase_segsum_semantic(dev, intr, sem_frames)
    phase_repeat_semantic(dev, sem_cfg, intr, sem_frames)
    phase_perception(dev, intr)
    e2e_launches = phase_e2e_depth(dev, intr)
    phase_semantic_models(dev, intr)
    # The timed phases are done: the workers' CPU load costs only the
    # CPU reference solves time from here on.
    pool, sequences = _start_sequences(intr, PIPELINE_SEEDS)
    try:
        phase_path_reference(intr, frames)
        per_it_launches, k2_per_it = phase_per_iteration(dev, intr, frames)
        phase_semantic_reference(dev, sem_cfg, intr, sem_frames)
        phase_pipeline(dev, intr, sequences)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    phase_bench(dev)

    # The launches of K1, data_gram and the segment sum are those of this
    # slice's main path, the live path with monodepth2's depth; each
    # earlier path's count rides beside.  The segment sum's time is that
    # of the semantic fit's anchor rows, with the headline's pair rows
    # beside.
    segsum_entry = _kernel_entry(
        "segment_sum", "super_tpu_torch/csrc/segment_sum.cu", None,
        e2e_launches["segment_sum"], segsum_sem)
    segsum_entry.update(launches_lm=launches["segment_sum"],
                        launches_semantic=sem_launches["segment_sum"],
                        lm_pair_rows_ms=segsum["ms"])
    k1_entry = _kernel_entry("pairs_cg", "super_tpu_torch/csrc/pairs_cg.cu",
                             "super_tpu/pallas_kernels/pcg.py:92",
                             e2e_launches["pairs_cg"], k1)
    k1_entry.update(launches_lm=launches["pairs_cg"])
    k2_entry = _kernel_entry("data_gram", "super_tpu_torch/csrc/tuple_gram.cu",
                             "super_tpu/pallas_kernels/gram.py:33",
                             e2e_launches["data_gram"], k2_fused)
    k2_entry.update(launches_lm=launches["data_gram"])
    emit({"kernels": [
        k1_entry,
        _kernel_entry("pairs_cg_chunked",
                      "super_tpu_torch/csrc/pairs_cg.cu",
                      "super_tpu/pallas_kernels/pcg.py:177",
                      dense_launches["pairs_cg_chunked"], k1b),
        _kernel_entry("tuple_gram", "super_tpu_torch/csrc/tuple_gram.cu",
                      "super_tpu/pallas_kernels/gram.py:33",
                      per_it_launches["tuple_gram"], k2_per_it),
        k2_entry,
        _kernel_entry("dense_cg", "super_tpu_torch/csrc/dense_cg.cu",
                      "super_tpu/pallas_kernels/pcg.py:32",
                      solver_launches["dense_cg"], k3),
        segsum_entry,
    ]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
