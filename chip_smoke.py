#!/usr/bin/env python
"""Smoke check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's hand-written CUDA kernels from super_tpu_torch/csrc, holds
each against its plain PyTorch version on the card at the shapes of the
paths that run it, then drives three paths of the LM tracking step at
480 x 640 (synthetic frames -> preprocess_frame -> init_tracker ->
track_step) and checks that each went through its kernels and that its
results are right:

- main: the headline workload, ``lm_workload_config(480, 640, 30)``
  (J = 384, pair-sparse CG by K1, the data term's tuple Grams by K2 with
  the rows computed in the kernel, ``data_gram``);
- dense: the dense ED graph, ``lm_workload_config(480, 640, 16)``
  (J = 1216, pair-sparse CG by K1b, ``data_gram``);
- solvers: the headline workload with the dense-matrix solvers,
  ``linear_solver="pcg_pallas"`` (K3, ``data_gram``), then ``"cholesky"``
  and ``"pcg"``.

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
their path's own frame 1 (phases ``path_main`` and ``path_dense``).

Launch counts are set to 0 just before a path runs and read just after.
Each phase prints one JSON line; any failure raises and exits non-zero.  The
run ends with a ``{"kernels": [...]}`` summary line, the card's name and
power limit as nvidia-smi reports them, and ``{"ok": true, "device": ...}``.

Needs a CUDA card and nvcc; imports nothing of the JAX package.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

H100_HBM_BYTES_PER_S = 3.35e12     # HBM3, H100 SXM data sheet
H100_F32_FLOP_PER_S = 67e12        # f32 outside the tensor cores
MAIN_FRAMES = 5                    # tracked frames after frame 0
PATH_FRAMES = 3                    # tracked frames of the dense and solvers paths
SEED = 0
SOURCES = ("pairs_cg", "tuple_gram", "dense_cg")   # csrc/<name>.cu


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


def phase_k3(dev):
    """K3 against its plain version at path B's shapes (J = 384: dim
    2688, padded to 2816 in the wrapper), 32 iterations, on a seeded
    normal-equation-shaped system (the damped pair system as a dense
    matrix) block-preconditioned as the LM step does it."""
    from super_tpu_torch.core.lm import block_precondition, \
        example_pair_system
    from super_tpu_torch.kernels.pcg import dense_cg, dense_cg_plain

    j, iters = 384, 32
    layout, acc, rhs, u, _ = example_pair_system(j, 4096, SEED + 1,
                                                 device=dev)
    a64 = _pair_matrix(layout, acc, u, j, dev)
    a_hat, b_hat, _ = block_precondition(a64.float(), rhs, j)
    x_k = dense_cg(a_hat, b_hat, iterations=iters)
    x_p = dense_cg_plain(a_hat, b_hat, iterations=iters)
    torch.cuda.synchronize()
    a_hat64, b64 = a_hat.double(), b_hat.double()

    def resid(x):
        return float(torch.linalg.norm(a_hat64 @ x.double() - b64)
                     / torch.linalg.norm(b64))

    err = float(torch.max(torch.abs(x_k - x_p)))
    rel = err / float(torch.max(torch.abs(x_p)))
    res_k, res_p = resid(x_k), resid(x_p)
    ms = cuda_ms(lambda: dense_cg(a_hat, b_hat, iterations=iters), reps=50)
    enqueue_ms = host_ms(lambda: dense_cg(a_hat, b_hat, iterations=iters),
                         reps=20)
    plain_ms = cuda_ms(lambda: dense_cg_plain(a_hat, b_hat,
                                              iterations=iters), reps=10)
    dim = a_hat.shape[0]
    n = -(-dim // 256) * 256
    # Work: one matvec (2 dim^2) and ~10 operations per entry per
    # iteration.  Bytes: the matrix and b read once, x written.  From L2
    # the kernel reads the padded matrix once per iteration.
    flops = iters * (2 * dim * dim + 10 * dim)
    nbytes = (dim * dim + 2 * dim) * 4
    b_ms, b_by = bound(nbytes, flops)
    l2_bytes = iters * n * n * 4
    # f32 CG, 32 iterations, sums in other orders: 1e-4 relative to |x|,
    # and the same residual.
    if not (math.isfinite(rel) and rel < 1e-4 and res_k < 2 * res_p + 1e-5):
        raise RuntimeError(f"K3 disagrees: rel {rel}, residuals {res_k} "
                           f"vs {res_p}")
    out = dict(phase="k3", j=j, dim=dim, dim_padded=n, iterations=iters,
               max_abs_err=err, max_rel_err=rel, residual_kernel=res_k,
               residual_plain=res_p, ms=ms, host_enqueue_ms=enqueue_ms,
               plain_ms=plain_ms, bound_ms=b_ms,
               bound_by=b_by, bytes=nbytes, flops=flops, l2_bytes=l2_bytes,
               l2_gb_per_s=l2_bytes / ms / 1e6)
    emit(out)
    return out


def phase_k2(dev, cfg, ctx, assoc, name="k2"):
    """K2 against its plain version on a path's own rows (a real
    block_tuple from build_tuple_layout on synthetic 480 x 640 frames)."""
    from super_tpu_torch.core.losses import data_rows
    from super_tpu_torch.geometry.quaternion import identity_dq
    from super_tpu_torch.kernels.gram import tuple_gram, tuple_gram_plain

    gen = torch.Generator(device="cpu").manual_seed(SEED)
    j_cap = cfg.capacity.node_capacity
    beta = identity_dq(dev)[None].repeat(j_cap, 1)
    beta = beta + 1e-3 * torch.randn((j_cap, 7), generator=gen).to(dev)
    h, r = data_rows(ctx, beta, cfg.losses.sf_point_plane_weight, assoc)
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


def _frames(cfg, intr, n, dev, seed=SEED):
    from super_tpu_torch.core.preprocess import preprocess_frame
    from super_tpu_torch.data.synthetic import generate

    seq = generate(n, cfg.height, cfg.width, intr=intr, seed=seed)
    colors = np.ascontiguousarray(seq.colors.transpose(0, 3, 1, 2))
    return [preprocess_frame(cfg, intr, seq.depths[t], colors[t], float(t),
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
    from super_tpu_torch.kernels import gram, pcg

    return {"pairs_cg": pcg.pairs_cg, "pairs_cg_chunked": pcg.pairs_cg_chunked,
            "tuple_gram": gram.tuple_gram, "data_gram": gram.data_gram,
            "dense_cg": pcg.dense_cg}


def _run_path(name, cfg, intr, frames, per_trip):
    """Track ``frames`` (frame 0 initialises) with every step under sync
    debug mode "error", the launch counts zeroed just before and read just
    after.  ``per_trip``: the kernels that must launch once per LM trip;
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
    want = {k: trips if k in per_trip else 0 for k in wrappers}
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
                         ("pairs_cg", "data_gram"))
    return cfg, intr, frames, launches


def phase_dense(dev, intr, frames):
    """Path A, the dense ED graph (mesh step 16, J = 1216): K1b and K2
    (``data_gram``) once per LM trip, K1 never.  The synthetic frames do
    not depend on the mesh step, so the main path's are reused."""
    from super_tpu_torch.config import workload_config

    cfg = workload_config("dense16")
    launches = _run_path("dense", cfg, intr, frames[:PATH_FRAMES + 1],
                         ("pairs_cg_chunked", "data_gram"))
    return cfg, launches


def phase_solvers(dev, intr, frames):
    """Path B, the dense-matrix solvers on the headline workload: K3 and K2
    (``data_gram``) once per LM trip with "pcg_pallas"; then "cholesky" and
    "pcg" (K2 only) for one frame each."""
    from super_tpu_torch.config import workload_config

    launches = _run_path("solvers", workload_config("pcg_pallas"), intr,
                         frames[:PATH_FRAMES + 1], ("dense_cg", "data_gram"))
    for solver in ("cholesky", "pcg"):
        _run_path(f"solvers_{solver}", workload_config(solver), intr,
                  frames[:2], ("data_gram",))
    return launches


def _frame1_vs_cpu(cfg, intr, frames):
    """Frame 1's LM solve at full size on the card and on the CPU path from
    identical inputs: (max |beta| difference, cost relative difference,
    CPU seconds)."""
    from super_tpu_torch.core.lm import lm_solve
    from super_tpu_torch.core.losses import prepare_lm
    from super_tpu_torch.core.tracker import init_tracker

    def to(x, d):
        if isinstance(x, torch.Tensor):
            return x.to(d)
        return type(x)(*(to(v, d) for v in x))

    state = init_tracker(cfg, frames[0])
    res_c = lm_solve(cfg, prepare_lm(cfg, state.surfels, state.graph,
                                     frames[1]), intr)
    cpu = torch.device("cpu")
    state_h, frame_h, intr_h = to(state, cpu), to(frames[1], cpu), \
        to(intr, cpu)
    t0 = time.perf_counter()
    res_h = lm_solve(cfg, prepare_lm(cfg, state_h.surfels, state_h.graph,
                                     frame_h), intr_h)
    cpu_s = time.perf_counter() - t0
    beta_err = float(torch.max(torch.abs(res_c.beta.cpu() - res_h.beta)))
    cost_rel = abs(float(res_c.cost) - float(res_h.cost)) / float(res_h.cost)
    return beta_err, cost_rel, float(res_c.cost), cpu_s


def phase_path_reference(intr, frames):
    """Frame 1 of path A and of path B's "pcg_pallas" and "cholesky" against
    the CPU path (same tolerances as the main path's frame 1)."""
    from super_tpu_torch.config import workload_config

    out = {}
    for name in ("dense16", "pcg_pallas", "cholesky"):
        cfg = workload_config(name)
        beta_err, cost_rel, cost, cpu_s = _frame1_vs_cpu(cfg, intr, frames)
        out[name] = dict(beta_max_abs_err=beta_err, cost_rel_err=cost_rel,
                         cost=cost, cpu_s=cpu_s)
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
    beta_err, cost_rel, cost, cpu_s = _frame1_vs_cpu(cfg, intr, frames)

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


def _kernel_entry(name, source, replaces, launches, phase):
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=launches, max_abs_err=phase["max_abs_err"],
                ms=phase["ms"], plain_ms=phase["plain_ms"],
                bound_ms=phase["bound_ms"], bound_by=phase["bound_by"],
                library_ms=None)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    import super_tpu_torch  # noqa: F401  (TF32 off, see its docstring)
    from super_tpu_torch.core.losses import associate, prepare_lm
    from super_tpu_torch.core.tracker import init_tracker

    card = card_line()
    phase_build()
    k1 = phase_k1(dev)
    k1b = phase_k1b(dev)
    k3 = phase_k3(dev)
    cfg, intr, frames, launches = phase_main(dev)
    state = init_tracker(cfg, frames[0])
    ctx = prepare_lm(cfg, state.surfels, state.graph, frames[1])
    assoc = associate(cfg, ctx, intr)
    k2 = phase_k2(dev, cfg, ctx, assoc)
    k2_fused = phase_k2_fused(dev, cfg, ctx, assoc)
    phase_pair_path(dev, "path_main", cfg, ctx, assoc, intr)
    del state, ctx
    phase_reference(dev, cfg, intr, frames)
    dense_cfg, dense_launches = phase_dense(dev, intr, frames)
    state = init_tracker(dense_cfg, frames[0])
    ctx = prepare_lm(dense_cfg, state.surfels, state.graph, frames[1])
    assoc = associate(dense_cfg, ctx, intr)
    phase_k2(dev, dense_cfg, ctx, assoc, name="k2_dense")
    phase_k2_fused(dev, dense_cfg, ctx, assoc, name="k2_fused_dense")
    phase_pair_path(dev, "path_dense", dense_cfg, ctx, assoc, intr)
    del state, ctx, assoc
    solver_launches = phase_solvers(dev, intr, frames)
    phase_path_reference(intr, frames)

    emit({"kernels": [
        _kernel_entry("pairs_cg", "super_tpu_torch/csrc/pairs_cg.cu",
                      "super_tpu/pallas_kernels/pcg.py:92",
                      launches["pairs_cg"], k1),
        _kernel_entry("pairs_cg_chunked",
                      "super_tpu_torch/csrc/pairs_cg.cu",
                      "super_tpu/pallas_kernels/pcg.py:177",
                      dense_launches["pairs_cg_chunked"], k1b),
        _kernel_entry("tuple_gram", "super_tpu_torch/csrc/tuple_gram.cu",
                      "super_tpu/pallas_kernels/gram.py:33",
                      launches["tuple_gram"], k2),
        _kernel_entry("data_gram", "super_tpu_torch/csrc/tuple_gram.cu",
                      "super_tpu/pallas_kernels/gram.py:33",
                      launches["data_gram"], k2_fused),
        _kernel_entry("dense_cg", "super_tpu_torch/csrc/dense_cg.cu",
                      "super_tpu/pallas_kernels/pcg.py:32",
                      solver_launches["dense_cg"], k3),
    ]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
