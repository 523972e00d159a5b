#!/usr/bin/env python
"""Smoke check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's hand-written CUDA kernels from super_tpu_torch/csrc, holds
each against its plain PyTorch version on the card at the shapes of the main
path, then drives the main path -- the LM tracking step at 480 x 640
(synthetic frames -> preprocess_frame -> init_tracker -> track_step) -- and
checks that it went through the kernels and that its results are right.
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
SEED = 0


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


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
    logs = build.build(["pairs_cg", "tuple_gram"])   # nvcc runs in parallel
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, log in logs.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "arch": "sm_90a", "ptxas": ptxas})


def phase_k1(dev):
    """K1 against its plain version at the headline shapes (J = 384,
    P = 4096, 32 iterations) on a seeded well-posed pair system."""
    from super_tpu_torch.core.lm import example_pair_system, pairs_band_system
    from super_tpu_torch.kernels.pcg import pairs_cg, pairs_cg_plain

    j, p, iters = 384, 4096, 32
    layout, acc, rhs, u, x0 = example_pair_system(j, p, SEED, device=dev)
    args = pairs_band_system(layout, acc, rhs, u, j, x0)
    x_k = pairs_cg(*args, iterations=iters)
    x_p = pairs_cg_plain(*args, iterations=iters)
    torch.cuda.synchronize()

    # The damped system as a dense matrix, for the residuals.
    n12 = (layout.pair_dest.long() // 7)
    dense = torch.zeros((7 * j + 7, 7 * j + 7), dtype=torch.float64,
                        device=dev)
    rows = (7 * n12[:, 0, None, None] + torch.arange(7, device=dev)[:, None])
    cols = (7 * n12[:, 1, None, None] + torch.arange(7, device=dev)[None, :])
    dense.index_put_((rows.expand(p, 7, 7), cols.expand(p, 7, 7)),
                     acc.reshape(p, 7, 7).double(), accumulate=True)
    dense = dense[:7 * j, :7 * j]
    a = dense + dense.T + float(u) * torch.eye(7 * j, dtype=torch.float64,
                                              device=dev)
    b = rhs.double()

    def resid(x_fm):
        x = x_fm.T.reshape(-1).double()
        return float(torch.linalg.norm(a @ x - b) / torch.linalg.norm(b))

    err = float(torch.max(torch.abs(x_k - x_p)))
    rel = err / float(torch.max(torch.abs(x_p)))
    res_k, res_p = resid(x_k), resid(x_p)
    ms = cuda_ms(lambda: pairs_cg(*args, iterations=iters), reps=50)
    plain_ms = cuda_ms(lambda: pairs_cg_plain(*args, iterations=iters),
                       reps=5)
    # Work of this run: each valid pair costs two 7x7 block products per
    # matvec; the preconditioner one per node; dots and updates ~10 per
    # vector entry.  Bytes: every input read once, the solution written.
    n1, n2 = args[2], args[3]
    p_valid = int(((n1 < j) & (n2 < j)).sum())
    flops = (iters + 1) * (2 * 2 * 49 * p_valid + 2 * 49 * j + 10 * 7 * j)
    nbytes = sum(t.numel() * t.element_size() for t in args) + 7 * j * 4
    b_ms, b_by = bound(nbytes, flops)
    # What the design reads from L2 instead: both pair tables per matvec and
    # the preconditioner per iteration (the kernel reads 49 of 64 band rows).
    l2_bytes = (iters + 1) * 4 * 49 * (2 * p_valid + j)
    # The kernel is right if it agrees with the plain recurrence to f32
    # reassociation (32 iterations): 1e-4 relative to |x|; and both solve
    # the system to the same residual.
    if not (math.isfinite(rel) and rel < 1e-4 and res_k < 2 * res_p + 1e-5):
        raise RuntimeError(f"K1 disagrees: rel {rel}, residuals {res_k} "
                           f"vs {res_p}")
    out = dict(phase="k1", j=j, p=p, iterations=iters, max_abs_err=err,
               max_rel_err=rel, residual_kernel=res_k, residual_plain=res_p,
               ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
               bytes=nbytes, flops=flops, l2_bytes=l2_bytes,
               l2_gb_per_s=l2_bytes / ms / 1e6)
    emit(out)
    return out


def phase_k2(dev, cfg, ctx, assoc):
    """K2 against its plain version on the main path's own rows (a real
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
    g_p, j_p = tuple_gram_plain(h, r, bt, **kw)
    torch.cuda.synchronize()
    err = max(float(torch.max(torch.abs(g_k - g_p))),
              float(torch.max(torch.abs(j_k - j_p))))
    scale = max(float(torch.max(torch.abs(g_p))),
                float(torch.max(torch.abs(j_p))))
    sym = float(torch.max(torch.abs(g_k - g_k.transpose(1, 2))))
    ms = cuda_ms(lambda: tuple_gram(h, r, bt, **kw), reps=20)
    plain_ms = cuda_ms(lambda: tuple_gram_plain(h, r, bt, **kw), reps=5)
    np_cap = h.shape[0]
    t_cap = kw["tuple_cap"]
    flops = 2 * np_cap * 28 * 29
    nbytes = (h.numel() + r.numel() + bt.numel() + t_cap * 28 * 29) * 4
    b_ms, b_by = bound(nbytes, flops)
    # f32 sums of the same products in other orders (64 rows, then the
    # blocks of a tuple): 1e-5 relative to the largest entry.  The kernel
    # forms (i, j) and (j, i) by one chain: its Grams are exactly symmetric.
    if not (math.isfinite(err) and err <= 1e-5 * scale and sym == 0.0):
        raise RuntimeError(f"K2 disagrees: err {err} (scale {scale}), "
                           f"asymmetry {sym}")
    out = dict(phase="k2", np=np_cap, tuples=t_cap,
               blocks=int(bt.numel()), max_abs_err=err, scale=scale,
               asymmetry=sym, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
               bound_by=b_by, bytes=nbytes, flops=flops)
    emit(out)
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


def phase_main(dev):
    """The main path at 480 x 640: counts zeroed before, read after."""
    from super_tpu_torch.config import lm_workload_config
    from super_tpu_torch.data.synthetic import default_intrinsics
    from super_tpu_torch.kernels.gram import tuple_gram
    from super_tpu_torch.kernels.pcg import pairs_cg

    cfg = lm_workload_config(480, 640, 30)
    intr = default_intrinsics(cfg.height, cfg.width, device=dev)
    t0 = time.perf_counter()
    frames = _frames(cfg, intr, MAIN_FRAMES + 1, dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    pairs_cg.launches = 0
    tuple_gram.launches = 0
    state, outs, times = _track(cfg, intr, frames, timed=True)
    launches = {"pairs_cg": pairs_cg.launches,
                "tuple_gram": tuple_gram.launches}

    counters = ("tuple_overflow", "pair_overflow", "proj_overflow",
                "add_overflow", "free_exhausted", "dup_skipped")
    per_frame = [dict(frame=i + 1, ms=t, lm_cost=float(o.lm_cost),
                      lm_damping=float(o.lm_damping),
                      num_surfels=int(o.num_surfels),
                      num_nodes=int(o.num_nodes),
                      **{c: int(getattr(o, c)) for c in counters})
                 for i, (o, t) in enumerate(zip(outs, times))]
    trips = cfg.solver.num_iterations * MAIN_FRAMES
    ok = (all(math.isfinite(f["lm_cost"]) for f in per_frame)
          and all(f["num_surfels"] > 0 for f in per_frame)
          and launches == {"pairs_cg": trips, "tuple_gram": trips})
    steady = times[1:] or times
    emit(dict(phase="main", height=cfg.height, width=cfg.width,
              nodes=per_frame[0]["num_nodes"],
              node_capacity=cfg.capacity.node_capacity,
              surfel_capacity=cfg.capacity.surfel_capacity,
              lm_trips=trips, launches=launches, setup_s=setup_s,
              ms_per_frame_steady=sum(steady) / len(steady),
              peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
              frames=per_frame))
    if not ok:
        raise RuntimeError("main path check failed (finite cost, surfels, one "
                           f"K1 and one K2 launch per LM trip): {launches}")
    return cfg, intr, frames, launches


def phase_reference(dev, cfg, intr, frames):
    """Results against the port's plain path on the CPU, which the CPU
    tests hold against the JAX package: (a) frame 1's LM solve at full size
    from identical inputs; (b) a 4-frame tiny scene (48 x 64, mesh step 8)
    tracked on the card and on the CPU."""
    from super_tpu_torch.config import CapacityConfig, SolverConfig, \
        SuPerConfig
    from super_tpu_torch.core.lm import lm_solve
    from super_tpu_torch.core.losses import prepare_lm
    from super_tpu_torch.core.tracker import init_tracker
    from super_tpu_torch.data.synthetic import default_intrinsics

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
              frame1_cost_rel_err=cost_rel, frame1_cost=float(res_c.cost),
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
    cfg, intr, frames, launches = phase_main(dev)
    state = init_tracker(cfg, frames[0])
    ctx = prepare_lm(cfg, state.surfels, state.graph, frames[1])
    k2 = phase_k2(dev, cfg, ctx, associate(cfg, ctx, intr))
    del state, ctx
    phase_reference(dev, cfg, intr, frames)

    emit({"kernels": [
        dict(name="pairs_cg", route="cuda",
             source="super_tpu_torch/csrc/pairs_cg.cu",
             replaces="super_tpu/pallas_kernels/pcg.py:92",
             launches=launches["pairs_cg"], max_abs_err=k1["max_abs_err"],
             ms=k1["ms"], plain_ms=k1["plain_ms"], bound_ms=k1["bound_ms"],
             bound_by=k1["bound_by"], library_ms=None),
        dict(name="tuple_gram", route="cuda",
             source="super_tpu_torch/csrc/tuple_gram.cu",
             replaces="super_tpu/pallas_kernels/gram.py:33",
             launches=launches["tuple_gram"], max_abs_err=k2["max_abs_err"],
             ms=k2["ms"], plain_ms=k2["plain_ms"], bound_ms=k2["bound_ms"],
             bound_by=k2["bound_by"], library_ms=None),
    ]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
