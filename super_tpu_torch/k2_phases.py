"""Where the time of kernel K2 goes, on one CUDA card.

    python -m super_tpu_torch.k2_phases [--workload lm] [--rounds 2]

Builds copies of csrc/tuple_gram.cu that each leave out one phase of the
kernel (their results are wrong by design; only their times count) or
change its occupancy, and times each copy's ``data_gram`` and
``tuple_gram`` on the workload's frame-1 context (``config.workload_config``,
480 x 640), in turns, as the device time alone of 20 queued launches.
A phase's cost is the full kernel's time less the copy's without it.
Prints the card's name and power limit, then one JSON line a copy and round.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import torch

# (name, [(text of csrc/tuple_gram.cu, its replacement), ...]).
VARIANTS = (
    ("full", []),
    ("empty", [("  __shared__ Smem sm;\n",
                "  __shared__ Smem sm;\n  if (a.T > 0) return;\n")]),
    ("no_products", [("      if (w.owner && sm.live[j]) {",
                      "      if (false) {")]),
    ("no_row_math", [("  if (in.live) {\n", "  if (false) {\n")]),
    ("no_tuple_constants", [
        ("src.beta[(size_t)node * 7 + q % 7]", "0.f"),
        ("src.tuple_knn[(size_t)(q - D) * T + t]", "0.f")]),
    ("no_zero_tuples", [("write_zero(a, t);\n", ";\n")]),
    ("no_combine", [("  if (b1 > b0) {\n    const int tf",
                     "  if (false) {\n    const int tf")]),
    ("two_ctas_an_sm", [("__launch_bounds__(NT, 3)",
                         "__launch_bounds__(NT, 2)")]),
)


def _build():
    from super_tpu_torch.kernels import build, gram

    src = (build.CSRC / "tuple_gram.cu").read_text()
    out = build.BUILD_DIR.parent / "k2_phases"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS:
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}: csrc/tuple_gram.cu has no "
                                   f"{old!r}; update k2_phases.VARIANTS")
            text = text.replace(old, new)
        cu = out / f"{name}.cu"
        cu.write_text(text)
        so = out / f"{name}.so"
        procs[name] = (subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc exit {proc.returncode}\n{log}")
        libs[name] = gram.declare(ctypes.CDLL(str(so)))
        print(json.dumps(dict(variant=name, ptxas=[
            ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln])), flush=True)
    return libs


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="lm")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k2_phases: no CUDA device")
    import super_tpu_torch  # noqa: F401  (TF32 off)
    from super_tpu_torch.config import workload_config
    from super_tpu_torch.core.losses import associate, data_rows, prepare_lm
    from super_tpu_torch.core.preprocess import preprocess_frame
    from super_tpu_torch.core.tracker import init_tracker
    from super_tpu_torch.data.synthetic import default_intrinsics, generate
    from super_tpu_torch.geometry.quaternion import identity_dq
    from super_tpu_torch.kernels import gram

    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    libs = _build()
    cfg = workload_config(args.workload)
    intr = default_intrinsics(cfg.height, cfg.width, device=dev)
    seq = generate(2, cfg.height, cfg.width, intr=intr, seed=0)
    frames = [preprocess_frame(cfg, intr, seq.depths[t],
                               seq.colors[t].transpose(2, 0, 1).copy(),
                               float(t), device=dev) for t in range(2)]
    state = init_tracker(cfg, frames[0])
    ctx = prepare_lm(cfg, state.surfels, state.graph, frames[1])
    assoc = associate(cfg, ctx, intr)
    gen = torch.Generator(device="cpu").manual_seed(0)
    j_cap = cfg.capacity.node_capacity
    beta = identity_dq(dev)[None].repeat(j_cap, 1) + 1e-3 * torch.randn(
        (j_cap, 7), generator=gen).to(dev)
    weight = cfg.losses.sf_point_plane_weight
    g = cfg.solver.assembly_pad_group
    layout = ctx.layout
    h, r = data_rows(ctx, beta, weight, assoc)

    def device_ms(fn, reps=20):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)   # queue all launches first
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    # The wrappers launch whichever build gram._lib returns.
    for rnd in range(args.rounds):
        for name, lib in libs.items():
            gram._lib = lambda lib=lib: lib
            gram._scratch_floats.cache_clear()
            data_ms = device_ms(lambda: gram.data_gram(ctx, beta, weight,
                                                       assoc, block=g))
            memory_ms = device_ms(lambda: gram.tuple_gram(
                h, r, layout.block_tuple,
                tuple_cap=layout.tuple_nodes.shape[0], block=g))
            print(json.dumps(dict(workload=args.workload, variant=name,
                                  round=rnd, data_gram_ms=data_ms,
                                  tuple_gram_ms=memory_ms)), flush=True)


if __name__ == "__main__":
    main()
