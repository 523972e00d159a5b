"""Speed-of-light cost model of the tracking step's hot stages on one
NVIDIA H100 (counterpart of super_tpu/utils/sol.py, with the same
functions and terms and the card's own constants).

Every measured stage gets a denominator: a modelled floor built from the
card's primitive costs and its physical limits, so that "is it fast" is a
number (``sol_frac = floor / achieved``).  The assembly also reports the
share of the f32 peak its Gram products reach (``mfu``).

Constants:
- streaming: 3.35 TB/s of HBM3, and the f32 peak outside the tensor cores,
  67 TFLOP/s (TF32 stays off), as ``chip_smoke.py:bound()`` takes them;
  bf16 989 TFLOP/s dense (NVIDIA's H100 SXM data sheet, 700 W);
- measured on the card by ``chip_smoke.py``'s ``sol`` phase (device time
  alone, the mean of back-to-back calls between CUDA events): the
  ``index_select`` of F = 8, 17 and 28 rows of a (F, 393,216) f32 array at
  393,216 random indices, fitted to a fixed cost plus bytes at a random
  access rate; a scatter of 393,216 f32 elements to random places; a
  ``torch.sort`` of 393,216 int64 keys packing three sort keys; and one
  launch of a one-element kernel (the dispatch a solve pays at least).

The floors are models, not guarantees: they flag stages below half of
the model, so that headroom and regressions show in the bench's line.
"""

from __future__ import annotations

HBM_GBPS = 3350.0
PEAK_TFLOPS = {"bf16": 989.0, "f32": 67.0}
# Measured by chip_smoke.py's sol phase in chip run 3 of PR 12, on an
# NVIDIA H100 80GB HBM3 at a 700.00 W power limit: the gathers of 8, 17
# and 28 rows took 0.030062, 0.064682 and 0.103187 ms (least-squares fit:
# 0.001484 ms fixed, 430.86 GB/s); the scatter 0.009986 ms; the sort
# 0.138573 ms; the launch 0.0020197 ms.
RAND_GATHER_GBPS = 430.86
GATHER_FIXED_MS = 0.001484
SCATTER_NS_PER_ELEM = 0.025395
SORT3_MS_PER_393K = 0.138573
LAUNCH_MS = 0.0020197


def gather_ms(n_idx: float, rows: float, elem_bytes: float = 4.0) -> float:
    return GATHER_FIXED_MS + n_idx * rows * elem_bytes / (
        RAND_GATHER_GBPS * 1e6)


def scatter_ms(n_elem: float) -> float:
    return n_elem * SCATTER_NS_PER_ELEM * 1e-6


def stream_ms(n_bytes: float) -> float:
    return n_bytes / (HBM_GBPS * 1e6)


def matmul_ms(flops: float, dtype: str = "f32") -> float:
    return flops / (PEAK_TFLOPS[dtype] * 1e9)


def sort3_ms(n: float) -> float:
    return SORT3_MS_PER_393K * n / 393216.0


def stage_floors(np_cap: int, p: int, j: int, t_cap: int, k: int = 4,
                 a_cap: int = 8192, pcg_iters: int = 32,
                 num_lm_iters: int = 10, pair_cap: int = 8192) -> dict:
    """Modelled floors (ms) of the per-frame workload's stages.

    np_cap: surfel capacity; p: pixels; j: node capacity; t_cap: tuple
    cap; pair_cap: the pair table's capacity (the JAX package's model
    takes 8192, its ``assembly_pair_cap`` default).  Each term names the
    operation it models.
    """
    f = 4.0  # f32 bytes

    # associate (identity): one 16-row z-bank gather + streaming the
    # (K..3K, Np) geometry in and (3, Np) x2 + mask out.
    assoc = (gather_ms(np_cap, 16)
             + stream_ms((7 * k + 7) * np_cap * f))

    # frozen assembly trip: geometry and association rows streamed, the
    # 28 x 29 Gram per surfel, and the JAX package's block -> tuple sum as
    # a bf16 one-hot product (t_cap x blocks of 256).
    gram_flops = np_cap * 28 * 29 * 2
    seg_flops = (np_cap / 256) * t_cap * 28 * 29 * 2
    assemble = (stream_ms((7 * k + 8) * np_cap * f)
                + matmul_ms(gram_flops, "f32")
                + matmul_ms(seg_flops, "bf16"))

    # pair-sparse CG damped solve (K1): the band tables streamed in, plus
    # one launch.
    solve = stream_ms(2 * 64 * pair_cap * f) + LAUNCH_MS

    # fusion, steady-state fast path: 3-key sort, the 9-row frame gather,
    # the consumed-pixel scatter, the pair-packed reweight gather, the
    # candidate gather, KNN product and packed column scatter.
    fuse = (sort3_ms(np_cap)
            + gather_ms(np_cap, 9) + scatter_ms(np_cap)
            + gather_ms(k / 2 * np_cap, 2 * 4)
            + gather_ms(a_cap, 14) + matmul_ms(a_cap * j * 8, "f32")
            + scatter_ms(26 * a_cap))

    # prepare: the tuple layout's sorts over (K, Np) keys, the z-bank build
    # (16 x P streamed twice) and the per-surfel geometry gathers.
    prepare = (2 * sort3_ms(np_cap) + stream_ms(2 * 16 * p * f)
               + gather_ms(np_cap, 3 * k + k))

    floors = {
        "assoc": assoc,
        "assemble": assemble,
        "solve": solve,
        "fuse": fuse,
        "prepare": prepare,
    }
    floors["step"] = (prepare + assoc + fuse
                      + num_lm_iters * (assemble + solve))
    return floors


def sol_report(achieved_ms: dict, floors: dict,
               mxu_flops: dict = None) -> dict:
    """{stage: {ms, floor_ms, sol_frac[, mfu]}}, flagging stages below half
    of their floor (``below_floor``)."""
    out = {}
    for name, ms in achieved_ms.items():
        if name not in floors or ms <= 0:
            continue
        floor = floors[name]
        entry = {"ms": round(ms, 2), "floor_ms": round(floor, 2),
                 "sol_frac": round(min(floor / ms, 1.0), 3)}
        if mxu_flops and name in mxu_flops:
            entry["mfu"] = round(
                mxu_flops[name] / (ms * 1e-3) / (PEAK_TFLOPS["f32"] * 1e12),
                4)
        if entry["sol_frac"] < 0.5:
            entry["below_floor"] = True
        out[name] = entry
    return out
