"""Levenberg-Marquardt warp solve (counterpart of super_tpu/core/lm.py: the
deferred schedule with the pairs_fused solver and the per-frame
association).

The loop has a fixed trip count and branch-free accept/reject
(``torch.where``), so a frame runs without host syncs.  Each trip assembles
the normal equations at the candidate (whose cost falls out of the same
pass), accepts or rejects it, and solves the damped pair-sparse system with
kernel K1 (kernels/pcg.py), warm-started from the last accepted step.
Profiler ranges (``lm.*``) mark the association, each trip's assembly and
solve, and the final cost pass for a traced run.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from super_tpu_torch.config import SuPerConfig
from super_tpu_torch.core.losses import (
    LMContext,
    assemble_normal_equations,
    associate,
    total_cost,
)
from super_tpu_torch.geometry.camera import Intrinsics
from super_tpu_torch.kernels.pcg import pairs_cg


class LMResult(NamedTuple):
    beta: torch.Tensor           # (J_cap, 7)
    cost: torch.Tensor           # () final accepted cost
    final_damping: torch.Tensor  # ()


@functools.lru_cache(maxsize=None)
def _band_index(device):
    """Source row (of the 49 block entries plus one zero row) of each of the
    64 band rows: band row 8d+i holds M[i, (i+d) % 8]; fwd reads M, rev
    reads M^T.  Made on the device (a copy from host memory would
    synchronise the step with the card), once."""
    r = torch.arange(64, device=device)
    d, i = r // 8, r % 8
    j = (i + d) % 8
    ok = (i < 7) & (j < 7)
    return torch.where(ok, i * 7 + j, 49), torch.where(ok, j * 7 + i, 49)


def pairs_band_system(layout, acc, rhs, u, j_cap: int, x0=None):
    """Kernel K1's arguments for the damped pair-sparse system: the band
    tables of the pair blocks and of the block-Jacobi inverse, the pair
    node ids, and the node-major right-hand side and warm start.

    ``acc`` (P, 49): symmetric-half blocks, diagonal pairs halved;
    ``layout`` supplies ``pair_dest`` (P, 2) and ``diag_rank`` (J,).
    Returns the positional arguments of :func:`kernels.pcg.pairs_cg`."""
    pcap = acc.shape[0]
    dev, dt = acc.device, rhs.dtype
    dr = layout.diag_rank.long().clamp(0, pcap - 1)
    dhalf = acc[dr].reshape(j_cap, 7, 7)
    dhalf = torch.where((layout.diag_rank < pcap - 1)[:, None, None], dhalf,
                        0.0)
    dblk = dhalf + dhalf.transpose(1, 2)
    eye7 = torch.eye(7, dtype=dt, device=dev)
    # inv_ex: no singularity check, so no host sync (the JAX inverse returns
    # non-finite values there too; the LM loop rejects non-finite steps).
    minv = torch.linalg.inv_ex(dblk + (u + 1e-8) * eye7).inverse

    fwd, rev = _band_index(dev)
    pad_rows = torch.cat([acc.T, acc.new_zeros((1, pcap))])
    blk_pad = pad_rows[fwd].contiguous()                  # (64, P)
    blkt_pad = pad_rows[rev].contiguous()
    minv_t = minv.permute(1, 2, 0).reshape(49, j_cap)
    minv_pad = torch.cat([minv_t, minv_t.new_zeros((1, j_cap))])[fwd]
    n1 = torch.div(layout.pair_dest[:, 0], 7, rounding_mode="floor")
    n2 = torch.div(layout.pair_dest[:, 1], 7, rounding_mode="floor")
    b_fm = rhs.reshape(j_cap, 7).T.contiguous()
    x0_fm = None if x0 is None else x0.reshape(j_cap, 7).T.contiguous()
    return (blk_pad, blkt_pad, n1.to(torch.int32).contiguous(),
            n2.to(torch.int32).contiguous(), minv_pad.contiguous(), b_fm,
            u.to(dt), x0_fm)


class PairLayout(NamedTuple):
    """The two layout fields the pair-sparse solve reads."""

    pair_dest: torch.Tensor   # (P, 2) [7 n1, 7 n2]; 7J marks the sink
    diag_rank: torch.Tensor   # (J,) rank of the pair (j, j)


def example_pair_system(j_cap: int, pair_cap: int, seed: int = 0,
                        device="cuda"):
    """A well-posed pair-sparse system from a seed, shaped as the LM loop
    hands it to the solve: every node's diagonal pair, random distinct
    off-diagonal pairs in sorted key order, and the sink pair last.
    Diagonal blocks dominate their rows, so S + S^T + u I is positive
    definite.  Returns (layout, acc (P, 49), rhs (7J,), u (), x0 (7J,))."""
    rng = np.random.default_rng(seed)
    n_off = pair_cap - 1 - j_cap
    keys = set()
    while len(keys) < n_off:
        a, b = rng.integers(0, j_cap, 2)
        if a != b:
            keys.add((min(a, b), max(a, b)))
    pairs = sorted(keys | {(i, i) for i in range(j_cap)})
    pairs.append((j_cap, j_cap))                        # the sink
    pairs = np.asarray(pairs, np.int64)
    acc = np.zeros((pair_cap, 7, 7), np.float64)
    off = (pairs[:, 0] != pairs[:, 1]) & (pairs[:, 0] < j_cap)
    acc[off] = 0.1 * rng.normal(size=(int(off.sum()), 7, 7))
    deg = np.bincount(pairs[off].reshape(-1), minlength=j_cap)
    diag = np.flatnonzero(pairs[:, 0] == pairs[:, 1])[:j_cap]
    m = rng.normal(size=(j_cap, 7, 7))
    d = m @ m.transpose(0, 2, 1) / 7 + (deg + 1.0)[:, None, None] * np.eye(7)
    acc[diag] = 0.5 * d                                 # halved convention
    layout = PairLayout(
        pair_dest=torch.as_tensor((7 * pairs).astype(np.int32), device=device),
        diag_rank=torch.as_tensor(diag.astype(np.int32), device=device))
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32),  # noqa: E731
                                    device=device)
    return (layout, f32(acc.reshape(pair_cap, 49)),
            f32(rng.normal(size=7 * j_cap)), f32(0.05),
            f32(0.01 * rng.normal(size=7 * j_cap)))


def _pairs_fused_solve(cfg: SuPerConfig, layout, acc, rhs, u, j_cap: int,
                       x0=None):
    """Damped solve of the pair-sparse normal equations by block-Jacobi
    PCG (kernel K1); returns the (7J,) step."""
    x_fm = pairs_cg(*pairs_band_system(layout, acc, rhs, u, j_cap, x0),
                    iterations=cfg.solver.pcg_iterations)
    return x_fm.T.reshape(7 * j_cap)


def lm_solve(cfg: SuPerConfig, ctx: LMContext, intr: Intrinsics) -> LMResult:
    sol = cfg.solver
    if sol.lm_schedule != "deferred" or sol.lm_hypotheses != 1 or \
            sol.association != "per_frame" or not cfg.losses.sf_point_plane:
        raise NotImplementedError(
            "the port runs lm_schedule='deferred', lm_hypotheses=1 and "
            "association='per_frame' with the point-plane term")
    j_cap = ctx.ed_mask.shape[0]
    dim = 7 * j_cap
    dtype = ctx.d_eds.dtype
    dev = ctx.d_eds.device
    # Made on the card (no host copy): [1, 0, 0, 0, 0, 0, 0] per node.
    beta0 = torch.zeros((j_cap, 7), dtype=dtype, device=dev)
    beta0[:, 0] = 1.0
    u0 = torch.full((), sol.lm_damping_init, dtype=dtype, device=dev)
    v = sol.lm_damping_factor
    with record_function("lm.associate"):
        assoc = associate(cfg, ctx, intr)

    beta_cand, best_beta = beta0, beta0
    best_cost = torch.full((), 1e10, dtype=dtype, device=dev)
    best_jtj = best_jtr = None
    u = u0 * v
    delta_prev = torch.zeros((dim,), dtype=dtype, device=dev)
    # num_iterations trips judge beta0 plus the first num_iterations-1
    # candidates; the last candidate is judged by a residual-only pass.
    for i in range(sol.num_iterations):
        with record_function("lm.assemble"):
            jtj_c, jtr_c, cost_c = assemble_normal_equations(
                cfg, ctx, beta_cand, intr, assoc)
        if i == 0:
            # Trip 0 caches beta0's equations but keeps the 1e10 cost: the
            # reference never evaluates the cost at beta0.
            accept = torch.ones((), dtype=torch.bool, device=dev)
            best_jtj, best_jtr = jtj_c, jtr_c
        else:
            accept = torch.all(torch.isfinite(jtr_c)) & (cost_c < best_cost)
            best_cost = torch.where(accept, cost_c, best_cost)
            best_jtj = torch.where(accept, jtj_c, best_jtj)
            best_jtr = torch.where(accept, jtr_c, best_jtr)
        best_beta = torch.where(accept, beta_cand, best_beta)
        u = torch.where(accept, u / v, u * v)
        # After a reject the damping jumped: cold-start the solve.
        x0 = torch.where(accept, delta_prev, 0.0)
        with record_function("lm.solve"):
            delta = _pairs_fused_solve(cfg, ctx.layout, best_jtj, best_jtr,
                                       u, j_cap, x0=x0)
        ok = torch.all(torch.isfinite(delta))
        delta = torch.where(ok, delta, 0.0)
        beta_cand = best_beta + delta.reshape(j_cap, 7)
        delta_prev = delta

    with record_function("lm.final_cost"):
        cost_c = total_cost(cfg, ctx, beta_cand, intr, assoc)
    accept = torch.isfinite(cost_c) & (cost_c < best_cost)
    best_beta = torch.where(accept, beta_cand, best_beta)
    best_cost = torch.where(accept, cost_c, best_cost)
    u = torch.where(accept, u / v, u * v)
    return LMResult(beta=best_beta, cost=best_cost, final_damping=u)
