"""Levenberg-Marquardt warp solve (counterpart of super_tpu/core/lm.py:
the deferred and classic schedules and H damping hypotheses a trip
(``lm_hypotheses``), with the per-frame, per-iteration and
per-iteration-frozen associations, and the pairs_fused, cholesky, pcg
(also on a bf16 matrix) and pcg_pallas solvers).

The loop has a fixed trip count and branch-free accept/reject
(``torch.where``), so a frame runs without host syncs.  In the deferred
schedule each trip assembles the normal equations at the candidate (whose
cost falls out of the same pass), accepts or rejects it, and solves the
damped system from the last accepted equations; the classic schedule
assembles at the accepted point and judges each candidate by a separate
cost pass.  The solves: the pair-sparse system by kernel K1 or K1b
(kernels/pcg.py:pairs_cg), warm-started from the last accepted step; the
dense (7J, 7J) system by Jacobi-scaled Cholesky, by block-Jacobi PCG in
PyTorch ops, or by block preconditioning and kernel K3
(kernels/pcg.py:dense_cg).  An ill-posed solve (a factor that is not
positive definite gives NaN, as ``jnp.linalg.cholesky`` does) yields a
non-finite step, which the loop treats as a reject.  Profiler ranges
(``lm.*``) mark the association, each trip's assembly and solve, and the
cost passes for a traced run.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from super_tpu_torch.config import SuPerConfig
from super_tpu_torch.core.losses import (
    LMContext,
    assemble_normal_equations,
    associate,
    total_cost,
)
from super_tpu_torch.geometry.camera import Intrinsics
from super_tpu_torch.kernels.pcg import dense_cg, pairs_cg
from super_tpu_torch.utils.profiling import span


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
    return _pair_system(np.asarray(pairs, np.int64), j_cap, rng, device)


# The pair systems of adversarial_pair_system.
PAIR_CASES = ("shuffled", "hub", "duplicates", "few_nodes")


def adversarial_pair_system(case: str, j_cap: int, pair_cap: int,
                            seed: int = 0, device="cuda"):
    """A well-posed pair system from a seed with a layout that tests how a
    pair CG splits its work, in the form of :func:`example_pair_system`:

    - ``"shuffled"``: the pairs in random order and orientation, with sink
      slots between them (a sink id on one side or both) holding nonzero
      blocks that must be ignored;
    - ``"hub"``: node J // 2 paired with every other node, plus repeated
      pairs on it up to a third of the table, so that its list alone is
      longer than one CTA keeps in shared memory;
    - ``"duplicates"``: every off-diagonal pair drawn from a small pool,
      each (n1, n2) about four times;
    - ``"few_nodes"``: the example's layout; meant for J below the number
      of SMs (J = 64), so that some CTAs own no node.
    """
    rng = np.random.default_rng(seed)
    n_off = pair_cap - 1 - j_cap
    diag = [(i, i) for i in range(j_cap)]

    def random_pairs(n, exclude=-1):
        a = rng.integers(0, j_cap, 4 * n + 16)
        b = rng.integers(0, j_cap, 4 * n + 16)
        ok = (a != b) & (a != exclude) & (b != exclude)
        return list(zip(a[ok][:n].tolist(), b[ok][:n].tolist()))

    if case == "shuffled":
        n_sink = pair_cap // 16
        sinks = [(j_cap, j_cap), (j_cap, 0), (j_cap - 1, j_cap)]
        sinks = (sinks * n_sink)[:n_sink]
        pairs = diag + random_pairs(n_off + 1 - n_sink) + sinks
        pairs = [pairs[i] for i in rng.permutation(len(pairs))]
    elif case == "hub":
        hub = j_cap // 2
        spokes = [(hub, j) if j % 2 else (j, hub)
                  for j in range(j_cap) if j != hub]
        extra = rng.integers(0, j_cap - 1, max(pair_cap // 3 - len(spokes), 0))
        extra = [(hub, int(j) + (j >= hub)) for j in extra]
        rest = random_pairs(n_off - len(spokes) - len(extra), exclude=hub)
        pairs = sorted(diag + spokes + extra + rest)
    elif case == "duplicates":
        pool = random_pairs(max(n_off // 4, 1))
        pairs = sorted(diag + [pool[i] for i in
                               rng.integers(0, len(pool), n_off)])
    elif case == "few_nodes":
        return example_pair_system(j_cap, pair_cap, seed, device)
    else:
        raise ValueError(f"unknown pair system {case!r}")
    if case != "shuffled":
        pairs.append((j_cap, j_cap))
    pairs = np.asarray(pairs, np.int64)
    if pairs.shape != (pair_cap, 2):
        raise ValueError(f"{case}: J={j_cap}, P={pair_cap} leaves no room "
                         f"for the off-diagonal pairs")
    return _pair_system(pairs, j_cap, rng, device, sink_blocks=True)


def _pair_system(pairs, j_cap: int, rng, device, sink_blocks=False):
    """Blocks, right-hand side, damping and warm start for the (P, 2) node
    pairs: off-diagonal blocks small and random, each node's diagonal block
    (the first (j, j) pair) dominant over all its pairs, sink blocks random
    if ``sink_blocks`` (else zero)."""
    pair_cap = len(pairs)
    valid = (pairs < j_cap).all(axis=1)
    acc = np.zeros((pair_cap, 7, 7), np.float64)
    off = (pairs[:, 0] != pairs[:, 1]) & valid
    acc[off] = 0.1 * rng.normal(size=(int(off.sum()), 7, 7))
    deg = np.bincount(pairs[off].reshape(-1), minlength=j_cap)
    diag = np.flatnonzero(pairs[:, 0] == pairs[:, 1])
    diag = diag[np.unique(pairs[diag, 0], return_index=True)[1]][:j_cap]
    m = rng.normal(size=(j_cap, 7, 7))
    d = m @ m.transpose(0, 2, 1) / 7 + (deg + 1.0)[:, None, None] * np.eye(7)
    acc[diag] = 0.5 * d                                 # halved convention
    layout = PairLayout(
        pair_dest=torch.as_tensor((7 * pairs).astype(np.int32), device=device),
        diag_rank=torch.as_tensor(diag.astype(np.int32), device=device))
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32),  # noqa: E731
                                    device=device)
    rhs, u = f32(rng.normal(size=7 * j_cap)), f32(0.05)
    x0 = f32(0.01 * rng.normal(size=7 * j_cap))
    if sink_blocks:
        acc[~valid] = rng.normal(size=(int((~valid).sum()), 7, 7))
    return layout, f32(acc.reshape(pair_cap, 49)), rhs, u, x0


def _pairs_fused_solve(cfg: SuPerConfig, layout, acc, rhs, u, j_cap: int,
                       x0=None):
    """Damped solve of the pair-sparse normal equations by block-Jacobi
    PCG (kernel K1); returns the (7J,) step."""
    x_fm = pairs_cg(*pairs_band_system(layout, acc, rhs, u, j_cap, x0),
                    iterations=cfg.solver.pcg_iterations)
    return x_fm.T.reshape(7 * j_cap)


def _diag_blocks(a, j_cap: int):
    """The (J, 7, 7) diagonal node blocks of a dense (7J, 7J) matrix."""
    return a.reshape(j_cap, 7, j_cap, 7).diagonal(dim1=0, dim2=2).permute(
        2, 0, 1)


def _cholesky_nan(a):
    """Lower Cholesky factor(s), NaN where a matrix is not positive definite
    (``jnp.linalg.cholesky``'s answer).  ``cholesky_ex`` reports failure in
    ``info`` on the device; ``cholesky`` would sync the host to raise."""
    chol, info = torch.linalg.cholesky_ex(a)
    return torch.where((info == 0)[..., None, None], chol, float("nan"))


def _matvec_bf16(a):
    """The product of a bf16 matrix with a vector rounded to bf16, summed
    and returned in f32 (``jax.lax.dot(..., preferred_element_type=
    float32)``; the bf16 products are exact in f32), as a function of the
    vector.  On the card one bf16 matrix product with an f32 result; on
    the CPU the matrix upcast once (the same products)."""
    if a.device.type == "cuda":
        return lambda p: torch.mm(a, p.to(torch.bfloat16)[:, None],
                                  out_dtype=torch.float32)[:, 0]
    a32 = a.float()
    return lambda p: a32 @ p.to(torch.bfloat16).float()


def _block_jacobi_pcg(a, b, j_cap: int, iterations: int, inv_d, x0,
                      scaled_eps: float = 0.0):
    """Block-Jacobi PCG on the Jacobi-scaled system D^-1/2 A D^-1/2 x = b,
    the scaling folded into the matvec (the JAX package's
    ``_block_jacobi_pcg``), warm-started from ``x0`` (None: from zero).

    A bf16 ``a`` (``jtj_dtype="bf16"``) is read by a bf16 matvec with an
    f32 result, its diagonal blocks make an f32 preconditioner, and
    ``scaled_eps`` damps the scaled system by the bf16 storage noise's
    spectral norm."""
    dim = 7 * j_cap
    mv = _matvec_bf16(a) if a.dtype == torch.bfloat16 else \
        functools.partial(torch.mv, a)

    def matvec(p):
        y = inv_d * mv(inv_d * p)
        return y + scaled_eps * p if scaled_eps else y

    d_scale = inv_d.reshape(j_cap, 7)
    diag = _diag_blocks(a, j_cap).to(b.dtype) * d_scale[:, :, None] * \
        d_scale[:, None, :]
    eye7 = torch.eye(7, dtype=b.dtype, device=b.device)
    diag_inv = torch.linalg.inv_ex(diag + (1e-8 + scaled_eps) * eye7).inverse

    def precond(r):
        return torch.einsum("jab,jb->ja", diag_inv,
                            r.reshape(j_cap, 7)).reshape(dim)

    if x0 is None:
        x, r = torch.zeros_like(b), b
    else:
        x, r = x0, b - matvec(x0)
    z = precond(r)
    p = z
    rz = r @ z
    for _ in range(iterations):
        ap = matvec(p)
        denom = p @ ap
        alpha = torch.where(torch.abs(denom) > 1e-30, rz / denom, 0.0)
        x = x + alpha * p
        r = r - alpha * ap
        z = precond(r)
        rz_new = r @ z
        beta = torch.where(torch.abs(rz) > 1e-30, rz_new / rz, 0.0)
        p = z + beta * p
        rz = rz_new
    return x


def block_precondition(a, rhs, j_cap: int):
    """Fold the block-Jacobi preconditioner into the system: with L the
    Cholesky factors of A's 7x7 diagonal blocks, A-hat = L^-1 A L^-T (unit
    diagonal blocks) and b-hat = L^-1 b.  Returns (A-hat, b-hat, L^-1)."""
    dim = 7 * j_cap
    eye7 = torch.eye(7, dtype=rhs.dtype, device=rhs.device)
    chol = _cholesky_nan(_diag_blocks(a, j_cap).to(rhs.dtype) + 1e-8 * eye7)
    linv = torch.linalg.solve_triangular(
        chol, eye7.expand(j_cap, 7, 7), upper=False)
    # Two batched 7-row transforms, each one pass over the matrix (f32,
    # TF32 off).
    a1 = torch.einsum("jik,jkd->jid", linv,
                      a.reshape(j_cap, 7, dim)).reshape(dim, dim)
    a_hat = torch.einsum("djk,jik->dji", a1.reshape(dim, j_cap, 7),
                         linv).reshape(dim, dim)
    b_hat = torch.einsum("jik,jk->ji", linv,
                         rhs.reshape(j_cap, 7)).reshape(dim)
    return a_hat, b_hat, linv


def _block_precond_pcg_pallas(a, rhs, j_cap: int, iterations: int):
    """The damped dense solve of ``linear_solver="pcg_pallas"``: block
    preconditioning, plain CG on A-hat by kernel K3, x = L^-T x-hat."""
    a_hat, b_hat, linv = block_precondition(a, rhs, j_cap)
    x_hat = dense_cg(a_hat, b_hat, iterations=iterations)
    return torch.einsum("jki,jk->ji", linv,
                        x_hat.reshape(j_cap, 7)).reshape(7 * j_cap)


def solve_damped(cfg: SuPerConfig, layout, jtj, rhs, u, j_cap: int, x0):
    """The LM step for damping ``u``: (J^T J + u I) delta = rhs, with jtj in
    the solver's form (pair blocks for ``pairs_fused``, dense otherwise).

    The dense solves other than ``pcg_pallas`` scale the system by its
    diagonal first (the q- and b-columns differ by ~1e3 in magnitude);
    ``pcg`` warm-starts from ``x0`` (None: from zero), the direct solves
    ignore it.  A bf16 matrix (``jtj_dtype="bf16"``, ``pcg`` only) is
    damped in bf16, as the JAX package's, and its PCG adds the damping
    2^-8 sqrt(7J) in the scaled space."""
    sol = cfg.solver
    if sol.linear_solver == "pairs_fused":
        return _pairs_fused_solve(cfg, layout, jtj, rhs, u, j_cap, x0=x0)
    a = torch.diagonal_scatter(jtj, jtj.diagonal() + u.to(jtj.dtype))
    if sol.linear_solver == "pcg_pallas":
        return _block_precond_pcg_pallas(a, rhs, j_cap, sol.pcg_iterations)
    d = torch.sqrt(torch.clamp(a.diagonal().to(rhs.dtype), min=1e-20))
    inv_d = 1.0 / d
    b_s = rhs * inv_d
    if sol.linear_solver == "pcg":
        eps = 2.0 ** -8 * (7 * j_cap) ** 0.5 if a.dtype == torch.bfloat16 \
            else 0.0
        x = _block_jacobi_pcg(a, b_s, j_cap, sol.pcg_iterations, inv_d,
                              None if x0 is None else x0 * d,
                              scaled_eps=eps)
    else:
        chol = _cholesky_nan(a * inv_d[:, None] * inv_d[None, :])
        y = torch.linalg.solve_triangular(chol, b_s[:, None], upper=False)
        x = torch.linalg.solve_triangular(chol.T, y, upper=True)[:, 0]
    return x * inv_d


def lm_solve(cfg: SuPerConfig, ctx: LMContext, intr: Intrinsics,
             group=None) -> LMResult:
    """The LM warp solve of one frame.  With a ``torch.distributed``
    process ``group`` (the JAX package's ``axis_name``) the context holds
    this process's slice of the surfel slots (parallel/sharded.py:
    shard_ctx): every assembly and cost pass is summed over the group, and
    each process solves the same reduced system."""
    sol = cfg.solver
    if sol.jtj_dtype == "bf16" and sol.linear_solver != "pcg":
        raise ValueError(
            "jtj_dtype='bf16' requires linear_solver='pcg' (the dense "
            "Cholesky would materialize an f32 copy, defeating the bf16 "
            "accumulator's memory purpose)")
    if sol.lm_schedule not in ("deferred", "classic") or \
            sol.association not in (
                "per_frame", "per_iteration", "per_iteration_frozen"):
        raise NotImplementedError(
            "the port runs the deferred and classic schedules and the "
            "per_frame, per_iteration and per_iteration_frozen "
            "associations")
    j_cap = ctx.ed_mask.shape[0]
    dim = 7 * j_cap
    dtype = ctx.d_eds.dtype
    dev = ctx.d_eds.device
    # Made on the card (no host copy): [1, 0, 0, 0, 0, 0, 0] per node.
    beta0 = torch.zeros((j_cap, 7), dtype=dtype, device=dev)
    beta0[:, 0] = 1.0
    u0 = torch.full((), sol.lm_damping_init, dtype=dtype, device=dev)
    v = sol.lm_damping_factor
    # The association: "per_frame" once at the identity warp (the cost
    # passes reuse it); "per_iteration_frozen" anew at every assembly's
    # beta, with the cost passes sampling as "per_iteration" does; with no
    # association the data term follows the moving target.  Without the
    # point-plane term there is none.
    point_plane = cfg.losses.sf_point_plane
    assoc = None
    if sol.association == "per_frame" and point_plane:
        with span("lm.associate"):
            assoc = associate(cfg, ctx, intr)
    per_it_frozen = sol.association == "per_iteration_frozen" and point_plane

    def assemble(beta):
        with span("lm.assemble"):
            a = assoc
            if per_it_frozen:
                with span("lm.associate"):
                    a = associate(cfg, ctx, intr, beta=beta)
            return assemble_normal_equations(cfg, ctx, beta, intr, a,
                                             group=group)

    def solve(jtj, jtr, u, x0):
        with span("lm.solve"):
            delta = solve_damped(cfg, ctx.layout, jtj, jtr, u, j_cap, x0)
        ok = torch.all(torch.isfinite(delta))
        return torch.where(ok, delta, 0.0), ok

    if sol.lm_hypotheses > 1:
        return _lm_solve_hypotheses(cfg, ctx, intr, assoc, beta0, u0,
                                    assemble, solve, group)
    if sol.lm_schedule == "classic":
        return _lm_solve_classic(cfg, ctx, intr, assoc, beta0, u0, assemble,
                                 solve, group)

    beta_cand, best_beta = beta0, beta0
    best_cost = torch.full((), 1e10, dtype=dtype, device=dev)
    best_jtj = best_jtr = None
    u = u0 * v
    delta_prev = torch.zeros((dim,), dtype=dtype, device=dev)
    # num_iterations trips judge beta0 plus the first num_iterations-1
    # candidates; the last candidate is judged by a residual-only pass.
    for i in range(sol.num_iterations):
        jtj_c, jtr_c, cost_c = assemble(beta_cand)
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
        delta, _ = solve(best_jtj, best_jtr, u, x0)
        beta_cand = best_beta + delta.reshape(j_cap, 7)
        delta_prev = delta

    with span("lm.final_cost"):
        cost_c = total_cost(cfg, ctx, beta_cand, intr, assoc, group=group)
    accept = torch.isfinite(cost_c) & (cost_c < best_cost)
    best_beta = torch.where(accept, beta_cand, best_beta)
    best_cost = torch.where(accept, cost_c, best_cost)
    u = torch.where(accept, u / v, u * v)
    return LMResult(beta=best_beta, cost=best_cost, final_damping=u)


def _lm_solve_classic(cfg: SuPerConfig, ctx: LMContext, intr, assoc, beta0,
                      u0, assemble, solve, group=None) -> LMResult:
    """The reference loop: assemble at the accepted point, solve, judge the
    candidate by a separate cost pass (the JAX package's classic body)."""
    v = cfg.solver.lm_damping_factor
    beta, best_beta = beta0, beta0
    best_cost = torch.full((), 1e10, dtype=beta0.dtype, device=beta0.device)
    u = u0
    delta_prev = beta0.new_zeros((beta0.numel(),))
    for _ in range(cfg.solver.num_iterations):
        jtj, jtr, _ = assemble(beta)
        # (delta_prev is zeroed on reject, so a rejected step's overlong
        # delta never warm-starts the more-damped re-solve.)
        delta, ok = solve(jtj, jtr, u, delta_prev)
        beta_new = beta + delta.reshape(beta.shape)
        with span("lm.cost"):
            cost = total_cost(cfg, ctx, beta_new, intr, assoc, group=group)
        accept = ok & (cost < best_cost)
        best_beta = torch.where(accept, beta_new, best_beta)
        best_cost = torch.where(accept, cost, best_cost)
        u = torch.where(accept, u / v, u * v)
        beta = torch.where(accept, beta_new, best_beta)
        delta_prev = torch.where(accept, delta, 0.0)
    return LMResult(beta=best_beta, cost=best_cost, final_damping=u)


def _lm_solve_hypotheses(cfg: SuPerConfig, ctx: LMContext, intr, assoc,
                         beta0, u0, assemble, solve, group=None) -> LMResult:
    """H = ``lm_hypotheses`` dampings a trip (the JAX package's
    ``_lm_solve_hypotheses``; ``lm_schedule`` is not read): one assembly at
    the accepted point, H cold-started solves with u v^-(H-1), ..., u v^-1,
    u (under ``pairs_fused`` H launches of K1 or K1b over the one pair
    table, under ``pcg_pallas`` H of K3), H candidate costs, the least
    taken (the first on ties; a non-finite step's cost is inf); accepted
    if it beats the best cost, u continuing from its damping / v, else
    u v."""
    hyp = cfg.solver.lm_hypotheses
    v = cfg.solver.lm_damping_factor
    j_cap = beta0.shape[0]
    ladder = v ** torch.arange(-(hyp - 1), 1, dtype=beta0.dtype,
                               device=beta0.device)
    beta, best_beta = beta0, beta0
    best_cost = torch.full((), 1e10, dtype=beta0.dtype, device=beta0.device)
    u = u0
    for _ in range(cfg.solver.num_iterations):
        jtj, jtr, _ = assemble(beta)
        us = u * ladder
        cands, costs = [], []
        for h in range(hyp):
            delta, ok = solve(jtj, jtr, us[h], None)
            cand = beta + delta.reshape(j_cap, 7)
            with span("lm.cost"):
                cost = total_cost(cfg, ctx, cand, intr, assoc, group=group)
            cands.append(cand)
            costs.append(torch.where(ok, cost, float("inf")))
        # A (1,) index: a 0-dim tensor index would be read on the host.
        costs = torch.stack(costs)
        h_star = torch.argmin(costs).reshape(1)
        cost_star = costs.index_select(0, h_star)[0]
        accept = cost_star < best_cost
        beta_new = torch.stack(cands).index_select(0, h_star)[0]
        best_beta = torch.where(accept, beta_new, best_beta)
        best_cost = torch.where(accept, cost_star, best_cost)
        u = torch.where(accept, us.index_select(0, h_star)[0] / v, u * v)
        beta = torch.where(accept, beta_new, best_beta)
    return LMResult(beta=best_beta, cost=best_cost, final_damping=u)
