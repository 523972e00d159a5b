"""Parity of the port's normal equations, pair-sparse CG (kernel K1's plain
version) and LM solve with the JAX package."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import close, port_config, port_frame, port_intr, \
    port_state, scene, slice_config

from super_tpu.core import lm as jlm
from super_tpu.core import losses as jloss
from super_tpu.core.tracker import init_tracker
from super_tpu.geometry.quaternion import IDENTITY_DQ
from super_tpu.pallas_kernels.pcg import _pairs_cg_ref, pairs_cg_pallas
from super_tpu_torch.core import lm as tlm
from super_tpu_torch.core import losses as tloss
from super_tpu_torch.kernels import pcg as tpcg


def _j(x):
    return jnp.asarray(x.numpy())


def _system(j_cap, pair_cap, seed):
    layout, acc, rhs, u, x0 = tlm.example_pair_system(j_cap, pair_cap, seed,
                                                      device="cpu")
    jlayout = types.SimpleNamespace(pair_dest=_j(layout.pair_dest),
                                    diag_rank=_j(layout.diag_rank))
    return layout, jlayout, acc, rhs, u, x0


def test_example_pair_system_is_well_posed():
    layout, _, acc, rhs, u, x0 = _system(48, 400, 0)
    # Dense S + S^T + u I from the pair blocks: positive definite.
    j = 48
    dense = np.zeros((7 * j + 7, 7 * j + 7))
    for (a, b), blk in zip(layout.pair_dest.numpy() // 7,
                           acc.numpy().reshape(-1, 7, 7)):
        dense[7 * a:7 * a + 7, 7 * b:7 * b + 7] += blk
    dense = dense[:7 * j, :7 * j]
    dense = dense + dense.T + float(u) * np.eye(7 * j)
    assert np.linalg.eigvalsh(dense).min() > 0.5


@pytest.mark.parametrize("j_cap,pair_cap,iters", [(64, 512, 32),
                                                  (40, 300, 8)])
def test_k1_plain_matches_pairs_fused_solve(j_cap, pair_cap, iters):
    """The whole pair solve (band tables, block-Jacobi inverse, K1's plain
    recurrence) against lm._pairs_fused_solve, whose off-TPU CG is
    _pairs_cg_ref."""
    layout, jlayout, acc, rhs, u, x0 = _system(j_cap, pair_cap, 1)
    cfg = slice_config()
    cfg = cfg.replace(solver=cfg.solver.__class__(
        **{**cfg.solver.__dict__, "pcg_iterations": iters}))
    want = jlm._pairs_fused_solve(cfg, jlayout, _j(acc), _j(rhs), _j(u),
                                  j_cap, x0=_j(x0))
    got = tlm._pairs_fused_solve(port_config(cfg), layout, acc, rhs, u, j_cap,
                                 x0=x0)
    # Same recurrence in f32; dot products summed in another order drift
    # over the iterations: 1e-5 relative to the solution's size.
    scale = float(np.abs(np.asarray(want)).max())
    close(want, got, atol=1e-5 * scale, name="x")


def test_k1_plain_matches_ref_and_kernel_interpret():
    """pairs_cg_plain against _pairs_cg_ref on the padded (8, J) vectors,
    and against the Pallas kernel itself in interpret mode."""
    j_cap, pair_cap = 24, 128
    layout, _, acc, rhs, u, x0 = _system(j_cap, pair_cap, 2)
    args = tlm.pairs_band_system(layout, acc, rhs, u, j_cap, x0)
    blk, blkt, n1, n2, minv, b_fm, u_t, x0_fm = args
    before = tpcg.pairs_cg.launches
    got = tpcg.pairs_cg(*args, iterations=8)
    # A CPU tensor takes the plain version: no kernel launch is counted.
    assert tpcg.pairs_cg.launches == before
    jp = 128
    pad = lambda a, rows: np.pad(a.numpy(), ((0, rows - a.shape[0]),  # noqa
                                             (0, jp - a.shape[1])))
    ref = _pairs_cg_ref(_j(blk), _j(blkt), _j(n1), _j(n2),
                        jnp.asarray(pad(minv, 64)), jnp.asarray(pad(b_fm, 8)),
                        jnp.asarray(pad(x0_fm, 8)), _j(u_t), iterations=8)
    interp = pairs_cg_pallas(_j(blk), _j(blkt), _j(n1), _j(n2), _j(minv),
                             _j(b_fm), _j(u_t), _j(x0_fm), iterations=8,
                             interpret=True)
    # f32 CG, 8 iterations, sums in other orders: 1e-5 of the solution.
    scale = float(np.abs(np.asarray(interp)).max())
    close(np.asarray(ref)[:7, :j_cap], got, atol=1e-5 * scale, name="ref")
    close(interp, got, atol=1e-5 * scale, name="kernel")
    # The solve converges: residual of the damped system well below |b|.
    x = got.T.reshape(-1).numpy().astype(np.float64)
    dense = np.zeros((7 * j_cap + 7,) * 2)
    for (a, b), blk7 in zip(layout.pair_dest.numpy() // 7,
                            acc.numpy().reshape(-1, 7, 7)):
        dense[7 * a:7 * a + 7, 7 * b:7 * b + 7] += blk7
    dense = dense[:7 * j_cap, :7 * j_cap]
    a_mat = dense + dense.T + float(u) * np.eye(7 * j_cap)
    res = np.linalg.norm(a_mat @ x - rhs.numpy()) / np.linalg.norm(rhs.numpy())
    assert res < 1e-3, res


@pytest.fixture(scope="module")
def lm_ref():
    cfg = slice_config()
    intr, _, frames = scene(2, cfg)
    st = jax.jit(lambda f: init_tracker(cfg, f))(frames[0])
    ctx = jax.jit(lambda s, g, f: jloss.prepare_lm(cfg, s, g, f))(
        st.surfels, st.graph, frames[1])
    pcfg, pintr = port_config(cfg), port_intr(intr)
    ps = port_state(st)
    pctx = tloss.prepare_lm(pcfg, ps.surfels, ps.graph, port_frame(frames[1]))
    j_cap = cfg.capacity.node_capacity
    beta0 = jnp.tile(jnp.asarray(IDENTITY_DQ, jnp.float32)[None], (j_cap, 1))
    # Eager, as the port runs (see test_torch_assembly.py).
    assoc = jloss.associate(cfg, ctx, beta0, intr, identity=True)
    passoc = tloss.associate(pcfg, pctx, pintr)
    return dict(cfg=cfg, intr=intr, ctx=ctx, assoc=assoc, pcfg=pcfg,
                pintr=pintr, pctx=pctx, passoc=passoc)


@pytest.mark.parametrize("sum_dtype", ["f32", "bf16"])
def test_assemble_normal_equations(lm_ref, sum_dtype):
    cfg = lm_ref["cfg"]
    cfg = cfg.replace(solver=cfg.solver.__class__(
        **{**cfg.solver.__dict__, "gram_sum_dtype": sum_dtype}))
    rng = np.random.default_rng(0)
    j_cap = cfg.capacity.node_capacity
    beta = np.tile(np.asarray(IDENTITY_DQ, np.float32), (j_cap, 1))
    beta += (1e-3 * rng.normal(size=beta.shape)).astype(np.float32)
    jtj, jtr, cost = jax.jit(lambda c, a, b: jloss.assemble_normal_equations(
        cfg, c, b, lm_ref["intr"], assoc=a, with_cost=True))(
        lm_ref["ctx"], lm_ref["assoc"], jnp.asarray(beta))
    pjtj, pjtr, pcost = tloss.assemble_normal_equations(
        port_config(cfg), lm_ref["pctx"], torch.as_tensor(beta),
        lm_ref["pintr"], lm_ref["passoc"])
    # f32 sums over ~3000 surfels in other orders (G-blocks, tuples,
    # pairs): 1e-6 relative to the largest entry; the bf16 variant rounds
    # the same values the same way before its f32 sums.
    close(jtj, pjtj, atol=1e-6 * float(np.abs(np.asarray(jtj)).max()),
          name="jtj")
    close(jtr, pjtr, atol=1e-6 * float(np.abs(np.asarray(jtr)).max()),
          name="jtr")
    close(cost, pcost, atol=0, rtol=1e-5, name="cost")
    total = jloss.total_cost(cfg, lm_ref["ctx"], jnp.asarray(beta),
                             lm_ref["intr"], assoc=lm_ref["assoc"])
    ptotal = tloss.total_cost(port_config(cfg), lm_ref["pctx"],
                              torch.as_tensor(beta), lm_ref["pintr"],
                              lm_ref["passoc"])
    close(total, ptotal, atol=0, rtol=1e-5, name="total_cost")
    close(total, pcost, atol=0, rtol=1e-5, name="cost == total_cost")


def test_lm_solve(lm_ref):
    # Not under jit: lm_solve's association would then round differently
    # from the port's (see the fixture).
    res = jlm.lm_solve(lm_ref["cfg"], lm_ref["ctx"], lm_ref["intr"])
    pres = tlm.lm_solve(lm_ref["pcfg"], lm_ref["pctx"], lm_ref["pintr"])
    # Ten LM trips of f32 assembly and 32-iteration CG: the accepted steps
    # agree to 1e-5 of a unit quaternion / metre; the final cost (~5e-8,
    # sums of squared residuals of a few micrometres) to 1e-3 relative;
    # the damping follows the same accept/reject sequence: 1e-6 relative.
    close(res.beta, pres.beta, atol=1e-5, name="beta")
    close(res.cost, pres.cost, atol=0, rtol=1e-3, name="cost")
    close(res.final_damping, pres.final_damping, atol=0, rtol=1e-6,
          name="final_damping")
