"""``jtj_dtype="bf16"`` with ``linear_solver="pcg"`` in the port against
the JAX package: the dense matrix stored in bf16 (the pair expansion's
blocks rounded once, the graph terms' rows summed in f32 and added once,
where the JAX package adds them one by one in bf16), the bf16 matvec with
an f32 result, the f32 block-Jacobi preconditioner and the damping 2^-8
sqrt(7J) in the scaled space (super_tpu/core/lm.py:51-140, 312-315)."""

import dataclasses

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
from super_tpu_torch.core import lm as tlm
from super_tpu_torch.core import losses as tloss

BF16 = 2.0 ** -8     # bf16's unit roundoff is half of this


def _solver(cfg, **kw):
    return cfg.replace(solver=dataclasses.replace(cfg.solver, **kw))


@pytest.fixture(scope="module")
def scene4():
    cfg = _solver(slice_config(), linear_solver="pcg", jtj_dtype="bf16")
    intr, _, frames = scene(4, cfg)
    st = jax.jit(lambda f: init_tracker(cfg, f))(frames[0])
    return dict(cfg=cfg, intr=intr, frames=frames, st=st, ps=port_state(st),
                pi=port_intr(intr))


def _contexts(s, cfg, t):
    ctx = jloss.prepare_lm(cfg, s["st"].surfels, s["st"].graph,
                           s["frames"][t])
    pcfg = port_config(cfg)
    pctx = tloss.prepare_lm(pcfg, s["ps"].surfels, s["ps"].graph,
                            port_frame(s["frames"][t]))
    return ctx, pcfg, pctx


def _assembled(s, jtj_dtype):
    cfg = _solver(s["cfg"], jtj_dtype=jtj_dtype)
    ctx, pcfg, pctx = _contexts(s, cfg, 3)
    j_cap = cfg.capacity.node_capacity
    rng = np.random.default_rng(0)
    beta = np.tile(np.asarray(IDENTITY_DQ, np.float32), (j_cap, 1))
    beta += (1e-3 * rng.normal(size=beta.shape)).astype(np.float32)
    beta0 = jnp.tile(jnp.asarray(IDENTITY_DQ, jnp.float32)[None], (j_cap, 1))
    assoc = jloss.associate(cfg, ctx, beta0, s["intr"], identity=True)
    want = jax.jit(lambda c, a, b: jloss.assemble_normal_equations(
        cfg, c, b, s["intr"], assoc=a, with_cost=True))(
        ctx, assoc, jnp.asarray(beta))
    got = tloss.assemble_normal_equations(
        pcfg, pctx, torch.as_tensor(beta), s["pi"],
        tloss.associate(pcfg, pctx, s["pi"]))
    return want, got


def test_bf16_matrix_band(scene4):
    """The bf16 matrix in the Jacobi-scaled space of the f32 one (entries
    at most 1 there): the port's within 2^-8 of its f32 matrix (one or two
    roundings; measured 3.6e-3), the JAX package's within 2^-7 of its own
    (its graph adds round one by one; measured 6.8e-3), so the two within
    3 * 2^-8 of each other (measured 7.8e-3).  J^T r and the cost are the
    f32 ones (1e-6)."""
    (j16, jr16, jc16), (p16, pr16, pc16) = _assembled(scene4, "bf16")
    (j32, _, _), (p32, pr32, pc32) = _assembled(scene4, "f32")
    assert j16.dtype == jnp.bfloat16 and p16.dtype == torch.bfloat16
    d = np.sqrt(np.maximum(np.diag(np.asarray(j32, np.float64)), 1e-30))

    def scaled(a):
        return np.asarray(a, np.float64) / d[:, None] / d[None, :]

    p16n = p16.float().numpy()
    assert np.abs(scaled(p16n) - scaled(p32.numpy())).max() <= BF16
    assert np.abs(scaled(np.asarray(j16, np.float32)) -
                  scaled(j32)).max() <= 2 * BF16
    close(scaled(np.asarray(j16, np.float32)), scaled(p16n), atol=3 * BF16,
          name="jtj")
    assert np.abs(p16n - p32.numpy()).max() > 0
    close(jr16, pr16, atol=1e-6 * float(np.abs(np.asarray(jr16)).max()),
          name="jtr")
    close(pr32, pr16, atol=0, name="jtr is the f32 one")
    close(jc16, pc16, atol=0, rtol=1e-6, name="cost")


def test_bf16_matvec():
    """The matvec reads the bf16 matrix and the bf16-rounded vector and
    sums in f32: the same products as jax.lax.dot with an f32 result
    (exact in f32), summed in another order (1e-6 of the largest row sum
    of magnitudes)."""
    rng = np.random.default_rng(1)
    a = rng.normal(size=(448, 448)).astype(np.float32)
    p = rng.normal(size=448).astype(np.float32)
    ab = torch.as_tensor(a).to(torch.bfloat16)
    got = tlm._matvec_bf16(ab)(torch.as_tensor(p))
    assert got.dtype == torch.float32
    want = jax.lax.dot(jnp.asarray(a, jnp.bfloat16),
                       jnp.asarray(p).astype(jnp.bfloat16),
                       preferred_element_type=jnp.float32)
    mag = np.abs(ab.float().numpy()) @ np.abs(
        torch.as_tensor(p).to(torch.bfloat16).float().numpy())
    close(want, got, atol=1e-6 * float(mag.max()), name="matvec")


@pytest.mark.parametrize("iterations", [8, 64])
def test_bf16_block_jacobi_pcg(iterations):
    """The PCG on a bf16 normal matrix (J = 24, badly column-scaled as
    test_torch_solvers.py's) with the scaled-space damping, against the
    JAX function: the same f32 recurrence from the same bf16 products,
    1e-4 of the solution's size (the sums' order drifts over the
    iterations)."""
    j = 24
    dim = 7 * j
    rng = np.random.default_rng(2)
    jac = rng.standard_normal((3 * dim, dim)) * rng.uniform(0.1, 30.0,
                                                           (1, dim))
    a = (jac.T @ jac + np.eye(dim)).astype(np.float32)
    b = rng.standard_normal(dim).astype(np.float32)
    ab = jnp.asarray(a, jnp.bfloat16)
    inv_d = 1.0 / np.sqrt(np.asarray(ab, np.float32).diagonal())
    eps = 2.0 ** -8 * dim ** 0.5
    want = jlm._block_jacobi_pcg(ab, jnp.asarray(b * inv_d), j, iterations,
                                 inv_d=jnp.asarray(inv_d), scaled_eps=eps)
    got = tlm._block_jacobi_pcg(torch.as_tensor(a).to(torch.bfloat16),
                                torch.as_tensor(b * inv_d), j, iterations,
                                torch.as_tensor(inv_d), None, scaled_eps=eps)
    scale = float(np.abs(np.asarray(want)).max())
    close(want, got, atol=1e-4 * scale, name="x")


def test_bf16_lm_solve(scene4):
    """Frame 1's LM solve against the JAX package's: the bf16 roundings of
    the two matrices differ (test_bf16_matrix_band), so beta to 1e-4
    (measured 2e-5) and the cost to 1e-2 (measured 3.1e-3), the damping on
    the same ladder within one flip (two rungs)."""
    s = scene4
    ctx, pcfg, pctx = _contexts(s, s["cfg"], 1)
    want = jlm.lm_solve(s["cfg"], ctx, s["intr"])
    got = tlm.lm_solve(pcfg, pctx, s["pi"])
    close(want.beta, got.beta, atol=1e-4, name="beta")
    close(want.cost, got.cost, atol=0, rtol=1e-2, name="cost")
    k = [np.log(float(u) / 10.0) / np.log(7.5)
         for u in (want.final_damping, got.final_damping)]
    assert all(abs(x - round(x)) < 1e-3 for x in k)
    assert abs(round(k[0]) - round(k[1])) <= 2


def test_bf16_dense_layout_descends():
    """tests/test_lm.py::test_bf16_jtj_dense_layout_descends on the port:
    node capacity 576 (the JAX package's dense accumulator), frame 3 from
    the frame-0 model, the bf16 PCG below a tenth of the identity's
    cost."""
    from super_tpu_torch.core.tracker import init_tracker as tinit

    cfg = _solver(slice_config(), linear_solver="pcg", jtj_dtype="bf16")
    cfg = cfg.replace(capacity=dataclasses.replace(cfg.capacity,
                                                   node_capacity=576))
    intr, _, frames = scene(4, cfg)
    pcfg = port_config(cfg)
    st = tinit(pcfg, port_frame(frames[0]))
    pctx = tloss.prepare_lm(pcfg, st.surfels, st.graph, port_frame(frames[3]))
    pi = port_intr(intr)
    beta0 = torch.as_tensor(np.tile(np.asarray(IDENTITY_DQ, np.float32),
                                    (576, 1)))
    cost0 = float(tloss.total_cost(pcfg, pctx, beta0, pi,
                                   tloss.associate(pcfg, pctx, pi)))
    res = tlm.lm_solve(pcfg, pctx, pi)
    assert np.isfinite(float(res.cost))
    assert float(res.cost) < 0.1 * cost0, (float(res.cost), cost0)
