"""Parity of the port's moving-target data term (``association=
"per_iteration"``: core/losses.py:moving_rows through K2's memory form)
with the JAX package's, in both of its forms: ``assembly_backend="xla"``
(``moving_chunk_partial_fm`` per chunk, and ``moving_mix_pass`` with
``premixed_chunk_partial_fm`` at ``assembly_chunk=512``) and ``"pallas"``
(``data_chunk_jacobian``, the full chain, into the off-TPU branch of
``tuple_gram_pallas``); and the cost with no association."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import close, port_config, port_frame, port_intr, \
    port_state, scene, slice_config

from super_tpu.core import losses as jloss
from super_tpu.core.tracker import init_tracker
from super_tpu.geometry.quaternion import IDENTITY_DQ
from super_tpu_torch.core import losses as tloss

# (assembly_backend, assembly_chunk, moving_premix) of the JAX reference.
FORMS = {"xla": ("xla", 4096, False), "xla_premix512": ("xla", 512, True),
         "pallas": ("pallas", 4096, False)}


@pytest.fixture(scope="module")
def frame1():
    cfg = slice_config()
    intr, _, frames = scene(2, cfg)
    st = jax.jit(lambda f: init_tracker(cfg, f))(frames[0])
    return cfg, intr, frames, st


def _config(cfg, form, solver):
    backend, chunk, premix = FORMS[form]
    return cfg.replace(solver=dataclasses.replace(
        cfg.solver, association="per_iteration", linear_solver=solver,
        assembly_backend=backend, assembly_chunk=chunk,
        moving_premix=premix, gram_sum_dtype="f32"))


def _contexts(frame1, cfg):
    _, intr, frames, st = frame1
    ctx = jax.jit(lambda s, g, f: jloss.prepare_lm(cfg, s, g, f))(
        st.surfels, st.graph, frames[1])
    ps = port_state(st)
    pctx = tloss.prepare_lm(port_config(cfg), ps.surfels, ps.graph,
                            port_frame(frames[1]))
    return ctx, pctx


def _beta(j_cap, seed=0):
    rng = np.random.default_rng(seed)
    beta = np.tile(np.asarray(IDENTITY_DQ, np.float32), (j_cap, 1))
    return beta + (1e-3 * rng.normal(size=beta.shape)).astype(np.float32)


@pytest.mark.parametrize("solver", ["pairs_fused", "cholesky"])
@pytest.mark.parametrize("form", sorted(FORMS))
def test_moving_normal_equations(frame1, form, solver):
    cfg = _config(frame1[0], form, solver)
    intr = frame1[1]
    ctx, pctx = _contexts(frame1, cfg)
    beta = _beta(cfg.capacity.node_capacity)
    jtj, jtr, cost = jax.jit(lambda c, b: jloss.assemble_normal_equations(
        cfg, c, b, intr, assoc=None, with_cost=True))(ctx, jnp.asarray(beta))
    pjtj, pjtr, pcost = tloss.assemble_normal_equations(
        port_config(cfg), pctx, torch.as_tensor(beta), port_intr(intr), None)
    # The same full-chain rows (the port's collapsed effective normal
    # against the JAX package's per-chunk or premixed algebra, or its
    # row-major chain rule) summed in other orders in f32: 1e-5 of the
    # largest entry; the cost to 1e-5 relative.
    close(jtj, pjtj, atol=1e-5 * float(np.abs(np.asarray(jtj)).max()),
          name="jtj")
    close(jtr, pjtr, atol=1e-5 * float(np.abs(np.asarray(jtr)).max()),
          name="jtr")
    close(cost, pcost, atol=0, rtol=1e-5, name="cost")


def test_moving_rows_reach_the_memory_form(frame1):
    """moving_rows against the JAX package's data_chunk_jacobian (rows and
    residuals, row for row, on the padded slots), and the cost of the
    same pass against data_term_cost with no association."""
    cfg = _config(frame1[0], "pallas", "pairs_fused")
    intr = frame1[1]
    ctx, pctx = _contexts(frame1, cfg)
    beta = _beta(cfg.capacity.node_capacity, seed=1)
    np_cap = ctx.sf_mask.shape[0]
    xs, _ = jloss._chunk_xs(ctx, np_cap)
    xs0 = jax.tree.map(lambda a: a[0], xs)
    beta_t = jnp.asarray(beta)[ctx.layout.tuple_nodes]
    w = cfg.losses.sf_point_plane_weight
    r, g, _ = jax.jit(lambda b, bt: jloss._jacobian_of(
        cfg, ctx, b, bt, intr, w, xs0, None))(jnp.asarray(beta), beta_t)
    h, pr = tloss.moving_rows(port_config(cfg), pctx, torch.as_tensor(beta),
                              port_intr(intr), w)
    # Row for row: the full chain rule (a 3 x 3 product through the
    # projection's and the sample's Jacobians) and the collapsed normal
    # cancel differently in single rows, up to ~1e-4 of the largest row
    # entry; their Grams agree to 1e-5 (test_moving_normal_equations).
    g = np.asarray(g).reshape(np_cap, 28)
    close(g, h, atol=1e-4 * float(np.abs(g).max()), name="h")
    # r = w n . (tp - o) is a difference of points ~0.5 m deep: its
    # rounding floor is f32's on the points (~6e-8 a coordinate), not on
    # r; 5e-7 absolute.
    close(r, pr, atol=5e-7, name="r")
    cost = jloss.data_term_cost(cfg, ctx, jnp.asarray(beta), intr, w)
    pcost = tloss.data_term_cost(port_config(cfg), pctx,
                                 torch.as_tensor(beta), port_intr(intr), w)
    close(cost, pcost, atol=0, rtol=1e-5, name="data_term_cost")
    close(cost, torch.sum(pr * pr), atol=0, rtol=1e-5, name="sum r^2")


@pytest.mark.parametrize("solver", ["pairs_fused", "cholesky"])
def test_total_cost_without_association(frame1, solver):
    cfg = _config(frame1[0], "xla", solver)
    intr = frame1[1]
    ctx, pctx = _contexts(frame1, cfg)
    beta = _beta(cfg.capacity.node_capacity, seed=2)
    want = jax.jit(lambda c, b: jloss.total_cost(cfg, c, b, intr))(
        ctx, jnp.asarray(beta))
    got = tloss.total_cost(port_config(cfg), pctx, torch.as_tensor(beta),
                           port_intr(intr), None)
    # Sums of squared residuals in other orders: 1e-5 relative.
    close(want, got, atol=0, rtol=1e-5, name="total_cost")


def test_associate_at_beta(frame1):
    """The per-iteration-frozen association (at a beta off the identity)
    against the JAX package's associate."""
    cfg = _config(frame1[0], "pallas", "pairs_fused")
    intr = frame1[1]
    ctx, pctx = _contexts(frame1, cfg)
    beta = _beta(cfg.capacity.node_capacity, seed=3)
    a = jax.jit(lambda c, b: jloss.associate(cfg, c, b, intr))(
        ctx, jnp.asarray(beta))
    pa = tloss.associate(port_config(cfg), pctx, port_intr(intr),
                         beta=torch.as_tensor(beta))
    # Samples off the pixel grid: the same corners, so the mask agrees
    # exactly and the samples to f32 rounding.
    close(a.mask, pa.mask, atol=0, name="mask")
    m = np.asarray(a.mask)
    close(np.asarray(a.o)[:, m], pa.o[:, torch.as_tensor(m)], atol=1e-6,
          name="o")
    close(np.asarray(a.n)[:, m], pa.n[:, torch.as_tensor(m)], atol=1e-5,
          name="n")
