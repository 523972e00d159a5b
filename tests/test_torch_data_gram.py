"""Parity of kernel K2's main-path form, the data term's per-tuple Grams
with the rows computed in the kernel (``kernels/gram.py:data_gram``), with
the JAX package.

On the CPU ``data_gram`` takes its plain version, ``data_gram_plain``
(``data_rows``, then ``tuple_gram_plain``, then the sum of squared
residuals).  The reference is the JAX package's fused form of the same
function: ``frozen_chunk_partial_fm`` (the rows and their per-G-block
Grams in one pass) over all padded slots, then the segment sum over
``block_tuple``.
"""

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
from super_tpu_torch.kernels import gram as tgram

WEIGHT = 1.0


@pytest.fixture(scope="module")
def ref():
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
                intr_t=pintr, pctx=pctx, passoc=passoc)


def _beta(cfg, scale, seed=0):
    """Identity warps, plus seeded noise of the given scale."""
    rng = np.random.default_rng(seed)
    j_cap = cfg.capacity.node_capacity
    beta = np.tile(np.asarray(IDENTITY_DQ, np.float32), (j_cap, 1))
    return beta + (scale * rng.normal(size=beta.shape)).astype(np.float32)


def _jax_fused(ref, beta):
    """frozen_chunk_partial_fm over all Np slots as one chunk, then the
    per-tuple segment sum: (gram (T, 28, 28), jtr (T, 28), cost)."""
    ctx, assoc = ref["ctx"], ref["assoc"]
    g = ref["cfg"].solver.assembly_pad_group
    np_cap = ctx.sf_mask.shape[0]
    t_cap = ctx.layout.tuple_nodes.shape[0]

    def fused(ctx, assoc, beta):
        xs, nc = jloss._chunk_xs(ctx, np_cap)
        assert nc == 1
        xs0 = jax.tree.map(lambda a: a[0], xs)
        beta_t = beta[ctx.layout.tuple_nodes]
        part, cost = jloss.frozen_chunk_partial_fm(
            jloss._geom_of(ctx, xs0), assoc.o, assoc.n, assoc.mask,
            jloss._beta_fm_of(beta_t, xs0), WEIGHT, g)
        acc = jnp.zeros((t_cap, 28 * 29), jnp.float32).at[
            ctx.layout.block_tuple].add(part).reshape(t_cap, 28, 29)
        return acc[..., :28], acc[..., 28], cost

    # Eager, as the port runs: under jit the residuals of slots that barely
    # move round differently (1.6e-7 against 2.6e-2 in jtr at the identity).
    return fused(ctx, assoc, jnp.asarray(beta))


def _port(ref, beta, fn=tgram.data_gram_plain):
    return fn(ref["pctx"], torch.as_tensor(beta), WEIGHT, ref["passoc"],
              block=ref["cfg"].solver.assembly_pad_group)


@pytest.mark.parametrize("scale", [1e-6, 1e-3], ids=["near_identity",
                                                      "perturbed"])
def test_data_gram_plain_matches_fused_jax(ref, scale):
    beta = _beta(ref["cfg"], scale)
    gram_j, jtr_j, cost_j = _jax_fused(ref, beta)
    gram, jtr, cost = _port(ref, beta)
    # f32 sums over ~3000 slots in other orders (G-blocks, tuples): 1e-6
    # relative to the largest entry; the cost, one f32 sum, 1e-5 relative.
    close(gram_j, gram, atol=1e-6 * float(np.abs(np.asarray(gram_j)).max()),
          name="gram")
    close(jtr_j, jtr, atol=1e-6 * float(np.abs(np.asarray(jtr_j)).max()),
          name="jtr")
    close(cost_j, cost, atol=0, rtol=1e-5, name="cost")
    assert float(cost) > 0


def test_data_gram_sink_and_unvisited_tuples_are_zero(ref):
    gram, jtr, _ = _port(ref, _beta(ref["cfg"], 1e-3))
    layout = ref["pctx"].layout
    t_cap = layout.tuple_nodes.shape[0]
    bt = layout.block_tuple.numpy()
    live = np.unique(bt[bt < t_cap - 1])
    dead = np.setdiff1d(np.arange(t_cap), live)
    # The sink (T - 1) and the unused capacity, and some of each kind.
    assert t_cap - 1 in dead and len(dead) > 100 and len(live) > 50
    assert np.all(gram.numpy()[dead] == 0) and np.all(jtr.numpy()[dead] == 0)
    assert np.abs(gram.numpy()[live]).max() > 0


def test_data_gram_cpu_takes_plain(ref):
    beta = _beta(ref["cfg"], 1e-3, seed=1)
    before = (tgram.tuple_gram.launches, tgram.data_gram.launches)
    got = _port(ref, beta, fn=tgram.data_gram)
    # A CPU tensor takes the plain version: no kernel launch is counted.
    assert (tgram.tuple_gram.launches, tgram.data_gram.launches) == before
    for a, b in zip(got, _port(ref, beta)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("sum_dtype", ["f32", "bf16"])
def test_assemble_normal_equations_through_data_gram(ref, sum_dtype,
                                                     monkeypatch):
    """The normal equations take their data term from data_gram, once, and
    agree with the JAX package's as in
    test_torch_lm.py::test_assemble_normal_equations."""
    cfg = ref["cfg"]
    cfg = cfg.replace(solver=cfg.solver.__class__(
        **{**cfg.solver.__dict__, "gram_sum_dtype": sum_dtype}))
    beta = _beta(cfg, 1e-3, seed=2)
    calls = []

    def spy(*a, **k):
        calls.append(1)
        return tgram.data_gram(*a, **k)

    monkeypatch.setattr(tloss, "data_gram", spy)
    jtj, jtr, cost = tloss.assemble_normal_equations(
        port_config(cfg), ref["pctx"], torch.as_tensor(beta), ref["intr_t"],
        ref["passoc"])
    assert len(calls) == 1
    want = jax.jit(lambda c, a, b: jloss.assemble_normal_equations(
        cfg, c, b, ref["intr"], assoc=a, with_cost=True))(
        ref["ctx"], ref["assoc"], jnp.asarray(beta))
    # f32 sums in other orders: 1e-6 relative to the largest entry; the
    # cost 1e-5 relative.
    for name, w, g in zip(("jtj", "jtr"), want, (jtj, jtr)):
        close(w, g, atol=1e-6 * float(np.abs(np.asarray(w)).max()),
              name=name)
    close(want[2], cost, atol=0, rtol=1e-5, name="cost")
