"""The LM assembly options against the JAX package: the
scatter assembly (``assembly_mode="scatter"``: every slot's K x K blocks
summed at their node pairs by the segment sum, chunk by chunk), the tuple
Grams expanded into node-pair blocks (``assembly_expand`` other than
"pairs", ``assembly.expand_to_blocks``), and ``jac_dtype="bf16"`` (the
data term's rows in bf16 where the JAX package honours it).

The scatter and block forms are held at J = 64 (the JAX package's (J, J,
7, 7) block accumulator) and J = 576 (its dense (7J, 7J) accumulator above
J 512); the port keeps one layout at every J (core/losses.py:jtj_form)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import close, port_config, port_frame, port_intr, \
    port_state, scene, slice_config

from super_tpu.core import assembly as jasm
from super_tpu.core import losses as jloss
from super_tpu.core.tracker import init_tracker
from super_tpu.geometry.quaternion import IDENTITY_DQ
from super_tpu_torch.core import assembly as tasm
from super_tpu_torch.core import losses as tloss
from super_tpu_torch.kernels import gram as tgram
from super_tpu_torch.kernels import segsum as tsegsum


def _solver(cfg, **kw):
    return cfg.replace(solver=dataclasses.replace(cfg.solver, **kw))


@pytest.fixture(scope="module", params=[64, 576])
def frame1(request):
    """Frame 1 of tiny_scene at node capacity 64 or 576: the JAX state and
    its port copy."""
    j_cap = request.param
    cfg = slice_config()
    cfg = cfg.replace(capacity=dataclasses.replace(cfg.capacity,
                                                   node_capacity=j_cap))
    intr, _, frames = scene(2, cfg)
    st = jax.jit(lambda f: init_tracker(cfg, f))(frames[0])
    return dict(cfg=cfg, intr=intr, frame=frames[1], st=st,
                ps=port_state(st), pf=port_frame(frames[1]),
                pi=port_intr(intr))


def _beta(j_cap, seed=0, scale=1e-3):
    rng = np.random.default_rng(seed)
    beta = np.tile(np.asarray(IDENTITY_DQ, np.float32), (j_cap, 1))
    return beta + (scale * rng.normal(size=beta.shape)).astype(np.float32)


def _assemble(f, cfg, beta, moving):
    """(JAX (jtj, jtr, cost), port (jtj, jtr, cost), port context) at
    ``beta``, against the per-frame association or the moving target."""
    ctx = jloss.prepare_lm(cfg, f["st"].surfels, f["st"].graph, f["frame"])
    j_cap = cfg.capacity.node_capacity
    beta0 = jnp.tile(jnp.asarray(IDENTITY_DQ, jnp.float32)[None], (j_cap, 1))
    assoc = None if moving else jloss.associate(cfg, ctx, beta0, f["intr"],
                                                identity=True)
    want = jax.jit(lambda c, a, b: jloss.assemble_normal_equations(
        cfg, c, b, f["intr"], assoc=a, with_cost=True))(
        ctx, assoc, jnp.asarray(beta))
    pcfg = port_config(cfg)
    pctx = tloss.prepare_lm(pcfg, f["ps"].surfels, f["ps"].graph, f["pf"])
    passoc = None if moving else tloss.associate(pcfg, pctx, f["pi"])
    got = tloss.assemble_normal_equations(pcfg, pctx, torch.as_tensor(beta),
                                          f["pi"], passoc)
    return want, got, pctx


def _close_equations(want, got, name):
    """f32 sums of the same rows in other orders (XLA's scatter-adds, the
    fixed-order segment sum): 1e-6 of the largest entry (measured 6e-8 on
    J^T J, 1.3e-7 on J^T r), the cost to 1e-6 (measured 1.7e-7)."""
    for i, part in enumerate(("jtj", "jtr")):
        scale = float(np.abs(np.asarray(want[i])).max())
        close(want[i], got[i], atol=1e-6 * scale, name=f"{name} {part}")
    close(want[2], got[2], atol=0, rtol=1e-6, name=f"{name} cost")


@pytest.mark.parametrize("moving", [False, True])
@pytest.mark.parametrize("option", ["scatter", "expand_blocks"])
def test_block_forms_match_jax_and_tuple(frame1, option, moving):
    """The scatter assembly and the block expansion against the JAX
    package's same option, and against the port's tuple assembly with the
    pair expansion (the same normal equations)."""
    f = frame1
    kw = dict(assembly_mode="scatter") if option == "scatter" else \
        dict(assembly_expand="scatter")
    cfg = _solver(f["cfg"], linear_solver="cholesky", **kw)
    beta = _beta(cfg.capacity.node_capacity)
    want, got, pctx = _assemble(f, cfg, beta, moving)
    assert (pctx.layout is None) == (option == "scatter")
    assert got[0].dtype == torch.float32
    _close_equations(want, got, option)
    _, tup, _ = _assemble(f, _solver(f["cfg"], linear_solver="cholesky"),
                          beta, moving)
    _close_equations([t.numpy() for t in tup], got, f"{option} vs tuple")


def test_scatter_plans(frame1):
    """The scatter context: one plan per assembly chunk of slots (the JAX
    package's chunking of the same capacity), every inactive slot's K x K
    blocks and K J^T r rows in the sink segment, every active slot's at its
    anchors' node pair."""
    f = frame1
    cfg = port_config(_solver(f["cfg"], assembly_mode="scatter",
                              linear_solver="cholesky"))
    ctx = tloss.prepare_lm(cfg, f["ps"].surfels, f["ps"].graph, f["pf"])
    j_cap = cfg.capacity.node_capacity
    n = f["ps"].surfels.active.shape[0]
    chunk = tloss.assembly_chunk_size(n, cfg.solver.assembly_chunk)
    assert len(ctx.chunk_plans) == n // chunk
    ids = torch.cat([p.ids for p in ctx.chunk_plans]).reshape(n, 4, 4)
    act = f["ps"].surfels.active
    knn = f["ps"].surfels.knn_idx.long().T
    assert bool((ids[~act] == j_cap * j_cap).all())
    want = knn[:, :, None] * j_cap + knn[:, None, :]
    assert torch.equal(ids[act], want[act])
    assert ctx.jtr_plan.num_segments == j_cap + 1
    assert bool((ctx.jtr_plan.ids.reshape(n, 4)[~act] == j_cap).all())


def test_expand_to_blocks(frame1):
    """Seeded per-tuple Grams (test_torch_solvers.py's) through the port's
    expand_to_blocks against the JAX package's (the sink tuple's zero
    blocks included) and against the port's expand_pairs."""
    f = frame1
    cfg = _solver(f["cfg"], linear_solver="cholesky")
    ctx = jloss.prepare_lm(cfg, f["st"].surfels, f["st"].graph, f["frame"])
    pcfg = port_config(_solver(cfg, assembly_expand="scatter"))
    pctx = tloss.prepare_lm(pcfg, f["ps"].surfels, f["ps"].graph, f["pf"])
    lay = pctx.layout
    t_cap = lay.tuple_nodes.shape[0]
    g = cfg.solver.assembly_pad_group
    live = np.zeros((t_cap, 1), np.float32)
    slots = lay.slot_valid.numpy().reshape(-1, g).any(axis=1)
    live[lay.block_tuple.numpy()[slots]] = 1.0
    rng = np.random.default_rng(7)
    h = rng.normal(size=(t_cap, 6, 28)).astype(np.float32)
    gram = live[:, :, None] * np.einsum("tri,trj->tij", h, h)
    jtr_t = live * rng.normal(size=(t_cap, 28)).astype(np.float32)
    j_cap = cfg.capacity.node_capacity
    dim = 7 * j_cap
    jj, jr = jasm.expand_to_blocks(ctx.layout, jnp.asarray(gram),
                                   jnp.asarray(jtr_t),
                                   jnp.zeros((dim, dim), jnp.float32),
                                   jnp.zeros((j_cap, 7), jnp.float32))
    acc, pr = tasm.expand_to_blocks(lay, torch.as_tensor(gram),
                                    torch.as_tensor(jtr_t), pctx.expand_plan)
    assert acc.shape == (j_cap * j_cap + 1, 49)
    assert not bool(acc[-1].any())
    pj = acc[:-1].reshape(j_cap, j_cap, 7, 7).permute(0, 2, 1, 3).reshape(
        dim, dim)
    # f32 sums of the same blocks in other orders: 1e-6 of the largest
    # entry (test_torch_solvers.py::test_expand_pairs's).
    scale = float(np.abs(np.asarray(jj)).max())
    close(jj, pj, atol=1e-6 * scale, name="jtj")
    close(jr, pr, atol=1e-6 * float(np.abs(np.asarray(jr)).max()),
          name="jtr")
    # The pair expansion counts a tuple's two anchors on one node once
    # (the JAX package's diagonal-pair convention), so it agrees on tuples
    # of four distinct nodes (here all but a tuple of node 0's).
    tn = lay.tuple_nodes.numpy()
    distinct = np.array([len(set(t)) == 4 for t in tn], np.float32)
    gram4 = torch.as_tensor(gram * distinct[:, None, None])
    acc4, _ = tasm.expand_to_blocks(lay, gram4, torch.as_tensor(jtr_t),
                                    pctx.expand_plan)
    pj4 = acc4[:-1].reshape(j_cap, j_cap, 7, 7).permute(0, 2, 1, 3).reshape(
        dim, dim)
    ppctx = tloss.prepare_lm(port_config(cfg), f["ps"].surfels,
                             f["ps"].graph, f["pf"])
    ej, er = tasm.expand_pairs(ppctx.layout, gram4, torch.as_tensor(jtr_t),
                               j_cap)
    close(ej, pj4, atol=1e-6 * scale, name="jtj vs expand_pairs")
    close(er, pr, atol=0, name="jtr vs expand_pairs")


def _pair_assemble(f, jac_dtype):
    cfg = _solver(f["cfg"], assembly_backend="xla", jac_dtype=jac_dtype)
    want, got, _ = _assemble(f, cfg, _beta(cfg.capacity.node_capacity),
                             moving=False)
    return ([np.asarray(x, np.float64) for x in want],
            [x.double().numpy() for x in got])


def test_jac_dtype_bf16(frame1):
    """``jac_dtype="bf16"`` with the per-frame association and the "xla"
    backend: the rows in bf16, the Gram summed in f32, the residual kept
    in f32 for the cost and rounded to bf16 in the Gram's r column.

    The JAX package's bf16 pair blocks differ from its f32 ones by the
    rows' bf16 rounding (5e-5 of the largest block entry), so a port that
    ignored the field (its bf16 blocks equal to its f32 ones) fails here.
    The port's bf16 blocks match the JAX package's within f32 sum
    order (1e-6 of the largest entry; measured 4e-9: bf16 products are
    exact in f32), J^T r within 5e-6 (measured 1.4e-6: an f32 residual one
    ulp from the JAX package's may round to the other bf16 neighbour),
    the cost as the f32 path's (1e-6)."""
    f = frame1
    j32, p32 = _pair_assemble(f, "f32")
    j16, p16 = _pair_assemble(f, "bf16")
    scale = np.abs(j32[0]).max()
    rscale = np.abs(j32[1]).max()
    assert np.abs(j16[0] - j32[0]).max() > 10 * 1e-6 * scale
    assert np.abs(p16[0] - p32[0]).max() > 10 * 1e-6 * scale
    close(j16[0], p16[0], atol=1e-6 * scale, name="jtj")
    close(j16[1], p16[1], atol=5e-6 * rscale, name="jtr")
    close(j16[2], p16[2], atol=0, rtol=1e-6, name="cost")
    close(p32[2], p16[2], atol=0, name="cost is the f32 residuals'")


def test_jac_dtype_bf16_no_effect_on_pallas_backend(frame1):
    """Under ``assembly_backend="pallas"`` (the workload's) the JAX package
    computes the rows in f32 whatever ``jac_dtype`` says, and so does the
    port: bitwise the f32 equations, by K2's fused form."""
    f = frame1
    pcfg = port_config(f["cfg"])
    pctx = tloss.prepare_lm(pcfg, f["ps"].surfels, f["ps"].graph, f["pf"])
    passoc = tloss.associate(pcfg, pctx, f["pi"])
    beta = torch.as_tensor(_beta(pcfg.capacity.node_capacity))
    out = [tloss.assemble_normal_equations(
        port_config(_solver(f["cfg"], jac_dtype=d)), pctx, beta, f["pi"],
        passoc) for d in ("f32", "bf16")]
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_num_neighbors_other_than_4_raises(frame1):
    """The JAX package cannot track with num_neighbors != 4 (its fusion
    leaves no surfels, then packs banks of two anchor counts: ROADMAP
    queue 3), so the port raises rather than run unheld."""
    f = frame1
    cfg = port_config(f["cfg"].replace(num_neighbors=6))
    with pytest.raises(NotImplementedError, match="num_neighbors"):
        tloss.prepare_lm(cfg, f["ps"].surfels, f["ps"].graph, f["pf"])


def test_cpu_takes_plain_versions(frame1):
    """The option paths on CPU tensors launch no kernel."""
    f = frame1
    before = (tgram.data_gram.launches, tgram.tuple_gram.launches,
              tsegsum.segment_sum.launches)
    for kw in (dict(assembly_mode="scatter"), dict(assembly_expand="x")):
        _assemble(f, _solver(f["cfg"], linear_solver="cholesky", **kw),
                  _beta(f["cfg"].capacity.node_capacity), moving=False)
    assert before == (tgram.data_gram.launches, tgram.tuple_gram.launches,
                      tsegsum.segment_sum.launches)
