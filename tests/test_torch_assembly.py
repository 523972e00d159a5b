"""Parity of the port's LM context, tuple/pair layouts, association and
tuple-Gram reduction (kernel K2's plain version) with the JAX package.

The state after frame-0 init and frame 1 go through the JAX package, and
the same arrays, converted, through the port: the layouts' integer fields
must agree exactly (the port reproduces the total orders of the JAX sorts).
"""

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
from super_tpu.pallas_kernels.gram import tuple_gram_pallas
from super_tpu_torch.core import assembly as tasm
from super_tpu_torch.core import losses as tloss
from super_tpu_torch.kernels import gram as tgram

LAYOUT_FIELDS = ["sort_perm", "src_pos", "slot_valid", "block_tuple",
                 "tuple_nodes", "overflow_count", "pair_rank", "pair_scale",
                 "pair_dest", "pair_overflow", "pair_key", "pair_rank10",
                 "pair_swap10", "pair_scale10", "diag_rank", "arap_rank",
                 "arap_swap", "live_end"]


@pytest.fixture(scope="module")
def ctxs():
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
    # Eager, as the port runs: frame-0 surfels project back onto exact
    # pixel coordinates, so an FMA that jit may contract moves floor(u)
    # by one pixel for ~1% of them.
    assoc = jloss.associate(cfg, ctx, beta0, intr, identity=True)
    passoc = tloss.associate(pcfg, pctx, pintr)
    return dict(cfg=cfg, intr=intr, ctx=ctx, assoc=assoc, pcfg=pcfg,
                pintr=pintr, pctx=pctx, passoc=passoc)


@pytest.mark.parametrize("field", LAYOUT_FIELDS)
def test_tuple_and_pair_layout_exact(ctxs, field):
    want = getattr(ctxs["ctx"].layout, field)
    got = getattr(ctxs["pctx"].layout, field)
    # Integer, boolean and the 0 / 0.5 / 1 scale fields: exactly equal.
    close(want, got, atol=0, name=field)


def test_build_layout_with_overflow():
    """A tuple cap and a pair cap too small for the anchors: the sink
    tuple, the overflow counts and the pair sink must agree too."""
    rng = np.random.default_rng(0)
    n, j = 3000, 40
    knn = np.sort(rng.integers(0, j, (4, n)), axis=0).astype(np.int32)
    active = rng.random(n) < 0.8
    extra = np.stack([np.arange(j), np.arange(j)], 1).astype(np.int32)
    kw = dict(tuple_cap=256, pad_group=8, chunk=1024, pair_cap=512)
    want = jax.jit(lambda a, b, c: jasm.build_tuple_layout(
        a, b, j, extra_pairs=c, **kw))(jnp.asarray(knn), jnp.asarray(active),
                                       jnp.asarray(extra))
    got = tasm.build_tuple_layout(torch.as_tensor(knn),
                                  torch.as_tensor(active), j,
                                  extra_pairs=torch.as_tensor(extra), **kw)
    assert int(want.overflow_count) > 0 and int(want.pair_overflow) > 0
    for field in LAYOUT_FIELDS[:15] + ["live_end"]:
        close(getattr(want, field), getattr(got, field), atol=0, name=field)
    pairs = rng.integers(0, j, (50, 2)).astype(np.int32)
    close(jasm.pair_rank_lookup(want.pair_key, j, jnp.asarray(pairs)),
          tasm.pair_rank_lookup(got.pair_key, j, torch.as_tensor(pairs)),
          atol=0, name="pair_rank_lookup")


def test_prepare_lm_context(ctxs):
    ctx, pctx = ctxs["ctx"], ctxs["pctx"]
    # Gathers and differences of the same f32 arrays: exact.
    for field in ("sf_mask", "sf_knn_w", "sf_points", "tuple_knn",
                  "trg_points", "trg_norms", "trg_index_map",
                  "trg_corner_bank", "ed_mask", "ed_knn_idx", "ed_pair_mask",
                  "d_eds", "ed_skew"):
        close(getattr(ctx, field), getattr(pctx, field), atol=0, name=field)


def test_associate_identity(ctxs):
    assoc, passoc = ctxs["assoc"], ctxs["passoc"]
    m = np.asarray(assoc.mask)
    close(assoc.mask, passoc.mask, atol=0, name="mask")
    assert m.sum() > 2000
    # The blend at the identity sums 4 weighted points; its order may differ
    # by an FMA: 1e-6 m on points, 1e-6 on unit normals.  Values outside
    # the mask are don't-cares (the JAX pass skips the sink chunks).
    close(np.asarray(assoc.o)[:, m], passoc.o.numpy()[:, m], atol=1e-6)
    close(np.asarray(assoc.n)[:, m], passoc.n.numpy()[:, m], atol=1e-6)


def _rows(ctxs, seed):
    """The data term's (h, r) at a perturbed beta, in the port."""
    pctx = ctxs["pctx"]
    rng = np.random.default_rng(seed)
    j_cap = ctxs["cfg"].capacity.node_capacity
    beta = np.tile(np.asarray(IDENTITY_DQ, np.float32), (j_cap, 1))
    beta += (1e-3 * rng.normal(size=beta.shape)).astype(np.float32)
    return tloss.data_rows(pctx, torch.as_tensor(beta), 1.0,
                           ctxs["passoc"])


def test_k2_plain_matches_xla_branch(ctxs):
    """K2's plain version against the off-TPU branch of tuple_gram_pallas,
    at the tiny scene's real layout (Np = 16384 rows, T = 1024 tuples)."""
    h, r = _rows(ctxs, 0)
    layout = ctxs["pctx"].layout
    g = ctxs["cfg"].solver.assembly_pad_group
    t_cap = layout.tuple_nodes.shape[0]
    gram_j, jtr_j = tuple_gram_pallas(jnp.asarray(h.numpy()),
                                      jnp.asarray(r.numpy()),
                                      jnp.asarray(layout.block_tuple.numpy()),
                                      tuple_cap=t_cap, block=g)
    before = tgram.tuple_gram.launches
    gram_t, jtr_t = tgram.tuple_gram(h, r, layout.block_tuple,
                                     tuple_cap=t_cap, block=g)
    # A CPU tensor takes the plain version: no kernel launch is counted.
    assert tgram.tuple_gram.launches == before
    # f32 sums of G-row products, then of the blocks of a tuple, in orders
    # that differ: 2e-6 relative to the largest entry.
    scale = float(np.abs(np.asarray(gram_j)).max())
    close(gram_j, gram_t, atol=2e-6 * scale, name="gram")
    close(jtr_j, jtr_t, atol=2e-6 * float(np.abs(np.asarray(jtr_j)).max()),
          name="jtr")


def test_k2_plain_matches_kernel_interpret():
    """K2's plain version against the Pallas kernel itself (interpret
    mode) on a small sorted layout with gaps and a sink run."""
    rng = np.random.default_rng(1)
    g, t_cap = 8, 16
    block_tuple = np.sort(rng.choice([0, 2, 3, 7, 9, 15], size=24))
    block_tuple = block_tuple.astype(np.int32)
    h = rng.normal(size=(24 * g, 28)).astype(np.float32)
    r = rng.normal(size=(24 * g,)).astype(np.float32)
    gram_j, jtr_j = tuple_gram_pallas(jnp.asarray(h), jnp.asarray(r),
                                      jnp.asarray(block_tuple),
                                      tuple_cap=t_cap, block=g,
                                      interpret=True)
    gram_t, jtr_t = tgram.tuple_gram_plain(torch.as_tensor(h),
                                           torch.as_tensor(r),
                                           torch.as_tensor(block_tuple),
                                           tuple_cap=t_cap, block=g)
    # Sums of up to 24 * 8 products of N(0, 1) values: 1e-4 absolute.
    close(gram_j, gram_t, atol=1e-4, name="gram")
    close(jtr_j, jtr_t, atol=1e-4, name="jtr")
    unvisited = np.setdiff1d(np.arange(t_cap), block_tuple)
    assert np.all(gram_t.numpy()[unvisited] == 0)


@pytest.mark.parametrize("sum_dtype", [None, "bf16"])
def test_reduce_pairs(ctxs, sum_dtype):
    """Per-tuple Grams -> pair blocks, with f32 sums and with the bench's
    bf16-rounded values (summed in f32, as the JAX one-hot product does on
    the CPU)."""
    h, r = _rows(ctxs, 2)
    layout = ctxs["pctx"].layout
    j_cap = ctxs["cfg"].capacity.node_capacity
    gram, jtr_t = tgram.tuple_gram(h, r, layout.block_tuple,
                                   tuple_cap=layout.tuple_nodes.shape[0],
                                   block=ctxs["cfg"].solver.assembly_pad_group)
    acc_j, jtr_j = jasm.reduce_pairs(ctxs["ctx"].layout,
                                     jnp.asarray(gram.numpy()),
                                     jnp.asarray(jtr_t.numpy()), j_cap,
                                     sum_dtype=sum_dtype)
    acc_t, jtr7 = tasm.reduce_pairs(layout, gram, jtr_t, j_cap,
                                    sum_dtype=sum_dtype)
    # The same rounded values summed in f32 in another order: 1e-6
    # relative to the largest block entry.
    scale = float(np.abs(np.asarray(acc_j)).max())
    close(acc_j, acc_t, atol=1e-6 * scale, name="acc")
    close(jtr_j, jtr7, atol=1e-6 * float(np.abs(np.asarray(jtr_j)).max()),
          name="jtr")
