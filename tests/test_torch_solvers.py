"""The dense-matrix solvers in the port (linear_solver "cholesky", "pcg"
and "pcg_pallas"): kernel K3's plain version, the block-preconditioned
solve, the dense assembly (expand_pairs and the graph-term blocks), the LM
solve with each solver and both schedules, the rejection of a system that
is not positive definite, and a tiny track with "pcg_pallas", each against
the JAX package."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import close, port_config, port_frame, port_intr, \
    port_state, scene, slice_config

from super_tpu.core import assembly as jasm
from super_tpu.core import lm as jlm
from super_tpu.core import losses as jloss
from super_tpu.core.tracker import init_tracker, track_step
from super_tpu.geometry.quaternion import IDENTITY_DQ
from super_tpu.pallas_kernels.pcg import _pcg_ref, pcg_pallas
from super_tpu_torch.convert import to_numpy
from super_tpu_torch.core import assembly as tasm
from super_tpu_torch.core import lm as tlm
from super_tpu_torch.core import losses as tloss
from super_tpu_torch.core import tracker as ttrack
from super_tpu_torch.core.preprocess import preprocess_frame
from super_tpu_torch.kernels import gram as tgram
from super_tpu_torch.kernels import pcg as tpcg


def _solver(cfg, **kw):
    return cfg.replace(solver=dataclasses.replace(cfg.solver, **kw))


def _spd(dim, seed=0, cond=1e3):
    """test_pallas_pcg.py's symmetric positive definite test matrix."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((dim, dim)))
    ev = np.geomspace(1.0, cond, dim)
    return (q * ev) @ q.T


@pytest.mark.parametrize("iterations", [32, 100])
def test_dense_cg_plain_matches_ref_and_kernel_interpret(iterations):
    """dense_cg on CPU tensors (zero-padded to 256, then dense_cg_plain)
    against _pcg_ref on the same padding and against pcg_pallas's kernel
    in interpret mode, at test_pallas_pcg.py's size (dim 200)."""
    dim = 200
    a = _spd(dim, cond=50.0).astype(np.float32)
    b = np.random.default_rng(1).standard_normal(dim).astype(np.float32)
    before = tpcg.dense_cg.launches
    got = tpcg.dense_cg(torch.as_tensor(a), torch.as_tensor(b),
                        iterations=iterations)
    assert tpcg.dense_cg.launches == before, "CPU takes the plain version"
    ref = _pcg_ref(jnp.asarray(np.pad(a, ((0, 56), (0, 56)))),
                   jnp.asarray(np.pad(b, (0, 56)))[None],
                   iterations=iterations)[0, :dim]
    interp = pcg_pallas(jnp.asarray(a), jnp.asarray(b),
                        iterations=iterations, row_block=128, interpret=True)
    x_ref = np.linalg.solve(a.astype(np.float64), b.astype(np.float64))
    scale = float(np.abs(x_ref).max())
    # The same f32 CG; the dot products and the matvec sum in other orders
    # (measured 7e-7 of |x|): 1e-5 of the solution's size.
    close(ref, got, atol=1e-5 * scale, name="ref")
    close(interp, got, atol=1e-5 * scale, name="kernel")
    if iterations == 100:
        # Converged: test_pallas_pcg.py's tolerance against a direct solve.
        close(x_ref, got, atol=2e-4, rtol=2e-3, name="direct")


def test_block_precond_pcg_pallas():
    """The pcg_pallas solve (7x7 block Cholesky, the two transforms, K3's
    plain version, back-transform) against the JAX function on
    test_pallas_pcg.py's badly column-scaled normal system at J = 24."""
    j = 24
    dim = 7 * j
    rng = np.random.default_rng(2)
    jac = rng.standard_normal((3 * dim, dim)) * rng.uniform(
        0.1, 30.0, (1, dim))
    a = (jac.T @ jac).astype(np.float32) + np.eye(dim, dtype=np.float32)
    b = rng.standard_normal(dim).astype(np.float32)
    for iters in (32, 120):
        want = jlm._block_precond_pcg_pallas(jnp.asarray(a), jnp.asarray(b),
                                             j, iterations=iters)
        got = tlm._block_precond_pcg_pallas(torch.as_tensor(a),
                                            torch.as_tensor(b), j, iters)
        # f32 transforms and CG, sums in other orders (measured 2e-7 of
        # |x|): 1e-5 of the solution's size.
        scale = float(np.abs(np.asarray(want)).max())
        close(want, got, atol=1e-5 * scale, name=f"x ({iters})")
    x_ref = np.linalg.solve(a.astype(np.float64), b.astype(np.float64))
    scale = float(np.abs(x_ref).max())
    close(x_ref / scale, got / scale, atol=5e-4, name="direct")


@pytest.fixture(scope="module")
def dense_ref():
    """Frame 1 of tiny_scene with a dense solver, on both sides: the LM
    context (pair layout without the graph pairs) and the association."""
    cfg = _solver(slice_config(), linear_solver="cholesky")
    intr, _, frames = scene(2, cfg)
    st = jax.jit(lambda f: init_tracker(cfg, f))(frames[0])
    ctx = jax.jit(lambda s, g, f: jloss.prepare_lm(cfg, s, g, f))(
        st.surfels, st.graph, frames[1])
    pcfg, pintr = port_config(cfg), port_intr(intr)
    ps = port_state(st)
    pctx = tloss.prepare_lm(pcfg, ps.surfels, ps.graph, port_frame(frames[1]))
    j_cap = cfg.capacity.node_capacity
    beta0 = jnp.tile(jnp.asarray(IDENTITY_DQ, jnp.float32)[None], (j_cap, 1))
    # Eager, as the port runs (see test_torch_lm.py).
    assoc = jloss.associate(cfg, ctx, beta0, intr, identity=True)
    passoc = tloss.associate(pcfg, pctx, pintr)
    return dict(cfg=cfg, intr=intr, ctx=ctx, assoc=assoc, pcfg=pcfg,
                pintr=pintr, pctx=pctx, passoc=passoc)


def test_dense_layout_has_no_graph_pairs(dense_ref):
    """prepare_lm for a dense solver builds the pair table from the data
    tuples alone (no extra pairs, no graph ranks): the same table as the
    JAX package's."""
    lay, play = dense_ref["ctx"].layout, dense_ref["pctx"].layout
    for name in ("pair_rank", "pair_dest", "pair_key", "pair_rank10",
                 "pair_swap10", "pair_scale10", "pair_overflow"):
        close(getattr(lay, name), getattr(play, name), atol=0, name=name)
    assert lay.diag_rank is None and play.diag_rank is None
    assert play.arap_rank is None and play.arap_swap is None


def test_expand_pairs(dense_ref):
    """Seeded per-tuple Grams through expand_pairs on the frame's layout."""
    lay, play = dense_ref["ctx"].layout, dense_ref["pctx"].layout
    t_cap = lay.tuple_nodes.shape[0]
    rng = np.random.default_rng(7)
    # Only tuples that hold surfels carry rows (the others' Grams are zero,
    # as the assembly makes them).
    g = dense_ref["cfg"].solver.assembly_pad_group
    live = np.zeros((t_cap, 1), np.float32)
    slots = play.slot_valid.numpy().reshape(-1, g).any(axis=1)
    live[play.block_tuple.numpy()[slots]] = 1.0
    h = rng.normal(size=(t_cap, 6, 28)).astype(np.float32)
    gram = live[:, :, None] * np.einsum("tri,trj->tij", h, h)
    jtr_t = live * rng.normal(size=(t_cap, 28)).astype(np.float32)
    j_cap = dense_ref["cfg"].capacity.node_capacity
    jtj, jtr = jasm.expand_pairs(lay, jnp.asarray(gram), jnp.asarray(jtr_t),
                                 j_cap)
    pjtj, pjtr = tasm.expand_pairs(play, torch.as_tensor(gram),
                                   torch.as_tensor(jtr_t), j_cap)
    # f32 sums of the same blocks in other orders: 1e-6 of the largest
    # entry.  The matrix is exactly symmetric.
    close(jtj, pjtj, atol=1e-6 * float(np.abs(np.asarray(jtj)).max()),
          name="jtj")
    close(jtr, pjtr, atol=1e-6 * float(np.abs(np.asarray(jtr)).max()),
          name="jtr")
    assert torch.equal(pjtj, pjtj.T)


@pytest.mark.parametrize("sum_dtype", ["f32", "bf16"])
def test_dense_assemble_normal_equations(dense_ref, sum_dtype):
    cfg = _solver(dense_ref["cfg"], gram_sum_dtype=sum_dtype)
    rng = np.random.default_rng(0)
    j_cap = cfg.capacity.node_capacity
    beta = np.tile(np.asarray(IDENTITY_DQ, np.float32), (j_cap, 1))
    beta += (1e-3 * rng.normal(size=beta.shape)).astype(np.float32)
    jtj, jtr, cost = jax.jit(lambda c, a, b: jloss.assemble_normal_equations(
        cfg, c, b, dense_ref["intr"], assoc=a, with_cost=True))(
        dense_ref["ctx"], dense_ref["assoc"], jnp.asarray(beta))
    pjtj, pjtr, pcost = tloss.assemble_normal_equations(
        port_config(cfg), dense_ref["pctx"], torch.as_tensor(beta),
        dense_ref["pintr"], dense_ref["passoc"])
    assert tuple(pjtj.shape) == (7 * j_cap, 7 * j_cap)
    # f32 sums over ~3000 surfels in other orders (G-blocks, tuples, pairs,
    # graph-term blocks): 1e-6 relative to the largest entry (measured
    # 5e-8); the bf16 variant rounds the same values the same way.
    close(jtj, pjtj, atol=1e-6 * float(np.abs(np.asarray(jtj)).max()),
          name="jtj")
    close(jtr, pjtr, atol=1e-6 * float(np.abs(np.asarray(jtr)).max()),
          name="jtr")
    close(cost, pcost, atol=0, rtol=1e-6, name="cost")


def _ladder(u):
    """k with u = 10 * 7.5^k (the damping ladder of the default LM)."""
    k = np.log(float(u) / 10.0) / np.log(7.5)
    assert abs(k - round(k)) < 1e-3, k
    return round(k)


@pytest.mark.parametrize("solver,schedule", [
    ("cholesky", "deferred"), ("pcg", "deferred"), ("pcg_pallas", "deferred"),
    ("cholesky", "classic"), ("pcg_pallas", "classic")])
def test_lm_solve_dense(dense_ref, solver, schedule):
    cfg = _solver(dense_ref["cfg"], linear_solver=solver,
                  lm_schedule=schedule)
    # Not under jit, as test_torch_lm.py::test_lm_solve.
    res = jlm.lm_solve(cfg, dense_ref["ctx"], dense_ref["intr"])
    pres = tlm.lm_solve(port_config(cfg), dense_ref["pctx"],
                        dense_ref["pintr"])
    # test_torch_lm.py's tolerances on the accepted step (1e-5) and the
    # final cost (1e-3 relative).  The last trips compare costs at the
    # noise floor (~5e-8), where a one-ULP difference flips an accept: the
    # JAX package's own deferred and classic Cholesky schedules, the same
    # decisions in exact arithmetic, end this solve one flip apart (final
    # damping 1.0e-6 and 5.6e-5).  So the damping must sit on the ladder
    # u0 * v^k, at most one flip (two rungs) from the JAX package's.
    close(res.beta, pres.beta, atol=1e-5, name="beta")
    close(res.cost, pres.cost, atol=0, rtol=1e-3, name="cost")
    assert abs(_ladder(res.final_damping) -
               _ladder(pres.final_damping)) <= 2


@pytest.mark.parametrize("solver", ["cholesky", "pcg_pallas"])
def test_not_positive_definite_is_rejected(dense_ref, solver):
    """A damped system that is not positive definite: the Cholesky factor
    (dense, or of the 7x7 blocks) is NaN as jnp.linalg.cholesky's is, the
    step is non-finite, and the LM loop rejects it (u *= v) every trip,
    ending at beta0 with beta0's cost, as the JAX package does."""
    j_cap = dense_ref["cfg"].capacity.node_capacity
    dim = 7 * j_cap
    a = torch.eye(dim)
    a[5, 5] = -1.0
    x = tlm.solve_damped(port_config(_solver(dense_ref["cfg"],
                                             linear_solver=solver)),
                         None, a, torch.ones(dim), torch.zeros(()), j_cap,
                         torch.zeros(dim))
    assert torch.isnan(x).all()
    cfg = _solver(dense_ref["cfg"], linear_solver=solver,
                  lm_damping_init=-1e3)
    res = jlm.lm_solve(cfg, dense_ref["ctx"], dense_ref["intr"])
    pres = tlm.lm_solve(port_config(cfg), dense_ref["pctx"],
                        dense_ref["pintr"])
    beta0 = np.tile(np.asarray(IDENTITY_DQ, np.float32), (j_cap, 1))
    close(beta0, pres.beta, atol=0, name="beta")
    close(res.beta, pres.beta, atol=0, name="beta vs JAX")
    # beta0's cost by two f32 assemblies: 1e-5 relative; the damping walks
    # the same rejects: -1e3 * 7.5^8 to 1e-6 relative.
    close(res.cost, pres.cost, atol=0, rtol=1e-5, name="cost")
    close(res.final_damping, pres.final_damping, atol=0, rtol=1e-6,
          name="final_damping")
    assert abs(float(pres.final_damping) / (-1e3 * 7.5 ** 8) - 1) < 1e-6


FRAMES = 4


@pytest.fixture(scope="module")
def pcg_pallas_runs():
    """A 4-frame tiny track with linear_solver="pcg_pallas" on both sides,
    as test_torch_track.py runs the main path."""
    cfg = _solver(slice_config(gram_sum_dtype="bf16"),
                  linear_solver="pcg_pallas")
    intr, seq, frames = scene(FRAMES + 1, cfg)
    state = jax.jit(lambda f: init_tracker(cfg, f))(frames[0])
    step = jax.jit(lambda s, f: track_step(cfg, intr, s, f))
    want = []
    for t in range(1, FRAMES + 1):
        state, outs = step(state, frames[t])
        want.append(jax.tree.map(np.asarray, outs))
    want_nodes = np.asarray(state.graph.points)

    pcfg, pintr = port_config(cfg), port_intr(intr)
    colors = np.ascontiguousarray(seq.colors.transpose(0, 3, 1, 2))
    pframes = [preprocess_frame(pcfg, pintr, seq.depths[t], colors[t],
                                float(t), device="cpu")
               for t in range(FRAMES + 1)]
    launches = (tpcg.dense_cg.launches, tgram.tuple_gram.launches,
                tgram.data_gram.launches)
    pstate = ttrack.init_tracker(pcfg, pframes[0])
    got = []
    for t in range(1, FRAMES + 1):
        pstate, pouts = ttrack.track_step(pcfg, pintr, pstate, pframes[t])
        got.append(to_numpy(pouts))
    assert launches == (tpcg.dense_cg.launches, tgram.tuple_gram.launches,
                        tgram.data_gram.launches), \
        "CPU tensors must take the plain versions"
    return want, got, want_nodes, pstate.graph.points.numpy()


@pytest.mark.parametrize("t", range(FRAMES))
def test_pcg_pallas_track_frame_outputs(pcg_pallas_runs, t):
    """test_torch_track.py's tolerances (its docstring gives the scales)."""
    want, got = pcg_pallas_runs[0][t], pcg_pallas_runs[1][t]
    assert np.isfinite(got.lm_cost) and got.lm_cost > 0
    np.testing.assert_allclose(got.lm_cost, want.lm_cost, rtol=0.15)
    _ladder(got.lm_damping)
    n_want = int(want.num_surfels)
    assert abs(int(got.num_surfels) - n_want) <= 0.01 * n_want
    assert int(got.num_nodes) == int(want.num_nodes)
    for name in ("tuple_overflow", "pair_overflow", "proj_overflow",
                 "add_overflow", "free_exhausted", "dup_skipped"):
        assert int(getattr(got, name)) == int(getattr(want, name)), name


def test_pcg_pallas_track_node_positions(pcg_pallas_runs):
    assert np.max(np.abs(pcg_pallas_runs[2] - pcg_pallas_runs[3])) < 1e-4


@pytest.mark.parametrize("kw,error", [
    (dict(linear_solver="cholesky", jtj_dtype="bf16"), ValueError),
    (dict(linear_solver="pcg_pallas", jtj_dtype="bf16"), ValueError),
])
def test_unported_solver_options_raise(dense_ref, kw, error):
    """jtj_dtype="bf16" needs linear_solver="pcg", as in the JAX package
    (ValueError).  The other options run: tests/test_torch_lm_options.py,
    test_torch_hypotheses.py, test_torch_bf16_pcg.py."""
    cfg = port_config(_solver(dense_ref["cfg"], **kw))
    with pytest.raises(error):
        tlm.lm_solve(cfg, dense_ref["pctx"], dense_ref["pintr"])
