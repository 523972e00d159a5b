"""The dense ED graph in the port: kernel K1b's plain version, the choice
between K1 and K1b, the dense workload's configuration and the layouts at
its node count, and a tiny track through the K1b route, each against the
JAX package."""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import close, port_config, port_intr, scene, slice_config

import bench
from super_tpu.core import assembly as jasm
from super_tpu.core.tracker import init_tracker, track_step
from super_tpu.pallas_kernels import pcg as jpcg
from super_tpu_torch.config import WORKLOADS, lm_workload_config, \
    workload_config
from super_tpu_torch.convert import to_numpy
from super_tpu_torch.core import assembly as tasm
from super_tpu_torch.core import lm as tlm
from super_tpu_torch.core import tracker as ttrack
from super_tpu_torch.core.preprocess import preprocess_frame
from super_tpu_torch.kernels import gram as tgram
from super_tpu_torch.kernels import pcg as tpcg


def _j(x):
    return jnp.asarray(x.numpy())


def _band_args(j_cap, pair_cap, seed):
    layout, acc, rhs, u, x0 = tlm.example_pair_system(j_cap, pair_cap, seed,
                                                      device="cpu")
    return tlm.pairs_band_system(layout, acc, rhs, u, j_cap, x0)


def _bf16(a):
    return a.to(torch.bfloat16).to(torch.float32)


def test_chunked_plain_matches_interpreted_chunked_kernel(monkeypatch):
    """pairs_cg_chunked_plain against the JAX package's chunked kernel,
    interpreted, forced as test_pallas_pcg.py forces it (threshold 0,
    chunks of 128, which do not divide P: the pad is exercised)."""
    j_cap, pair_cap, iters = 56, 440, 8
    args = _band_args(j_cap, pair_cap, 3)
    monkeypatch.setattr(jpcg, "_PAIRS_PERSISTENT_OH_MAX", 0)
    monkeypatch.setattr(jpcg, "_PAIRS_CHUNK", 128)
    want = jpcg.pairs_cg_pallas(*(_j(t) for t in args), iterations=iters,
                                interpret=True)
    got = tpcg.pairs_cg_chunked_plain(*args, iterations=iters)
    # The same bf16-rounded blocks and f32 recurrence; the kernel gathers
    # and scatters by one-hot products, so its sums run in another order:
    # 1e-5 of the solution's size after 8 iterations.
    scale = float(np.abs(np.asarray(want)).max())
    close(want, got, atol=1e-5 * scale, name="x")


def test_chunked_plain_matches_ref_with_bf16_banks():
    """pairs_cg_chunked_plain is _pairs_cg_ref fed bf16-rounded banks; the
    rounding changes the solve (so the two K1 versions really differ)."""
    j_cap, pair_cap, iters = 24, 128, 8
    blk, blkt, n1, n2, minv, b_fm, u, x0_fm = _band_args(j_cap, pair_cap, 4)
    got = tpcg.pairs_cg_chunked_plain(blk, blkt, n1, n2, minv, b_fm, u,
                                      x0_fm, iterations=iters)
    jp = 128
    pad = lambda a, rows: jnp.asarray(np.pad(  # noqa: E731
        a.numpy(), ((0, rows - a.shape[0]), (0, jp - a.shape[1]))))
    ref = jpcg._pairs_cg_ref(_j(_bf16(blk)), _j(_bf16(blkt)), _j(n1), _j(n2),
                             pad(minv, 64), pad(b_fm, 8), pad(x0_fm, 8),
                             _j(u), iterations=iters)
    # Same f32 recurrence on the same rounded blocks, sums in other
    # orders: 1e-5 of the solution's size.
    scale = float(np.abs(got.numpy()).max())
    close(np.asarray(ref)[:7, :j_cap], got, atol=1e-5 * scale, name="x")
    f32 = tpcg.pairs_cg_plain(blk, blkt, n1, n2, minv, b_fm, u, x0_fm,
                              iterations=iters)
    assert float(torch.max(torch.abs(f32 - got))) > 1e-4 * scale


@pytest.mark.parametrize("j,p", [(384, 4096), (1216, 19456), (512, 6144),
                                 (512, 6145), (64, 4096), (1, 1)])
def test_kernel_choice_follows_the_jax_predicate(j, p):
    """pairs_cg takes K1b exactly where pairs_cg_pallas takes the chunked
    kernel: 2 * jp * P * 4 > 24 MiB, jp = J rounded up to 128 (512 x 6144
    sits on the threshold itself)."""
    jp = -(-j // 128) * 128
    assert tpcg.uses_chunked(j, p) == \
        (2 * jp * p * 4 > jpcg._PAIRS_PERSISTENT_OH_MAX)
    assert tpcg._PAIRS_PERSISTENT_OH_MAX == jpcg._PAIRS_PERSISTENT_OH_MAX
    assert tpcg.uses_chunked(1216, 19456) and not tpcg.uses_chunked(384, 4096)


@pytest.mark.parametrize("threshold,chunked", [(None, False), (0, True)])
def test_pairs_cg_dispatch(monkeypatch, threshold, chunked):
    """On CPU tensors pairs_cg returns the plain version of the kernel the
    predicate picks, bit for bit, and counts no launch."""
    if threshold is not None:
        monkeypatch.setattr(tpcg, "_PAIRS_PERSISTENT_OH_MAX", threshold)
    args = _band_args(40, 300, 5)
    before = (tpcg.pairs_cg.launches, tpcg.pairs_cg_chunked.launches)
    got = tpcg.pairs_cg(*args, iterations=6)
    plain = tpcg.pairs_cg_chunked_plain if chunked else tpcg.pairs_cg_plain
    assert torch.equal(got, plain(*args, iterations=6))
    assert before == (tpcg.pairs_cg.launches, tpcg.pairs_cg_chunked.launches)


def _bench_config(monkeypatch, mesh_step, **solver):
    """The configuration bench.py:build_workload derives at 480 x 640
    (non-semantic branch, per-frame association) with
    assembly_backend="pallas" and ``solver`` set, in the port's types.  The
    frames and state it would build are stubbed out."""
    import super_tpu.core.preprocess as jpre
    import super_tpu.core.tracker as jtrk
    import super_tpu.data.synthetic as jsyn

    monkeypatch.setattr(jsyn, "generate", lambda n, h, w, **k:
                        types.SimpleNamespace(
                            depths=np.zeros((n, h, w), np.float32),
                            colors=np.zeros((n, h, w, 3), np.float32)))
    monkeypatch.setattr(jpre, "preprocess_frame", lambda *a, **k: None)
    monkeypatch.setattr(jtrk, "init_tracker", lambda *a, **k: None)
    args = types.SimpleNamespace(height=480, width=640)
    cfg, _, _, _ = bench.build_workload(args, mesh_step, "per_frame")
    cfg = cfg.replace(solver=dataclasses.replace(
        cfg.solver, assembly_backend="pallas", **solver))
    return port_config(cfg)


@pytest.mark.parametrize("mesh_step", [16, 30])
def test_lm_workload_config_matches_bench(monkeypatch, mesh_step):
    """lm_workload_config(480, 640, step) is the configuration
    bench.py:build_workload derives, with assembly_backend="pallas"."""
    got = lm_workload_config(480, 640, mesh_step)
    assert got == _bench_config(monkeypatch, mesh_step)
    if mesh_step == 16:
        cap, sol = got.capacity, got.solver
        assert (cap.node_capacity, cap.surfel_capacity) == (1216, 393216)
        assert (sol.assembly_tuple_cap, sol.assembly_pair_cap,
                sol.assembly_pad_group) == (9728, 19456, 32)
        assert tpcg.uses_chunked(cap.node_capacity, sol.assembly_pair_cap)


# The LM paths with given depth; "semantic" is held to the bench's semantic
# branch in tests/test_torch_autograd.py, "e2e_depth" to its
# measure_e2e_depth in tests/test_torch_perception_pipeline.py.  The option
# paths: (base path, the solver fields they change).
OPTION_PATHS = {
    "hypotheses": ("lm", dict(lm_hypotheses=3)),
    "hypotheses_dense": ("pcg_pallas", dict(lm_hypotheses=2)),
    "scatter": ("lm", dict(assembly_mode="scatter", linear_solver="cholesky")),
    "expand_blocks": ("lm", dict(assembly_expand="scatter",
                                 linear_solver="cholesky")),
    "bf16_pcg": ("dense16", dict(linear_solver="pcg", jtj_dtype="bf16")),
}


def _path_fields(name):
    """(mesh step, solver fields over the bench's) of a named path."""
    if name in OPTION_PATHS:
        base, fields = OPTION_PATHS[name]
        step, solver = _path_fields(base)
        return step, dict(solver, **fields)
    step = 16 if name == "dense16" else 30
    solver = {} if name in ("lm", "dense16") else dict(linear_solver=name)
    if name == "per_iteration":
        solver = dict(association="per_iteration")
    return step, solver


@pytest.mark.parametrize("name", [w for w in WORKLOADS
                                  if w not in ("semantic", "e2e_depth")])
def test_workload_config_names_bench_paths(monkeypatch, name):
    """Each named path of chip_smoke.py and profile_step.py is the bench's
    workload (mesh step 16 for dense16, else 30) with only linear_solver
    replaced for the dense-matrix solvers, and only the association for
    per_iteration (the bench's per_iteration_hz workload); each option
    path is its base path with only its option's fields changed; an
    unknown name raises."""
    step, solver = _path_fields(name)
    assert workload_config(name) == _bench_config(monkeypatch, step,
                                                  **solver)
    with pytest.raises(ValueError):
        workload_config(name + "_")


def test_tuple_layout_at_dense_graph_size():
    """The tuple and pair layouts at J = 1216 nodes (keys up to J^2, well
    past int32 in the tuple sort's composite key) equal the JAX package's
    exactly, on random anchors drawn as the dense graph draws them."""
    j_cap, n = 1216, 6000
    rng = np.random.default_rng(6)
    base = rng.integers(0, j_cap - 40, n)
    knn = np.sort(base[None] + rng.integers(0, 40, (4, n)), axis=0)
    knn = knn.astype(np.int32)
    active = rng.random(n) < 0.9
    kw = dict(tuple_cap=8192, pad_group=8, chunk=4096, pair_cap=16384)
    want = jasm.build_tuple_layout(jnp.asarray(knn), jnp.asarray(active),
                                   j_cap, **kw)
    got = tasm.build_tuple_layout(torch.as_tensor(knn),
                                  torch.as_tensor(active), j_cap, **kw)
    for name in ("sort_perm", "src_pos", "slot_valid", "block_tuple",
                 "tuple_nodes", "overflow_count", "pair_rank", "pair_dest",
                 "pair_overflow", "pair_key", "pair_rank10", "pair_swap10"):
        close(getattr(want, name), getattr(got, name), atol=0, name=name)
    assert int(got.tuple_nodes.max()) >= 1100
    pairs = np.stack([knn[0, :50], knn[3, :50]], axis=-1)
    close(jasm.pair_rank_lookup(want.pair_key, j_cap, jnp.asarray(pairs)),
          tasm.pair_rank_lookup(got.pair_key, j_cap, torch.as_tensor(pairs)),
          atol=0, name="pair_rank_lookup")


FRAMES = 4


@pytest.fixture(scope="module")
def chunked_runs():
    """A 4-frame tiny track with the pair solve through the K1b route on
    both sides: the port's threshold lowered to 0 (pairs_cg takes
    pairs_cg_chunked), and the JAX package's solve fed bf16-rounded pair
    blocks, the arithmetic of its chunked kernel (off the TPU,
    pairs_cg_pallas runs its f32 reference whatever the threshold)."""
    cfg = slice_config(gram_sum_dtype="bf16")
    intr, seq, frames = scene(FRAMES + 1, cfg)
    orig = jpcg.pairs_cg_pallas

    def bf16_banks(blk, blkt, *a, **k):
        r = lambda t: t.astype(jnp.bfloat16).astype(jnp.float32)  # noqa
        return orig(r(blk), r(blkt), *a, **k)

    calls = []

    def spy(*a, **k):
        calls.append(1)
        return plain(*a, **k)

    plain = tpcg.pairs_cg_chunked_plain
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpcg, "pairs_cg_pallas", bf16_banks)
        state = jax.jit(lambda f: init_tracker(cfg, f))(frames[0])
        step = jax.jit(lambda s, f: track_step(cfg, intr, s, f))
        want = []
        for t in range(1, FRAMES + 1):
            state, outs = step(state, frames[t])
            want.append(jax.tree.map(np.asarray, outs))
        want_nodes = np.asarray(state.graph.points)
        start_nodes = np.asarray(jax.jit(lambda f: init_tracker(cfg, f))(
            frames[0]).graph.points)

        mp.setattr(tpcg, "_PAIRS_PERSISTENT_OH_MAX", 0)
        mp.setattr(tpcg, "pairs_cg_chunked_plain", spy)
        pcfg, pintr = port_config(cfg), port_intr(intr)
        colors = np.ascontiguousarray(seq.colors.transpose(0, 3, 1, 2))
        pframes = [preprocess_frame(pcfg, pintr, seq.depths[t], colors[t],
                                    float(t), device="cpu")
                   for t in range(FRAMES + 1)]
        launches = (tpcg.pairs_cg.launches, tpcg.pairs_cg_chunked.launches,
                    tgram.tuple_gram.launches, tgram.data_gram.launches)
        pstate = ttrack.init_tracker(pcfg, pframes[0])
        got = []
        for t in range(1, FRAMES + 1):
            pstate, pouts = ttrack.track_step(pcfg, pintr, pstate,
                                              pframes[t])
            got.append(to_numpy(pouts))
        assert launches == (tpcg.pairs_cg.launches,
                            tpcg.pairs_cg_chunked.launches,
                            tgram.tuple_gram.launches,
                            tgram.data_gram.launches), \
            "CPU tensors must take the plain versions"
    assert len(calls) == FRAMES * cfg.solver.num_iterations
    return want, got, want_nodes, pstate.graph.points.numpy(), start_nodes


# The track is chaotic at the f32 rounding level (test_torch_track.py), and
# more so here: a last-bit difference in an f32 pair sum can flip its bf16
# rounding, a 4e-3 change in that block.  The JAX package's own jit and
# eager runs of this sequence through bf16-rounded blocks differ by up to
# 2.4x in lm_cost (4.8e-7 vs 1.1e-6 on frame 1), by 5 of ~2,950 surfels
# and by 1.1e-4 in the node positions after 4 frames; those are the scales
# of the tolerances below.  A single frame's solve from identical inputs
# agrees far closer (cost within 1%, same damping: test_chunked_lm_solve),
# which is the precise check of the K1b route; the per-frame lm_cost bound
# here is a sanity check of a chaotic quantity.  It still tells a solve from
# none: a pair solve that returns its warm start leaves lm_cost 1,000x
# higher (5e-4 on frame 1), drives the damping to 1e8 and leaves the nodes
# 5.6e-3 from where the JAX package puts them.


@pytest.mark.parametrize("t", range(FRAMES))
def test_chunked_track_frame_outputs(chunked_runs, t):
    want, got = chunked_runs[0][t], chunked_runs[1][t]
    assert np.isfinite(got.lm_cost) and got.lm_cost > 0
    assert abs(np.log(got.lm_cost / want.lm_cost)) < np.log(3.0), \
        (got.lm_cost, want.lm_cost)
    k = np.log(float(got.lm_damping) / 10.0) / np.log(7.5)
    assert abs(k - round(k)) < 1e-3, k
    assert float(got.lm_damping) < 1.0, "steps rejected: the solve failed"
    n_want = int(want.num_surfels)
    assert abs(int(got.num_surfels) - n_want) <= 0.01 * n_want
    assert int(got.num_nodes) == int(want.num_nodes)
    for name in ("tuple_overflow", "pair_overflow", "proj_overflow",
                 "add_overflow", "free_exhausted", "dup_skipped"):
        assert int(getattr(got, name)) == int(getattr(want, name)), name


def test_chunked_track_node_positions(chunked_runs):
    """After 4 frames the ED nodes sit where the JAX package puts them, to
    0.3 mm (~0.3 px at 0.55 m; see the scales above), while they moved
    more than ten times that from where frame 0 put them."""
    want, got, start = chunked_runs[2], chunked_runs[3], chunked_runs[4]
    assert np.max(np.abs(want - got)) < 3e-4
    assert np.max(np.abs(want - start)) > 3e-3


def test_chunked_lm_solve(monkeypatch):
    """One frame's LM solve from identical inputs through the K1b route on
    both sides (as chunked_runs sets them up)."""
    from super_tpu.core import lm as jlm
    from super_tpu.core import losses as jloss
    from super_tpu_torch.core import losses as tloss
    from torch_helpers import port_frame, port_state

    cfg = slice_config(gram_sum_dtype="bf16")
    intr, _, frames = scene(2, cfg)
    st = jax.jit(lambda f: init_tracker(cfg, f))(frames[0])
    ctx = jax.jit(lambda s, g, f: jloss.prepare_lm(cfg, s, g, f))(
        st.surfels, st.graph, frames[1])
    orig = jpcg.pairs_cg_pallas
    r = lambda t: t.astype(jnp.bfloat16).astype(jnp.float32)  # noqa: E731
    monkeypatch.setattr(jpcg, "pairs_cg_pallas", lambda blk, blkt, *a, **k:
                        orig(r(blk), r(blkt), *a, **k))
    monkeypatch.setattr(tpcg, "_PAIRS_PERSISTENT_OH_MAX", 0)
    # Eager on both sides, as test_torch_lm.py::test_lm_solve runs it.
    res = jlm.lm_solve(cfg, ctx, intr)
    ps = port_state(st)
    pcfg = port_config(cfg)
    pres = tlm.lm_solve(pcfg, tloss.prepare_lm(pcfg, ps.surfels, ps.graph,
                                               port_frame(frames[1])),
                        port_intr(intr))
    # Ten trips with bf16-rounded blocks: an f32 difference that flips one
    # block's rounding moves the step by ~4e-3 of itself (measured 3e-6 on
    # beta here, 2e-7 with f32 blocks).  The accept/reject sequence is the
    # same: the damping to 1e-6 relative.
    close(res.beta, pres.beta, atol=1e-4, name="beta")
    close(res.cost, pres.cost, atol=0, rtol=1e-2, name="cost")
    close(res.final_damping, pres.final_damping, atol=0, rtol=1e-6,
          name="final_damping")
