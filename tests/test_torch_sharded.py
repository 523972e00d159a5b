"""The port's surfel-sharded LM solve and its process mesh against the JAX
package's (super_tpu/parallel/, tests/test_parallel.py and
tests/test_multihost.py), on the CPU with gloo process groups.

The JAX side runs in this process on two of conftest's virtual CPU
devices (``shard_map``); the port's side runs in worker processes
(tests/torch_parallel_worker.py, which imports no JAX), started once per
mesh and given the JAX package's frames and frame-0 state.  Tolerances are
test_parallel.py's: the sharded sums reassociate the f32 sums of one
process, so the assembly is held to 2e-5 of its largest magnitude and the
cost to rtol 1e-5, and the LM solve to rtol 1e-3 in cost and 5e-3 of
scale in beta.  Both ranks of a shard group end bitwise equal: the
all-reduce hands each the same sums.
"""

import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import tiny_scene
from torch_helpers import join_workers, same_bits, slice_config, \
    start_workers, write_inputs

from super_tpu_torch.core.tracker import StepOutputs
from super_tpu_torch.parallel import multihost
from super_tpu_torch.parallel.mesh import make_mesh, mesh_shape
from super_tpu_torch.parallel.sharded import shard_ctx

MODES = ("scatter", "tuple", "pairs_fused", "slice")
BETAS = ("identity", "perturbed")


def _plain(tree):
    """A JAX NamedTuple tree as nested dicts of numpy arrays (picklable
    without the JAX package)."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {k: _plain(v) for k, v in tree._asdict().items()}
    return np.asarray(tree)


def _mode_config(cfg, mode):
    if mode == "slice":
        return slice_config()
    solver = dict(assembly_mode="tuple" if mode == "pairs_fused" else mode)
    if mode == "pairs_fused":
        solver["linear_solver"] = "pairs_fused"
    return cfg.replace(solver=dataclasses.replace(cfg.solver, **solver))


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    cfg, intr, seq, frames = tiny_scene(num_frames=3)
    from super_tpu.core.tracker import init_tracker

    state0 = init_tracker(cfg, frames[0])
    rng = np.random.default_rng(0)
    j = cfg.capacity.node_capacity
    beta = np.zeros((j, 7), np.float32)
    beta[:, 0] = 1.0
    beta += (1e-3 * rng.standard_normal((j, 7))).astype(np.float32)
    root = tmp_path_factory.mktemp("torch_sharded")
    write_inputs(
        root, assembly_cfgs={m: dataclasses.asdict(_mode_config(cfg, m))
                             for m in MODES},
        cfg=dataclasses.asdict(cfg),
        track_cfg=dataclasses.asdict(slice_config(gram_sum_dtype="bf16")),
        intr=_plain(intr), frames=[_plain(f) for f in frames],
        state0=_plain(state0), beta_perturbed=beta)
    # The workers run while this process builds the JAX references.
    procs = start_workers("shard", 2, root)
    yield root, (cfg, intr, frames, state0, beta), procs
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


@pytest.fixture(scope="module")
def shard_runs(inputs, jax_sharded):
    """The workers' outputs by rank, joined after the JAX references are
    built (``jax_sharded``)."""
    return join_workers("shard", inputs[2], inputs[0])


@pytest.fixture(scope="module")
def jax_sharded(inputs):
    """The JAX package's 2-shard assembly (shard_map over two virtual CPU
    devices) of each mode but the port's slice config, at the perturbed
    beta.  (At the identity the moving target's projections land on pixel
    centres, where the bilinear cell flips on one ULP: one process of the
    port and of the JAX package differ there by 7% of the largest jtj
    entry, which is why tests/test_torch_moving.py holds the two packages
    off the identity; the port's shards are held to its single process
    there.)"""
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P

    from super_tpu.core.losses import assemble_normal_equations, prepare_lm
    from super_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from super_tpu.parallel.sharded import shard_ctx as jax_shard_ctx

    cfg, intr, frames, state0, beta_p = inputs[1]
    mesh = jax_make_mesh(num_streams=1, num_shards=2,
                         devices=jax.devices()[:2])
    out = {}
    for mode in MODES[:3]:
        mcfg = _mode_config(cfg, mode)
        ctx = prepare_lm(mcfg, state0.surfels, state0.graph, frames[1])

        def local(c, b, mcfg=mcfg):
            c = jax_shard_ctx(c, "shard", 2)
            return assemble_normal_equations(mcfg, c, b, intr,
                                             axis_name="shard",
                                             with_cost=True)

        fn = jax.jit(shard_map(local, mesh=mesh, in_specs=(P(), P()),
                               out_specs=(P(), P(), P()), check_rep=False))
        out[mode] = [np.asarray(x, np.float64)
                     for x in fn(ctx, jnp.asarray(beta_p))]
    return out


def _close_assembly(got, ref):
    """test_parallel.py's tolerances: jtj and jtr within 2e-5 of their
    largest magnitude, the cost within rtol 1e-5."""
    for name, g, r in zip(("jtj", "jtr"), got[:2], ref[:2]):
        g = np.asarray(g, np.float64)
        r = np.asarray(r, np.float64)
        scale = np.max(np.abs(r)) + 1e-12
        np.testing.assert_allclose(g / scale, r / scale, atol=2e-5,
                                   err_msg=name)
    np.testing.assert_allclose(float(got[2]), float(ref[2]), rtol=1e-5)


# --- the mesh, without a world ---------------------------------------------

@pytest.mark.parametrize("world,streams,shards,want", [
    (8, None, None, (8, 1)), (8, 4, 2, (4, 2)), (8, None, 4, (2, 4)),
    (8, 2, None, (2, 4)), (2, 1, 2, (1, 2)), (1, None, None, (1, 1))])
def test_mesh_shape(world, streams, shards, want):
    assert mesh_shape(world, streams, shards) == want


@pytest.mark.parametrize("streams,shards", [(3, 2), (4, 3), (3, None)])
def test_mesh_shape_mismatch_raises(streams, shards):
    with pytest.raises(ValueError, match="processes"):
        mesh_shape(8, streams, shards)


def test_make_mesh_needs_a_world():
    with pytest.raises(RuntimeError, match="initialize"):
        make_mesh(device_type="cpu")


def test_initialize_without_a_world_is_a_noop(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert multihost.initialize("gloo") is False
    assert not torch.distributed.is_initialized()


# --- shard_ctx ---------------------------------------------------------------

@pytest.fixture(scope="module")
def port_ctx(inputs):
    from super_tpu_torch import convert
    from super_tpu_torch.core.losses import prepare_lm

    root = inputs[0]
    with open(root / "inputs.pkl", "rb") as f:
        inp = pickle.load(f)
    state = convert.tracker_state_from_numpy(inp["state0"], "cpu")
    frame = convert.frame_from_numpy(inp["frames"][1], "cpu")
    out = {}
    for mode in ("scatter", "tuple"):
        pcfg = convert.config_from_dict(inp["assembly_cfgs"][mode])
        out[mode] = prepare_lm(pcfg, state.surfels, state.graph, frame)
    return out


@pytest.mark.parametrize("mode", ["scatter", "tuple"])
def test_shard_ctx_partitions_the_slots(port_ctx, mode):
    """The shards' slot fields put back together are the whole context's,
    and the per-tuple fields stay whole."""
    ctx = port_ctx[mode]
    parts = [shard_ctx(ctx, i, 2) for i in range(2)]
    for name in ("sf_mask", "sf_knn_w", "sf_points", "slot_tuple",
                 "sf_knn_idx", "sf_knn", "sf_diff"):
        whole = getattr(ctx, name)
        if whole is None:
            continue
        assert torch.equal(torch.cat([getattr(p, name) for p in parts],
                                     dim=-1), whole), name
    if mode == "tuple":
        lay = ctx.layout
        assert torch.equal(torch.cat([p.layout.block_tuple for p in parts]),
                           lay.block_tuple)
        assert all(p.tuple_knn is ctx.tuple_knn for p in parts)
        assert all(p.layout.pair_plan is lay.pair_plan for p in parts)
        local = ctx.sf_mask.shape[0] // 2
        assert [int(p.layout.live_end) for p in parts] == [
            min(max(int(lay.live_end) - i * local, 0), local)
            for i in range(2)]
    else:
        rows = sum(p.ids.shape[0] for p in parts[0].chunk_plans)
        k = ctx.sf_knn_w.shape[0]
        assert rows == ctx.sf_mask.shape[0] // 2 * k * k
        assert parts[1].jtr_plan.ids.shape[0] == ctx.sf_mask.shape[0] // 2 * k


@pytest.mark.parametrize("count", [3, 5])
def test_shard_ctx_refuses_slots_that_do_not_divide(port_ctx, count):
    with pytest.raises(ValueError, match="do not split"):
        shard_ctx(port_ctx["tuple"], 0, count)


def test_shard_ctx_refuses_partial_blocks(port_ctx):
    """A shard count whose slice would cut a G-block is refused, though it
    divides the slot count."""
    ctx = port_ctx["tuple"]
    block = ctx.sf_mask.shape[0] // ctx.layout.block_tuple.shape[0]
    count = ctx.sf_mask.shape[0] // block * 2
    assert ctx.sf_mask.shape[0] % count == 0
    with pytest.raises(ValueError, match="whole"):
        shard_ctx(ctx, 0, count)


# --- two shard processes -----------------------------------------------------

def test_workers_build_the_mesh(shard_runs):
    for r, out in enumerate(shard_runs):
        assert out["mesh"] == [[0, 1]]
        assert out["coordinate"] == [0, r]
        assert tuple(out["names"]) == ("stream", "shard")


@pytest.mark.parametrize("beta", BETAS)
@pytest.mark.parametrize("mode", MODES)
def test_sharded_assembly_matches_single_process(shard_runs, mode, beta):
    got = shard_runs[0][f"assemble/{mode}/{beta}"]
    _close_assembly(got["sharded"], got["single"])


@pytest.mark.parametrize("mode", MODES[:3])
def test_sharded_assembly_matches_jax_shard_map(shard_runs, jax_sharded,
                                                mode):
    _close_assembly(shard_runs[0][f"assemble/{mode}/perturbed"]["sharded"],
                    jax_sharded[mode])


def test_ranks_agree_bitwise(shard_runs):
    a, b = shard_runs
    for key in a:
        if key.startswith("assemble/"):
            same_bits(a[key]["sharded"], b[key]["sharded"])
    same_bits(a["lm"]["sharded"], b["lm"]["sharded"])
    same_bits(a["bf16"]["sharded"], b["bf16"]["sharded"])
    same_bits([t["sharded"] for t in a["track"]],
          [t["sharded"] for t in b["track"]])
    same_bits(a["track_nodes"]["sharded"], b["track_nodes"]["sharded"])


def test_sharded_lm_solve_matches_single(shard_runs):
    """test_parallel.py:test_sharded_lm_solve_matches_single_mid_deformation
    on the port: frame 2 (real deformation), the sharded solve's cost
    within rtol 1e-3, its beta as good a minimiser of the same objective,
    and within 5e-3 of the beta's scale."""
    lm = shard_runs[0]["lm"]
    ref, sh = lm["ref"], lm["sharded"]
    assert np.abs(ref.beta[:, 4:]).max() > 1e-4
    np.testing.assert_allclose(float(sh.cost), float(ref.cost), rtol=1e-3)
    assert lm["cost_of_sharded_beta"] <= float(ref.cost) * (1 + 1e-3)
    scale = float(np.max(np.abs(ref.beta)))
    np.testing.assert_allclose(sh.beta / scale, ref.beta / scale, atol=5e-3)


def test_sharded_dense_memory_path_descends(shard_runs):
    """test_parallel.py:test_sharded_dense_memory_path_descends: the bf16
    (7J)^2 accumulator all-reduced, PCG on the reduced system."""
    out = shard_runs[0]["bf16"]
    assert np.isfinite(float(out["sharded"].cost))
    assert float(out["sharded"].cost) < 0.5 * out["cost0"]


def test_sharded_k1b_route_descends(shard_runs):
    """The dense graph's pair solve (K1b's plain version, bf16 pair
    blocks) on the reduced system: descent as the bf16 dense path's, and
    the single process's cost within rtol 1e-3."""
    out = shard_runs[0]["k1b"]
    cost = float(out["sharded"].cost)
    assert np.isfinite(cost) and cost < 0.5 * out["cost0"]
    np.testing.assert_allclose(cost, float(out["ref"].cost), rtol=1e-3)
    same_bits(out["sharded"], shard_runs[1]["k1b"]["sharded"])


def test_track_step_sharded_within_track_bands(shard_runs):
    """Two frames of track_step_sharded against track_step on the port's
    main path, at tests/torch_helpers.py:check_track's bands (the frame
    costs to 15%, surfel counts to 1%, node counts and overflow counters
    equal, node positions to 1e-4)."""
    from torch_helpers import check_track

    out = shard_runs[0]
    assert all(isinstance(t["sharded"], StepOutputs) for t in out["track"])
    check_track(([t["single"] for t in out["track"]],
                 [t["sharded"] for t in out["track"]],
                 out["track_nodes"]["single"], out["track_nodes"]["sharded"]))


# Each frame of make_multichip_step's cut graph (the workers run it under
# CutStandIn, tests/torch_parallel_worker.py) against the eager
# track_step_sharded: the same operations on the same inputs, each
# all-reduce performed at its cut, so the bits are the eager step's.  The
# eager step is held to the single process above and, through the
# assembly, to the JAX package's shard_map; the port's mesh step is that
# eager step bit for bit.  A deferred frame cuts at its 10 assemblies and
# the final cost (11), a classic one at 10 assemblies and 10 cost passes.
@pytest.mark.parametrize("schedule,cuts", [("deferred", 11),
                                           ("classic", 20)])
def test_captured_multichip_step_is_the_eager_step(shard_runs, schedule,
                                                   cuts):
    key = "captured" if schedule == "deferred" else "captured_classic"
    for out in shard_runs:
        run = out[key]
        assert len(run["captured"]) == len(run["eager"]) >= 2
        for got, want in zip(run["captured"], run["eager"]):
            same_bits(got, want)
        assert run["cuts"] == [cuts] * len(run["cuts"])
        assert len(run["cuts"]) == len(run["captured"])
    same_bits(shard_runs[0][key]["captured"], shard_runs[1][key]["captured"])
