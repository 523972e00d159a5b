"""Shared pieces of the PyTorch-port parity tests (tests/test_torch_*.py).

Each test feeds the same numpy inputs to a JAX package function and to its
counterpart in ``super_tpu_torch`` (on the CPU) and compares the outputs at
a tolerance stated beside the comparison.  conftest.py turns on x64 in JAX,
so everything handed to the JAX side is float32 explicitly.
"""

import dataclasses
import json
import os
import pickle
import re
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch.utils import _pytree as pytree

from helpers import tiny_config
from super_tpu.core.preprocess import preprocess_frame
from super_tpu import factory as jfactory
from super_tpu.data.synthetic import default_intrinsics, generate
from super_tpu_torch import convert
from super_tpu_torch import factory as tfactory
from super_tpu_torch.core import compiled

torch.set_num_threads(2)


def slice_config(gram_sum_dtype="f32"):
    """tiny_config with the solver settings of the port's main path
    (bench.py's non-semantic LM workload, assembly_backend="pallas")."""
    cfg = tiny_config()
    return cfg.replace(solver=dataclasses.replace(
        cfg.solver, linear_solver="pairs_fused", pcg_iterations=32,
        association="per_frame", lm_schedule="deferred",
        assembly_backend="pallas", gram_sum_dtype=gram_sum_dtype))


def headline_grid_config(**solver):
    """The port's workload config at 240 x 320, mesh step 15, as a JAX
    package config: the headline's 22 x 16 grid of ED node anchors (352 in
    a capacity of 384, as at 480 x 640 and step 30) and its assembly
    settings (``lm_workload_config``: pad group 64, tuple and pair caps
    4096) at a quarter of its pixels; ``solver`` overrides."""
    from super_tpu import config as jconfig
    from super_tpu_torch.config import lm_workload_config

    pc = lm_workload_config(240, 320, 15)
    return jconfig.SuPerConfig(
        height=pc.height, width=pc.width, mesh_step_size=pc.mesh_step_size,
        capacity=jconfig.CapacityConfig(**dataclasses.asdict(pc.capacity)),
        solver=jconfig.SolverConfig(**dict(dataclasses.asdict(pc.solver),
                                           **solver)))


def semantic_config(render=True, optimizer="Adam", lr=2e-4):
    """tiny_config with the semantic losses on the autograd path: with
    ``render``, tests/test_semantic.py's configuration (superv2 data);
    without, the root bench's semantic workload (bench.py:build_workload,
    semantic=True: superv1 data, no render loss)."""
    from super_tpu.config import LossConfig

    base = tiny_config()
    cfg = base.replace(
        method="semantic-super", num_classes=2, load_seg=True,
        losses=LossConfig(
            sf_point_plane=False, sf_soft_seg_point_plane=True,
            mesh_arap=False, mesh_rot=True, mesh_face=True,
            sf_bn_morph=True, render_loss=render),
        solver=dataclasses.replace(
            base.solver, use_derived_gradient=False, optimizer=optimizer,
            learning_rate=lr, num_iterations=10))
    return cfg.replace(data="superv2") if render else cfg


def semantic_scene(num_frames, cfg, seed=3):
    """JAX-preprocessed tiny frames with the generator's two-class
    segmentations: (intr, seq, frames)."""
    h, w = cfg.height, cfg.width
    intr = default_intrinsics(h, w)
    seq = generate(num_frames, h, w, intr=intr, seed=seed, num_classes=2)
    pre = jax.jit(lambda d, c, t, s, sc: preprocess_frame(
        cfg, intr, d, c, t, seg=s, seg_conf=sc))
    frames = [pre(jnp.asarray(seq.depths[t]),
                  jnp.asarray(seq.colors[t].transpose(2, 0, 1)),
                  jnp.float32(t), jnp.asarray(seq.segs[t]),
                  jnp.asarray(seq.seg_confs[t]))
              for t in range(num_frames)]
    return intr, seq, frames


def pipeline_pair(cfg, seq):
    """The JAX package's SuPerPipeline and the port's (on the CPU) over
    ``seq`` with its GT points: (JAX summary, port summary, port
    pipeline)."""
    from super_tpu.pipeline import SuPerPipeline
    from super_tpu_torch.data.synthetic import default_intrinsics as tintr
    from super_tpu_torch.pipeline import SuPerPipeline as TSuPerPipeline

    h, w = cfg.height, cfg.width
    ref = SuPerPipeline(cfg, default_intrinsics(h, w))
    port = TSuPerPipeline(port_config(cfg), tintr(h, w, device="cpu"),
                          device="cpu")
    ref_m, port_m = (p.run(seq.depths, seq.colors, gt_xy=seq.gt_xy,
                           gt_valid=seq.gt_valid) for p in (ref, port))
    return ref_m, port_m, port


def port_config(cfg):
    return convert.config_from_dict(dataclasses.asdict(cfg))


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def port_intr(intr):
    return convert.intrinsics_from_numpy(to_np(intr), device="cpu")


def port_frame(frame):
    return convert.frame_from_numpy(to_np(frame), device="cpu")


def port_state(state):
    return convert.tracker_state_from_numpy(to_np(state), device="cpu")


def scene(num_frames, cfg, seed=0):
    """JAX-preprocessed tiny frames: (intr, seq, frames)."""
    h, w = cfg.height, cfg.width
    intr = default_intrinsics(h, w)
    seq = generate(num_frames, h, w, intr=intr, seed=seed)
    pre = jax.jit(lambda d, c, t: preprocess_frame(cfg, intr, d, c, t))
    frames = [pre(jnp.asarray(seq.depths[t]),
                  jnp.asarray(seq.colors[t].transpose(2, 0, 1)),
                  jnp.float32(t))
              for t in range(num_frames)]
    return intr, seq, frames


def close(ref, got, atol, rtol=0.0, name=""):
    """Compare a JAX array (or numpy) with a tensor (or numpy)."""
    a = np.asarray(ref)
    b = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else \
        np.asarray(got)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    if a.dtype == np.bool_ or np.issubdtype(a.dtype, np.integer):
        np.testing.assert_array_equal(a, b, err_msg=name)
    else:
        np.testing.assert_allclose(b.astype(np.float64), a.astype(np.float64),
                                   atol=atol, rtol=rtol, err_msg=name)


# The perception nets' tolerances (largest error over the output's largest
# magnitude): the feed-forward nets, and the recurrent RAFTs (the JAX
# package's own RAFT parity tolerance, tests/test_raft_parity.py).
NET_TOL = 1e-4
RAFT_TOL = 1e-3


def seeded(model, seed=0):
    """A port model with seeded random weights and random batch-norm
    statistics (super_tpu_torch.models.init_random)."""
    from super_tpu_torch.models import init_random

    return init_random(model, torch.Generator().manual_seed(seed))


def image(seed, n=1, h=64, w=96):
    """(n, 3, h, w) float32 numpy image in [0, 1]."""
    return np.random.RandomState(seed).rand(n, 3, h, w).astype(np.float32)


def nhwc(x):
    """An NCHW numpy image as the JAX models' NHWC array."""
    return jnp.asarray(np.ascontiguousarray(np.asarray(x).transpose(
        0, 2, 3, 1)))


def scaled_err(ref, got):
    """max |got - ref| / max |ref|."""
    a = np.asarray(ref, np.float64)
    b = (got.detach().cpu().numpy() if isinstance(got, torch.Tensor)
         else np.asarray(got)).astype(np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(a)) + 1e-12))


def to_torchvision_raft(sd):
    """The port's (original RAFT) state dict in torchvision's raft_large
    key layout: the inverse of torchvision_raft_keys (each downsample
    norm once, under downsample.1)."""
    out = {}
    for k, v in sd.items():
        nk = re.sub(r"^fnet\.", "feature_encoder.", k)
        nk = re.sub(r"^cnet\.", "context_encoder.", nk)
        if nk.startswith(("feature_encoder.", "context_encoder.")):
            if ".norm3." in nk:
                continue
            nk = re.sub(r"^(\w+)\.conv1\.", r"\1.convnormrelu.0.", nk)
            nk = re.sub(r"^(\w+)\.norm1\.", r"\1.convnormrelu.1.", nk)
            nk = re.sub(r"^(\w+)\.conv2\.", r"\1.conv.", nk)
            for a, b in ((".conv1.", ".convnormrelu1.0."),
                         (".norm1.", ".convnormrelu1.1."),
                         (".conv2.", ".convnormrelu2.0."),
                         (".norm2.", ".convnormrelu2.1.")):
                nk = nk.replace(a, b)
        nk = re.sub(r"^update_block\.encoder\.conv([cf])([12])\.",
                    lambda m: "update_block.motion_encoder.conv%s%s.0." % (
                        {"c": "corr", "f": "flow"}[m.group(1)], m.group(2)),
                    nk)
        nk = nk.replace("update_block.encoder.conv.",
                        "update_block.motion_encoder.conv.0.")
        nk = re.sub(r"^update_block\.gru\.conv([zrq])([12])\.",
                    r"update_block.recurrent_block.convgru\g<2>.conv\g<1>.",
                    nk)
        nk = nk.replace("update_block.mask.0.", "mask_predictor.convrelu.0.")
        nk = nk.replace("update_block.mask.2.", "mask_predictor.conv.")
        out[nk] = v
    return out


def save_checkpoint(path, sd, **extra):
    """``sd`` saved as a reference checkpoint: wrapped in ``state_dict``
    with DataParallel's ``module.`` prefix, plus ``extra`` entries."""
    torch.save({"state_dict": dict({"module." + k: v for k, v in sd.items()},
                                   **extra)}, path)
    return str(path)


def option_tracks(option_fields, config=None, num_frames=3):
    """(JAX outputs, port outputs, JAX nodes, port nodes) of a tiny track
    of ``num_frames`` frames after frame 0, slice_config() with
    ``option_fields`` in its solver (and ``config`` fields)."""
    from super_tpu.core.tracker import init_tracker, track_step
    from super_tpu_torch.convert import to_numpy
    from super_tpu_torch.core import preprocess as tpre
    from super_tpu_torch.core import tracker as ttrack

    cfg = slice_config(gram_sum_dtype="bf16")
    cfg = cfg.replace(solver=dataclasses.replace(cfg.solver,
                                                 **option_fields),
                      **(config or {}))
    intr, seq, frames = scene(num_frames + 1, cfg)
    state = jax.jit(lambda f: init_tracker(cfg, f))(frames[0])
    step = jax.jit(lambda s, f: track_step(cfg, intr, s, f))
    want = []
    for t in range(1, num_frames + 1):
        state, outs = step(state, frames[t])
        want.append(jax.tree.map(np.asarray, outs))
    pcfg, pintr = port_config(cfg), port_intr(intr)
    colors = np.ascontiguousarray(seq.colors.transpose(0, 3, 1, 2))
    pframes = [tpre.preprocess_frame(pcfg, pintr, seq.depths[t], colors[t],
                                     float(t), device="cpu")
               for t in range(num_frames + 1)]
    pstate = ttrack.init_tracker(pcfg, pframes[0])
    got = []
    for t in range(1, num_frames + 1):
        pstate, pouts = ttrack.track_step(pcfg, pintr, pstate, pframes[t])
        got.append(to_numpy(pouts))
    return want, got, np.asarray(state.graph.points), \
        pstate.graph.points.numpy()


def check_track(runs, node_atol=1e-4):
    """tests/test_torch_solvers.py's track tolerances (test_torch_track.py's
    docstring gives their scales): the frame costs to 15%, surfel counts to
    1%, node counts and every overflow counter equal, and the node
    positions to ``node_atol``."""
    want, got, nodes_j, nodes_t = runs
    for w, g in zip(want, got):
        assert np.isfinite(g.lm_cost) and g.lm_cost > 0
        np.testing.assert_allclose(g.lm_cost, w.lm_cost, rtol=0.15)
        k = np.log(float(g.lm_damping) / 10.0) / np.log(7.5)
        assert abs(k - round(k)) < 1e-3
        n_want = int(w.num_surfels)
        assert abs(int(g.num_surfels) - n_want) <= 0.01 * n_want
        assert int(g.num_nodes) == int(w.num_nodes)
        for name in ("tuple_overflow", "pair_overflow", "proj_overflow",
                     "add_overflow", "free_exhausted", "dup_skipped"):
            assert int(getattr(g, name)) == int(getattr(w, name)), name
    assert np.max(np.abs(nodes_j - nodes_t)) < node_atol


# The port's multi-process tests: workers of tests/torch_parallel_worker.py,
# which imports no JAX, on inputs pickled without JAX types.
WORKER = os.path.join(os.path.dirname(__file__), "torch_parallel_worker.py")
JOIN_TIMEOUT = 300       # seconds a worker may take


def start_workers(scenario, world, root):
    """Start ``world`` workers of ``scenario`` on the inputs in ``root``."""
    return [subprocess.Popen(
        [sys.executable, WORKER, scenario, str(r), str(world), str(root)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]


def join_workers(scenario, procs, root):
    """Wait for the workers (each at most JOIN_TIMEOUT); their outputs by
    rank."""
    world = len(procs)
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=JOIN_TIMEOUT)[0].decode(
                errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"{scenario} rank {r}:\n{log[-4000:]}"
    outs = []
    for r in range(world):
        with open(os.path.join(root, f"{scenario}_{r}.pkl"), "rb") as f:
            outs.append(pickle.load(f))
    return outs


def write_inputs(root, **inp):
    with open(root / "inputs.pkl", "wb") as f:
        pickle.dump(inp, f)


def same_bits(a, b):
    """Bitwise equal (nested) results."""
    la = jax.tree.leaves(a)
    lb = jax.tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


class StandInGraph:
    """A CUDA graph's behaviour without a card: the capture runs ``body``
    once (the Python of a CUDA capture runs once, launching nothing);
    a replay runs it again with every launch counter left as it was and
    writes its results into the captured outputs in place."""

    def __init__(self, body, stream):
        self.body = body
        self.outputs = body()
        self.replays = 0

    def replay(self):
        counts = compiled.launch_counts()
        new = self.body()
        for k, c in zip(compiled.counted_kernels(), counts):
            k.launches = c
        for old, fresh in zip(pytree.tree_leaves(self.outputs),
                              pytree.tree_leaves(new)):
            if old.data_ptr() != fresh.data_ptr():
                old.copy_(fresh)
        self.replays += 1


def same_tensor_bits(a, b):
    """Bit for bit equal trees of tensors (floats compared as integers of
    their width)."""
    la, lb = pytree.tree_leaves(a), pytree.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        if x.is_floating_point():
            x = x.view(torch.int32 if x.element_size() == 4 else torch.int16)
            y = y.view(x.dtype)
        assert torch.equal(x, y)


# The port's bench on the CPU at 48 x 64 (tests/test_torch_bench*.py).
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_TINY = ["--cpu", "--reps", "2", "--height", "48", "--width", "64",
              "--mesh_step_size", "8"]
BENCH_ROOT_KEYS = ("metric", "value", "unit", "vs_baseline", "streams",
                   "per_stream_hz")


def bench_line(capsys, monkeypatch, *extra):
    """``python -m super_tpu_torch.bench`` at BENCH_TINY with ``extra``
    flags: its one JSON line."""
    from super_tpu_torch import bench

    monkeypatch.setattr(sys, "argv", ["bench", *BENCH_TINY, *extra])
    bench.main()
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    return json.loads(lines[0])


# The sf_corr tests' flow and scene (tests/test_torch_corr_flow*.py).
def corr_jflow(src, trg):
    """The test's flow (N, H, W, 2) of two NHWC images, JAX side."""
    ms, mt = jnp.mean(src, axis=-1), jnp.mean(trg, axis=-1)
    return jnp.stack([1.5 * (mt - ms) + 0.8, 0.9 * ms - 0.6], axis=-1)


def corr_tflow(src, trg):
    """The same flow (N, 2, H, W) of two NCHW images, port side."""
    ms, mt = torch.mean(src, dim=1), torch.mean(trg, dim=1)
    return torch.stack([1.5 * (mt - ms) + 0.8, 0.9 * ms - 0.6], dim=1)


CORR_J_MODELS = jfactory.Models(None, None, None, None,
                                types.SimpleNamespace(
                                    apply=lambda p, a, b: corr_jflow(a, b)),
                                None)
CORR_T_MODELS = tfactory.Models(None, None, corr_tflow)


def corr_flow_scene(kinds=("point-point", "point-plane")):
    """tests/test_torch_corr_flow.py's scene: the bench's semantic
    configuration with sf_corr of each loss type of ``kinds``, on the tiny
    scene: {loss type: (cfg, intr, frames, JAX state, JAX ctx, port ctx,
    ...)}."""
    from super_tpu.core import optimizer as jopt
    from super_tpu.core.tracker import init_tracker
    from super_tpu_torch.core import optimizer as topt

    base = semantic_config(render=False)
    intr, _, frames = semantic_scene(3, base)
    st = jax.jit(lambda f: init_tracker(base, f))(frames[0])
    flow = corr_jflow(frames[0].color_image.transpose(1, 2, 0)[None],
                      frames[1].color_image.transpose(1, 2, 0)[None])[0]
    flow = flow.transpose(2, 0, 1)
    out = {}
    for kind in kinds:
        cfg = base.replace(losses=dataclasses.replace(
            base.losses, sf_corr=True, sf_corr_loss_type=kind))
        ctx = jopt.prepare_autograd(cfg, st.surfels, st.graph, frames[1],
                                    flow=flow, intr=intr)
        pcfg, ps, pintr = port_config(cfg), port_state(st), port_intr(intr)
        pctx = topt.prepare_autograd(
            pcfg, ps.surfels, ps.graph, port_frame(frames[1]),
            flow=torch.as_tensor(np.asarray(flow)), intr=pintr)
        out[kind] = types.SimpleNamespace(
            cfg=cfg, intr=intr, frames=frames, st=st, ctx=ctx, pcfg=pcfg,
            ps=ps, pctx=pctx, pintr=pintr)
    return out


# The compiled fit's configurations and pipelines (tests/
# test_torch_compiled_fit*.py): name: (configuration, frames of a run).
FIT_FRAMES = 4           # frames of a run, frame 0 included

# name: (configuration, frames of a run).  "render" tracks one frame: the
# render loss's soft splat is the fit's dearest face on the CPU.
FIT_CONFIGS = {
    "adam": (semantic_config(render=False), FIT_FRAMES),
    "render": (semantic_config(render=True), 2),
    "sgd": (semantic_config(render=True, optimizer="SGD", lr=5e-5),
            FIT_FRAMES),
}


def _fit_flow_config(match_renderimg):
    base = FIT_CONFIGS["adam"][0]
    return base.replace(losses=dataclasses.replace(
        base.losses, sf_corr=True,
        sf_corr_match_renderimg=match_renderimg))


FIT_FLOWS = {"per_frame": (_fit_flow_config(False), FIT_FRAMES),
             "match_renderimg": (_fit_flow_config(True), 2)}


def fit_port_pipeline(cfg, models=None, graph=StandInGraph):
    """The port's SuPerPipeline on the CPU with its compiled steps under
    ``graph`` (None: the CPU seam)."""
    from super_tpu_torch.data.synthetic import default_intrinsics as tintr
    from super_tpu_torch.pipeline import SuPerPipeline

    pipe = SuPerPipeline(port_config(cfg),
                         tintr(cfg.height, cfg.width, device="cpu"),
                         device="cpu")
    pipe._choose_loop(models)
    pipe._step._graph_type = graph
    pipe._preprocess._graph_type = graph
    return pipe


def fit_pipeline_run(pipe, seq, n, models=None):
    return pipe.run(seq.depths[:n], seq.colors[:n], gt_xy=seq.gt_xy[:n],
                    gt_valid=seq.gt_valid[:n], segs=seq.segs[:n],
                    seg_confs=seq.seg_confs[:n], models=models)
