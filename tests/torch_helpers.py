"""Shared pieces of the PyTorch-port parity tests (tests/test_torch_*.py).

Each test feeds the same numpy inputs to a JAX package function and to its
counterpart in ``super_tpu_torch`` (on the CPU) and compares the outputs at
a tolerance stated beside the comparison.  conftest.py turns on x64 in JAX,
so everything handed to the JAX side is float32 explicitly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from helpers import tiny_config
from super_tpu.core.preprocess import preprocess_frame
from super_tpu.data.synthetic import default_intrinsics, generate
from super_tpu_torch import convert

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
