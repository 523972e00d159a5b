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
