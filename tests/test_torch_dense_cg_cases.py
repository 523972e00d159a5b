"""Kernel K3's wrapper (``dense_cg``) on CPU tensors, at the system's own
dim, against the JAX package's ``_pcg_ref`` on the system zero-padded to a
multiple of 256 and against ``pcg_pallas``'s kernel in interpret mode:
block-preconditioned normal systems at dims 7J that are multiples of
neither 4 nor 256, one whose failed block Cholesky leaves a node's rows and
columns NaN, and a fully dense SPD system."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import close

from super_tpu.pallas_kernels.pcg import _pcg_ref, pcg_pallas
from super_tpu_torch.core import lm as tlm
from super_tpu_torch.kernels import pcg as tpcg


def _normal_system(j, seed, failed_node=None):
    """A-hat and b-hat of a damped normal system J^T J + u I whose residual
    blocks each touch two random nodes (the LM's 7 x 7 pair pattern),
    block-preconditioned as ``pcg_pallas``'s caller does it; with
    ``failed_node`` that node's diagonal block is not positive definite, so
    its rows and columns of A-hat are NaN."""
    rng = np.random.default_rng(seed)
    dim = 7 * j
    jac = np.zeros((7 * 4 * j, dim))
    for res in range(4 * j):
        for node in rng.choice(j, 2, replace=False):
            jac[7 * res:7 * res + 7, 7 * node:7 * node + 7] = \
                rng.standard_normal((7, 7))
    a = jac.T @ jac + 1e-2 * np.eye(dim)
    if failed_node is not None:
        blk = slice(7 * failed_node, 7 * failed_node + 7)
        a[blk, blk] = -np.eye(7)
    b = rng.standard_normal(dim)
    a_hat, b_hat, _ = tlm.block_precondition(
        torch.as_tensor(a, dtype=torch.float32),
        torch.as_tensor(b, dtype=torch.float32), j)
    return a_hat, b_hat


def _spd(dim, seed=0, cond=50.0):
    """test_pallas_pcg.py's symmetric positive definite test matrix: no
    zero anywhere."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((dim, dim)))
    return ((q * np.geomspace(1.0, cond, dim)) @ q.T).astype(np.float32)


def _solves(a, b, iterations):
    """dense_cg on CPU tensors; _pcg_ref on the 256-padded system;
    pcg_pallas's kernel interpreted, as test_pallas_pcg.py runs it."""
    dim = a.shape[0]
    before = tpcg.dense_cg.launches
    got = tpcg.dense_cg(a, b, iterations=iterations)
    assert tpcg.dense_cg.launches == before, "CPU takes the plain version"
    assert tuple(got.shape) == (dim,)
    pad = -dim % 256
    a_np, b_np = a.numpy(), b.numpy()
    ref = _pcg_ref(jnp.asarray(np.pad(a_np, ((0, pad), (0, pad)))),
                   jnp.asarray(np.pad(b_np, (0, pad)))[None],
                   iterations=iterations)[0, :dim]
    interp = pcg_pallas(jnp.asarray(a_np), jnp.asarray(b_np),
                        iterations=iterations, interpret=True)
    assert np.asarray(ref).dtype == np.float32
    return got, ref, interp


@pytest.mark.parametrize("j", [3, 5, 37])
def test_dense_cg_unpadded_dim(j):
    a_hat, b_hat = _normal_system(j, seed=j)
    assert a_hat.shape[0] % 4 and a_hat.shape[0] % 256
    got, ref, interp = _solves(a_hat, b_hat, 32)
    # The same f32 CG; the dot products and the matvec sum in other orders
    # and over the padding's exact zeros: 1e-5 of the solution's size.
    scale = float(np.abs(got.numpy()).max())
    assert np.isfinite(scale) and scale > 0
    close(ref, got, atol=1e-5 * scale, name="ref")
    close(interp, got, atol=1e-5 * scale, name="kernel")


@pytest.mark.parametrize("iterations", [2, 32])
def test_dense_cg_failed_block_is_non_finite(iterations):
    """A node whose block Cholesky failed: alpha is guarded to 0 on the NaN
    p.Ap, so x turns NaN at that node in the first iteration and
    everywhere in the second; the LM counts the step as a reject."""
    a_hat, b_hat = _normal_system(5, seed=11, failed_node=2)
    nan_rows = torch.isnan(a_hat).all(dim=1)
    assert int(nan_rows.sum()) == 7 and bool(torch.isnan(a_hat[:, 14:21]).all())
    got, ref, interp = _solves(a_hat, b_hat, iterations)
    for name, x in (("port", got.numpy()), ("ref", np.asarray(ref)),
                    ("kernel", np.asarray(interp))):
        assert not np.isfinite(x).any(), name


def test_dense_cg_fully_dense_system():
    dim = 7 * 37
    a = torch.as_tensor(_spd(dim))
    b = torch.as_tensor(
        np.random.default_rng(1).standard_normal(dim).astype(np.float32))
    got, ref, interp = _solves(a, b, 32)
    scale = float(np.abs(got.numpy()).max())
    close(ref, got, atol=1e-5 * scale, name="ref")
    close(interp, got, atol=1e-5 * scale, name="kernel")
