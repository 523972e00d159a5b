"""The port's pose networks (models/pose.py) against the JAX package's
flax models at 64 x 64: seeded flax parameters go through the port's
converter (load_flax_params: kernels HWIO -> OIHW), both run the same
numpy input, and the outputs agree within 1e-5 of their largest
magnitude; ``transformation_from_parameters``, plain and inverted,
within 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_helpers  # noqa: F401  (two threads)
from torch_helpers import scaled_err

from super_tpu.models import pose as jpose
from super_tpu.models.resnet import ResNetEncoder
from super_tpu_torch.models import pose

POSE_TOL = 1e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def images():
    return np.random.RandomState(0).rand(2, 64, 64, 6).astype(np.float32)


def test_pose_cnn_matches_flax(images):
    net = jpose.PoseCNN(num_input_frames=2)
    params = net.init(jax.random.PRNGKey(1), jnp.asarray(images))
    want = net.apply(params, jnp.asarray(images))
    port = pose.load_flax_params(pose.PoseCNN(2), _np(params)).eval()
    with torch.no_grad():
        got = port(torch.from_numpy(images.transpose(0, 3, 1, 2).copy()))
    for w, g in zip(want, got):
        assert tuple(g.shape) == w.shape == (2, 1, 1, 3)
        assert scaled_err(w, g) < POSE_TOL


@pytest.mark.parametrize("n_features", [1, 2])
def test_pose_decoder_matches_flax(images, n_features):
    """On ResNet-18 features of one or two frames: each input its own
    squeeze convolution, as in the JAX package (ROADMAP queue 3)."""
    enc = ResNetEncoder(num_layers=18)
    ep = enc.init(jax.random.PRNGKey(2), jnp.asarray(images[..., :3]))
    feats = [[f.astype(jnp.float32) for f in enc.apply(
        ep, jnp.asarray(images[..., 3 * i:3 * i + 3]))]
        for i in range(n_features)]
    dec = jpose.PoseDecoder(num_input_features=n_features)
    dp = dec.init(jax.random.PRNGKey(3), feats)
    want = dec.apply(dp, feats)
    port = pose.load_flax_params(pose.PoseDecoder(n_features), _np(dp))
    tfeats = [[torch.from_numpy(np.asarray(f).transpose(0, 3, 1, 2).copy())
               for f in fs] for fs in feats]
    with torch.no_grad():
        got = port.eval()(tfeats)
    for w, g in zip(want, got):
        assert tuple(g.shape) == w.shape == (2, 1, 1, 3)
        assert scaled_err(w, g) < POSE_TOL


def test_converter_refuses_other_trees(images):
    net = jpose.PoseCNN(num_input_frames=2)
    params = _np(net.init(jax.random.PRNGKey(1), jnp.asarray(images)))
    with pytest.raises(ValueError):
        pose.load_flax_params(pose.PoseCNN(3), params)
    with pytest.raises(ValueError):
        pose.load_flax_params(pose.PoseDecoder(1), params)


@pytest.mark.parametrize("invert", [False, True])
def test_transformation_from_parameters(invert):
    rng = np.random.RandomState(4)
    aa = (rng.randn(3, 1, 3) * 0.3).astype(np.float32)
    aa[0, 0] = 0.0                          # a zero rotation
    t = rng.randn(3, 1, 3).astype(np.float32)
    want = np.asarray(jpose.transformation_from_parameters(
        jnp.asarray(aa), jnp.asarray(t), invert=invert))
    got = pose.transformation_from_parameters(
        torch.from_numpy(aa), torch.from_numpy(t), invert=invert).numpy()
    assert got.shape == (3, 1, 4, 4)
    np.testing.assert_allclose(got, want, atol=1e-6)
    if invert:
        fwd = pose.transformation_from_parameters(torch.from_numpy(aa),
                                                  torch.from_numpy(t))
        np.testing.assert_allclose((fwd @ torch.from_numpy(got)).numpy(),
                                   np.broadcast_to(np.eye(4), got.shape),
                                   atol=1e-5)
