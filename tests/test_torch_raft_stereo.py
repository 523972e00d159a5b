"""The port's RAFT-Stereo against the JAX package's flax model fed with the
port's own state dict through convert_torch_raft_stereo: the whole model
at 3 GRU iterations on 64 x 96 images (within RAFT_TOL of the output's
largest magnitude), the correlation lookup at the volume's edges, the
input padder in both modes and the disparity -> depth conversion."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import RAFT_TOL, image, nhwc, scaled_err, seeded

from super_tpu.models import raft_stereo as jrs
from super_tpu_torch.models import raft_stereo as rs

ITERS = 3


@pytest.fixture(scope="module")
def stereo():
    model = seeded(rs.RAFTStereo(iters=ITERS), seed=7)
    return model, jrs.convert_torch_raft_stereo(model.state_dict())


def test_raft_stereo_matches_flax(stereo):
    model, params = stereo
    im1, im2 = image(1), image(2)
    with torch.no_grad():
        got = model(torch.from_numpy(im1), torch.from_numpy(im2))
    ref = jax.jit(jrs.RAFTStereo(iters=ITERS).apply)(params, nhwc(im1),
                                                     nhwc(im2))
    assert got.shape == (1, 64, 96)
    assert scaled_err(ref, got) < RAFT_TOL


def test_state_dict_is_the_reference_layout(stereo):
    """Every key the JAX converter reads is in the port's state dict, and
    the downsample norms appear under both of their reference names."""
    sd = stereo[0].state_dict()
    assert "cnet.layer2.0.norm3.running_mean" in sd
    assert "cnet.layer2.0.downsample.1.running_mean" in sd
    assert not any(".norm" in k for k in sd if k.startswith("fnet."))
    for k in ("context_zqr_convs.2.weight", "update_block.gru32.convq.bias",
              "update_block.mask.2.weight", "cnet.outputs16.1.0.conv1.weight",
              "cnet.outputs32.1.bias", "update_block.encoder.convf1.weight"):
        assert k in sd, k


def test_lookup_corr_edges():
    """Queries off both ends of the row at every level, samples whose
    floor is -1 among them: zero outside the volume, linear inside, as
    the JAX gather (which reads column 1 for such a sample's right
    corner)."""
    rng = np.random.RandomState(0)
    f1 = rng.randn(1, 8, 3, 40).astype(np.float32)
    f2 = rng.randn(1, 8, 3, 40).astype(np.float32)
    jpyr = jrs.build_corr_pyramid(nhwc(f1), nhwc(f2))
    pyr = rs.build_corr_pyramid(torch.from_numpy(f1), torch.from_numpy(f2))
    for a, b in zip(jpyr, pyr):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5)
    x = np.linspace(-10.3, 50.7, 120, dtype=np.float32).reshape(1, 3, 40)
    ref = jrs.lookup_corr(jpyr, jnp.asarray(x))
    got = rs.lookup_corr(pyr, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref).transpose(
        0, 3, 1, 2), atol=1e-5)
    assert got.shape == (1, 36, 3, 40)


@pytest.mark.parametrize("mode", ["sintel", "kitti"])
@pytest.mark.parametrize("shape", [(37, 50), (64, 96), (33, 41)])
def test_input_padder(mode, shape):
    x = np.random.RandomState(1).rand(1, 3, *shape).astype(np.float32)
    jp = jrs.InputPadder(nhwc(x).shape, mode=mode, divis_by=8)
    tp = rs.InputPadder(x.shape, mode=mode, divis_by=8)
    ref = jp.pad(nhwc(x))
    got = tp.pad(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(ref).transpose(0, 3, 1, 2))
    assert got.shape[2] % 8 == 0 and got.shape[3] % 8 == 0
    np.testing.assert_array_equal(tp.unpad(got).numpy(), x)


def test_depth_from_disparity():
    d = np.linspace(-40, -1, 50, dtype=np.float32)
    np.testing.assert_allclose(
        rs.depth_from_disparity(torch.from_numpy(d)).numpy(),
        np.asarray(jrs.depth_from_disparity(jnp.asarray(d))), rtol=1e-6)
