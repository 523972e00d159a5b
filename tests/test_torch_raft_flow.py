"""The port's RAFT optical flow against the JAX package's flax model fed
with the port's own state dict through the JAX converters, in both key
layouts: the original RAFT's (convert_torch_raft_flow) and torchvision's
raft_large (convert_torchvision_raft_flow, the port loading it through
torchvision_raft_keys).  The whole model at 3 GRU iterations on 64 x 96
images within RAFT_TOL of the output's largest magnitude, and the
correlation window's channel order (x-offset outer)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import RAFT_TOL, image, nhwc, scaled_err, seeded, \
    to_torchvision_raft

from super_tpu.models import raft_flow as jrf
from super_tpu_torch.models import raft_flow as rf

ITERS = 3


@pytest.fixture(scope="module")
def flow_model():
    return seeded(rf.RAFTFlow(iters=ITERS), seed=11)


@pytest.fixture(scope="module")
def jflow():
    """The flax model, jitted once for both layouts (its compile is most
    of this file's time)."""
    return jax.jit(jrf.RAFTFlow(iters=ITERS).apply)


@pytest.mark.parametrize("layout", ["raft", "torchvision"])
def test_raft_flow_matches_flax(flow_model, jflow, layout):
    sd = flow_model.state_dict()
    if layout == "raft":
        params = jrf.convert_torch_raft_flow(sd)
        model = flow_model
    else:
        tv = to_torchvision_raft(sd)
        assert not any(k.startswith(("fnet.", "cnet.")) for k in tv)
        params = jrf.convert_torchvision_raft_flow(tv)
        model = rf.RAFTFlow(iters=ITERS)
        model.load_state_dict(rf.torchvision_raft_keys(
            {"module." + k: v for k, v in tv.items()}))
    im1, im2 = image(4), image(5)
    with torch.no_grad():
        got = model(torch.from_numpy(im1), torch.from_numpy(im2))
    ref = jflow(params, nhwc(im1), nhwc(im2))
    assert got.shape == (1, 2, 64, 96)
    assert scaled_err(np.asarray(ref).transpose(0, 3, 1, 2), got) < RAFT_TOL


def test_lookup_corr_2d_channel_order():
    """The window's x-offset is the outer channel axis within a level:
    a volume that is a ramp in x alone varies across the outer axis and
    not the inner; and the lookup matches the JAX one near the edges."""
    h, w = 10, 10
    ramp = torch.arange(w, dtype=torch.float32).expand(1, h, w, h, w) + 1.0
    pyr = [ramp]
    cx = torch.full((1, h, w), 4.0)
    cy = torch.full((1, h, w), 5.0)
    win = rf.lookup_corr_2d(pyr, cx, cy)[0, :, 0, 0].reshape(9, 9)
    assert torch.equal(win[:, 0], win[:, 4])        # inner axis: y
    assert torch.equal(win[:, 0], torch.tensor(
        [1.0, 2, 3, 4, 5, 6, 7, 8, 9]))             # outer axis: x - 4 + i
    rng = np.random.RandomState(2)
    f1 = rng.randn(1, 8, h, w).astype(np.float32)
    f2 = rng.randn(1, 8, h, w).astype(np.float32)
    jpyr = jrf.build_corr_pyramid_2d(nhwc(f1), nhwc(f2), num_levels=2)
    tpyr = rf.build_corr_pyramid_2d(torch.from_numpy(f1),
                                    torch.from_numpy(f2), num_levels=2)
    for a, b in zip(jpyr, tpyr):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5)
    x = rng.uniform(-6, w + 5, (1, h, w)).astype(np.float32)
    y = rng.uniform(-6, h + 5, (1, h, w)).astype(np.float32)
    ref = jrf.lookup_corr_2d(jpyr, jnp.asarray(x), jnp.asarray(y))
    got = rf.lookup_corr_2d(tpyr, torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref).transpose(
        0, 3, 1, 2), atol=1e-5)
