"""One checkpoint file, two factories: the port's seeded random weights are
saved as a reference checkpoint (``{"state_dict": {"module." + k: v}}``),
the JAX package's build_models and the port's load the same file, and
their predict_frame_inputs agree for every depth and segmentation net;
the flow net's weights arrive identically from the original RAFT layout
and from torchvision's raft_large.  64 x 96 images."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import tiny_config
from torch_helpers import NET_TOL, RAFT_TOL, image, port_config, \
    save_checkpoint, scaled_err, to_torchvision_raft

from super_tpu import factory as jfactory
from super_tpu.config import LossConfig
from super_tpu.models.raft_flow import convert_torch_raft_flow
from super_tpu_torch import factory

H, W = 64, 96


def _cfg(**kw):
    return tiny_config(h=H, w=W).replace(**kw)


def _both(cfg, tmp_path, right=False, **ckpt_of):
    """Save the port's random nets of ``cfg`` as checkpoints (``ckpt_of``:
    {build_models argument: (attribute, state_dict accessor)}), load them
    into both factories and run both predict_frame_inputs."""
    src = factory.build_models(port_config(cfg), seed=3, device="cpu")
    paths = {}
    for arg, get in ckpt_of.items():
        paths[arg] = save_checkpoint(tmp_path / f"{arg}.pth", get(src))
    jm = jfactory.build_models(cfg, **paths)
    tm = factory.build_models(port_config(cfg), device="cpu", seed=9,
                              **paths)
    left = image(11)[0]
    r = image(12)[0] if right else None
    jout = jfactory.predict_frame_inputs(
        cfg, jm, jnp.asarray(left),
        right_color_chw=None if r is None else jnp.asarray(r))
    tout = factory.predict_frame_inputs(port_config(cfg), tm, left,
                                        right_color_chw=r)
    return jout, tout


def test_monodepth2_checkpoint(tmp_path):
    """encoder.pth with its height / width / use_stereo entries."""
    cfg = _cfg(depth_model="monodepth2_stereo", post_process=True,
               depth_filter_kernel_size=5)
    src = factory.build_models(port_config(cfg), seed=3, device="cpu")
    enc = save_checkpoint(tmp_path / "encoder.pth",
                          src.depth_model.encoder.state_dict(), height=H,
                          width=W, use_stereo=True)
    dec = save_checkpoint(tmp_path / "depth.pth",
                          src.depth_model.decoder.state_dict())
    jm = jfactory.build_models(cfg, depth_checkpoint=dec,
                               encoder_checkpoint=enc)
    tm = factory.build_models(port_config(cfg), depth_checkpoint=dec,
                              encoder_checkpoint=enc, device="cpu", seed=9)
    for k, v in src.depth_model.state_dict().items():
        assert torch.equal(tm.depth_model.state_dict()[k], v), k
    x = image(11)[0]
    jd = jfactory.predict_frame_inputs(cfg, jm, jnp.asarray(x))["depth"]
    td = factory.predict_frame_inputs(port_config(cfg), tm, x)["depth"]
    assert td.shape == (H, W) and torch.isfinite(td).all()
    assert scaled_err(jd, td) < NET_TOL


def test_raft_stereo_checkpoint(tmp_path):
    """RAFT-Stereo at its 32 iterations; held on 1 / depth, which is
    linear in the disparity (an untrained net's disparity crosses 0)."""
    cfg = _cfg(depth_model="raft_stereo")
    jout, tout = _both(cfg, tmp_path, right=True, depth_checkpoint=lambda m:
                       m.depth_model.state_dict())
    assert tout["depth"].shape == (H, W)
    assert scaled_err(1.0 / np.asarray(jout["depth"], np.float64),
                      1.0 / tout["depth"].double()) < RAFT_TOL


@pytest.mark.parametrize("arch", ["deeplabv3plus", "unet", "unet++",
                                  "manet", "deeplabv3+"])
def test_seg_checkpoint(tmp_path, arch):
    cfg = _cfg(seg_model=arch, num_classes=2)
    jout, tout = _both(cfg, tmp_path, seg_checkpoint=lambda m:
                       m.seg_model.state_dict())
    assert set(tout) == {"seg", "seg_conf"}
    assert scaled_err(jout["seg_conf"], tout["seg_conf"]) < NET_TOL
    gap = np.abs(np.diff(np.asarray(jout["seg_conf"]), axis=0))[0]
    clear = gap > NET_TOL
    np.testing.assert_array_equal(tout["seg"].numpy()[clear],
                                  np.asarray(jout["seg"])[clear])


@pytest.mark.parametrize("layout", ["raft", "torchvision"])
def test_flow_checkpoint(tmp_path, layout):
    """The flow net's weights reach both packages unchanged (its outputs
    are held to the flax model's in test_torch_raft_flow.py)."""
    cfg = _cfg(losses=LossConfig(sf_corr=True))
    src = factory.build_models(port_config(cfg), seed=3, device="cpu")
    sd = src.flow_model.state_dict()
    path = save_checkpoint(tmp_path / "raft.pth", to_torchvision_raft(sd)
                 if layout == "torchvision" else sd)
    jm = jfactory.build_models(cfg, flow_checkpoint=path)
    tm = factory.build_models(port_config(cfg), flow_checkpoint=path,
                              device="cpu", seed=9)
    for k, v in sd.items():
        assert torch.equal(tm.flow_model.state_dict()[k], v), k
    want = jax.tree_util.tree_leaves(convert_torch_raft_flow(sd))
    got = jax.tree_util.tree_leaves(jm.flow_params)
    assert len(want) == len(got)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_random_weights_are_seeded():
    cfg = port_config(_cfg(depth_model="monodepth2_stereo",
                           seg_model="unet", num_classes=2))
    a, b, c = (factory.build_models(cfg, seed=s, device="cpu")
               for s in (4, 4, 5))
    for k, v in a.seg_model.state_dict().items():
        assert torch.equal(b.seg_model.state_dict()[k], v), k
    assert not torch.equal(a.depth_model.encoder.encoder.conv1.weight,
                           c.depth_model.encoder.encoder.conv1.weight)
    assert a.flow_model is None
    assert not a.seg_model.training and not a.depth_model.training
