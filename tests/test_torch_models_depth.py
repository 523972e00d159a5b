"""The port's ResNet encoders and monodepth2 against the JAX package's flax
models fed with the port's own state dict through the JAX converters
(convert_torch_resnet, convert_torch_monodepth2), plus the Gaussian blur
and the depth error metrics.  64 x 96 images; each net's output is held
within NET_TOL of its largest magnitude."""

import jax
import numpy as np
import pytest
import torch

from torch_helpers import NET_TOL, image, nhwc, scaled_err, seeded

from super_tpu.models.monodepth2 import (
    Monodepth2 as JMonodepth2,
    convert_torch_monodepth2,
    predict_depth as jpredict_depth,
)
from super_tpu.models.resnet import ResNetEncoder as JResNet
from super_tpu.models.resnet import convert_torch_resnet
from super_tpu.ops.blur import gaussian_blur as jblur
from super_tpu.utils.evaluation import compute_depth_errors as jerrors
from super_tpu_torch.models.monodepth2 import Monodepth2, predict_depth
from super_tpu_torch.models.resnet import ResNetEncoder
from super_tpu_torch.ops.blur import gaussian_blur
from super_tpu_torch.utils.evaluation import compute_depth_errors


@pytest.mark.parametrize("num_layers,normalize,output_stride", [
    (18, "monodepth2", 32), (18, "imagenet", 16), (50, "imagenet", 32)])
def test_resnet_encoder_matches_flax(num_layers, normalize, output_stride):
    enc = seeded(ResNetEncoder(num_layers, normalize, output_stride),
                 seed=num_layers).eval()
    x = image(1)
    with torch.no_grad():
        got = enc(torch.from_numpy(x))
    params = convert_torch_resnet(enc.state_dict(), num_layers)
    ref = JResNet(num_layers=num_layers, normalize=normalize,
                  output_stride=output_stride).apply(params, nhwc(x))
    assert len(got) == len(ref) == 5
    for r, g in zip(ref, got):
        assert scaled_err(np.asarray(r).transpose(0, 3, 1, 2), g) < NET_TOL


@pytest.fixture(scope="module")
def mono():
    """(port model, flax model, flax params) of one seeded monodepth2."""
    model = seeded(Monodepth2(18), seed=5)
    params = convert_torch_monodepth2(model.encoder.state_dict(),
                                      model.decoder.state_dict(), 18)
    return model, JMonodepth2(num_layers=18), params


def test_monodepth2_disparities_match_flax(mono):
    model, jmodel, params = mono
    x = image(2, n=2)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    ref = jax.jit(jmodel.apply)(params, nhwc(x))
    assert sorted(got) == sorted(ref) == [0, 1, 2, 3]
    for s in ref:
        assert got[s].shape == (2, 1, 64 // 2 ** s, 96 // 2 ** s)
        assert scaled_err(np.asarray(ref[s]).transpose(0, 3, 1, 2),
                          got[s]) < NET_TOL


@pytest.mark.parametrize("post_process,filter_kernel",
                         [(True, 0), (True, 5), (False, 0), (False, 7)])
def test_predict_depth_matches_flax(mono, post_process, filter_kernel):
    model, jmodel, params = mono
    x = image(3)[0]
    with torch.no_grad():
        disp, depth = predict_depth(model, torch.from_numpy(x), 0.1, 80.0,
                                    post_process, filter_kernel)
    rdisp, rdepth = jpredict_depth(params, jmodel, jax.numpy.asarray(x),
                                   0.1, 80.0, post_process, filter_kernel)
    assert scaled_err(rdisp, disp) < NET_TOL
    assert scaled_err(rdepth, depth) < NET_TOL


def test_monodepth2_loads_reference_checkpoints(mono):
    """encoder.pth's extra entries (its height, width and use_stereo
    values, torchvision's fc) are dropped; the weights arrive exactly."""
    model = mono[0]
    enc = dict(model.encoder.state_dict(), height=64, width=96,
               use_stereo=True)
    enc["encoder.fc.weight"] = torch.zeros(1000, 512)
    fresh = Monodepth2(18).load_checkpoints(enc, model.decoder.state_dict())
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    with pytest.raises(RuntimeError):
        Monodepth2(18).load_checkpoints(
            {k: v for k, v in enc.items() if k != "encoder.conv1.weight"},
            model.decoder.state_dict())


@pytest.mark.parametrize("kernel,sigma", [(5, None), (15, None), (7, 2.0)])
def test_gaussian_blur_matches_jax(kernel, sigma):
    x = np.random.RandomState(kernel).rand(2, 20, 30).astype(np.float32)
    ref = jblur(jax.numpy.asarray(x), kernel, sigma)
    got = gaussian_blur(torch.from_numpy(x), kernel, sigma)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


def test_compute_depth_errors_match():
    rng = np.random.RandomState(0)
    gt = rng.uniform(0.5, 10, 500)
    pred = gt * rng.uniform(0.7, 1.4, 500)
    assert compute_depth_errors(gt, pred) == jerrors(gt, pred)
