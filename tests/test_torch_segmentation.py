"""The port's segmentation nets (DeepLabV3+, U-Net, U-Net++, MAnet) against
the JAX package's flax models fed with the port's own state dict through
the JAX converters (smp's key layout), and predict_seg soft and hard.
64 x 96 images, three classes; each net's logits within NET_TOL of their
largest magnitude."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import NET_TOL, image, nhwc, scaled_err, seeded

from super_tpu.models import segmentation as jseg
from super_tpu_torch.models import segmentation as seg

CLASSES = 3
CONVERTERS = {"deeplabv3plus": jseg.convert_torch_smp_deeplab,
              "unet": jseg.convert_torch_smp_unet,
              "unet++": jseg.convert_torch_smp_unetplusplus,
              "manet": jseg.convert_torch_smp_manet}


@pytest.mark.parametrize("arch", sorted(CONVERTERS))
def test_seg_net_matches_flax(arch):
    model = seeded(seg.build_seg_model(arch, CLASSES), seed=len(arch))
    x = image(6)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    params = CONVERTERS[arch](model.state_dict(), 18)
    ref = jax.jit(jseg.build_seg_model(arch, CLASSES).apply)(params, nhwc(x))
    assert got.shape == (1, CLASSES, 64, 96)
    assert scaled_err(ref, got) < NET_TOL


def test_smp_key_layout():
    sd = seg.DeepLabV3Plus(2).state_dict()
    for k in ("encoder.layer4.0.downsample.0.weight",
              "decoder.aspp.0.convs.4.2.running_var",
              "decoder.aspp.0.convs.2.0.1.weight",
              "decoder.aspp.0.project.1.bias", "decoder.aspp.1.0.weight",
              "decoder.aspp.2.running_mean", "decoder.block1.0.weight",
              "decoder.block2.0.1.weight", "segmentation_head.0.bias"):
        assert k in sd, k
    assert not any(k.startswith("encoder.fc") for k in sd)
    assert "decoder.center.out_conv.bias" in seg.MAnet(2).state_dict()
    assert "decoder.blocks.x_2_3.conv2.1.weight" in \
        seg.UnetPlusPlus(2).state_dict()


@pytest.mark.parametrize("hard", [False, True])
def test_predict_seg_matches_jax(hard):
    model = seeded(seg.DeepLabV3Plus(CLASSES), seed=3)
    params = jseg.convert_torch_smp_deeplab(model.state_dict(), 18)
    x = image(7)[0]
    with torch.no_grad():
        s, conf = seg.predict_seg(model, torch.from_numpy(x), hard_seg=hard)
    js, jconf = jseg.predict_seg(params, jseg.DeepLabV3Plus(CLASSES),
                                 jnp.asarray(x), hard_seg=hard)
    assert s.dtype == torch.int32 and s.shape == (64, 96)
    assert conf.shape == (CLASSES, 64, 96)
    # The labels agree wherever the two largest smoothed scores are not
    # within the nets' tolerance of each other.
    _, soft = jseg.predict_seg(params, jseg.DeepLabV3Plus(CLASSES),
                               jnp.asarray(x))
    top2 = np.sort(np.asarray(soft), axis=0)[-2:]
    clear = (top2[1] - top2[0]) > NET_TOL
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(s.numpy()[clear], np.asarray(js)[clear])
    if hard:
        np.testing.assert_array_equal(conf.numpy()[:, clear],
                                      np.asarray(jconf)[:, clear])
        assert set(np.unique(conf.numpy())) <= {0.0, 1.0}
    else:
        assert scaled_err(jconf, conf) < NET_TOL


def test_predict_seg_smoothing_counts_in_image_pixels():
    """The 11 x 11 average divides by the in-image count: a constant
    probability map stays constant up to the border."""
    class Const(torch.nn.Module):
        def forward(self, x):
            return torch.zeros(1, 2, *x.shape[2:])

    _, conf = seg.predict_seg(Const(), torch.zeros(3, 20, 30))
    np.testing.assert_allclose(conf.numpy(), 0.5, atol=1e-6)
