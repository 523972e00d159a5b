"""Monodepth2 depth network in the reference checkpoints' key layout
(counterpart of super_tpu/models/monodepth2.py).

The encoder is a torchvision ResNet under ``encoder.`` (the layout of
monodepth2's ``encoder.pth``); the decoder is the U-Net of reflect-padded
3x3 convolutions with ELU, nearest 2x upsampling and sigmoid disparity at
four scales, its convolutions in one ModuleList ordered [(upconv 4..0, two
each), (dispconv 0..3)] (``depth.pth``: ``decoder.{i}.conv.conv.*`` and
``decoder.{10..13}.conv.*``).  Plus the flip post-processing and the
disparity -> depth conversion of the reference's ``pred_depth``.
"""

from __future__ import annotations

from typing import Dict, List, Mapping

import torch
import torch.nn.functional as F
from torch import nn

from super_tpu_torch.core.preprocess import disp_to_depth
from super_tpu_torch.models.resnet import ResNetEncoder
from super_tpu_torch.ops.blur import gaussian_blur

NUM_CH_DEC = (16, 32, 64, 128, 256)
SCALES = (0, 1, 2, 3)


class _Conv3x3(nn.Module):
    """Reflect-padded 3x3 convolution (monodepth2's ``Conv3x3``)."""

    def __init__(self, cin, cout):
        super().__init__()
        self.pad = nn.ReflectionPad2d(1)
        self.conv = nn.Conv2d(cin, cout, 3)

    def forward(self, x):
        return self.conv(self.pad(x))


class _ConvBlock(nn.Module):
    """``Conv3x3`` then ELU (monodepth2's ``ConvBlock``)."""

    def __init__(self, cin, cout):
        super().__init__()
        self.conv = _Conv3x3(cin, cout)
        self.nonlin = nn.ELU(inplace=True)

    def forward(self, x):
        return self.nonlin(self.conv(x))


class MonodepthEncoder(nn.Module):
    """The ResNet under ``encoder.``, with monodepth2's input scaling."""

    def __init__(self, num_layers: int = 18):
        super().__init__()
        self.encoder = ResNetEncoder(num_layers, normalize="monodepth2")

    def forward(self, x) -> List[torch.Tensor]:
        return self.encoder(x)


class DepthDecoder(nn.Module):
    """U-Net decoder: encoder pyramid -> {scale: (N, 1, H/2^s, W/2^s)}
    sigmoid disparities."""

    def __init__(self, num_ch_enc=(64, 64, 128, 256, 512)):
        super().__init__()
        convs = []
        for i in range(4, -1, -1):
            cin = num_ch_enc[-1] if i == 4 else NUM_CH_DEC[i + 1]
            convs.append(_ConvBlock(cin, NUM_CH_DEC[i]))
            cin = NUM_CH_DEC[i] + (num_ch_enc[i - 1] if i > 0 else 0)
            convs.append(_ConvBlock(cin, NUM_CH_DEC[i]))
        convs += [_Conv3x3(NUM_CH_DEC[s], 1) for s in SCALES]
        self.decoder = nn.ModuleList(convs)

    def forward(self, features) -> Dict[int, torch.Tensor]:
        x = features[-1]
        outputs = {}
        for k, i in enumerate(range(4, -1, -1)):
            x = self.decoder[2 * k](x)
            x = F.interpolate(x, scale_factor=2, mode="nearest")
            if i > 0:
                # Crop to the skip (sizes that are no multiple of 32).
                skip = features[i - 1]
                x = torch.cat([x[:, :, :skip.shape[2], :skip.shape[3]],
                               skip], dim=1)
            x = self.decoder[2 * k + 1](x)
            if i in SCALES:
                outputs[i] = torch.sigmoid(
                    self.decoder[10 + SCALES.index(i)](x))
        return outputs


class Monodepth2(nn.Module):
    """Encoder + decoder: (N, 3, H, W) in [0, 1] -> disparities by scale.
    Inference only: batch norm runs on its running statistics."""

    def __init__(self, num_layers: int = 18):
        super().__init__()
        self.encoder = MonodepthEncoder(num_layers)
        self.decoder = DepthDecoder(self.encoder.encoder.num_ch_enc)
        self.eval()

    def forward(self, x):
        return self.decoder(self.encoder(x))

    def load_checkpoints(self, encoder_sd: Mapping, decoder_sd: Mapping):
        """Load monodepth2's ``encoder.pth`` and ``depth.pth`` state dicts.
        The encoder's entries that the model does not hold (its
        ``height``, ``width`` and ``use_stereo`` values, torchvision's
        ``fc``) are dropped, as monodepth2's own loader drops them; a
        missing entry raises."""
        own = self.encoder.state_dict()
        self.encoder.load_state_dict(
            {k: v for k, v in encoder_sd.items() if k in own})
        self.decoder.load_state_dict(decoder_sd)
        return self


def batch_post_process_disparity(l_disp, r_disp):
    """Monodepth's flip blend of (N, H, W) disparities and their flipped
    twins' (already flipped back)."""
    w = l_disp.shape[-1]
    grid = torch.arange(w, dtype=l_disp.dtype, device=l_disp.device) / w
    l_mask = 1.0 - torch.clamp(20 * (grid - 0.05), 0.0, 1.0)
    r_mask = torch.flip(l_mask, dims=(0,))
    m_disp = 0.5 * (l_disp + r_disp)
    return r_mask * l_disp + l_mask * r_disp + \
        (1.0 - l_mask - r_mask) * m_disp


def predict_depth(model: Monodepth2, image_chw, min_depth: float,
                  max_depth: float, post_process: bool = True,
                  filter_kernel: int = 0):
    """The reference's ``pred_depth`` for monodepth2: (disp (H, W), depth
    (H, W)) of a (3, H, W) image in [0, 1].  ``filter_kernel > 0``
    Gaussian-blurs the disparity after the flip blend (post-process) or
    the raw sigmoid disparity before the depth conversion (otherwise)."""
    img = image_chw[None]
    if post_process:
        disp = model(torch.cat([img, torch.flip(img, dims=(3,))]))[0][:, 0]
        disp, _ = disp_to_depth(disp, min_depth, max_depth)
        disp = batch_post_process_disparity(
            disp[:1], torch.flip(disp[1:], dims=(2,)))[0]
        if filter_kernel > 0:
            disp = gaussian_blur(disp, kernel=filter_kernel)
        return disp, 1.0 / disp
    disp = model(img)[0][0, 0]
    if filter_kernel > 0:
        disp = gaussian_blur(disp, kernel=filter_kernel)
    return disp_to_depth(disp, min_depth, max_depth)
