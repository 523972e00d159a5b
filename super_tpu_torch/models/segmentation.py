"""Segmentation nets in segmentation_models_pytorch's key layout
(counterpart of super_tpu/models/segmentation.py).

The reference builds DeepLabV3+, U-Net, U-Net++ or MAnet from smp on a
ResNet encoder and loads its checkpoints (``checkpoint["state_dict"]``).
These mirror smp layer for layer under smp's module names (``encoder.*``
torchvision-style; ``decoder.aspp.0.convs.{0..4}``, ``decoder.aspp.{1,2}``,
``decoder.block{1,2}``; ``decoder.blocks.*``; ``decoder.center.*``;
``segmentation_head.0``).  Input (N, 3, H, W) in [0, 1] with the ImageNet
normalisation inside; output (N, C, H, W) logits.  Plus the reference's
``pred_seg``: softmax, 11 x 11 average over the in-image pixels, argmax.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from super_tpu_torch.models.resnet import ResNetEncoder


def _upsample_align(x, factor: int):
    """UpsamplingBilinear2d(scale_factor=factor): align_corners=True."""
    h, w = x.shape[2:]
    return F.interpolate(x, size=(h * factor, w * factor), mode="bilinear",
                         align_corners=True)


def _up2(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


def _sep(cin: int, cout: int, dilation: int = 1) -> nn.Sequential:
    """smp SeparableConv2d: depthwise 3x3 then pointwise 1x1, no biases."""
    return nn.Sequential(
        nn.Conv2d(cin, cin, 3, padding=dilation, dilation=dilation,
                  groups=cin, bias=False),
        nn.Conv2d(cin, cout, 1, bias=False))


def _cbr(cin: int, cout: int, k: int = 3) -> nn.Sequential:
    """smp Conv2dReLU (batch norm): bias-free conv, BN, ReLU."""
    return nn.Sequential(nn.Conv2d(cin, cout, k, padding=k // 2, bias=False),
                         nn.BatchNorm2d(cout), nn.ReLU(inplace=True))


class _ASPP(nn.Module):
    """smp's separable ASPP (rates 12 / 24 / 36 at output stride 16)."""

    def __init__(self, cin: int, cout: int = 256, rates=(12, 24, 36)):
        super().__init__()
        mods = [_cbr(cin, cout, 1)]
        mods += [nn.Sequential(_sep(cin, cout, r), nn.BatchNorm2d(cout),
                               nn.ReLU(inplace=True)) for r in rates]
        mods.append(nn.Sequential(nn.AdaptiveAvgPool2d(1),
                                  nn.Conv2d(cin, cout, 1, bias=False),
                                  nn.BatchNorm2d(cout), nn.ReLU(inplace=True)))
        self.convs = nn.ModuleList(mods)
        self.project = nn.Sequential(
            nn.Conv2d(5 * cout, cout, 1, bias=False), nn.BatchNorm2d(cout),
            nn.ReLU(inplace=True), nn.Dropout(0.5))

    def forward(self, x):
        outs = [m(x) for m in self.convs[:-1]]
        # The pooled branch's bilinear re-expansion from 1 x 1 is a
        # broadcast.
        outs.append(self.convs[-1](x).expand_as(outs[0]))
        return self.project(torch.cat(outs, dim=1))


class _DeepLabDecoder(nn.Module):
    def __init__(self, cin: int, highres_in: int):
        super().__init__()
        self.aspp = nn.Sequential(_ASPP(cin, 256), _sep(256, 256),
                                  nn.BatchNorm2d(256), nn.ReLU(inplace=True))
        self.block1 = _cbr(highres_in, 48, 1)
        self.block2 = nn.Sequential(_sep(48 + 256, 256), nn.BatchNorm2d(256),
                                    nn.ReLU(inplace=True))

    def forward(self, feats):
        y = _upsample_align(self.aspp(feats[-1]), 4)     # 1/16 -> 1/4
        return self.block2(torch.cat([y, self.block1(feats[1])], dim=1))


class _SegNet(nn.Module):
    """Encoder, decoder and a 3x3 segmentation head; inference only."""

    def _init_head(self, cin: int, num_classes: int):
        self.segmentation_head = nn.Sequential(
            nn.Conv2d(cin, num_classes, 3, padding=1))
        self.eval()


class DeepLabV3Plus(_SegNet):
    """smp.DeepLabV3Plus: dilated output-stride-16 encoder, separable
    ASPP, 48-channel high-resolution skip, head and 4x upsampling."""

    def __init__(self, num_classes: int = 3, num_layers: int = 18):
        super().__init__()
        self.encoder = ResNetEncoder(num_layers, "imagenet", output_stride=16)
        ch = self.encoder.num_ch_enc
        self.decoder = _DeepLabDecoder(ch[-1], ch[1])
        self._init_head(256, num_classes)

    def forward(self, x):
        y = self.decoder(self.encoder(x))
        return _upsample_align(self.segmentation_head(y), 4)


class _DecoderBlock(nn.Module):
    """smp's U-Net DecoderBlock: nearest 2x, concatenated skip, two
    Conv2dReLUs (no attention)."""

    def __init__(self, cin: int, cskip: int, cout: int):
        super().__init__()
        self.conv1 = _cbr(cin + cskip, cout)
        self.conv2 = _cbr(cout, cout)

    def forward(self, x, skip=None):
        x = _up2(x)
        if skip is not None:
            x = torch.cat([x, skip], dim=1)
        return self.conv2(self.conv1(x))


def _channels(num_ch_enc, decoder_channels):
    """smp's (in, skip, out) channels of the five decoder blocks."""
    in_ch = [num_ch_enc[-1]] + list(decoder_channels[:-1])
    skip_ch = list(num_ch_enc[-2::-1]) + [0]
    return in_ch, skip_ch, list(decoder_channels)


DECODER_CHANNELS = (256, 128, 64, 32, 16)


class UNet(_SegNet):
    """smp.Unet: stride-32 encoder, five decoder blocks, head at full
    resolution."""

    def __init__(self, num_classes: int = 3, num_layers: int = 18):
        super().__init__()
        self.encoder = ResNetEncoder(num_layers, "imagenet")
        in_ch, skip_ch, out_ch = _channels(self.encoder.num_ch_enc,
                                           DECODER_CHANNELS)
        self.decoder = nn.Module()
        self.decoder.blocks = nn.ModuleList(
            [_DecoderBlock(*c) for c in zip(in_ch, skip_ch, out_ch)])
        self._init_head(out_ch[-1], num_classes)

    def forward(self, x):
        feats = self.encoder(x)
        skips = feats[-2::-1] + [None]
        y = feats[-1]
        for blk, skip in zip(self.decoder.blocks, skips):
            y = blk(y, skip)
        return self.segmentation_head(y)


class UnetPlusPlus(_SegNet):
    """smp.UnetPlusPlus: the dense skip grid; node x_{d}_{l} upsamples
    x_{d}_{l-1} and concatenates the same-level nodes x_{d+1..l}_{l} and
    the encoder skip."""

    def __init__(self, num_classes: int = 3, num_layers: int = 18):
        super().__init__()
        self.encoder = ResNetEncoder(num_layers, "imagenet")
        in_ch, skip_ch, out_ch = _channels(self.encoder.num_ch_enc,
                                           DECODER_CHANNELS)
        self.depth = len(in_ch) - 1
        blocks = {}
        for layer in range(self.depth):
            for d in range(layer + 1):
                if d == 0:
                    c = (in_ch[layer], skip_ch[layer] * (layer + 1),
                         out_ch[layer])
                else:
                    c = (skip_ch[layer - 1],
                         skip_ch[layer] * (layer + 1 - d), skip_ch[layer])
                blocks[f"x_{d}_{layer}"] = _DecoderBlock(*c)
        blocks[f"x_0_{self.depth}"] = _DecoderBlock(in_ch[-1], 0, out_ch[-1])
        self.decoder = nn.Module()
        self.decoder.blocks = nn.ModuleDict(blocks)
        self._init_head(out_ch[-1], num_classes)

    def forward(self, x):
        f = self.encoder(x)[::-1]
        blocks = self.decoder.blocks
        dense = {}
        for layer in range(self.depth):
            for d in range(self.depth - layer):
                li = d + layer
                if layer == 0:
                    dense[(d, li)] = blocks[f"x_{d}_{li}"](f[d], f[d + 1])
                else:
                    cat = torch.cat([dense[(i, li)]
                                     for i in range(d + 1, li + 1)]
                                    + [f[li + 1]], dim=1)
                    dense[(d, li)] = blocks[f"x_{d}_{li}"](dense[(d, li - 1)],
                                                           cat)
        y = blocks[f"x_0_{self.depth}"](dense[(0, self.depth - 1)])
        return self.segmentation_head(y)


class _PAB(nn.Module):
    """MAnet's position-wise attention block: full spatial self-attention,
    the softmax over the whole flattened (HW x HW) map."""

    def __init__(self, cin: int, pab_channels: int = 64):
        super().__init__()
        self.top_conv = nn.Conv2d(cin, pab_channels, 1)
        self.center_conv = nn.Conv2d(cin, pab_channels, 1)
        self.bottom_conv = nn.Conv2d(cin, cin, 3, padding=1)
        self.out_conv = nn.Conv2d(cin, cin, 3, padding=1)

    def forward(self, x):
        n, c, h, w = x.shape
        top = self.top_conv(x).flatten(2)                      # (n, p, hw)
        center = self.center_conv(x).flatten(2).transpose(1, 2)
        bottom = self.bottom_conv(x).flatten(2).transpose(1, 2)
        att = torch.softmax(torch.matmul(center, top).reshape(n, -1),
                            dim=-1).reshape(n, h * w, h * w)
        sp = torch.matmul(att, bottom).transpose(1, 2).reshape(n, c, h, w)
        return self.out_conv(x + sp)


def _se(c: int, red: int) -> nn.Sequential:
    return nn.Sequential(nn.AdaptiveAvgPool2d(1), nn.Conv2d(c, red, 1),
                         nn.ReLU(inplace=True), nn.Conv2d(red, c, 1),
                         nn.Sigmoid())


class _MFAB(nn.Module):
    """MAnet's multi-scale fusion attention block: squeeze-excite gates of
    the upsampled deep path and of the skip, summed, on the deep path
    before the concatenation and two Conv2dReLUs."""

    def __init__(self, cin: int, cskip: int, cout: int, reduction: int = 16):
        super().__init__()
        self.hl_conv = nn.Sequential(_cbr(cin, cin, 3), _cbr(cin, cskip, 1))
        red = max(1, cskip // reduction)
        self.SE_ll = _se(cskip, red)
        self.SE_hl = _se(cskip, red)
        self.conv1 = _cbr(2 * cskip, cout)
        self.conv2 = _cbr(cout, cout)

    def forward(self, x, skip):
        x = _up2(self.hl_conv(x))
        gate = self.SE_hl(x) + self.SE_ll(skip)
        return self.conv2(self.conv1(torch.cat([x * gate, skip], dim=1)))


class MAnet(_SegNet):
    """smp.MAnet: PAB centre, MFAB blocks at every skip level, a plain
    DecoderBlock for the last, skip-free upsampling."""

    def __init__(self, num_classes: int = 3, num_layers: int = 18):
        super().__init__()
        self.encoder = ResNetEncoder(num_layers, "imagenet")
        in_ch, skip_ch, out_ch = _channels(self.encoder.num_ch_enc,
                                           DECODER_CHANNELS)
        self.decoder = nn.Module()
        self.decoder.center = _PAB(in_ch[0])
        self.decoder.blocks = nn.ModuleList(
            [_MFAB(*c) for c in zip(in_ch[:-1], skip_ch[:-1], out_ch[:-1])]
            + [_DecoderBlock(in_ch[-1], 0, out_ch[-1])])
        self._init_head(out_ch[-1], num_classes)

    def forward(self, x):
        feats = self.encoder(x)
        skips = feats[-2::-1]
        y = self.decoder.center(feats[-1])
        for blk, skip in zip(self.decoder.blocks[:-1], skips):
            y = blk(y, skip)
        return self.segmentation_head(self.decoder.blocks[-1](y))


def build_seg_model(arch: str, num_classes: int,
                    num_layers: int = 18) -> _SegNet:
    """The reference's ``seg_model`` switch: "unet", "unet++" /
    "unetplusplus", "manet"; any other name is DeepLabV3+."""
    if arch == "unet":
        return UNet(num_classes, num_layers)
    if arch in ("unet++", "unetplusplus"):
        return UnetPlusPlus(num_classes, num_layers)
    if arch == "manet":
        return MAnet(num_classes, num_layers)
    return DeepLabV3Plus(num_classes, num_layers)


def predict_seg(model: nn.Module, image_chw, hard_seg: bool = False):
    """The reference's ``pred_seg``: (seg (H, W) int32, seg_conf (C, H, W))
    of a (3, H, W) image in [0, 1]: class probabilities averaged over the
    in-image pixels of an 11 x 11 window, their argmax, and either the
    averages or (``hard_seg``) the argmax's one-hot."""
    logits = model(image_chw[None])[0]
    conf = torch.softmax(logits, dim=0)
    smoothed = F.avg_pool2d(conf[None], 11, stride=1, padding=5,
                            count_include_pad=False)[0]
    seg = torch.argmax(smoothed, dim=0).to(torch.int32)
    if hard_seg:
        return seg, F.one_hot(seg.long(), logits.shape[0]).permute(
            2, 0, 1).to(smoothed.dtype)
    return seg, smoothed
